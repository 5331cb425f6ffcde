"""The port's representation-quality tables against the reference's.

``runtime/quality_tables.py``'s four benches run beside
``benchmarks/quality_tables.py``'s (its rows collected from
``benchmarks.common.ROWS``).  The port gets the reference's initial
state and draws: the encoder's weights (``params_from_jax``) and GMM
(``gmm_from_jax``) of seed 0, and step i's virtual-negative and SW draws
from the key the reference's loop splits off at step i (``jdraws``, as in
``test_torch_edge_train.py``); §3.3's cones (``jax.random.normal`` of
``PRNGKey(angle)``) and SW draw (of ``PRNGKey(0)``); Fig 9's GMM
(``init_gmm(PRNGKey(1), 16, 32)``).

Each training run is cut, on both sides alike, to ``STEPS_OF[mode]``
steps (``benchmarks.quality_tables.STEPS`` is set to ``N_STEPS``, and the
runs' ``steps``, Fig 9's written-in 150 included, are replaced by the
wrappers that record them).  The plain-InfoNCE modes take one step:
their gradients hold elements at ~0 where the two frameworks' last bits
differ, and AdamW's normalisation turns such an element into a step of
up to lr, so their trajectories part after the first update (measured
after 3 steps: edge_only weights 3.9e-3 apart, eval embeddings 4.9e-2;
server 2.4e-4 and 8.0e-3).  The ``streamsplit`` runs take two.

Each of the 14 training runs (three Fig 8 modes, ten Table 5 cells, Fig
9's run) against the reference's run of the same arguments: each step's
loss at rtol 1e-5 (the reference's read by a ``jax.debug.callback`` in
its ``make_loss``; measured 1.1e-6), the final weights at atol 1e-4
(7.0e-5), the eval embeddings at atol 1e-5 (8.4e-6), the bounds of
``test_torch_edge_train.py``; eval labels and probe accuracy equal,
collapse at rtol 1e-5 (2.4e-7).

Each row (parametrised over its name): name and ``derived`` string
equal; accuracies (probe, ordering, robustness) and R@1 equal; collapse
at rtol 1e-5; mAP@10 at atol 1e-4 (measured 5.8e-5: a near-tie in
edge_only's neighbour order); §3.3's SW correlation at atol 1e-9
(1.0e-12), its Laplacian correlation at 1e-7 (2.0e-8), the spectral gap
equal (the same numpy); Fig 9's r at 1e-5 (4.3e-6).  The file runs in
about 110 s, most of it the reference's jit compiles (one a run).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:          # ``benchmarks`` is a package at the root
    sys.path.insert(0, REPO)

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import edge_train as jet  # noqa: E402
from benchmarks import quality_tables as jq  # noqa: E402
from repro.core import gmm as jgmm  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro_torch.optim.sgd import tree_leaves  # noqa: E402
from repro_torch.runtime import edge_train as et  # noqa: E402
from repro_torch.runtime import quality_tables as q  # noqa: E402
from repro_torch.weights import gmm_from_jax, params_from_jax  # noqa: E402

N_STEPS = 2
# training steps a run, by mode (see the module docstring)
STEPS_OF = {"streamsplit": N_STEPS, "edge_only": 1, "server": 1}
B, N_SYN, C, D = 8, 16, et.N_COMPONENTS, et.ENC.d_embed
LOSS_RTOL, PARAM_ATOL, EMBED_ATOL = 1e-5, 1e-4, 1e-5
COLLAPSE_RTOL = 1e-5
# row name prefix -> (rtol, atol); None: equal
ROW_TOL = {"fig8_probe_acc": None, "fig8_collapse": (COLLAPSE_RTOL, 0.0),
           "table3_mAP10": (0.0, 1e-4), "table3_R1_pct": None,
           "fig8_ordering_reproduced": None, "table5_probe_acc": None,
           "table5_hybrid_most_robust": None,
           "s33_swd_quality_corr_r": (0.0, 1e-9),
           "s33_lap_jitter_corr_r": (0.0, 1e-7),
           "s33_spectral_gap_clean_vs_40drop": None,
           "fig9_uncertainty_vs_difficulty_r": (0.0, 1e-5)}
ROWS = ([f"{r}[{m}]" for m in q.MODES for r in (
            "fig8_probe_acc", "fig8_collapse", "table3_mAP10",
            "table3_R1_pct")]
        + ["fig8_ordering_reproduced"]
        + [f"table5_probe_acc[{v},drop={d}]" for v in q.VARIANTS
           for d in q.DROPS]
        + ["table5_hybrid_most_robust", "s33_swd_quality_corr_r",
           "s33_lap_jitter_corr_r", "s33_spectral_gap_clean_vs_40drop",
           "fig9_uncertainty_vs_difficulty_r"])
# (mode, variant, drop, eval_n) of each training run
RUNS = ([(m, "hybrid", 0.0, q.PROBE_EVAL) for m in q.MODES]
        + [("streamsplit", v, d, q.ABLATION_EVAL) for v in q.VARIANTS
           for d in q.DROPS]
        + [("streamsplit", "hybrid", 0.0, q.CALIB_EVAL)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jdraws(sub, n_points=et.BUFFER + B):
    """What the reference draws from ``sub`` in one step: the Gumbel
    noise and eps of its virtual negatives, the SW directions and
    prior."""
    k1, k2 = jax.random.split(sub)
    gumbel = jax.random.gumbel(k1, (B, N_SYN, C), jnp.float32)
    eps = jax.random.normal(k2, (B, N_SYN, D), jnp.float32)
    kd, kp = jax.random.split(sub)
    dirs = jswd.random_directions(kd, 32, D)
    prior = jswd.sphere_prior_samples(kp, n_points, D)
    return tuple(map(np.array, (gumbel, eps))), \
        tuple(map(np.array, (dirs, prior)))


def run_key(mode, kw):
    return (mode, kw.get("variant", "hybrid"), kw.get("drop_rate", 0.0),
            kw["eval_n"])


@pytest.fixture(scope="module")
def tables():
    """-> (reference rows, port rows, reference runs, port runs); a run is
    (TrainResult, losses) under its ``run_key``."""
    ref_runs, port_runs, losses = {}, {}, []
    orig_make_loss, orig_ref, orig_port = (
        jet.make_loss, jq.train_representation, q.train_representation)

    def make_loss(mode, variant="hybrid", n_syn=16):
        fn = orig_make_loss(mode, variant, n_syn=n_syn)

        def loss_fn(*args):
            loss, z1 = fn(*args)
            jax.debug.callback(lambda v: losses.append(float(v)), loss,
                               ordered=True)
            return loss, z1
        return loss_fn

    def ref_train(mode, **kw):
        losses.clear()
        r = orig_ref(mode, **{**kw, "steps": STEPS_OF[mode]})
        ref_runs[run_key(mode, kw)] = (r, list(losses))
        return r

    def port_train(mode, **kw):
        r = orig_port(mode, **{**kw, "steps": STEPS_OF[mode]})
        port_runs[run_key(mode, kw)] = (r, list(r.losses))
        return r

    params = jax.tree.map(np.asarray, jet.init_audio_encoder(
        jet.ENC, jax.random.PRNGKey(0)))
    gmm0 = jgmm.init_gmm(jax.random.PRNGKey(1), C, D)
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        subs.append(sub)
    step_draws = [jdraws(s) for s in subs]

    def run_kw(mode, variant, drop):
        return dict(params=params_from_jax(params),
                    gmm_state=gmm_from_jax(gmm0),
                    draws=lambda step: step_draws[step])

    kd, kp = jax.random.split(jax.random.PRNGKey(0))
    sw_draws = (np.array(jswd.random_directions(kd, q.CONE_DIRS, q.CONE_D)),
                np.array(jswd.sphere_prior_samples(kp, q.CONE_N, q.CONE_D)))

    def cone_draws(angle):
        return np.array(jax.random.normal(jax.random.PRNGKey(angle),
                                          (q.CONE_N, q.CONE_D)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jet, "make_loss", make_loss)
        mp.setattr(jq, "train_representation", ref_train)
        mp.setattr(jq, "STEPS", N_STEPS)
        mp.setattr(jcommon, "ROWS", [])
        mp.setattr(q, "train_representation", port_train)
        jq.run_all()
        ref_rows = list(jcommon.ROWS)
        kw = dict(device="cpu", run_kw=run_kw)
        rows = (q.bench_probe_and_retrieval(steps=N_STEPS, **kw)
                + q.bench_loss_ablation(steps=N_STEPS, **kw)
                + q.bench_metric_validation(device="cpu",
                                            cone_draws=cone_draws,
                                            sw_draws=sw_draws)
                + q.bench_uncertainty_calibration(
                    steps=N_STEPS, gmm_state=gmm_from_jax(gmm0), **kw))
    return ref_rows, rows, ref_runs, port_runs


def test_rows_in_the_reference_order(tables):
    ref_rows, rows, _, _ = tables
    assert [r[0] for r in rows] == [r[0] for r in ref_rows] == ROWS
    assert all(np.isfinite(r[1]) for r in rows)


@pytest.mark.parametrize("name", ROWS)
def test_row_matches_reference(tables, name):
    ref_rows, rows, _, _ = tables
    (_, want, jderived), = [r for r in ref_rows if r[0] == name]
    (_, got, derived), = [r for r in rows if r[0] == name]
    assert derived == jderived
    tol = ROW_TOL[name.split("[")[0]]
    if tol is None:
        assert got == pytest.approx(want, rel=0, abs=0)
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("key", RUNS, ids=lambda k: str(k))
def test_run_matches_reference(tables, key):
    _, _, ref_runs, port_runs = tables
    (jr, jlosses), (r, losses) = ref_runs[key], port_runs[key]
    assert len(losses) == len(jlosses) == STEPS_OF[key[0]]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jr.params)))
    for a, b in zip(tree_leaves(r.params), want, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    np.testing.assert_array_equal(r.eval_y, jr.eval_y)
    np.testing.assert_allclose(r.eval_z, jr.eval_z, rtol=0, atol=EMBED_ATOL)
    assert r.probe_acc == jr.probe_acc
    np.testing.assert_allclose(r.collapse, jr.collapse, rtol=COLLAPSE_RTOL)


def test_seeded_defaults_and_the_card():
    """Without injected draws §3.3 runs from seeded torch generators; the
    entry points default to the card."""
    rows = q.bench_metric_validation(device="cpu")
    assert [r[0] for r in rows] == ROWS[-4:-1]
    assert all(np.isfinite(r[1]) for r in rows)
    assert rows[0][1] < -0.9 and rows[1][1] > 0.9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            q.bench_metric_validation()
