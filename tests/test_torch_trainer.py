"""The port's LM training slice against the reference: ``lm.lm_loss`` and
``chunked_ce``, remat, the optimizers and schedules, ``data/tokens.py``,
``checkpoint/``, ``runtime/trainer.py`` and ``launch/train.py``.

Weights and optimizer states are the reference's, carried across by
``weights.py``; batches are the reference's (threefry cannot be replayed
by a torch generator), and so are the hybrid term's SW draws, handed
across as ``(dirs, prior)`` pairs split from the same keys the reference
splits.  Tolerances (float32 sums in another order): losses rtol 1e-5,
every gradient within 1e-5 of its leaf's max |g|; after three optimizer
steps every parameter within 2e-5 of its leaf's max |p| (the update
divides by sqrt(v), which amplifies the gradients' last bits a little),
but for the k bias, held to 3 % of the learning rate a step (see
``K_BIAS``).
On the CPU ``attention`` takes the reference's plain path; the flash
kernels run on the card (``chip_smoke.py`` phases 11-12).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa
from repro.configs import base as jbase  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro.data.tokens import TokenStream as JTokenStream  # noqa: E402
from repro.data.tokens import random_batch as jrandom_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.schedules import SCHEDULES as JSCHEDULES  # noqa: E402
from repro.runtime import trainer as jtr  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.serial import _paths  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.tokens import TokenStream, random_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import OPTIMIZERS, get_optimizer  # noqa: E402
from repro_torch.optim.schedules import SCHEDULES  # noqa: E402
from repro_torch.optim.sgd import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402
from repro_torch.runtime.fault import FailureInjector  # noqa: E402
from repro_torch.runtime.metrics import MetricsLogger  # noqa: E402
from repro_torch.weights import (lm_from_jax, train_state_from_jax,  # noqa
                                 train_state_to_jax)

TIERS = ("qwen1.5-0.5b", "qwen3-1.7b")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5         # of each leaf's max |g|
PARAM_RTOL = 2e-5        # of each leaf's max |p|, after three steps
B, S, POOL = 4, 32, 8    # hybrid: T = 4 pooled frames a row, 16 points
LR = 1e-3                # the trajectories' peak learning rate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    jc = jbase.smoke_config(jbase.get_config(name))
    c = base.smoke_config(base.get_config(name))
    if kw:
        from dataclasses import replace
        jc, c = replace(jc, **kw), replace(c, **kw)
    return jc, c


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(step, vocab, b=B, s=S):
    return _np(jrandom_batch(jax.random.PRNGKey(step), vocab, b, s))


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _draw(key, n_points, d):
    """The reference's ``swd_loss(key, z)`` draws: (dirs, prior)."""
    kd, kp = jax.random.split(key)
    return (torch.from_numpy(np.array(jswd.random_directions(kd, 50, d))),
            torch.from_numpy(np.array(jswd.sphere_prior_samples(kp, n_points,
                                                                d))))


def _draws(key, n_micro, d, b=B):
    """The keys ``train_step`` hands each microbatch's SW term."""
    n_points = (b // n_micro) * (S // POOL)
    if n_micro == 1:
        return [_draw(key, n_points, d)]
    return [_draw(k, n_points, d) for k in jax.random.split(key, n_micro)]


def _max_rel(got_leaves, want_leaves):
    out = 0.0
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        scale = np.abs(w).max()
        err = np.abs(np.asarray(g) - w).max()
        out = max(out, err / scale if scale else err)
    return out


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TIERS)
@pytest.mark.parametrize("hybrid", [False, True])
def test_loss_and_gradients_match_reference(name, hybrid):
    jc, c = _cfgs(name)
    jp = _np(jlm.init_lm(jc, jax.random.PRNGKey(0))[0])
    batch = _jbatch(1, jc.vocab)
    key = jax.random.PRNGKey(7)
    jt = jtr.TrainCfg(hybrid=hybrid, hybrid_pool=POOL)
    (jv, jm), jg = jax.jit(jax.value_and_grad(
        jtr.make_loss_fn(jc, jt), has_aux=True))(jp, batch, key)
    loss_fn = tr.make_loss_fn(c, tr.TrainCfg(hybrid=hybrid, hybrid_pool=POOL))
    (v, m), g = value_and_grad(loss_fn, lm_from_jax(jp), _tbatch(batch),
                               _draws(key, 1, c.d_model)[0])
    np.testing.assert_allclose(float(v), float(jv), rtol=LOSS_RTOL)
    assert sorted(m) == sorted(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    assert _max_rel([x.numpy() for x in g], jax.tree.leaves(jg)) <= GRAD_RTOL


@pytest.mark.parametrize("S_, chunk", [(32, 8), (30, 8), (30, 64)])
def test_chunked_ce_matches_reference(S_, chunk):
    """Ragged last chunk (padded with ignored labels), one chunk, and
    ignored (negative) labels: the same sum-then-divide as the scan."""
    jc, c = _cfgs("qwen3-1.7b", loss_chunk=chunk)
    jp = _np(jlm.init_lm(jc, jax.random.PRNGKey(1))[0])
    rng = np.random.default_rng(S_)
    h = rng.normal(size=(3, S_, c.d_model)).astype(np.float32)
    labels = rng.integers(0, c.vocab, (3, S_)).astype(np.int32)
    labels[0, :5] = -1
    want = jlm.chunked_ce(jc, jp, jnp.asarray(h), jnp.asarray(labels))
    got = lm.chunked_ce(c, lm_from_jax(jp), torch.from_numpy(h),
                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_remat_on_and_off_give_the_same_bits():
    """Remat replays each layer in the backward; on the CPU the replay gives
    the same bits, so the loss and every gradient are bitwise equal."""
    outs = []
    for remat in (True, False):
        jc, c = _cfgs("qwen3-1.7b", remat=remat)
        p = lm_from_jax(_np(jlm.init_lm(jc, jax.random.PRNGKey(2))[0]))
        loss_fn = tr.make_loss_fn(c, tr.TrainCfg())
        (v, _), g = value_and_grad(loss_fn, p, _tbatch(_jbatch(2, c.vocab)),
                                   None)
        outs.append((v, g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _trajectories(name, optimizer, n_micro, hybrid=True, steps=3, b=B):
    """``steps`` steps of the reference's and the port's ``make_train_step``
    from the same state, batches and draws -> (reference states and
    metrics, port states and metrics), each a list over steps."""
    jc, c = _cfgs(name)
    kw = dict(optimizer=optimizer, lr=LR, warmup=1, total_steps=10,
              microbatches=n_micro, hybrid=hybrid, hybrid_pool=POOL)
    jt, tt = jtr.TrainCfg(**kw), tr.TrainCfg(**kw)
    jstate, _ = jtr.init_train_state(jc, jt, jax.random.PRNGKey(4))
    jstate = _np(jstate)
    state = train_state_from_jax(jstate, optimizer)
    jstep = jax.jit(jtr.make_train_step(jc, jt))
    step_fn = tr.make_train_step(c, tt)
    jp, jo = jstate["params"], jstate["opt"]
    p, o = state["params"], state["opt"]
    ref, port = [], []
    for s in range(steps):
        batch, key = _jbatch(10 + s, c.vocab, b), jax.random.PRNGKey(20 + s)
        jp, jo, jm = jstep(jp, jo, batch, jnp.int32(s), key)
        p, o, m = step_fn(p, o, _tbatch(batch), s,
                          _draws(key, n_micro, c.d_model, b))
        ref.append((_np(jp), _np(jo), _np(jm)))
        port.append((train_state_to_jax({"params": p, "opt": o, "step": s},
                                        optimizer),
                     {k: float(v) for k, v in m.items()}))
    return ref, port


K_BIAS = "blocks/layers/attn/wk/b"
# The k bias enters the scores as q_i . R_(j-i) b (it is added before
# RoPE), and the softmax's gradient sums to 0 over a row, so its gradient
# is a large cancellation over the dk rows: 43 % of its elements are below
# 1e-3 of the leaf's max |g| in these runs, down to 1e-7, where the two
# frameworks' rounding (3.5e-7 of the max, held at step 0 above) is a
# sizeable part of the element.  AdamW divides by sqrt(v) and Adafactor's
# update clipping couples the leaf, so that rounding reaches the updates.
# Measured over the three steps of both optimizers: at most 0.061 lr from
# the reference (Adafactor, third step), where one update moves an element
# by about lr.  The leaf is held to 0.03 lr a step taken.
K_BIAS_LR_FRAC = 0.03


def _split_k_bias(tree):
    """-> (every leaf but the k bias, the k bias or None)."""
    flat = _paths(tree)
    return ([v for k, v in flat if not k.endswith(K_BIAS)],
            next((v for k, v in flat if k.endswith(K_BIAS)), None))


@pytest.mark.parametrize("name", TIERS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_three_steps_track_reference(name, optimizer):
    """Three steps with the hybrid term on: every metric and parameter
    tracks the reference's; the k bias (qwen1.5-0.5b) is held to
    ``K_BIAS_LR_FRAC`` of the learning rate a step taken."""
    ref, port = _trajectories(name, optimizer, 1)
    for i, ((jp, jo, jm), (st, m)) in enumerate(zip(ref, port)):
        assert sorted(m) == sorted(jm)
        for k in m:
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        got, got_b = _split_k_bias(st["params"])
        want, want_b = _split_k_bias(jp)
        assert _max_rel(got, want) <= PARAM_RTOL
        if want_b is not None:
            err = np.abs(np.asarray(got_b) - want_b).max()
            assert err <= K_BIAS_LR_FRAC * LR * (i + 1), (i, err / LR)
    assert port[-1][1]["loss"] < port[0][1]["loss"]


def test_microbatches_match_reference_and_full_batch():
    """Two microbatches against the reference's (the keys split per
    microbatch), and against one full batch with the hybrid term off
    (the CE is a mean over tokens, so the two means agree)."""
    ref, port = _trajectories("qwen3-1.7b", "adamw", 2, steps=3)
    for (jp, _, jm), (st, m) in zip(ref, port):
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        assert _max_rel(jax.tree.leaves(st["params"]),
                        jax.tree.leaves(jp)) <= PARAM_RTOL
    _, full = _trajectories("qwen3-1.7b", "adamw", 1, hybrid=False, steps=1)
    _, micro = _trajectories("qwen3-1.7b", "adamw", 2, hybrid=False, steps=1)
    np.testing.assert_allclose(micro[0][1]["loss"], full[0][1]["loss"],
                               rtol=1e-5)
    assert _max_rel(jax.tree.leaves(micro[0][0]["params"]),
                    jax.tree.leaves(full[0][0]["params"])) <= PARAM_RTOL


def test_sgd_step_and_optimizer_registry():
    assert sorted(OPTIMIZERS) == ["adafactor", "adamw", "sgd"]
    assert get_optimizer("adamw") is OPTIMIZERS["adamw"]
    ref, port = _trajectories("qwen3-1.7b", "sgd", 1, hybrid=False, steps=2)
    for (jp, _, _), (st, _) in zip(ref, port):
        assert _max_rel(jax.tree.leaves(st["params"]),
                        jax.tree.leaves(jp)) <= PARAM_RTOL


@pytest.mark.parametrize("name", sorted(JSCHEDULES))
def test_schedules_match_reference(name):
    """Float32 as the reference computes it: bitwise but for cos, which
    XLA and torch round an ulp apart now and then (1 + cos cancels near the
    end of the cosine, so it is held at 1e-7 of the peak)."""
    assert sorted(SCHEDULES) == sorted(JSCHEDULES)
    peak = 3e-4
    kw = dict(peak=peak, warmup=100) if name == "rsqrt" else dict(
        peak=peak, warmup=100, total=1000)
    for step in range(0, 1100, 3):
        want = np.asarray(JSCHEDULES[name](jnp.int32(step), **kw))
        got = SCHEDULES[name](step, **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        if name == "cosine" and step > 100:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-7 * peak)
        else:
            assert got.numpy().tobytes() == want.tobytes(), step


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_token_stream_bitwise():
    for seed, step in ((0, 0), (3, 5)):
        want = JTokenStream(64, seed=seed).batch(3, 16, step=step)
        got = TokenStream(64, seed=seed).batch(3, 16, step=step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_shapes_match_reference():
    from dataclasses import asdict
    assert {k: asdict(v) for k, v in base.SHAPES.items()} == {
        k: asdict(v) for k, v in jbase.SHAPES.items()}


def test_random_batch():
    a = random_batch(torch.Generator().manual_seed(1), 50, 3, 7)
    b = random_batch(torch.Generator().manual_seed(1), 50, 3, 7)
    assert a["tokens"].shape == a["labels"].shape == (3, 7)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 50


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, optimizer):
    """A train state the reference's ``CheckpointManager`` wrote restores
    into the port's template (same keys, every leaf bitwise), and the
    port's checkpoint restores into the reference's."""
    jc, c = _cfgs("qwen3-1.7b")
    jt = jtr.TrainCfg(optimizer=optimizer)
    jstate, _ = jtr.init_train_state(jc, jt, jax.random.PRNGKey(5))
    jstate = {**jstate, "step": jnp.int32(7)}
    JManager(str(tmp_path / "ref")).save(7, jstate)
    template = tr.init_train_state(c, tr.TrainCfg(optimizer=optimizer),
                                   torch.Generator().manual_seed(0))
    got, step = CheckpointManager(str(tmp_path / "ref")).restore_latest(
        template)
    assert step == 7 and int(got["step"]) == 7
    want = train_state_from_jax(_np(jstate), optimizer)
    assert [k for k, _ in _paths(got)] == [k for k, _ in _paths(want)]
    for (_, a), (_, b) in zip(_paths(got), _paths(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    CheckpointManager(str(tmp_path / "port")).save(7, got)
    back, _ = JManager(str(tmp_path / "port")).restore_latest(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_save_snapshots_before_the_thread(tmp_path):
    """The optimizers update in place: a step taken while the background
    save runs must not reach the checkpoint."""
    state = {"w": torch.arange(100_000, dtype=torch.float32),
             "step": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(3, state, block=False)
    state["w"].add_(1.0)
    mgr.wait()
    got, step = mgr.restore_latest(state)
    assert step == 3
    assert torch.equal(got["w"], torch.arange(100_000, dtype=torch.float32))
    for s in (4, 5, 6):
        mgr.save(s, state)
    assert mgr.steps() == [5, 6]
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000006"]


# ---------------------------------------------------------------------------
# Trainer and launcher (the reference's tests/test_runtime.py, on the port)
# ---------------------------------------------------------------------------

def _trainer(tmp_path=None, **kw):
    _, c = _cfgs("qwen1.5-0.5b")
    tcfg = tr.TrainCfg(lr=kw.pop("lr", 1e-3), total_steps=40, warmup=4,
                       hybrid=kw.pop("hybrid", False), hybrid_pool=POOL)

    def data_fn(step):
        return _jbatch(step, c.vocab, 8, S)
    return tr.Trainer(c, tcfg, data_fn, device="cpu",
                      ckpt_dir=str(tmp_path) if tmp_path else None, **kw)


def test_loss_decreases():
    hist = _trainer(lr=2e-3).run(40, log_every=0)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first * 0.8


def test_failure_restore_and_continue(tmp_path):
    t = _trainer(tmp_path, ckpt_every=10,
                 failure_injector=FailureInjector(fail_at=[17, 23]))
    t.run(30, log_every=0)
    assert t.restarts == 2 and t.step == 30
    assert int(t.state["step"]) == 30


def test_restart_resumes_from_disk(tmp_path):
    t1 = _trainer(tmp_path, ckpt_every=5)
    t1.run(10, log_every=0)
    t2 = _trainer(tmp_path, ckpt_every=5)      # a fresh process, in effect
    assert t2.step == 10
    for a, b in zip(tree_leaves(t1.state), tree_leaves(t2.state)):
        assert torch.equal(a, b)


def test_other_errors_are_not_retried(tmp_path):
    """Only a node failure restores; any other error (a kernel that will
    not launch, say) propagates at once."""
    t = _trainer(tmp_path, ckpt_every=1)

    def boom(*a, **kw):
        raise RuntimeError("launch failed")
    t.train_step = boom
    with pytest.raises(RuntimeError, match="launch failed"):
        t.run(3, log_every=0)
    assert t.restarts == 0


def test_hybrid_metrics_and_straggler_monitor():
    t = _trainer(hybrid=True)
    hist = t.run(3, log_every=0)
    assert {"swd", "lap", "ce", "loss", "lr", "grad_norm"} <= set(hist[-1])
    assert np.isfinite(hist[-1]["swd"]) and np.isfinite(hist[-1]["lap"])
    assert t.monitor.samples == 3


def test_trainer_state_from_the_reference():
    """A ``Trainer`` given the reference's state (``train_state_from_jax``)
    takes the reference's first step: the same loss."""
    jc, c = _cfgs("qwen1.5-0.5b")
    jt = jtr.TrainCfg(lr=1e-3, total_steps=40, warmup=4)
    jstate, _ = jtr.init_train_state(jc, jt, jax.random.PRNGKey(0))
    batch = _jbatch(0, c.vocab, 8, S)
    _, _, jm = jax.jit(jtr.make_train_step(jc, jt))(
        jstate["params"], jstate["opt"], batch, jnp.int32(0),
        jax.random.PRNGKey(1))
    t = tr.Trainer(c, tr.TrainCfg(lr=1e-3, total_steps=40, warmup=4),
                   lambda step: batch, device="cpu")
    t.state = train_state_from_jax(_np(jstate))
    m = t.run(1, log_every=0)[0]
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=LOSS_RTOL)


def test_launcher_smoke_on_the_cpu(tmp_path, capsys):
    hist = launch_train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps",
                              "3", "--batch", "2", "--seq", "16", "--hybrid",
                              "--device", "cpu", "--ckpt-dir",
                              str(tmp_path)])
    assert len(hist) == 3 and np.isfinite(hist[-1]["loss"])
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 7"):
        launch_train.main(["--arch", "qwen1.5-0.5b", "--multi-pod",
                           "--device", "cpu"])


def test_metrics_logger(tmp_path):
    path = tmp_path / "m" / "log.jsonl"
    with MetricsLogger(str(path), window=2, clock=lambda: 1.5) as m:
        for i in range(3):
            m.log(i, loss=float(i))
        assert m.mean("loss") == 1.5 and np.isnan(m.mean("nope"))
    lines = path.read_text().splitlines()
    assert len(lines) == 3 and '"t": 1.5' in lines[0]
