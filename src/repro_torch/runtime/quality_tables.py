"""The representation-quality tables: Fig 8 probe (trained), Table 3
retrieval, Table 5 hybrid-loss ablation under frame drops, §3.3 metric
validation, Fig 9 uncertainty calibration.

Port of ``benchmarks/quality_tables.py``.  Each ``bench_*`` returns its
rows ``(name, value, derived)`` under the reference's names and
``paper:`` strings; ``run_all`` returns them all and ``main`` prints them
as ``name,value,derived``.  The training runs are the edge learner's
(``runtime/edge_train.py``) at the reference's small encoder ``ENC``;
on the card their steps run the hand-written kernels of the mode and
loss variant (``streamsplit``: ``infonce_vneg``, the regularisers'
kernels of the variant, ``gmm_posterior``), §3.3 the SW forward at
(512, 32) and the Laplacian forward at (1, 80, 3), Fig 9
``gmm_posterior`` at (8, 16, 32).

Random draws go through injectable sources, as everywhere in the port:
``run_kw(mode, variant, drop_rate) -> dict`` adds keyword arguments to
each ``train_representation`` call (its ``params``, ``gmm_state``,
``draws``, ``on_step``); §3.3 takes ``cone_draws(angle) -> (512, 32)``
normal draws and ``sw_draws = (dirs, prior)``; Fig 9 its ``gmm_state``.
By default they come from torch generators seeded with the reference's
integers.

    PYTHONPATH=src python -m repro_torch.runtime.quality_tables \\
        [--device cpu] [--steps N]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import gmm as G
from repro_torch.core.laplacian import (dirichlet_energy, spectral_gap,
                                        temporal_adjacency)
from repro_torch.core.swd import draw, swd_loss
from repro_torch.data.audio_stream import AudioStream, StreamCfg, augment_pair
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.audio_encoder import encode
from repro_torch.runtime.edge_train import (ENC, N_COMPONENTS,
                                            retrieval_metrics,
                                            train_representation)

STEPS = 220
MODES = ("edge_only", "streamsplit", "server")
VARIANTS = ("mse", "kl", "task_sw", "task_lap", "hybrid")
DROPS = (0.0, 0.4)
PROBE_EVAL, ABLATION_EVAL = 240, 200
# Fig 9: the trained encoder's run, then the GMM's batches (the first
# CALIB_WARM of them warm the GMM up and are not counted)
CALIB_STEPS, CALIB_EVAL, CALIB_BATCHES, CALIB_WARM = 150, 80, 60, 10
CALIB_B = 8
# §3.3: cones of CONE_N unit vectors in d = CONE_D, SW over CONE_DIRS
CONE_N, CONE_D, CONE_DIRS = 512, 32, 64
ANGLES = tuple(range(10, 100, 10))


def _train(mode, *, steps, eval_n, device, run_kw, drop_rate=0.0,
           variant="hybrid"):
    kw = run_kw(mode, variant, drop_rate) if run_kw is not None else {}
    return train_representation(mode, steps=steps, eval_n=eval_n,
                                drop_rate=drop_rate, variant=variant,
                                device=device, **kw)


def bench_probe_and_retrieval(*, steps=STEPS, device="cuda", run_kw=None):
    """Fig 8 (trained proxy) + Table 3: probe accuracy and retrieval
    metrics of the three trainable regimes."""
    paper_probe = {"edge_only": 58.6, "streamsplit": 71.8, "server": 73.6}
    paper_ret = {"edge_only": (0.287, 26.4), "streamsplit": (0.412, 38.7),
                 "server": (0.431, 40.2)}
    rows, res = [], {}
    for mode in MODES:
        r = _train(mode, steps=steps, eval_n=PROBE_EVAL, device=device,
                   run_kw=run_kw)
        res[mode] = r
        mAP, r1 = retrieval_metrics(r.eval_z, r.eval_y)
        rows += [(f"fig8_probe_acc[{mode}]", 100 * r.probe_acc,
                  f"paper:{paper_probe[mode]}"),
                 (f"fig8_collapse[{mode}]", r.collapse,
                  "mean |cos| (1.0 = dimensional collapse)"),
                 (f"table3_mAP10[{mode}]", mAP,
                  f"paper:{paper_ret[mode][0]}"),
                 (f"table3_R1_pct[{mode}]", 100 * r1,
                  f"paper:{paper_ret[mode][1]}")]
    ok = (res["edge_only"].probe_acc <= res["streamsplit"].probe_acc
          <= res["server"].probe_acc + 0.05)
    rows.append(("fig8_ordering_reproduced", float(ok),
                 "edge_only <= streamsplit <= server"))
    return rows


def bench_loss_ablation(*, steps=STEPS, device="cuda", run_kw=None):
    """Table 5: loss variants x frame-drop rates."""
    paper = {
        ("mse", 0.0): 69.2, ("mse", 0.4): 52.8,
        ("kl", 0.0): 70.1, ("kl", 0.4): 55.1,
        ("task_sw", 0.0): 70.8, ("task_sw", 0.4): 61.3,
        ("task_lap", 0.0): 70.4, ("task_lap", 0.4): 60.7,
        ("hybrid", 0.0): 71.8, ("hybrid", 0.4): 65.2,
    }
    rows, accs = [], {}
    for variant in VARIANTS:
        for drop in DROPS:
            r = _train("streamsplit", steps=steps, eval_n=ABLATION_EVAL,
                       device=device, run_kw=run_kw, drop_rate=drop,
                       variant=variant)
            accs[(variant, drop)] = r.probe_acc
            rows.append((f"table5_probe_acc[{variant},drop={drop}]",
                         100 * r.probe_acc, f"paper:{paper[(variant, drop)]}"))
    # headline: hybrid degrades least under 40% drops
    degr = {v: accs[(v, 0.0)] - accs[(v, 0.4)]
            for v in ("mse", "kl", "hybrid")}
    pct = {k: round(100 * v, 1) for k, v in degr.items()}
    rows.append(("table5_hybrid_most_robust",
                 float(degr["hybrid"] <= min(degr["mse"], degr["kl"]) + 0.03),
                 f"degradations:{pct}"))
    return rows


def _norm(z):
    """The reference's ``jnp.linalg.norm(z, -1, keepdims=True)``: -1 is
    the norm's order there, not an axis, so z (n, d) is scaled by one
    number, its matrix (-1)-norm (the least column sum of |z|)."""
    return torch.linalg.matrix_norm(z, ord=-1, keepdim=True)


def cone(normal, angle):
    """The reference's collapse levels: the (n, d) normal draws
    ``normal`` pulled towards the first axis, ``angle`` degrees of
    spread."""
    z = normal / _norm(normal)
    t = float(np.cos(np.radians(angle)))
    axis = torch.zeros(normal.shape[-1], device=normal.device)
    axis[0] = 1.0
    z = t * axis[None] + (1 - t) * z
    return z / _norm(z)


def _seeded_normal(angle):
    return torch.randn(CONE_N, CONE_D,
                       generator=torch.Generator().manual_seed(angle))


@torch.no_grad()
def bench_metric_validation(*, device="cuda", cone_draws=None, sw_draws=None):
    """§3.3: SWD vs a quality proxy across collapse levels (cones) and
    L_Lap vs jitter.  The reference imports the MMD baseline here but
    reports no row of it; neither does the port."""
    dev = resolve_device(device)
    cone_draws = cone_draws or _seeded_normal
    if sw_draws is None:
        sw_draws = draw(torch.Generator().manual_seed(0), CONE_DIRS, CONE_N,
                        CONE_D)
    key = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in sw_draws)
    # quality proxy: embedding diversity = 1 - mean pairwise |z_i . z_j|
    # (|cos| for unit rows; the discriminative capacity the paper's
    # downstream accuracy tracks)
    sw, acc_proxy = [], []
    for ang in ANGLES:
        z = cone(torch.as_tensor(cone_draws(ang), dtype=torch.float32,
                                 device=dev), ang)
        sw.append(swd_loss(key, z, n_dirs=CONE_DIRS))
        zn = z.cpu().numpy()
        sim = np.abs(zn @ zn.T)
        acc_proxy.append(1.0 - float((sim.sum() - CONE_N)
                                     / (CONE_N * (CONE_N - 1))))
    sw = torch.stack(sw).cpu().numpy().astype(np.float64)
    rows = [("s33_swd_quality_corr_r", float(np.corrcoef(sw, acc_proxy)[0, 1]),
             "paper:-0.96 (strong negative)")]

    # jitter: L_Lap rises, spectral gap falls
    t = np.linspace(0, 6 * np.pi, 80)
    z = np.stack([np.cos(t), np.sin(t), 0.5 * np.cos(2 * t)], -1)
    rng = np.random.default_rng(0)
    laps, ps = [], list(np.arange(0, 0.9, 0.1))
    for p in ps:
        zj = z.copy()
        idx = rng.random(80) < p
        perm = rng.permutation(np.where(idx)[0])
        zj[np.where(idx)[0]] = zj[perm]
        laps.append(dirichlet_energy(
            torch.as_tensor(zj, dtype=torch.float32, device=dev), k=5))
    laps = torch.stack(laps).cpu().numpy().astype(np.float64)
    rows.append(("s33_lap_jitter_corr_r", float(np.corrcoef(ps, laps)[0, 1]),
                 "paper:0.93 (strong positive)"))
    gap_clean = spectral_gap(temporal_adjacency(80, 5))
    mask = (rng.random(80) > 0.4).astype(float)
    gap_drop = spectral_gap(temporal_adjacency(80, 5, mask=mask))
    rows.append(("s33_spectral_gap_clean_vs_40drop", gap_clean,
                 f"dropped:{gap_drop:.3f} (paper: 0.42 -> 0.08)"))
    return rows


def bench_uncertainty_calibration(*, steps=CALIB_STEPS, device="cuda",
                                  run_kw=None, gmm_state=None):
    """Fig 9: GMM entropy vs difficulty, measured with a trained encoder
    (an untrained one's entropies are uninformative)."""
    dev = resolve_device(device)
    params = _train("streamsplit", steps=steps, eval_n=CALIB_EVAL,
                    device=device, run_kw=run_kw).params
    if gmm_state is None:
        gmm_state = G.init_gmm(torch.Generator().manual_seed(1),
                               N_COMPONENTS, ENC.d_embed)
    gmm = gmm_state.to(dev)
    stream = AudioStream(StreamCfg(seed=3))
    rng = np.random.default_rng(3)
    us, z1s, z2s = [], [], []
    with torch.no_grad():
        for i in range(CALIB_BATCHES):
            mels, _, _ = stream.batch(CALIB_B)
            m1, m2 = zip(*[augment_pair(rng, m[: ENC.frames]) for m in mels])
            z1, z2 = (encode(ENC, params,
                             torch.from_numpy(np.stack(m)).to(dev))
                      for m in (m1, m2))
            u = G.normalized_entropy(gmm, z1)
            gmm = G.em_update(gmm, z1, decay=0.1)
            if i >= CALIB_WARM:          # after the GMM warms up
                us.append(u)
                z1s.append(z1)
                z2s.append(z2)
    us = torch.cat(us).cpu().numpy()
    # per-frame hardness = view disagreement: frames the encoder can't pin
    # down move most under augmentation (the paper's "server utility")
    z1s, z2s = torch.cat(z1s).cpu().numpy(), torch.cat(z2s).cpu().numpy()
    hard = 1.0 - np.sum(z1s * z2s, -1)
    return [("fig9_uncertainty_vs_difficulty_r",
             float(np.corrcoef(us, hard)[0, 1]),
             "paper:0.84 — NOT reproduced at CPU scale (r~0 with C=16, d=32; "
             "see EXPERIMENTS.md)")]


def run_all(*, steps=STEPS, calib_steps=CALIB_STEPS, device="cuda",
            run_kw=None):
    """Every table's rows, in the reference's order."""
    kw = dict(device=device, run_kw=run_kw)
    return (bench_probe_and_retrieval(steps=steps, **kw)
            + bench_loss_ablation(steps=steps, **kw)
            + bench_metric_validation(device=device)
            + bench_uncertainty_calibration(steps=calib_steps, **kw))


def main(argv=None):
    ap = argparse.ArgumentParser(description="the representation-quality "
                                 "tables")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="training steps of the Fig 8 and Table 5 runs")
    ap.add_argument("--calib-steps", type=int, default=CALIB_STEPS,
                    help="training steps of Fig 9's run")
    a = ap.parse_args(argv)
    rows = run_all(steps=a.steps, calib_steps=a.calib_steps, device=a.device)
    for name, value, derived in rows:
        print(f"{name},{value:.2f},{derived}")
    return rows


if __name__ == "__main__":
    main()
