"""The edge learner: small-batch streaming contrastive representation
training on the synthetic stream, the measurement substrate for Fig 8
(probe), Table 3 (retrieval) and Table 5 (loss ablation under frame
drops).

Port of ``benchmarks/edge_train.py``.  Modes:

  streamsplit  N=8 batches + GMM virtual negatives + hybrid (SWD+Lap)
  edge_only    N=8 batches, plain InfoNCE (the collapse-prone baseline)
  server       N=64 large-batch InfoNCE (upper bound)

A ``streamsplit`` step runs the hand-written kernels on a CUDA device:
``infonce_vneg`` forward and backward for the virtual-negative InfoNCE,
``swd_rank`` forward and backward for the SW term, ``laplacian_energy``
and its backward for the temporal Laplacian, and ``gmm_posterior`` in
the per-step ``em_update`` of the GMM on the 96-frame buffer.  The graph
is the reference's: both task terms every step, combined by
``torch.where`` on the cold-start flag (so the virtual term's kernels run
on cold steps too, as under XLA); the SW and Laplacian terms over the
buffer (oldest first) followed by the batch.

Random draws: the reference splits a ``jax.random`` key each step, which
a torch generator cannot replay.  ``draws(step) -> (vneg_draws,
swd_draws)`` supplies them (``(gumbel, eps)`` as ``gmm.draw_virtual``
takes them, ``(dirs, prior)`` as ``swd.draw`` does); by default they are
drawn on the CPU from a generator seeded from ``(seed, step)`` and moved
to the device, so the card and the CPU port see the same numbers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import gmm as G
from repro_torch.core.hybrid import HybridCfg, hybrid_loss
from repro_torch.core.infonce import (batch_infonce,
                                      infonce_with_virtual_negatives)
from repro_torch.core.swd import (random_directions, seeded_generator,
                                  sphere_prior_samples)
from repro_torch.data.audio_stream import AudioStream, StreamCfg, augment_pair
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.audio_encoder import (AudioEncCfg, encode,
                                              init_audio_encoder)
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.sgd import tree_map, value_and_grad

ENC = AudioEncCfg(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2),
                  d_embed=32, groups=4, frames=97)
BUFFER = 96            # temporal buffer of past embeddings, newest first
COLD_STEPS = 50        # T_coldstart = 50 frames (paper §4.1.2)
N_COMPONENTS = 16      # GMM components of the distributional memory


@dataclass
class TrainResult:
    params: dict
    eval_z: np.ndarray
    eval_y: np.ndarray
    probe_acc: float
    collapse: float    # mean pairwise |cos| of eval embeddings
    losses: np.ndarray = field(default_factory=lambda: np.zeros(0))


# at this scale (d=32, N=8) SWD values are tiny; λ₁ rescaled accordingly
HCFG = HybridCfg(lam_sw=2.0, lam_lap=0.01, n_dirs=32, knn=3)


def make_loss(mode, variant="hybrid", n_syn=16, enc_cfg=ENC):
    """-> ``loss_fn(params, key, m1, m2, gmm_state, mask, cold, zbuf)``
    returning ``(loss, z1)``; ``key`` is ``(vneg_key, swd_key)``, each a
    generator or injected draws, and ``cold`` a bool tensor."""
    def loss_fn(params, key, m1, m2, gmm_state, mask, cold, zbuf):
        z1 = encode(enc_cfg, params, m1)
        z2 = encode(enc_cfg, params, m2)
        if mode in ("server", "edge_only"):
            return batch_infonce(z1, z2, tau=0.1), z1
        vneg_key, swd_key = key
        # streamsplit: virtual negatives decouple quality from batch size.
        # Cold start (paper §4.1.2): batch negatives until the GMM's
        # statistics are populated; both terms are computed every step.
        task_virtual = infonce_with_virtual_negatives(
            vneg_key, gmm_state, z1, z2, n_syn=n_syn, tau=0.1,
            boundary_tau=0.1)
        task_cold = batch_infonce(z1, z2, tau=0.1)
        task = torch.where(cold, task_cold,
                           0.5 * task_cold + 0.5 * task_virtual)
        # the hybrid regularisers over the buffer (stored newest-first,
        # so flipped into temporal order) followed by the current batch
        z_seq = torch.cat([zbuf.flip(0), z1], dim=0)
        buf_mask = torch.cat([torch.ones(zbuf.shape[0], device=mask.device),
                              mask])
        reg, _ = hybrid_loss(swd_key, z_seq[None], HCFG,
                             mask=buf_mask[None], variant=variant)
        return task + reg, z1

    return loss_fn


def seeded_draws(seed, step, *, batch, n_syn, n_components, dim, n_dirs,
                 n_points):
    """Step ``step``'s draws on the CPU from a generator seeded from
    ``(seed, step)`` -> ``((gumbel, eps), (dirs, prior))``."""
    g = seeded_generator(seed, step)
    vneg = G.draw_virtual(g, batch, n_syn, n_components, dim)
    return vneg, (random_directions(g, n_dirs, dim),
                  sphere_prior_samples(g, n_points, dim))


class EdgeTrainer:
    """The state of one ``train_representation`` run and its step.

    ``params`` (the port's layout, e.g. from ``weights.params_from_jax``)
    and ``gmm_state`` replace the seeded initial draws when given; both
    are copied to the device.  ``draws`` is as ``train_representation``
    takes it."""

    def __init__(self, mode="streamsplit", *, batch=8, drop_rate=0.0,
                 variant="hybrid", seed=0, lr=2e-3, n_syn=16, enc_cfg=ENC,
                 device="cuda", draws=None, params=None, gmm_state=None):
        self.device = dev = resolve_device(device)
        self.mode, self.enc_cfg, self.lr = mode, enc_cfg, lr
        self.drop_rate, self.seed, self.n_syn = drop_rate, seed, n_syn
        if params is None:
            params = init_audio_encoder(enc_cfg,
                                        torch.Generator().manual_seed(seed))
        # a copy: the AdamW step updates it in place
        self.params = tree_map(lambda p: p.detach().to(dev, copy=True),
                               params)
        self.opt = adamw_init(self.params)
        if gmm_state is None:
            gmm_state = G.init_gmm(torch.Generator().manual_seed(seed + 1),
                                   N_COMPONENTS, enc_cfg.d_embed)
        self.gmm = gmm_state.to(dev)
        self.stream = AudioStream(StreamCfg(seed=seed))
        self.rng = np.random.default_rng(seed)
        self.loss_fn = make_loss(mode, variant, n_syn=n_syn, enc_cfg=enc_cfg)
        self.eff_batch = 64 if mode == "server" else batch
        self.zbuf = torch.zeros(BUFFER, enc_cfg.d_embed, device=dev)
        self.zbuf[:, 0] = 1.0   # arbitrary unit vectors until filled
        self.draws = draws or self._seeded
        self.i = 0

    def _seeded(self, step):
        return seeded_draws(self.seed, step, batch=self.eff_batch,
                            n_syn=self.n_syn,
                            n_components=self.gmm.n_components,
                            dim=self.enc_cfg.d_embed,
                            n_dirs=HCFG.n_dirs,
                            n_points=BUFFER + self.eff_batch)

    def _key(self, step):
        if self.mode != "streamsplit":
            return None
        return tuple(tuple(torch.as_tensor(a, dtype=torch.float32,
                                           device=self.device) for a in pair)
                     for pair in self.draws(step))

    def batch(self):
        """The next two augmented views and the drop mask, as the
        reference draws them from its stream and numpy generator ->
        numpy (m1, m2, mask)."""
        mels, _, _ = self.stream.batch(self.eff_batch)
        m1s, m2s = [], []
        for m in mels:
            a, b = augment_pair(self.rng, m[: self.enc_cfg.frames])
            m1s.append(a)
            m2s.append(b)
        mask = (self.rng.random(self.eff_batch)
                >= self.drop_rate).astype(np.float32)
        return np.stack(m1s), np.stack(m2s), mask

    def step(self):
        """One training step -> (loss (device scalar, detached), the
        gradients in ``tree_leaves`` order, before the update)."""
        dev = self.device
        m1, m2, mask = (torch.from_numpy(a).to(dev) for a in self.batch())
        cold = torch.tensor(self.i < COLD_STEPS, device=dev)
        (loss, z1), grads = value_and_grad(
            self.loss_fn, self.params, self._key(self.i), m1, m2, self.gmm,
            mask, cold, self.zbuf)
        adamw_update(self.params, grads, self.opt, lr=self.lr)
        if self.mode == "streamsplit":
            self.zbuf = torch.cat([z1.detach(), self.zbuf], 0)[:BUFFER]
            # lazy sync (paper §4.3.3): the GMM is fit on the temporal
            # buffer, not on the edge's instantaneous 8-frame batch
            self.gmm = G.em_update(self.gmm, self.zbuf, decay=0.1)
        self.i += 1
        return loss, grads

    @torch.no_grad()
    def evaluate(self, eval_n=240):
        """Embeddings of an eval stream (seed + 100) -> (z, labels,
        linear-probe accuracy, collapse)."""
        ev = AudioStream(StreamCfg(seed=self.seed + 100))
        mels, ys, _ = ev.batch(eval_n)
        x = torch.from_numpy(np.ascontiguousarray(
            mels[:, : self.enc_cfg.frames])).to(self.device)
        z = encode(self.enc_cfg, self.params, x).cpu().numpy()
        acc = linear_probe(z, ys, seed=self.seed, device=self.device)
        sim = np.abs(z @ z.T)
        collapse = float((sim.sum() - eval_n) / (eval_n * (eval_n - 1)))
        return z, ys, acc, collapse


def train_representation(mode="streamsplit", *, steps=250, batch=8,
                         drop_rate=0.0, variant="hybrid", seed=0, eval_n=240,
                         lr=2e-3, n_syn=16, enc_cfg=ENC, device="cuda",
                         draws=None, params=None, gmm_state=None,
                         on_step=None) -> TrainResult:
    """``steps`` training steps, then the evaluation -> ``TrainResult``
    (``losses`` holds each step's loss).  ``on_step(i, loss, grads,
    trainer)``, when given, is called after each step."""
    tr = EdgeTrainer(mode, batch=batch, drop_rate=drop_rate, variant=variant,
                     seed=seed, lr=lr, n_syn=n_syn, enc_cfg=enc_cfg,
                     device=device, draws=draws, params=params,
                     gmm_state=gmm_state)
    losses = []
    for i in range(steps):
        loss, grads = tr.step()
        losses.append(loss)
        if on_step is not None:
            on_step(i, loss, grads, tr)
    z, ys, acc, collapse = tr.evaluate(eval_n)
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    return TrainResult(tr.params, z, ys, acc, collapse, losses)


def linear_probe(z, y, *, seed=0, train_frac=0.75, steps=300, lr=0.5,
                 device="cuda"):
    """Multinomial logistic probe on frozen embeddings (numpy) -> test
    accuracy."""
    dev = resolve_device(device)
    n = len(y)
    idx = np.random.default_rng(seed).permutation(n)
    n_tr = int(n * train_frac)
    tr, te = idx[:n_tr], idx[n_tr:]
    n_cls = int(y.max()) + 1
    W = torch.zeros(z.shape[1], n_cls, device=dev, requires_grad=True)
    b = torch.zeros(n_cls, device=dev, requires_grad=True)
    zt = torch.as_tensor(z[tr], dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y[tr], dtype=torch.long, device=dev)
    for _ in range(steps):
        with torch.enable_grad():
            logp = torch.log_softmax(zt @ W + b, dim=-1)
            loss = -logp.gather(1, yt[:, None]).mean()
            gW, gb = torch.autograd.grad(loss, (W, b))
        with torch.no_grad():
            W -= lr * gW
            b -= lr * gb
    with torch.no_grad():
        ze = torch.as_tensor(z[te], dtype=torch.float32, device=dev)
        pred = (ze @ W + b).argmax(-1).cpu().numpy()
    return float((pred == y[te]).mean())


def retrieval_metrics(z, y, *, k=10):
    """mAP@k and R@1 with cosine similarity (Table 3)."""
    zn = z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1e-9)
    sim = zn @ zn.T
    np.fill_diagonal(sim, -np.inf)
    order = np.argsort(-sim, axis=1)[:, :k]
    rel = (y[order] == y[:, None]).astype(float)
    prec = np.cumsum(rel, 1) / np.arange(1, k + 1)[None]
    denom = np.maximum(rel.sum(1), 1)
    ap = (prec * rel).sum(1) / denom
    return float(ap.mean()), float(rel[:, 0].mean())
