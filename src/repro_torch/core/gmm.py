"""Distributional Memory: streaming Gaussian Mixture Model (paper §4.1).

Port of ``repro.core.gmm``, with the reference's ``axis_name`` psum of
the sufficient statistics over the shards of a sessions mesh.  A
C-component diagonal GMM replaces the contrastive memory bank and is
updated by stepwise online EM.  ``responsibilities`` and ``entropy`` go
through the hand-written ``gmm_posterior`` kernel; the sufficient
statistics ``rwᵀz`` and ``rwᵀz²`` are plain matrix products, as they are
outside any Pallas kernel in the reference.  ``boundary_logits`` and
``sample_virtual_negatives`` give the edge learner its virtual negatives
(Eq. 9).  Their random draws come from a ``torch.Generator`` or are
handed in as a ``(gumbel, eps)`` pair (``draw_virtual``), as
``core.swd.draw`` takes ``(dirs, prior)``: the parity tests pass the
reference's own draws that way.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import PerShard, psum
from repro_torch.kernels import gmm_posterior


class GMMState(NamedTuple):
    s0: torch.Tensor      # (C,)    EMA count per component
    s1: torch.Tensor      # (C, d)  EMA sum of r*z
    s2: torch.Tensor      # (C, d)  EMA sum of r*z^2
    step: torch.Tensor    # ()      update counter (int32)

    @property
    def n_components(self):
        return self.s0.shape[0]

    @property
    def dim(self):
        return self.s1.shape[1]

    def to(self, device):
        return GMMState(*(x.to(device) for x in self))


def init_gmm(generator, n_components, dim, *, var0=0.05):
    """Unit-norm random means, unit counts, variance ``var0``; drawn on
    the generator's device."""
    mu = torch.randn(n_components, dim, generator=generator,
                     device=generator.device)
    mu = mu / torch.linalg.vector_norm(mu, dim=-1, keepdim=True)
    return GMMState(s0=torch.ones(n_components, device=mu.device), s1=mu,
                    s2=mu.square() + var0,
                    step=torch.zeros((), dtype=torch.int32, device=mu.device))


def params_of(state: GMMState, *, var_floor=1e-4):
    """-> (pi (C,), mu (C, d), var (C, d))."""
    s0 = state.s0.clamp_min(1e-8)
    pi = s0 / s0.sum()
    mu = state.s1 / s0[:, None]
    var = (state.s2 / s0[:, None] - mu.square()).clamp_min(var_floor)
    return pi, mu, var


def size_bytes(state: GMMState, *, dtype_bytes=2):
    """Wire/storage size of the distributional memory (Eq. 8)."""
    C, d = state.n_components, state.dim
    return 2 * C * d * dtype_bytes + C * dtype_bytes


def log_joint(state: GMMState, z):
    """log pi_c + log N(z; mu_c, diag var_c) -> (B, C), plain PyTorch."""
    pi, mu, var = params_of(state)
    return gmm_posterior.log_joint(z.float(), mu, var, torch.log(pi))


def posterior(state: GMMState, z):
    """-> (responsibilities (B, C), entropy (B,)) from the kernel."""
    pi, mu, var = params_of(state)
    return gmm_posterior.gmm_posterior(z.float().contiguous(),
                                       mu.contiguous(), var.contiguous(),
                                       torch.log(pi))


def responsibilities(state: GMMState, z):
    """Posterior p(c | z) via Bayes' rule -> (B, C)."""
    return posterior(state, z)[0]


def entropy(state: GMMState, z):
    """U_t = H(p(c|z_t)) in nats (Eq. 11) -> (B,)."""
    return posterior(state, z)[1]


def normalized_entropy(state: GMMState, z):
    """U_t / log C in [0, 1] — the RL state feature."""
    return entropy(state, z) / math.log(state.n_components)


def em_update(state: GMMState, z, *, decay=0.05, reseed_frac=0.2,
              weights=None, axis_name=None):
    """One streaming-EM step on a batch of embeddings z: (B, d) -> the new
    state (the old one is left as it was).

    Stepwise EM: S <- (1-λ) S + λ * batch sufficient statistics, the
    batch statistics scaled to ``sum(s0) / n`` so the decay does not
    depend on the batch size.  ``weights`` (B,) down-weights frames (0
    drops one): the fleet backend feeds the gap-masked snapshot this way.

    Components whose mixing weight falls below ``reseed_frac / C`` are
    re-seeded at the batch's least-explained frames (lowest max
    responsibility; zero-weight frames sort strictly last).

    With ``axis_name`` the batch is sharded: ``z`` (and ``weights``) are
    the shards' blocks, a sequence in shard order, each shard's
    statistics b0, b1, b2 and n are ``psum``'d — distributed streaming
    EM with the global fixed point — and every shard updates ``state``
    (replicated) from the sums -> a ``PerShard`` list of states.  In a
    joined job the blocks are this process's shards' and the sums cross
    processes, so every process's states are the same bits.  A shard
    reseeds from its own block, as in the reference."""
    if axis_name is None:
        z = z.float()
        r, stats = _batch_stats(state, z, weights)
        return _em_finish(state, z, r, weights, stats, decay, reseed_frac)
    zs = [x.float() for x in z]
    ws = [None] * len(zs) if weights is None else list(weights)
    states = [state.to(x.device) for x in zs]
    local = [_batch_stats(st, x, w) for st, x, w in zip(states, zs, ws)]
    totals = psum([stats for _, stats in local], axis_name)
    return PerShard(
        _em_finish(st, x, r, w, tot, decay, reseed_frac)
        for st, x, (r, _), w, tot in zip(states, zs, local, ws, totals))


def _batch_stats(state, z, weights):
    """Responsibilities of float32 ``z`` and its weighted sufficient
    statistics -> (r (B, C), (b0 (C,), b1 (C, d), b2 (C, d), n))."""
    r = responsibilities(state, z)                        # (B, C)
    if weights is None:
        rw = r
        n = torch.tensor(float(z.shape[0]), device=z.device)
    else:
        rw = r * weights.float()[:, None]
        n = weights.float().sum()
    return r, (rw.sum(0), rw.T @ z, rw.T @ z.square(), n)


def _em_finish(state, z, r, weights, stats, decay, reseed_frac):
    """The stepwise update from (summed) statistics, then the reseed."""
    b0, b1, b2, n = stats
    scale = state.s0.sum() / n.clamp_min(1.0)
    lam = decay
    s0 = (1 - lam) * state.s0 + lam * b0 * scale
    s1 = (1 - lam) * state.s1 + lam * b1 * scale
    s2 = (1 - lam) * state.s2 + lam * b2 * scale

    if reseed_frac:
        C = s0.shape[0]
        pi = s0 / s0.sum().clamp_min(1e-8)
        dead = pi < (reseed_frac / C)
        novelty = r.amax(-1)
        if weights is not None:
            novelty = novelty + 2.0 * (1.0 - weights.float().clamp(max=1.0))
        order = torch.argsort(novelty, stable=True)
        rank = torch.cumsum(dead.to(torch.int32), 0) - 1
        seed_z = z[order[rank.clamp(0, z.shape[0] - 1)]]  # (C, d)
        s0_new = s0.mean().expand_as(s0)
        mean_var = (s2 / s0.clamp_min(1e-8)[:, None]
                    - (s1 / s0.clamp_min(1e-8)[:, None]).square()
                    ).clamp_min(1e-4).mean()
        s1_new = seed_z * s0_new[:, None]
        s2_new = (seed_z.square() + mean_var) * s0_new[:, None]
        s0 = torch.where(dead, s0_new, s0)
        s1 = torch.where(dead[:, None], s1_new, s1)
        s2 = torch.where(dead[:, None], s2_new, s2)

    return GMMState(s0=s0, s1=s1, s2=s2, step=state.step + 1)


def assign(state: GMMState, z):
    """Hard component assignment c* -> (B,) int32."""
    return log_joint(state, z).argmax(-1).to(torch.int32)


def boundary_logits(state: GMMState, c_star, *, tau=0.1):
    """Eq. 9: p(c | z+, c*) ∝ pi_c · exp(−‖mu_c* − mu_c‖² / 2τ²), c ≠ c*.

    c_star: (B,) -> (B, C) sampling logits."""
    pi, mu, _ = params_of(state)
    d2 = (mu[:, None] - mu[None]).square().sum(-1)               # (C, C)
    logits = torch.log(pi)[None] - d2 / (2.0 * tau * tau)
    eye = torch.eye(pi.shape[0], dtype=torch.bool, device=pi.device)
    logits = logits.masked_fill(eye, -math.inf)
    return logits[c_star.long()]                                 # (B, C)


def draw_virtual(key, B, n_syn, C, d):
    """``key`` -> (gumbel (B, n_syn, C), eps (B, n_syn, d)): a generator
    is drawn from (Gumbel noise, then standard normals, on its device), a
    ``(gumbel, eps)`` pair is returned as it is."""
    if isinstance(key, torch.Generator):
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(B, n_syn, C, generator=key, device=key.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        eps = torch.randn(B, n_syn, d, generator=key, device=key.device)
        return gumbel, eps
    gumbel, eps = key
    if tuple(gumbel.shape) != (B, n_syn, C) or \
            tuple(eps.shape) != (B, n_syn, d):
        raise ValueError(f"drawn gumbel {tuple(gumbel.shape)} and eps "
                         f"{tuple(eps.shape)} != ({B}, {n_syn}, {C}) and "
                         f"({B}, {n_syn}, {d})")
    return gumbel, eps


def virtual_components(state: GMMState, z_anchor, gumbel, *, tau=0.1):
    """The component of each virtual negative: the Gumbel argmax over
    ``boundary_logits`` of the anchor's assigned component, which is what
    the reference's ``jax.random.categorical`` computes -> (B, n_syn)."""
    logits = boundary_logits(state, assign(state, z_anchor), tau=tau)
    return (logits[:, None, :] + gumbel.to(logits.device)).argmax(-1)


def sample_virtual_negatives(key, state: GMMState, z_anchor, n_syn, *,
                             tau=0.1):
    """Boundary-aware virtual negatives (Eq. 9) -> (B, n_syn, d),
    l2-normed.

    Per negative, a component near the anchor's decision boundary is
    drawn from ``boundary_logits`` by the Gumbel argmax (what the
    reference's ``jax.random.categorical`` computes), then a point from
    that component's Gaussian, projected to the sphere."""
    gumbel, eps = draw_virtual(key, z_anchor.shape[0], n_syn,
                               state.n_components, state.dim)
    _, mu, var = params_of(state)
    comps = virtual_components(state, z_anchor, gumbel, tau=tau)
    z = mu[comps] + eps.to(mu.device) * torch.sqrt(var[comps])
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(
        1e-6)
