"""Diversity metric: sliced-Wasserstein distance to the uniform
hypersphere prior (paper §3.1, Eq. 3).

Port of ``repro.core.swd``.  Embeddings are projected on M random
directions and each slice's 1-D Wasserstein-2 distance is computed by
sorting.  Random draws come from a ``torch.Generator`` where the
reference takes a ``jax.random`` key.  A *key* here is either a
``torch.Generator``, from which the directions and then the prior are
drawn, or a ``(dirs, prior)`` pair drawn elsewhere: the parity tests
hand the reference's own draws across that way, since a torch generator
cannot replay threefry.

``diff_sort`` and ``bitonic_diff_sort`` are ``torch.sort(..., stable=
True)``, whose values and subgradient (the gradient flows back through
the sorting permutation) are those of the reference's argsort+gather and
bitonic network.

On a CUDA tensor ``sliced_w2`` (and so ``swd_to_uniform`` and
``swd_loss``) goes through the hand-written kernels: the prior's sorted
projections ``prior_q`` are ``torch.sort(y @ dirs.T, dim=0)`` without a
gradient, as the refine round and the reference's ``ops.swd`` sort them,
and ``kernels.swd.swd_single`` gives the loss and its gradient to x
through the sort.  The gradient reaches x only: ``y`` and ``dirs`` must
not require one there.  ``core.hybrid.regularisers`` takes the same
``prior_q`` (``prior_quantiles``) into one backward launch for the SW and
Laplacian terms together.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import pmean
from repro_torch.kernels.swd import swd_single


def random_directions(generator, n_dirs, dim):
    """``n_dirs`` unit vectors of ``dim``, drawn on the generator's
    device."""
    w = torch.randn(n_dirs, dim, generator=generator,
                    device=generator.device)
    return w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)


def sphere_prior_samples(generator, n, dim):
    """``n`` samples of the uniform distribution on the unit sphere."""
    z = torch.randn(n, dim, generator=generator, device=generator.device)
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(
        1e-9)


def seeded_generator(seed, rnd, device="cpu"):
    """A generator on ``device`` seeded from ``(seed, rnd)``.  A CPU one
    gives draws that every device then sees as the same numbers; one on the
    card draws there, with no copy to the device (its numbers are the
    card's own)."""
    return torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, rnd]).generate_state(1, np.uint64)[0]
            >> np.uint64(1)))


def seeded_draws(seed, rnd, n_dirs, n, dim):
    """The directions and prior of refine round ``rnd``, from
    ``seeded_generator(seed, rnd)`` -> (dirs (n_dirs, dim), prior (n,
    dim))."""
    g = seeded_generator(seed, rnd)
    return random_directions(g, n_dirs, dim), sphere_prior_samples(g, n, dim)


def draw(key, n_dirs, n, dim):
    """``key`` -> (dirs (n_dirs, dim), prior (n, dim)): a generator is
    drawn from, a ``(dirs, prior)`` pair is returned as it is."""
    if isinstance(key, torch.Generator):
        return random_directions(key, n_dirs, dim), \
            sphere_prior_samples(key, n, dim)
    dirs, prior = key
    if tuple(dirs.shape) != (n_dirs, dim) or tuple(prior.shape) != (n, dim):
        raise ValueError(f"drawn dirs {tuple(dirs.shape)} and prior "
                         f"{tuple(prior.shape)} != ({n_dirs}, {dim}) and "
                         f"({n}, {dim})")
    return dirs, prior


def diff_sort(x, axis=0):
    """Sort along ``axis``; the gradient flows back through the sorting
    permutation."""
    return torch.sort(x, dim=axis, stable=True).values


def bitonic_diff_sort(x):
    """``diff_sort(x, axis=0)``: the reference's bitonic network gives the
    same values and subgradient."""
    return diff_sort(x, axis=0)


def prior_quantiles(y, dirs):
    """What the SW kernels take of the prior ``y`` (N, d) and ``dirs`` (M,
    d): ``dirs`` as contiguous float32, and ``prior_q`` (N, M), the prior's
    projections sorted along N, without a gradient."""
    if y.requires_grad:
        raise ValueError("the SW term on the card differentiates x only: "
                         "pass a y that does not require a gradient")
    dirs = dirs.float().contiguous()
    with torch.no_grad():
        prior_q = torch.sort(y.float() @ dirs.T, dim=0).values
    return dirs, prior_q.contiguous()


def sliced_w2(x, y, dirs):
    """Empirical SW₂² between point sets x (N, d), y (N, d) over ``dirs``
    (M, d)."""
    if x.device.type == "cuda":
        dirs, prior_q = prior_quantiles(y, dirs)
        return swd_single(x.float().contiguous(), dirs, prior_q)
    px = diff_sort(x.float() @ dirs.T, axis=0)
    py = diff_sort(y.float() @ dirs.T, axis=0)
    return (px - py).square().mean()


def swd_to_uniform(key, z, *, n_dirs=50):
    """L_SW(p_θ, U(S^{d-1})) for a batch of embeddings z: (N, d)."""
    dirs, prior = draw(key, n_dirs, z.shape[0], z.shape[-1])
    return sliced_w2(z, prior.to(z.device), dirs.to(z.device))


def swd_loss(key, z, *, n_dirs=50, axis_name=None):
    """Differentiable-through-sort SWD loss.

    With ``axis_name`` this is the *sharded* estimator: ``z`` is the
    shards' row blocks (a sequence of equal (n, d) tensors, in shard
    order), each shard computes its local SWD against the same draw —
    ONE directions/prior draw of n rows, replicated, as the reference's
    replicated key gives every shard — and the values are ``pmean``'d
    -> a ``PerShard`` list (each shard's value reaches every shard's
    rows through autograd)."""
    if axis_name is None:
        return swd_to_uniform(key, z, n_dirs=n_dirs)
    zs = list(z)
    n, d = zs[0].shape
    if any(tuple(x.shape) != (n, d) for x in zs):
        raise ValueError(f"sharded SWD needs equal row blocks, got "
                         f"{[tuple(x.shape) for x in zs]}")
    dirs, prior = draw(key, n_dirs, n, d)
    return pmean([sliced_w2(x, prior.to(x.device), dirs.to(x.device))
                  for x in zs], axis_name)


def wasserstein1_1d(x, y):
    """Exact 1-D W₁ between equal-size samples."""
    return (torch.sort(x).values - torch.sort(y).values).abs().mean()


def mmd_rbf(x, y, *, sigma=1.0):
    """Gaussian-kernel MMD², the weaker baseline metric of §3.3."""
    def k(a, b):
        d2 = (a[:, None] - b[None]).square().sum(-1)
        return torch.exp(-d2 / (2 * sigma * sigma))
    return k(x, x).mean() + k(y, y).mean() - 2 * k(x, y).mean()
