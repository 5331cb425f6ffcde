"""The Hybrid Loss (paper Eq. 13):

    L_server = L_task + λ₁·L_SW(p_θ, U) + λ₂·L_Lap(G)

Port of ``repro.core.hybrid``.  L_task is InfoNCE over the buffer in the
self-supervised setting, or CE when sparse labels are available.  Also
the ablation variants of Table 5 (MSE-only, KL, task+SW, task+Lap).
``key`` is a ``torch.Generator`` or a ``(dirs, prior)`` pair
(``core.swd.draw``).  ``regularisers`` gives L_SW and L_Lap together: on
the card their gradients come from one backward launch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.infonce import batch_infonce
from repro_torch.core.laplacian import laplacian_loss
from repro_torch.core.swd import draw, prior_quantiles, swd_loss
from repro_torch.distributed.sharding import PerShard, pmean
from repro_torch.kernels.hybrid_reg import hybrid_regularisers


@dataclass(frozen=True)
class HybridCfg:
    lam_sw: float = 0.1      # λ₁ (paper grid search)
    lam_lap: float = 0.01    # λ₂
    n_dirs: int = 50         # SWD projections M
    knn: int = 5             # temporal graph neighbours
    tau: float = 0.1


def task_loss(z, *, labels=None, logits=None, z_pos=None, tau=0.1):
    if logits is not None and labels is not None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels[:, None].long()).mean()
    if z_pos is not None:
        return batch_infonce(z, z_pos, tau=tau)
    return torch.zeros((), device=z.device)


def regularisers(key, z_seq, *, n_dirs=50, k=5, mask=None):
    """L_SW of the rows of ``z_seq`` (T, d) or (B, T, d) (``swd_loss`` of
    ``z_seq.reshape(-1, d)``) and L_Lap of its frames (``laplacian_loss``)
    -> (sw, lap).  On a CUDA tensor both come from
    ``kernels.hybrid_reg.hybrid_regularisers``: the two terms' forward
    kernels, then one backward launch for both gradients.  On a CPU tensor
    ``swd_loss`` and ``laplacian_loss`` under ordinary autograd."""
    d = z_seq.shape[-1]
    if z_seq.device.type != "cuda":
        return (swd_loss(key, z_seq.reshape(-1, d), n_dirs=n_dirs),
                laplacian_loss(z_seq, k=k, mask=mask))
    z = z_seq.float() if z_seq.dim() == 3 else z_seq.float()[None]
    B, T, _ = z.shape
    dirs, prior = draw(key, n_dirs, B * T, d)
    dirs, prior_q = prior_quantiles(prior.to(z.device), dirs.to(z.device))
    mask = torch.ones(B, T, device=z.device) if mask is None \
        else mask.float().reshape(B, T)
    sw, tot, cnt = hybrid_regularisers(
        z.contiguous(), mask.detach().contiguous(), k, dirs, prior_q)
    return sw, tot.sum() / cnt.sum().clamp_min(1.0)


def hybrid_loss(key, z_seq, cfg: HybridCfg = HybridCfg(), *, mask=None,
                labels=None, logits=None, z_pos=None, variant="hybrid",
                axis_name=None):
    """z_seq: (T, d) or (B, T, d) temporally ordered embeddings.

    variant ∈ {hybrid, task_sw, task_lap, mse, kl} (Table 5 ablation).
    -> (loss, parts).

    With ``axis_name`` the batch is sharded, as under the reference's
    ``shard_map``: ``z_seq`` and each of ``mask``, ``labels``, ``logits``,
    ``z_pos`` that is given are the shards' values (sequences in shard
    order, of equal row counts).  Every shard draws from the same key
    (one draw, replicated), its L_SW is the ``pmean`` over the shards
    (``swd_loss(axis_name=...)``) and its other terms are its own ->
    a ``PerShard`` list of (loss, parts)."""
    if axis_name is None:
        parts = _parts(key, z_seq, cfg, mask, labels, logits, z_pos, variant)
        return _total(parts, cfg), parts
    shards = list(z_seq)
    per = [[None] * len(shards) if a is None else list(a)
           for a in (mask, labels, logits, z_pos)]
    d = shards[0].shape[-1]
    rows = {z.reshape(-1, d).shape[0] for z in shards}
    if len(rows) != 1:
        raise ValueError(f"sharded hybrid loss needs equal blocks, got "
                         f"{sorted(rows)} rows")
    drawn = draw(key, cfg.n_dirs, rows.pop(), d)
    parts = [_parts(drawn, z, cfg, *args, variant)
             for z, *args in zip(shards, *per)]
    if "sw" in parts[0]:
        for p, sw in zip(parts, pmean([p["sw"] for p in parts], axis_name)):
            p["sw"] = sw
    return PerShard((_total(p, cfg), p) for p in parts)


def _parts(key, z_seq, cfg, mask, labels, logits, z_pos, variant):
    z_flat = z_seq.reshape(-1, z_seq.shape[-1])
    parts = {"task": task_loss(z_flat, labels=labels, logits=logits,
                               z_pos=z_pos, tau=cfg.tau)}
    if variant == "hybrid":
        parts["sw"], parts["lap"] = regularisers(
            key, z_seq, n_dirs=cfg.n_dirs, k=cfg.knn, mask=mask)
    if variant == "task_sw":
        parts["sw"] = swd_loss(key, z_flat, n_dirs=cfg.n_dirs)
    if variant == "task_lap":
        parts["lap"] = laplacian_loss(z_seq, k=cfg.knn, mask=mask)
    if variant == "mse":
        # naive consistency: pull adjacent frames together with plain MSE
        parts["mse"] = (z_seq[..., 1:, :] - z_seq[..., :-1, :]).square() \
            .mean()
    if variant == "kl":
        # KL of the batch feature distribution to N(0, I) (moment-matched)
        mu = z_flat.mean(0)
        var = z_flat.var(0, unbiased=False) + 1e-6
        parts["kl"] = 0.5 * (mu ** 2 + var - torch.log(var) - 1.0).mean()
    return parts


def _total(parts, cfg):
    loss = parts["task"]
    if "sw" in parts:
        loss = loss + cfg.lam_sw * parts["sw"]
    if "lap" in parts:
        loss = loss + cfg.lam_lap * parts["lap"]
    for extra in ("mse", "kl"):
        if extra in parts:
            loss = loss + parts[extra]
    return loss
