"""Mamba-2 (SSD, state-space duality) blocks.

Port of ``repro.models.ssm``: the chunked SSD for training and prefill
(block-diagonal intra-chunk "attention" plus a low-rank inter-chunk
recurrence, arXiv:2405.21060) and the O(1) recurrent step for decode.

The reference's three- and four-operand einsums are written here as
two-operand products in a fixed order, so the card and the CPU evaluate
the same contractions and every intermediate has a known size: the
intra-chunk scores C·B (batch, chunk, heads, Q, Q), masked by the decay,
then their product with x·dt.  The inter-chunk ``jax.lax.scan`` is a
Python loop over the chunks.  ``_segsum`` keeps the reference's -inf above
the diagonal, which ``exp`` turns into exact zeros.

``mamba_decode`` writes the new SSM and conv states into the state it is
given, in place.

On a mesh (``mamba_forward_sharded``, ``mamba_decode_sharded``), the
reference's axes split the heads over 'model': ``wz``, ``wx`` and ``wdt``
are column-parallel over ``ssm_heads``, ``conv_x``, ``dt_bias``, ``A_log``,
``D`` and ``norm_scale`` are blocks of heads, ``wB`` and ``wC``
(``ssm_group``, one group) are whole on every shard and ``wo`` is
row-parallel.  The gated RMSNorm normalises each head over its P channels
and the SSD scan runs per head, so a shard runs the one-device block on
its heads and only ``wo``'s partial products cross shards (psum'd over
'model').  The states are blocks of heads too.  A batch-1 prompt whose
positions split over 'data' runs each block on its own shard and passes
the state between blocks (``_split_forward``).
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import apply_dense, dense_init, device_of


def _draw(generator, shape, fill):
    """A float32 tensor of ``shape`` on the generator's device, filled by
    ``fill(tensor)`` (left empty on the ``meta`` device)."""
    t = torch.empty(shape, dtype=torch.float32, device=device_of(generator))
    if generator is not None:
        fill(t)
    return t


def init_mamba(generator, ssm_cfg, d_model, *, dtype=torch.float32,
               with_axes=False):
    """Same shapes and scales as the reference's ``init_mamba``; the draws
    differ (``generator=None``: shapes only, on the ``meta`` device)."""
    H, P, N, G = (ssm_cfg.n_heads, ssm_cfg.head_dim, ssm_cfg.d_state,
                  ssm_cfg.n_groups)
    W = ssm_cfg.conv_width
    dev = device_of(generator)
    params, axes = {}, {}
    for name, shape, ax in (
            ("wz", (d_model, H, P), ("embed", "ssm_heads", "head_dim")),
            ("wx", (d_model, H, P), ("embed", "ssm_heads", "head_dim")),
            ("wB", (d_model, G, N), ("embed", "ssm_group", "ssm_state")),
            ("wC", (d_model, G, N), ("embed", "ssm_group", "ssm_state")),
            ("wdt", (d_model, H), ("embed", "ssm_heads"))):
        params[name], axes[name] = dense_init(generator, shape, ax,
                                              dtype=dtype)
    # depthwise causal conv over the x-path channels (H*P)
    params["conv_x"] = (0.1 * _draw(generator, (W, H, P), lambda t: t.normal_(
        generator=generator))).to(dtype)
    axes["conv_x"] = ("conv", "ssm_heads", "head_dim")
    dt0 = torch.exp(_draw(generator, (H,), lambda t: t.uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator)))
    params["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))  # inv softplus
    axes["dt_bias"] = ("ssm_heads",)
    params["A_log"] = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                             device=dev))
    axes["A_log"] = ("ssm_heads",)
    params["D"] = torch.ones(H, dtype=torch.float32, device=dev)
    axes["D"] = ("ssm_heads",)
    params["norm_scale"] = torch.zeros((H, P), dtype=dtype, device=dev)
    axes["norm_scale"] = ("ssm_heads", "head_dim")
    params["wo"], axes["wo"] = dense_init(
        generator, (H, P, d_model), ("ssm_heads", "head_dim", "embed"),
        dtype=dtype, scale=1.0 / math.sqrt(H * P))
    return (params, axes) if with_axes else params


def _causal_depthwise_conv(x, w):
    """x: (B, S, H, P), w: (W, H, P) — causal depthwise conv along S."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, 0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return out


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) lower-triangular segment sums
    L[i, j] = sum_{j < t <= i} x[t]  (-inf at j > i)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -math.inf)


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    """y, z: (..., H, P).  y <- RMSNorm(y * silu(z)) per (H, P) channel."""
    h = y * F.silu(z.float())
    var = h.square().mean(-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return h * (1.0 + scale.float())


class SSMState(NamedTuple):
    ssm: torch.Tensor    # (B, H, P, N)
    conv: torch.Tensor   # (B, W-1, H, P): the last W-1 pre-conv x inputs


def init_ssm_state(ssm_cfg, batch, dtype=torch.float32, device=None):
    H, P, N, W = (ssm_cfg.n_heads, ssm_cfg.head_dim, ssm_cfg.d_state,
                  ssm_cfg.conv_width)
    return SSMState(
        ssm=torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        conv=torch.zeros((batch, W - 1, H, P), dtype=dtype, device=device))


def _project(p, ssm_cfg, u):
    z = apply_dense(p["wz"], u)                       # (B,S,H,P)
    x = apply_dense(p["wx"], u)                       # (B,S,H,P)
    Bv = apply_dense(p["wB"], u).float()              # (B,S,G,N)
    Cv = apply_dense(p["wC"], u).float()              # (B,S,G,N)
    dt = apply_dense(p["wdt"], u).float()             # (B,S,H)
    dt = F.softplus(dt + p["dt_bias"])
    return z, x, Bv, Cv, dt


def _ssd(ssm_cfg, x, dt, Bv, Cv, A):
    """The chunked SSD of x (B, S, H, P) from a zero state -> (y (B, S, H,
    P) float32, before the skip term; the state after the last position
    (B, H, P, N) float32)."""
    H, P, G = ssm_cfg.n_heads, ssm_cfg.head_dim, ssm_cfg.n_groups
    Q = ssm_cfg.chunk
    B_, S = x.shape[:2]
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):                                    # (B, nc, Q, ...)
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
        return t.reshape((B_, nc, Q) + t.shape[2:])

    xc = chunks(x).float()                            # (B,nc,Q,H,P)
    dtc = chunks(dt)                                  # (B,nc,Q,H)
    Bh = chunks(Bv).repeat_interleave(H // G, dim=3)  # (B,nc,Q,H,N)
    Ch = chunks(Cv).repeat_interleave(H // G, dim=3)

    dA = dtc * A                                      # (B,nc,Q,H)
    dA_cs = torch.cumsum(dA, dim=2)
    # intra-chunk (block-diagonal) term: (C B^T) masked by the decay, @ x dt
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))    # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]                         # (B,nc,Q,H,P)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh) * L
    Ydiag = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)
    # chunk-final states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (B,nc,Q,H)
    states = torch.einsum("bckhn,bckhp->bchpn", Bh * decay_states[..., None],
                          xdt)                        # (B,nc,H,P,N)
    # inter-chunk recurrence
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])       # (B,nc,H)
    s = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                # (B,nc,H,P,N)
    Yoff = torch.einsum("bcqhn,bchpn->bcqhp", Ch, prev_states) \
        * torch.exp(dA_cs)[..., None]

    return (Ydiag + Yoff).reshape(B_, nc * Q, H, P)[:, :S], s


def _finish(p, y, x, z, dtype):
    """The SSD's y (float32) -> the block's output: the skip term, the
    gated RMSNorm, ``wo``."""
    y = y + x.float() * p["D"][:, None]
    y = _gated_rmsnorm(y, z, p["norm_scale"]).to(dtype)
    return apply_dense(p["wo"], y, contract=2)


def _last_inputs(x_raw, W):
    """The last W-1 pre-conv inputs of x_raw (B, S, H, P), zero-padded on
    the left when S < W-1: the decode state's ``conv``."""
    S = x_raw.shape[1]
    return (x_raw[:, -(W - 1):] if S >= W - 1
            else F.pad(x_raw, (0, 0, 0, 0, W - 1 - S, 0)))


def mamba_forward(p, ssm_cfg, u, *, return_state=False):
    """u: (B, S, d_model) -> (B, S, d_model) via chunked SSD; with
    ``return_state``, also the ``SSMState`` after the last token (the
    final inter-chunk state and the last W-1 pre-conv inputs, zero-padded
    on the left when S < W-1)."""
    z, x_raw, Bv, Cv, dt = _project(p, ssm_cfg, u)
    x = F.silu(_causal_depthwise_conv(x_raw, p["conv_x"]).float()).to(
        u.dtype)
    A = -torch.exp(p["A_log"])                        # (H,)
    y, s = _ssd(ssm_cfg, x, dt, Bv, Cv, A)
    out = _finish(p, y, x, z, u.dtype)
    if not return_state:
        return out
    conv = _last_inputs(x_raw, ssm_cfg.conv_width)
    return out, SSMState(ssm=s.to(u.dtype), conv=conv.to(u.dtype))


def mamba_decode(p, ssm_cfg, u, state: SSMState):
    """Single-step recurrence.  u: (B, 1, d_model) -> (out (B, 1, d_model),
    state), the new SSM and conv states written into ``state`` in
    place."""
    H, G = ssm_cfg.n_heads, ssm_cfg.n_groups
    z, x_raw, Bv, Cv, dt = _project(p, ssm_cfg, u)
    # conv with buffered history
    hist = torch.cat([state.conv, x_raw.to(state.conv.dtype)], dim=1)
    x = F.silu((hist.float() * p["conv_x"].float()).sum(1))   # (B,H,P)
    state.conv.copy_(hist[:, 1:])

    A = -torch.exp(p["A_log"])                        # (H,)
    dt1 = dt[:, 0]                                    # (B,H)
    dA = torch.exp(dt1 * A)
    Bh = Bv[:, 0].repeat_interleave(H // G, dim=1)    # (B,H,N)
    Chh = Cv[:, 0].repeat_interleave(H // G, dim=1)
    xdt = x * dt1[..., None]                          # (B,H,P)
    # s <- s * dA + xdt (x) B, in the state's storage: no (B,H,P,N)
    # temporary
    s = state.ssm.mul_(dA[..., None, None]).addcmul_(
        xdt[..., None], Bh[:, :, None, :])
    y = torch.matmul(s.float(), Chh[..., None])[..., 0]   # (B,H,P)
    y = y + x * p["D"][:, None]
    y = _gated_rmsnorm(y[:, None], z, p["norm_scale"]).to(u.dtype)
    return apply_dense(p["wo"], y, contract=2), state


def _local(ssm_cfg, ps):
    """``ssm_cfg`` with the heads of a shard's block (``A_log``'s)."""
    H = ps[0]["A_log"].shape[0]
    if H != ssm_cfg.n_heads and ssm_cfg.n_groups != 1:
        raise NotImplementedError(f"{ssm_cfg.n_groups} B/C groups over "
                                  "split heads")
    return replace(ssm_cfg, n_heads=H)


def _split_forward(lay, ps, ssm_cfg, us, starts):
    """``mamba_forward`` (with its state) of a sequence whose positions
    split over 'data': ``us[s]`` shard s's block, from ``starts[s]`` on
    -> (each shard's output, before ``wo``'s psum; its ``SSMState``).

    The inter-chunk recurrence is sequential, so the blocks pass states:
    - the conv's halo: every shard's last W-1 pre-conv inputs (its whole
      block where shorter) are gathered over 'data', and a shard's halo is
      the last W-1 of the blocks before it (zeros before position 0), so
      its conv sums what one device's does;
    - each shard runs the chunked SSD of its block from a zero state ->
      its outputs, its final state ``s_loc`` and its block's decay
      ``exp(sum dA)``;
    - ``(s_loc, decay)`` are gathered over 'data' and every shard folds
      them in block order, ``s <- s * decay + s_loc`` (the same order on
      every shard, so the same bits): the state entering each block
      ``s_in``, and the whole sequence's final state;
    - each shard adds ``C_t . s_in * exp(cumsum dA from its block's start
      to t)`` to its outputs.
    The decode state (the fold's final state and the last W-1 inputs of
    the gathered tails) is the same on every data shard, as
    ``decode_state_sharding`` replicates it over 'data' at batch 1."""
    local = _local(ssm_cfg, ps)
    H, G, W = local.n_heads, local.n_groups, local.conv_width
    S_l = us[0].shape[1]
    T = min(W - 1, S_l)
    parts = [(p,) + _project(p, local, u) for p, u in zip(ps, us)]
    tails = lay.all_gather_seq([x_raw[:, S_l - T:]
                                for _, _, x_raw, _, _, _ in parts], 1)
    runs, states, decays = [], [], []
    for (p, z, x_raw, Bv, Cv, dt), tail, first in zip(parts, tails, starts):
        zeros = x_raw.new_zeros((x_raw.shape[0], W - 1) + x_raw.shape[2:])
        before = torch.cat([zeros, tail[:, :first // S_l * T]], 1)
        halo = before[:, before.shape[1] - (W - 1):]
        conv = _causal_depthwise_conv(torch.cat([halo, x_raw], 1),
                                      p["conv_x"])[:, W - 1:]
        x = F.silu(conv.float()).to(x_raw.dtype)
        A = -torch.exp(p["A_log"])
        y, s_loc = _ssd(local, x, dt, Bv, Cv, A)
        cum = torch.cumsum(dt * A, dim=1)             # (B, S_l, H)
        runs.append((p, z, x, y, Cv, cum))
        states.append(s_loc[None])
        decays.append(torch.exp(cum[:, -1])[None])
    states = lay.all_gather_seq(states, 0)            # (D, B, H, P, N)
    decays = lay.all_gather_seq(decays, 0)            # (D, B, H)
    outs, finals = [], []
    for (p, z, x, y, Cv, cum), st, dec, tail, first in zip(
            runs, states, decays, tails, starts):
        s, s_in = torch.zeros_like(st[0]), None
        for j in range(st.shape[0]):
            if j == first // S_l:
                s_in = s
            s = s * dec[j][..., None, None] + st[j]
        if first:
            Ch = Cv.repeat_interleave(H // G, dim=2)  # (B, S_l, H, N)
            y = y + torch.einsum("bshn,bhpn->bshp", Ch, s_in) \
                * torch.exp(cum)[..., None]
        outs.append(_finish(p, y, x, z, us[0].dtype))
        conv = _last_inputs(tail, W)
        finals.append(SSMState(ssm=s.to(us[0].dtype),
                               conv=conv.to(us[0].dtype)))
    return outs, finals


def mamba_forward_sharded(lay, ps, ssm_cfg, us, *, return_state=False,
                          starts=None):
    """``mamba_forward`` on a mesh: ``ps[s]`` shard s's blocks (heads over
    'model'), ``us[s]`` its rows, whole over 'model' -> each shard's
    output, whole over 'model' (with ``return_state``, also each shard's
    ``SSMState`` of its heads).  With ``starts``
    (``ShardLayout.seq_starts``), ``us[s]`` is shard s's block of the
    positions, from ``starts[s]`` on, and the blocks pass states over
    'data' (``_split_forward``)."""
    if starts is not None:
        outs, states = _split_forward(lay, ps, ssm_cfg, us, starts)
        outs = lay.psum_model(outs)
        return (outs, states) if return_state else outs
    local = _local(ssm_cfg, ps)
    outs = [mamba_forward(p, local, u, return_state=return_state)
            for p, u in zip(ps, us)]
    if not return_state:
        return lay.psum_model(outs)
    return lay.psum_model([o for o, _ in outs]), [st for _, st in outs]


def mamba_decode_sharded(lay, ps, ssm_cfg, us, states):
    """``mamba_decode`` on a mesh: ``states[s]`` shard s's ``SSMState``
    block (its heads), updated in place -> each shard's output, whole
    over 'model'."""
    local = _local(ssm_cfg, ps)
    return lay.psum_model([mamba_decode(p, local, u, st)[0]
                           for p, u, st in zip(ps, us, states)])
