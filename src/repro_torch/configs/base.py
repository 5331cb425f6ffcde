"""Config dataclasses and the architecture registry.

Port of ``repro.configs.base`` without JAX: ``ModelCfg.xdtype`` and
``pdtype`` are torch dtypes and ``layer_windows()`` is a list of ints.
``ShapeCfg`` and ``SHAPES`` are the launchers' named shapes; ``cells``
lists the dry run's (arch, shape) cells and ``input_specs`` gives a
cell's data inputs as ``meta`` tensors (shapes and dtypes, no data), as
``launch/dryrun.py`` traces them.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

import torch

GLOBAL_WINDOW = 1 << 30     # the window of a 'global' layer (unwindowed)


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    gated: bool = True
    act: str = "silu"
    n_shared_experts: int = 0      # always-on shared expert(s) (DeepSeek/kimi)
    dense_residual: bool = False   # parallel dense FFN residual (arctic)
    first_k_dense: int = 0         # leading dense layers (kimi)
    aux_coef: float = 0.01
    cap_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    n_heads: int
    head_dim: int
    d_state: int
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                    # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    rope_theta: float = 1e4
    window: Optional[int] = None           # sliding-window size
    attn_pattern: tuple = ("global",)      # cycled over layers
    attn_chunk: int = 2048                 # online-softmax KV chunk
    loss_chunk: int = 2048                 # CE computed in seq chunks
    tie_embeddings: bool = False
    embed_scale: bool = False              # gemma: x *= sqrt(d_model)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid_period: int = 0                 # shared attn block every k mamba
    remat: bool = True
    dtype: str = "float32"
    param_dtype: str = "float32"
    # provenance
    source: str = ""

    @property
    def xdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_windows(self) -> list:
        """Per-layer attention window sizes; 'global' layers get the
        sentinel ``GLOBAL_WINDOW`` (== unwindowed)."""
        return [self.window
                if self.attn_pattern[i % len(self.attn_pattern)] == "sliding"
                else GLOBAL_WINDOW for i in range(self.n_layers)]


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# archs for which long_500k runs (sub-quadratic / O(1)-state decode).
LONG_CONTEXT_OK = {"mamba2-780m", "zamba2-1.2b"}

_REGISTRY: dict = {}


def register(cfg: ModelCfg) -> ModelCfg:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelCfg:
    if name not in _REGISTRY:
        importlib.import_module("repro_torch.configs.all")
    return _REGISTRY[name]


def list_configs() -> list:
    importlib.import_module("repro_torch.configs.all")
    return sorted(_REGISTRY)


def cells(include_long=True) -> list:
    """All (arch, shape) dry-run cells: every LM config (not the audio
    encoder) at every shape, ``long_500k`` only for ``LONG_CONTEXT_OK``
    (and not at all without ``include_long``)."""
    out = []
    for name in list_configs():
        if _REGISTRY[name].family in ("audio_enc",):
            continue
        for sname in SHAPES:
            if sname == "long_500k" and (not include_long
                                         or name not in LONG_CONTEXT_OK):
                continue
            out.append((name, sname))
    return out


def input_specs(cfg: ModelCfg, shape: ShapeCfg, *, dtype=None) -> dict:
    """A step's data inputs as ``meta`` tensors, the reference's keys,
    shapes and dtypes: ``tokens`` and ``labels`` (B, S) int32 for a train
    step (a ``vlm``'s ``embeds`` (B, S, d) in ``dtype``, default
    ``cfg.dtype``, in place of tokens), ``tokens`` or ``embeds`` for a
    prefill, ``tokens`` (B,) for a decode step."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else \
        (dtype or cfg.xdtype)
    B, S = shape.global_batch, shape.seq_len

    def spec(shape_, dtype_):
        return torch.empty(shape_, dtype=dtype_, device="meta")
    i32 = torch.int32
    if shape.kind == "train":
        if cfg.family == "vlm":
            return {"embeds": spec((B, S, cfg.d_model), dt),
                    "labels": spec((B, S), i32)}
        return {"tokens": spec((B, S), i32), "labels": spec((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.family == "vlm":
            return {"embeds": spec((B, S, cfg.d_model), dt)}
        return {"tokens": spec((B, S), i32)}
    if shape.kind == "decode":
        return {"tokens": spec((B,), i32)}
    raise ValueError(shape.kind)


def smoke_config(cfg: ModelCfg) -> ModelCfg:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers,
                     2 if cfg.hybrid_period == 0 else cfg.hybrid_period + 1),
        d_model=64, d_ff=128, vocab=256,
        attn_chunk=32, loss_chunk=64,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(4, cfg.n_kv_heads)),
                  head_dim=16)
        if cfg.n_kv_heads == cfg.n_heads:
            kw["n_kv_heads"] = 4
    if cfg.window:
        kw["window"] = 16
    if cfg.moe:
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=min(2, cfg.moe.top_k),
                            d_ff_expert=32)
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, n_heads=4, head_dim=8, d_state=8,
                            chunk=16)
    if cfg.hybrid_period:
        kw["hybrid_period"] = 2
        kw["n_layers"] = 5
    return replace(cfg, **kw)
