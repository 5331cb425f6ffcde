"""zamba2-1.2b — hybrid: Mamba2 backbone with a shared attention+MLP block
applied every 6 layers. [arXiv:2411.15242; hf]

Adaptation note: real Zamba2 adds per-use LoRA deltas on the shared block;
we share the block verbatim.
"""
from repro_torch.configs.base import ModelCfg, SSMCfg, register

CFG = register(ModelCfg(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,           # mamba layers; shared attn block every 6
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,             # shared block MLP
    vocab=32000,
    ssm=SSMCfg(
        n_heads=64,        # d_inner = 2*d_model = 4096, head_dim 64
        head_dim=64,
        d_state=64,
        chunk=128,
    ),
    hybrid_period=6,
    source="arXiv:2411.15242",
))
