"""qwen3-1.7b — dense, GQA kv=8, qk-norm. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelCfg, register

CFG = register(ModelCfg(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    act="silu",
    gated_mlp=True,
    source="hf:Qwen/Qwen3-8B",
))
