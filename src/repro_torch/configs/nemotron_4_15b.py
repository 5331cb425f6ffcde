"""nemotron-4-15b — dense, GQA kv=8, squared-ReLU, LayerNorm.
[arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelCfg, register

CFG = register(ModelCfg(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    norm="layernorm",
    act="relu2",
    gated_mlp=False,
    rope_theta=1e4,
    source="arXiv:2402.16819",
))
