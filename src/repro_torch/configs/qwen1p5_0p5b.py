"""qwen1.5-0.5b — dense MHA (kv=16), QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelCfg, register

CFG = register(ModelCfg(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B",
))
