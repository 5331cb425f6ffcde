"""musicgen-large — decoder-only over EnCodec tokens (frontend stub provides
conditioning embeddings). [arXiv:2306.05284; hf]

Adaptation note: MusicGen uses learned absolute positions; we use RoPE for
stack uniformity.
"""
from repro_torch.configs.base import ModelCfg, register

CFG = register(ModelCfg(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    source="arXiv:2306.05284",
))
