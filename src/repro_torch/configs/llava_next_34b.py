"""llava-next-34b — VLM backbone (anyres tiling frontend is a stub; inputs
are precomputed patch embeddings). [hf:llava-hf/llava-v1.6; unverified]"""
from repro_torch.configs.base import ModelCfg, register

CFG = register(ModelCfg(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
