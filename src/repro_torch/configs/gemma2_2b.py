"""gemma2-2b — local+global alternating attention, logit softcaps, GeGLU.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelCfg, register

CFG = register(ModelCfg(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    act="gelu",
    gated_mlp=True,
    attn_pattern=("sliding", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=1.0 / 256.0 ** 0.5,  # query_pre_attn_scalar = head_dim
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2408.00118",
))
