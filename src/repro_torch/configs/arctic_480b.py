"""arctic-480b — 128-expert top-2 MoE with a parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelCfg, MoECfg, register

CFG = register(ModelCfg(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,             # dense residual branch
    vocab=32000,
    moe=MoECfg(
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
        aux_coef=0.01,
    ),
    source="hf:Snowflake/snowflake-arctic-base",
))
