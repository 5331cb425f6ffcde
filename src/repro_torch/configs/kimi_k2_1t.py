"""kimi-k2-1t-a32b — trillion-param MoE: 384 experts top-8, 1 shared expert,
first layer dense. [arXiv:2501.kimi2; unverified]

Note: assigned spec prescribes GQA kv=8 with 64 heads at d_model 7168
(head_dim 112); we follow the spec (real K2 uses MLA — out of scope here).
"""
from repro_torch.configs.base import ModelCfg, MoECfg, register

CFG = register(ModelCfg(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=18432,            # the leading dense layer's FFN
    vocab=163840,
    moe=MoECfg(
        n_experts=384,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        first_k_dense=1,
        aux_coef=0.001,
    ),
    rope_theta=5e4,
    source="arXiv:2501.kimi2",
))
