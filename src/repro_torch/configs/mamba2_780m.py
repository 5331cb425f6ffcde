"""mamba2-780m — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelCfg, SSMCfg, register

CFG = register(ModelCfg(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    # assigned vocab 50280, padded to a multiple of 128 so the vocab dim
    # shards over the 16-way 'model' axis (standard practice; the original
    # Mamba releases pad to a multiple of 16 for the same reason).
    vocab=50304,
    ssm=SSMCfg(
        n_heads=48,        # d_inner = 2*d_model = 3072, head_dim 64
        head_dim=64,
        d_state=128,
        chunk=128,
    ),
    source="arXiv:2405.21060",
))
