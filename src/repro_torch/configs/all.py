"""Import every ported arch config so registration side-effects run: the
two dense tiers of the cascade server (the other families wait, ROADMAP
§1) and the paper's audio encoder's registry marker."""
from repro_torch.configs import (qwen1p5_0p5b, qwen3_1p7b,  # noqa: F401
                                 streamsplit_audio)
