"""Import every arch config so registration side-effects run: the ten LM
configurations of the reference and the paper's audio encoder's registry
marker."""
from repro_torch.configs import (arctic_480b, gemma2_2b,  # noqa: F401
                                 kimi_k2_1t, llava_next_34b, mamba2_780m,
                                 musicgen_large, nemotron_4_15b,
                                 qwen1p5_0p5b, qwen3_1p7b, streamsplit_audio,
                                 zamba2_1p2b)
