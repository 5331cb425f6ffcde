"""PyTorch/CUDA port of the StreamSplit serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``repro_torch.api.gateway`` is the counterpart of
``repro.api.gateway`` and so on) and never imports it or JAX.  Entry
points take ``device=`` and default to ``"cuda"``; the tests pass
``device="cpu"``, where every hand-written kernel runs its plain PyTorch
version instead.
"""
