"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled with
``nvcc`` into its own shared library, loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds.  Libraries go to
``build/repro_torch/`` at the repository root (git-ignored), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads from disk.  Nothing is built at import time: the
first launch of a kernel builds it, and ``chip_smoke.py`` calls
``build_all`` once up front so the build time is measured apart.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -fmad=false: no FMA contraction, the wire kernel's bitwise contract
# depends on it.  No --use_fast_math anywhere.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_S = ctypes.c_char_p
# C signature of every entry point, by source file
SIGNATURES = {
    "wire_roundtrip.cu": {
        **{f"wire_roundtrip_{t}": ([_P, _P, _I, _I, _P], _I)
           for t in ("f32", "bf16", "f16")},
        **{f"wire_roundtrip_grouped_{t}": ([_P, _P], _I)
           for t in ("f32", "bf16", "f16")},
        "wire_roundtrip_error_string": ([_I], _S),
    },
    "int8_quant.cu": {
        **{f"int8_quantize_{t}": ([_P, _P, _P, _P, _L, _P], _I)
           for t in ("f32", "bf16")},
        **{f"int8_quantize_roundtrip_{t}": ([_P, _P, _P, _P, _P, _L, _P], _I)
           for t in ("f32", "bf16")},
        **{f"int8_dequantize_{t}": ([_P, _P, _P, _P, _L, _P], _I)
           for t in ("f32", "bf16", "f16")},
        "int8_quant_error_string": ([_I], _S),
    },
    "swd.cu": {
        "swd_sessions_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "swd_rank_fwd_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                             _I),
        "swd_error_string": ([_I], _S),
    },
    "laplacian_energy.cu": {
        "laplacian_energy_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "laplacian_energy_error_string": ([_I], _S),
    },
    "hybrid_reg_bwd.cu": {
        "hybrid_reg_bwd_f32": ([_P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _P], _I),
        "hybrid_reg_bwd_error_string": ([_I], _S),
    },
    "gmm_posterior.cu": {
        **{f"gmm_posterior_{t}": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _F, _P], _I) for t in ("f32", "bf16")},
        "gmm_posterior_scratch_floats": ([_I, _I, _I], _L),
        "gmm_posterior_error_string": ([_I], _S),
    },
    "infonce_vneg.cu": {
        **{f"infonce_vneg_fwd_{t}": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _F, _P], _I) for t in ("f32", "bf16")},
        **{f"infonce_vneg_bwd_{t}": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _F, _P], _I)
           for t in ("f32", "bf16")},
        "infonce_vneg_error_string": ([_I], _S),
    },
    "flash_attention.cu": {
        "flash_attention_fwd_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _F, _I, _P], _I),
        "flash_attention_bwd_dq_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, _I, _F, _I, _P], _I),
        "flash_attention_bwd_dkv_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _I, _I, _F, _I, _P],
                                        _I),
        "flash_attention_fwd_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _F, _I, _P], _I),
        "flash_attention_bwd_dq_bf16": ([_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _I, _F, _I, _P], _I),
        "flash_attention_bwd_dkv_bf16": ([_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _I, _I, _I, _F, _I, _P],
                                         _I),
        "flash_attention_bwd_bf16_attributes": ([_I, _P], _I),
        "flash_attention_error_string": ([_I], _S),
    },
}
SOURCES = tuple(SIGNATURES)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin): the CUDA kernels cannot be "
                           "built on this machine")
    return path


def library_path(source: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built;
    -> the library's path.  The compiler writes to a temporary name and
    the result is renamed into place, so a concurrent or interrupted
    build never leaves a half-written library behind."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp,
                            str(CSRC / source)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(rc={r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> list[Path]:
    """Build every kernel source, one ``nvcc`` per source, all at once."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return list(pool.map(build, SOURCES))


# the launchers' suffix of each input type a kernel may take
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def input_dtype(name: str, x, allowed) -> torch.dtype:
    """``x``'s type, which must be one of ``allowed`` (float64, integer and
    any other type raise ``TypeError``)."""
    if x.dtype not in allowed:
        raise TypeError(f"{name} takes "
                        f"{', '.join(str(t) for t in allowed)}, got "
                        f"{x.dtype}")
    return x.dtype


def check_inputs(name: str, *tensors, dtype=torch.float32) -> None:
    """The checks a kernel wrapper makes on its inputs: ``dtype``
    (float32 unless given; a sequence gives each tensor's), contiguous,
    on one CPU or CUDA device, and not requiring a gradient (a wrapper
    launches one kernel; the differentiable entries call it with detached
    tensors).  The refine and training wrappers make them before they pick
    a path; the per-tensor INT8 wrappers on their CUDA path only (they
    check the type on both, with ``input_dtype``), as their plain versions
    take any layout; the wire's makes its own."""
    dev = tensors[0].device
    dtypes = (dtype if isinstance(dtype, (tuple, list))
              else (dtype,) * len(tensors))
    for x, dt in zip(tensors, dtypes, strict=True):
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: no kernel for device {x.device}")
        if x.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {x.device}")
        if x.dtype != dt:
            raise TypeError(f"{name} takes {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if x.requires_grad:
            raise ValueError(f"{name} has no backward: pass tensors that "
                             "do not require a gradient")


def raise_on_error(lib, prefix: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{prefix} launch failed: {msg}")


def stream_of(x) -> int:
    """PyTorch's current stream on ``x``'s device, as the launchers take
    it."""
    return torch.cuda.current_stream(x.device).cuda_stream


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` with every entry point's
    ``argtypes``/``restype`` declared (pointers and the stream as
    ``c_void_p``, so none is cut to 32 bits)."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, (argtypes, restype) in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[source] = lib
    return lib
