#!/usr/bin/env python3
"""What ``mma.sync`` m16n8k8 TF32 delivers on this card, alone.

    python3 tools/mma_tf32_peak.py      # from the repository root, one CUDA card

The flash backward kernels (``csrc/flash_attention.cu``) issue every
product as three ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``
(3xTF32).  This script builds a kernel that does nothing else, into
``build/mma_peak/``: each warp runs 8 independent accumulators through
``ITERS`` rounds, at 4, 8, 16 and 32 warps an SM, and one warp a block
runs a single dependent chain.  It prints the TF32 rate (2 x 16 x 8 x 8
operations an instruction) beside the data sheet's 495 TFLOP/s dense
TF32, the float32-accurate rate that 3xTF32 leaves (a third), and the
time of one dependent ``mma.sync`` (its latency).  Prints the card's name
and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

ITERS = 8192
SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>

#define MMA(d, a, b)                                                       \
  asm volatile(                                                            \
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "                \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))

template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  const float x = 1e-3f * threadIdx.x;
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(x + i) & 0xffffe000u;
  b[0] = __float_as_uint(2.0f * x) & 0xffffe000u;
  b[1] = __float_as_uint(3.0f * x) & 0xffffe000u;
  float d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) MMA(d[j], a, b);
  }
  float s = 0.0f;
  for (int j = 0; j < CHAINS; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_peak(float* out, int blocks, int threads, int chains,
                        int iters, cudaStream_t stream) {
  if (chains == 8) {
    mma_loop<8><<<blocks, threads, 0, stream>>>(out, iters);
  } else {
    mma_loop<1><<<blocks, threads, 0, stream>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def library():
    out_dir = os.path.join(ROOT, "build", "mma_peak")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, f"mma_peak.{e}") for e in ("cu", "so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    so.mma_peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    so.mma_peak.restype = ctypes.c_int
    return so


def run_ms(so, blocks, threads, chains, iters):
    """Device ms of one launch, the second of two."""
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(2):
        start.record()
        err = so.mma_peak(out.data_ptr(), blocks, threads, chains, iters,
                          stream)
        end.record()
        if err:
            raise RuntimeError(f"mma_peak launch failed: error {err}")
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main():
    if not torch.cuda.is_available():
        sys.exit("mma_tf32_peak.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    so = library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for warps in (4, 8, 16, 32):
        blocks, threads = sms * warps // 4, 128
        ms = run_ms(so, blocks, threads, 8, ITERS)
        ops = blocks * threads // 32 * ITERS * 8 * 2 * 16 * 8 * 8
        tf = ops / ms / 1e9
        print(f"{warps} warps an SM, 8 independent accumulators a warp: "
              f"{tf:.1f} TFLOP/s TF32 ({tf / 495:.3f} of 495), "
              f"{tf / 3:.1f} TFLOP/s in 3xTF32")
    ms = run_ms(so, sms, 32, 1, ITERS)
    print(f"one dependent chain a warp: {ms * 1e6 / ITERS:.2f} ns an mma.sync")


if __name__ == "__main__":
    main()
