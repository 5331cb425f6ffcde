// Fused per-row INT8 wire round trip for Hopper (sm_90a).
//
// Replaces the TPU kernel `wire_roundtrip_pallas` / `_wire_roundtrip_kernel`
// in src/repro/kernels/int8_quant.py.  For each row of a (rows, n) float32
// matrix it computes the row min and max, then
//   scale = max((hi - lo) * float32(1/255), 1e-12)
//   zero  = -128 - lo / scale
//   q     = clip(round_half_even(x / scale + zero), -128, 127)
//   out   = (q - zero) * scale
// and writes float32: the int8 level never goes to device memory.
//
// Bitwise contract: equal to the plain PyTorch version
// (`wire_roundtrip_ref` in int8_quant.py), which equals the reference's
// jitted per-sample quantize∘dequantize.  XLA folds the reference's
// "(hi - lo) / 255" into a multiply by float32(1/255) = 0x3B808081, so the
// scale is a correctly rounded multiply by that constant; the two
// divisions by `scale` are IEEE (__fdiv_rn); __float2int_rn rounds half to
// even.
// Every operation is an explicit _rn intrinsic and the library is built
// with -fmad=false, so no FMA contraction changes (q - zero) * scale.
// Min and max are exact in any order, so the reduction tree is free.  A
// NaN element makes the row's lo, hi, scale and zero NaN, and so the whole
// row NaN, as in the plain version: the min/max fold and the scale floor
// keep NaN, where fminf/fmaxf would drop it.  The level converts to int
// before it is dequantized, NaN to 0, as the reference's int8 cast does.
//
// Bound: the function reads each input once and writes each output once,
// 8 bytes per element, against a handful of float operations: on an H100
// (3.35 TB/s) it is memory-bound at 8*rows*n bytes / 3.35e12 s.  On the
// serving path rows <= 256 and n <= 12800, at most 26 MB, so the bound is
// a few microseconds and launch latency dominates in practice.
//
// Design (simple and right first): one 256-thread block per row, 16-byte
// float4 loads where the row allows them, a warp-shuffle then
// shared-memory min/max reduction, thread 0 computes scale and zero into
// shared memory, and a second pass over the row (<= 51 KB, still in L2)
// quantises and writes.  The TPU kernel's lane padding (each row padded to
// a multiple of 128 with its first element) and its 8-row tiles are TPU
// artefacts and are dropped: every block masks its own ragged tail.
// Holding the row in shared memory, so it is read from HBM once, or fusing
// the stage into the edge stage's epilogue is later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInv255 = 0x1.010102p-8f;  // float32(1/255), 0x3B808081

// min and max that keep a NaN operand (fminf/fmaxf drop it), and are
// fminf/fmaxf otherwise: one PTX instruction each (sm_80+), as cheap as
// fminf, where a select on `a != a` costs a quarter of the kernel's time
// at the per-frame sizes (tools/int8_fold_compare.py)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The level goes through int as the int8 payload would: round half to even
// (__float2int_rn, as rintf), then clamp.  The conversion gives 0 for NaN
// (PTX cvt), as XLA's float-to-int8 does, so the +inf element of a row whose
// scale is +inf comes back +inf, as in the reference.
__device__ __forceinline__ float roundtrip(float v, float scale, float zero) {
  int q = __float2int_rn(__fadd_rn(__fdiv_rn(v, scale), zero));
  q = min(max(q, -128), 127);
  return __fmul_rn(__fsub_rn(static_cast<float>(q), zero), scale);
}

__global__ void __launch_bounds__(kThreads)
wire_roundtrip_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int n) {
  const size_t row = blockIdx.x;
  const float* xr = x + row * static_cast<size_t>(n);
  float* outr = out + row * static_cast<size_t>(n);
  const int tid = threadIdx.x;
  const bool vec = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(xr) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(outr) % 16 == 0);

  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = tid; i < n / 4; i += kThreads) {
      float4 v = x4[i];
      lo = min_nan(lo, min_nan(min_nan(v.x, v.y), min_nan(v.z, v.w)));
      hi = max_nan(hi, max_nan(max_nan(v.x, v.y), max_nan(v.z, v.w)));
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      lo = min_nan(lo, xr[i]);
      hi = max_nan(hi, xr[i]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  __shared__ float s_scale, s_zero;
  if (tid % 32 == 0) {
    s_lo[tid / 32] = lo;
    s_hi[tid / 32] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    lo = s_lo[0];
    hi = s_hi[0];
    for (int w = 1; w < kWarps; ++w) {
      lo = min_nan(lo, s_lo[w]);
      hi = max_nan(hi, s_hi[w]);
    }
    const float span = __fmul_rn(__fsub_rn(hi, lo), kInv255);
    const float scale = span < 1e-12f ? 1e-12f : span;   // keeps NaN
    s_scale = scale;
    s_zero = __fsub_rn(-128.0f, __fdiv_rn(lo, scale));
  }
  __syncthreads();
  const float scale = s_scale, zero = s_zero;

  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* o4 = reinterpret_cast<float4*>(outr);
    for (int i = tid; i < n / 4; i += kThreads) {
      float4 v = x4[i];
      v.x = roundtrip(v.x, scale, zero);
      v.y = roundtrip(v.y, scale, zero);
      v.z = roundtrip(v.z, scale, zero);
      v.w = roundtrip(v.w, scale, zero);
      o4[i] = v;
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      outr[i] = roundtrip(xr[i], scale, zero);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller checks it, because a refused launch never runs.
int wire_roundtrip_f32(const float* x, float* out, int rows, int n,
                       cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  wire_roundtrip_kernel<<<rows, kThreads, 0, stream>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* wire_roundtrip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
