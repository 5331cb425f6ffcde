// Per-tensor INT8 quantize and dequantize for Hopper (sm_90a): the wire
// format of the per-frame split path (`SplitEngine.run`).
//
// Replaces the TPU kernels `int8_quantize_pallas` (`_minmax_kernel` then
// `_quant_kernel`) and `int8_dequantize_pallas` (`_dequant_kernel`) in
// src/repro/kernels/int8_quant.py.  Over a flat float32 tensor of n
// elements:
//   lo, hi = min(x), max(x)
//   scale  = max((hi - lo) * float32(1/255), 1e-12)
//   zero   = -128 - lo / scale
//   q      = clip(round_half_even(x / scale + zero), -128, 127)   (int8)
// and the inverse, out = (q - zero) * scale.
//
// Bitwise contract: equal to the plain PyTorch versions
// (`int8_quantize_ref` / `int8_dequantize_ref` in int8_quant.py), which
// equal the reference's jitted per-tensor quantize and dequantize.  The
// numerics are wire_roundtrip.cu's: XLA folds the reference's
// "(hi - lo) / 255" into a multiply by float32(1/255) = 0x3B808081, so
// the scale is a correctly rounded multiply by that constant; the two
// divisions by `scale` are IEEE (__fdiv_rn); rintf rounds half to even;
// every operation is an explicit _rn intrinsic and the library is built
// with -fmad=false.  Min and max are exact in any order, so neither the
// reduction tree nor the number of blocks changes a bit, and no atomics
// are needed.  NaN goes where it goes in the plain versions: a NaN
// element makes lo, hi, scale and zero NaN (the min/max fold, the scale
// floor and the clip keep it, where fminf/fmaxf would drop it), and a NaN
// level is stored as 0, as XLA's and PyTorch's float-to-int8 conversions
// store it; so an input with a NaN dequantizes to NaN everywhere.
//
// Design.  The TPU kernel runs its grid in order on one core and hands
// the per-tile min/max to jnp between two pallas_calls.  Here the blocks
// run in parallel, so the reduction across blocks is a second launch,
// and no host round trip sits between the two:
//   pass 1 (`minmax_partials_kernel`): each block reduces a grid-strided
//     share of x to one (lo, hi) partial;
//   pass 2 (`quantize_kernel`): each block folds all the partials itself
//     (at most kMaxBlocks pairs, read from L2), forms scale and zero, and
//     quantizes its share; block 0 also writes (scale, zero) to device
//     memory, the 8-byte header the wire carries beside the payload.
// `dequantize_kernel` reads scale and zero from device memory, so a
// dequantize needs no host value either.  Loads are 16 bytes a thread
// (float4 in, char4 out, and back) where the pointers allow, with a
// scalar tail; the TPU kernel's padding of x to a multiple of its block
// with x[0] is a TPU artefact and is dropped.
//
// Bound: the function reads each input once and writes each output once:
// quantize reads x and writes q and the header, dequantize reads q and
// the header and writes out, 5 bytes an element (+ 8) either way, against
// a handful of float operations: both are memory-bound on an H100 (3.35
// TB/s).  At the per-frame shapes (3,200-12,800 elements) that bound is
// under 0.02 us and launch latency sets the time; at 2^24 elements it is
// 25 us each.  This quantize moves 9 bytes an element, as pass 2 reads x
// again: from L2 at the per-frame shapes, from HBM at 2^24.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kElemsPerThread = 16;   // grid sizing: 4 float4 a thread
constexpr int kMaxBlocks = 1024;      // quantize partials; 132 SMs x 8
constexpr int kMaxDequantBlocks = 4096;
constexpr float kInv255 = 0x1.010102p-8f;  // float32(1/255), 0x3B808081

__host__ __device__ inline long long blocks_for(long long n, int cap) {
  long long g = (n + kThreads * kElemsPerThread - 1) /
                (static_cast<long long>(kThreads) * kElemsPerThread);
  return g < 1 ? 1 : (g > cap ? cap : g);
}

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

// Block-wide min and max of every thread's (lo, hi); the result is
// returned to every thread.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int tid = threadIdx.x;
  if (tid % 32 == 0) {
    s_lo[tid / 32] = lo;
    s_hi[tid / 32] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int w = 1; w < kWarps; ++w) {
    lo = min_nan(lo, s_lo[w]);
    hi = max_nan(hi, s_hi[w]);
  }
}

// clip to [-128, 127] keeping NaN, then NaN -> 0 as XLA and PyTorch
// convert it
__device__ __forceinline__ int8_t level(float v, float scale, float zero) {
  float q = rintf(__fadd_rn(__fdiv_rn(v, scale), zero));
  q = min_nan(max_nan(q, -128.0f), 127.0f);
  return q != q ? 0 : static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ float unlevel(int8_t q, float scale, float zero) {
  return __fmul_rn(__fsub_rn(static_cast<float>(q), zero), scale);
}

__global__ void __launch_bounds__(kThreads)
minmax_partials_kernel(const float* __restrict__ x, long long n,
                       float* __restrict__ partials) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  long long tail = 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long nq = n / 4;
    for (long long i = start; i < nq; i += stride) {
      const float4 v = x4[i];
      lo = min_nan(lo, min_nan(min_nan(v.x, v.y), min_nan(v.z, v.w)));
      hi = max_nan(hi, max_nan(max_nan(v.x, v.y), max_nan(v.z, v.w)));
    }
    tail = 4 * nq;
  }
  for (long long i = tail + start; i < n; i += stride) {
    lo = min_nan(lo, x[i]);
    hi = max_nan(hi, x[i]);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = lo;
    partials[gridDim.x + blockIdx.x] = hi;
  }
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ partials, int8_t* __restrict__ q,
                float* __restrict__ sz) {
  const int g = gridDim.x;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int i = threadIdx.x; i < g; i += kThreads) {
    lo = min_nan(lo, partials[i]);
    hi = max_nan(hi, partials[g + i]);
  }
  block_minmax(lo, hi);
  const float span = __fmul_rn(__fsub_rn(hi, lo), kInv255);
  const float scale = span < 1e-12f ? 1e-12f : span;   // keeps NaN
  const float zero = __fsub_rn(-128.0f, __fdiv_rn(lo, scale));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sz[0] = scale;
    sz[1] = zero;
  }
  const long long stride = static_cast<long long>(g) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  long long tail = 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(q) % 4 == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    const long long nq = n / 4;
    for (long long i = start; i < nq; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_char4(level(v.x, scale, zero), level(v.y, scale, zero),
                         level(v.z, scale, zero), level(v.w, scale, zero));
    }
    tail = 4 * nq;
  }
  for (long long i = tail + start; i < n; i += stride) {
    q[i] = level(x[i], scale, zero);
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, long long n,
                  const float* __restrict__ scale_p,
                  const float* __restrict__ zero_p, float* __restrict__ out) {
  const float scale = *scale_p, zero = *zero_p;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  long long tail = 0;
  if (reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const char4* q4 = reinterpret_cast<const char4*>(q);
    float4* o4 = reinterpret_cast<float4*>(out);
    const long long nq = n / 4;
    for (long long i = start; i < nq; i += stride) {
      const char4 v = q4[i];
      o4[i] = make_float4(
          unlevel(v.x, scale, zero), unlevel(v.y, scale, zero),
          unlevel(v.z, scale, zero), unlevel(v.w, scale, zero));
    }
    tail = 4 * nq;
  }
  for (long long i = tail + start; i < n; i += stride) {
    out[i] = unlevel(q[i], scale, zero);
  }
}

}  // namespace

extern "C" {

// Two launches on `stream`, no host round trip between them; returns
// cudaGetLastError() (0 on success) after each, because a refused launch
// never runs.  `partials` is scratch of 2 * kMaxBlocks floats; `sz`
// receives (scale, zero).
int int8_quantize_f32(const float* x, int8_t* q, float* partials, float* sz,
                      long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int g = static_cast<int>(blocks_for(n, kMaxBlocks));
  minmax_partials_kernel<<<g, kThreads, 0, stream>>>(x, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<<<g, kThreads, 0, stream>>>(x, n, partials, q, sz);
  return static_cast<int>(cudaGetLastError());
}

int int8_dequantize_f32(const int8_t* q, const float* scale,
                        const float* zero, float* out, long long n,
                        cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int g = static_cast<int>(blocks_for(n, kMaxDequantBlocks));
  dequantize_kernel<<<g, kThreads, 0, stream>>>(q, n, scale, zero, out);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
