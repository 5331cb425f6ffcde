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
// divisions by `scale` are IEEE (__fdiv_rn); every operation is an
// explicit _rn intrinsic and the library is built with -fmad=false; a
// level is one `cvt.rni.sat.s8.f32`, which rounds half to even, clips to
// [-128, 127] and converts NaN to 0, as the plain version's round, clip
// and float-to-int8 conversion do (tools/int8_variants.py holds the
// three-instruction form beside it).  Min and max are exact in any
// order, so neither the reduction tree nor the number of blocks changes a
// bit, and no atomics are needed.  NaN goes where it goes in the plain
// versions: a NaN element makes lo, hi, scale and zero NaN (the min/max
// fold and the scale floor keep it, where fminf/fmaxf would drop it), and
// a NaN level is stored as 0, as XLA's and PyTorch's float-to-int8
// conversions store it; so an input with a NaN dequantizes to NaN
// everywhere.
//
// Design.  The TPU kernel runs its grid in order on one core and hands
// the per-tile min/max to jnp between two pallas_calls.  Here:
//   one block (`quantize_one_block_kernel`), for n <= kOneBlockMax
//     (16,384: 1,024 threads x 16 floats, which covers every per-frame
//     boundary shape, 3,200-12,800 elements): the whole function in one
//     launch.  Each thread reads its share of x once into registers (up
//     to 4 float4, or 16 floats where x is not 16-byte aligned), the
//     block reduces (lo, hi), and each thread quantizes from its
//     registers and writes q; thread 0 writes the (scale, zero) header.
//     No scratch.  At these sizes launch latency sets the time, so one
//     launch and one read of x is the design's point.
//   two passes, above kOneBlockMax, where the blocks run in parallel and
//     the reduction across them is a second launch, with no host round
//     trip between the two:
//     pass 1 (`minmax_partials_kernel`): each block reduces a grid-strided
//       share of x to one (lo, hi) partial, into scratch;
//     pass 2 (`quantize_kernel`), launched as pass 1's programmatic
//       dependent (scheduled while pass 1 drains, it waits in
//       griddepcontrol.wait for pass 1's writes): each block folds all the
//       partials itself (at most kMaxBlocks pairs, read from L2), forms
//       scale and zero, and quantizes its share; block 0 writes the
//       header.
// Both paths form scale and zero by the same instructions (`scale_zero`),
// so which one runs changes no bit.  `dequantize_kernel` reads scale and
// zero from device memory, so a dequantize needs no host value either.
// Loads are 16 bytes a thread (float4 in, char4 out, and back) where the
// pointers allow, with a scalar tail; the TPU kernel's padding of x to a
// multiple of its block with x[0] is a TPU artefact and is dropped.
//
// Bound: the function reads each input once and writes each output once:
// quantize reads x and writes q and the header, dequantize reads q and
// the header and writes out, 5 bytes an element (+ 8) either way, against
// a handful of float operations: both are memory-bound on an H100 (3.35
// TB/s).  At the per-frame shapes that bound is under 0.02 us and launch
// latency sets the time; at 2^24 elements it is 25 us each.  The one-block
// path moves those 5 bytes an element; the two passes move 9, as pass 2
// reads x again (from HBM at 2^24).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElemsPerThread = 16;   // grid sizing: 4 float4 a thread
// the one-block path: up to 1,024 threads, 16 floats each in registers
constexpr int kOneBlockThreads = 1024;
constexpr int kOneBlockPerThread = 16;
constexpr long long kOneBlockMax =
    static_cast<long long>(kOneBlockThreads) * kOneBlockPerThread;
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

// Block-wide min and max of every thread's (lo, hi), for a block of any
// multiple of 32 threads up to 1,024; the result is returned to every
// thread.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[32], s_hi[32];
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < static_cast<int>(blockDim.x / 32);
    lo = live ? s_lo[lane] : CUDART_INF_F;
    hi = live ? s_hi[lane] : -CUDART_INF_F;
    for (int off = 16; off > 0; off >>= 1) {
      lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {                   // warp 0 has read every slot
      s_lo[0] = lo;
      s_hi[0] = hi;
    }
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
}

// scale and zero from the tensor's (lo, hi), the plain version's numerics
__device__ __forceinline__ void scale_zero(float lo, float hi, float& scale,
                                           float& zero) {
  const float span = __fmul_rn(__fsub_rn(hi, lo), kInv255);
  scale = span < 1e-12f ? 1e-12f : span;   // keeps NaN
  zero = __fsub_rn(-128.0f, __fdiv_rn(lo, scale));
}

// round half to even, clip to [-128, 127], NaN -> 0 (as XLA and PyTorch
// convert it): one saturating convert
__device__ __forceinline__ int8_t level(float v, float scale, float zero) {
  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;"
      : "=r"(q) : "f"(__fadd_rn(__fdiv_rn(v, scale), zero)));
  return static_cast<int8_t>(q);
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
  // pass 2 may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ partials, int8_t* __restrict__ q,
                float* __restrict__ sz) {
  // launched early (programmatic dependent launch): wait for pass 1 to
  // finish and its partials to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int g = gridDim.x;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int i = threadIdx.x; i < g; i += kThreads) {
    lo = min_nan(lo, partials[i]);
    hi = max_nan(hi, partials[g + i]);
  }
  block_minmax(lo, hi);
  float scale, zero;
  scale_zero(lo, hi, scale, zero);
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

// The whole quantize in one block (n <= kOneBlockMax, blockDim.x a
// multiple of 32 with n <= kOneBlockPerThread * blockDim.x): x read once
// into registers, element i of the float4 (VEC) or float view held by
// thread i % blockDim.x; (lo, hi) reduced over the block; q written from
// the registers.  VEC needs x 16-byte and q 4-byte aligned; its n % 4
// tail elements are held by threads 0..2.
template <bool VEC>
__global__ void __launch_bounds__(kOneBlockThreads)
quantize_one_block_kernel(const float* __restrict__ x, int n,
                          int8_t* __restrict__ q, float* __restrict__ sz) {
  constexpr int kUnits = VEC ? kOneBlockPerThread / 4 : kOneBlockPerThread;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int units = VEC ? n / 4 : n;
  float v[kOneBlockPerThread];
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int i = tid + j * threads;
    if (i >= units) break;
    if constexpr (VEC) {
      const float4 f = reinterpret_cast<const float4*>(x)[i];
      v[4 * j] = f.x;
      v[4 * j + 1] = f.y;
      v[4 * j + 2] = f.z;
      v[4 * j + 3] = f.w;
      lo = min_nan(lo, min_nan(min_nan(f.x, f.y), min_nan(f.z, f.w)));
      hi = max_nan(hi, max_nan(max_nan(f.x, f.y), max_nan(f.z, f.w)));
    } else {
      v[j] = x[i];
      lo = min_nan(lo, v[j]);
      hi = max_nan(hi, v[j]);
    }
  }
  const int tail = 4 * units + tid;             // VEC: the n % 4 last
  const bool has_tail = VEC && tail < n;
  float t = 0.0f;
  if (has_tail) {
    t = x[tail];
    lo = min_nan(lo, t);
    hi = max_nan(hi, t);
  }
  block_minmax(lo, hi);
  float scale, zero;
  scale_zero(lo, hi, scale, zero);
  if (tid == 0) {
    sz[0] = scale;
    sz[1] = zero;
  }
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int i = tid + j * threads;
    if (i >= units) break;
    if constexpr (VEC) {
      reinterpret_cast<char4*>(q)[i] = make_char4(
          level(v[4 * j], scale, zero), level(v[4 * j + 1], scale, zero),
          level(v[4 * j + 2], scale, zero), level(v[4 * j + 3], scale, zero));
    } else {
      q[i] = level(v[j], scale, zero);
    }
  }
  if (has_tail) q[tail] = level(t, scale, zero);
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

// One launch (n <= kOneBlockMax) or two (above it) on `stream`, no host
// round trip between them; returns cudaGetLastError() (0 on success)
// after each, because a refused launch never runs.  `partials` is scratch
// of 2 * kMaxBlocks floats, read only by the two passes (it may be null
// for n <= kOneBlockMax); `sz` receives (scale, zero).
int int8_quantize_f32(const float* x, int8_t* q, float* partials, float* sz,
                      long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= kOneBlockMax) {
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 4 == 0;
    // a thread for each float4 (or float) up to 1,024, then up to
    // kOneBlockPerThread floats each
    const long long units = vec ? n / 4 : n;
    const long long warps = (units + 31) / 32;
    const int threads = static_cast<int>(
        warps < 1 ? 32 : (warps > kOneBlockThreads / 32 ? kOneBlockThreads
                                                         : 32 * warps));
    if (vec) {
      quantize_one_block_kernel<true><<<1, threads, 0, stream>>>(
          x, static_cast<int>(n), q, sz);
    } else {
      quantize_one_block_kernel<false><<<1, threads, 0, stream>>>(
          x, static_cast<int>(n), q, sz);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int g = static_cast<int>(blocks_for(n, kMaxBlocks));
  minmax_partials_kernel<<<g, kThreads, 0, stream>>>(x, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // pass 2 as pass 1's programmatic dependent
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, quantize_kernel, x, n,
      static_cast<const float*>(partials), q, sz));
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
