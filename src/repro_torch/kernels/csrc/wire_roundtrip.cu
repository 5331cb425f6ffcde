// Fused per-row INT8 wire round trip for Hopper (sm_90a), any number of
// (rows, n) float32, bf16 or float16 matrices of different widths in one
// launch (all of one type).
//
// Replaces the TPU kernel `wire_roundtrip_pallas` / `_wire_roundtrip_kernel`
// in src/repro/kernels/int8_quant.py.  For each row of each matrix it
// computes the row min and max, then
//   scale = max((hi - lo) * float32(1/255), 1e-12)
//   zero  = -128 - lo / scale
//   q     = clip(round_half_even(x / scale + zero), -128, 127)
//   out   = (q - zero) * scale
// and writes float32: the int8 level never goes to device memory.  A bf16
// or float16 input is loaded as it is (8 bytes for 4 values) and widened to
// float32 in registers, as the TPU kernel casts its tile (`astype`): the
// widening is exact, so a 16-bit input gives the bits of the float32
// kernel on the widened tensor.
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
// Min and max are exact in any order, so the reduction tree is free and
// no atomics are needed.  A NaN element makes the row's lo, hi, scale and
// zero NaN, and so the whole row NaN, as in the plain version: the min/max
// fold and the scale floor keep NaN, where fminf/fmaxf would drop it.  The
// level converts to int before it is dequantized, NaN to 0, as the
// reference's int8 cast does.
//
// Bound: the function reads each input once and writes each output once,
// 8 bytes per element (6 from a 16-bit input), against a handful of float operations: on an H100
// (3.35 TB/s) it is memory-bound at 8 * elements / 3.35e12 s.  The serving
// tick's eight k-buckets (32 rows each, n 3,200-12,800) hold 1.55 M
// elements, a 3.70 us bound; one launch costs about 3 us by itself, which
// is why the tick's buckets go in one launch.
//
// Design.  The serving tick runs every bucket's edge stage, then this
// kernel once over all buckets (the groups), then every server stage.
// A launch takes its group table (each group's pointers, rows, width and
// first block) by value as a __grid_constant__ parameter, so nothing is
// copied to the device for it, and is a programmatic dependent of the
// kernel before it on the stream (the edge stage's last): its blocks are
// scheduled while that kernel drains and wait in griddepcontrol.wait for
// its writes, about 1 us less a tick than a plain launch on an H100
// (tools/wire_variants.py).  One 512-thread block a row, blocks of a
// group consecutive: the tick's ~256 rows cover the card's 132 SMs, two
// blocks an SM.  A row of up to kRowMax floats (16-byte aligned, n % 4 ==
// 0: every serving width) is read once, into registers (up to 8 float4 a
// thread), reduced over the block, and written from the registers; any
// other row is read twice, the second time from L2, as a strided loop.
// The TPU kernel's lane padding (each row padded to a multiple of 128 with
// its first element) and its 8-row tiles are TPU artefacts and are dropped.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// The group table stands outside the unnamed namespace: the extern "C"
// launcher takes it, and a parameter type of internal linkage would make
// the launcher internal too.
constexpr int kMaxGroups = 16;

// One matrix of the launch: `rows` rows of `n` values from x (of the
// launch's input type) to out (float32), rows in blocks first_block ..
// first_block + rows - 1.
struct Group {
  const void* x;
  float* out;
  int rows;
  int n;
  int first_block;
  int pad;
};

// The launch's groups in block order; the host packs it (int8_quant.py
// mirrors this layout with ctypes).
struct GroupTable {
  Group g[kMaxGroups];
  int count;
};

namespace {

constexpr int kThreads = 512;
constexpr int kUnitsPerThread = 8;      // float4 a thread held in registers
constexpr int kRowMax = kThreads * kUnitsPerThread * 4;   // 16,384 floats
constexpr float kInv255 = 0x1.010102p-8f;  // float32(1/255), 0x3B808081

// The 16-bit input types, as their bits: each widens to float32 exactly.
struct bf16_t {
  unsigned short bits;
};
struct f16_t {
  unsigned short bits;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) {
  return __uint_as_float(static_cast<unsigned>(v.bits) << 16);
}
__device__ __forceinline__ float widen(f16_t v) {
  float r;
  asm("cvt.f32.f16 %0, %1;" : "=f"(r) : "h"(v.bits));
  return r;
}

// Values 4i .. 4i + 3 of p, widened: one 16-byte load of float32, one
// 8-byte load of a 16-bit type (p aligned to 4 values)
__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return reinterpret_cast<const float4*>(p)[i];
}
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, long long i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  return make_float4(widen(T{static_cast<unsigned short>(u.x)}),
                     widen(T{static_cast<unsigned short>(u.x >> 16)}),
                     widen(T{static_cast<unsigned short>(u.y)}),
                     widen(T{static_cast<unsigned short>(u.y >> 16)}));
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

// The level goes through int as the int8 payload would: round half to even
// (__float2int_rn, as rintf), then clamp.  The conversion gives 0 for NaN
// (PTX cvt), as XLA's float-to-int8 does, so the +inf element of a row whose
// scale is +inf comes back +inf, as in the reference.
__device__ __forceinline__ float roundtrip(float v, float scale, float zero) {
  int q = __float2int_rn(__fadd_rn(__fdiv_rn(v, scale), zero));
  q = min(max(q, -128), 127);
  return __fmul_rn(__fsub_rn(static_cast<float>(q), zero), scale);
}

__device__ __forceinline__ float4 roundtrip4(float4 v, float scale,
                                             float zero) {
  return make_float4(roundtrip(v.x, scale, zero), roundtrip(v.y, scale, zero),
                     roundtrip(v.z, scale, zero), roundtrip(v.w, scale, zero));
}

__device__ __forceinline__ void fold4(float4 v, float& lo, float& hi) {
  lo = min_nan(lo, min_nan(min_nan(v.x, v.y), min_nan(v.z, v.w)));
  hi = max_nan(hi, max_nan(max_nan(v.x, v.y), max_nan(v.z, v.w)));
}

// The block's (lo, hi) -> (scale, zero) in every thread.
__device__ __forceinline__ void row_scale_zero(float lo, float hi,
                                               float& scale, float& zero) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  __shared__ float s_scale, s_zero;
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
  if (tid < 32) {
    lo = tid < kThreads / 32 ? s_lo[tid] : CUDART_INF_F;
    hi = tid < kThreads / 32 ? s_hi[tid] : -CUDART_INF_F;
    for (int off = 16; off > 0; off >>= 1) {
      lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (tid == 0) {
      const float span = __fmul_rn(__fsub_rn(hi, lo), kInv255);
      const float s = span < 1e-12f ? 1e-12f : span;   // keeps NaN
      s_scale = s;
      s_zero = __fsub_rn(-128.0f, __fdiv_rn(lo, s));
    }
  }
  __syncthreads();
  scale = s_scale;
  zero = s_zero;
}

// A row of n <= kRowMax values, n % 4 == 0, aligned to 4 values: read once
// into registers (unit i, values 4i .. 4i + 3, held by thread i % kThreads).
template <typename T>
__device__ __forceinline__ void row_in_registers(const T* __restrict__ xr,
                                                 float* __restrict__ outr,
                                                 int n) {
  const int tid = threadIdx.x, units = n / 4;
  float4* o4 = reinterpret_cast<float4*>(outr);
  float4 v[kUnitsPerThread];
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kUnitsPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i >= units) break;
    v[j] = load4(xr, i);
    fold4(v[j], lo, hi);
  }
  float scale, zero;
  row_scale_zero(lo, hi, scale, zero);
#pragma unroll
  for (int j = 0; j < kUnitsPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i >= units) break;
    o4[i] = roundtrip4(v[j], scale, zero);
  }
}

// Any other row: a strided min/max pass, then a second pass (the row
// again, from L2) that quantizes and writes; float4 where the row allows.
template <typename T>
__device__ __forceinline__ void row_twice(const T* __restrict__ xr,
                                          float* __restrict__ outr, int n,
                                          bool vec) {
  const int tid = threadIdx.x;
  float4* o4 = reinterpret_cast<float4*>(outr);
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  if (vec) {
    for (int i = tid; i < n / 4; i += kThreads) fold4(load4(xr, i), lo, hi);
  } else {
    for (int i = tid; i < n; i += kThreads) {
      lo = min_nan(lo, widen(xr[i]));
      hi = max_nan(hi, widen(xr[i]));
    }
  }
  float scale, zero;
  row_scale_zero(lo, hi, scale, zero);
  if (vec) {
    for (int i = tid; i < n / 4; i += kThreads) {
      o4[i] = roundtrip4(load4(xr, i), scale, zero);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      outr[i] = roundtrip(widen(xr[i]), scale, zero);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wire_roundtrip_grouped_kernel(const __grid_constant__ GroupTable table) {
  // launched early (programmatic dependent launch): wait for the kernel
  // before it to finish and its writes to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int b = blockIdx.x;
  int gi = 0;                        // the group whose blocks hold b
  while (b >= table.g[gi].first_block + table.g[gi].rows) ++gi;
  const Group& grp = table.g[gi];
  const int n = grp.n;
  const size_t offset = static_cast<size_t>(b - grp.first_block) * n;
  const T* xr = static_cast<const T*>(grp.x) + offset;
  float* outr = grp.out + offset;
  const bool vec = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(xr) % (4 * sizeof(T)) == 0) &&
                   (reinterpret_cast<uintptr_t>(outr) % 16 == 0);
  if (vec && n <= kRowMax) {
    row_in_registers(xr, outr, n);
  } else {
    row_twice(xr, outr, n, vec);
  }
}

// Checks a packed table: 1..kMaxGroups groups, each of at least one row of
// at least one float, their blocks consecutive from 0 -> the launch's
// blocks, or 0 if the table is not well formed.
long long table_blocks(const GroupTable& t) {
  if (t.count < 1 || t.count > kMaxGroups) return 0;
  long long blocks = 0;
  for (int i = 0; i < t.count; ++i) {
    const Group& g = t.g[i];
    if (g.rows < 1 || g.n < 1 || g.first_block != blocks ||
        g.x == nullptr || g.out == nullptr)
      return 0;
    blocks += g.rows;
  }
  return blocks < (1LL << 31) ? blocks : 0;
}

template <typename T>
int launch(const GroupTable& table, cudaStream_t stream) {
  const long long blocks = table_blocks(table);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, wire_roundtrip_grouped_kernel<T>, table));
}

// One (rows, n) matrix: a table of one group.
template <typename T>
int one_group(const void* x, float* out, int rows, int n,
              cudaStream_t stream) {
  GroupTable table = {};
  table.g[0] = {x, out, rows, n, 0, 0};
  table.count = 1;
  return launch<T>(table, stream);
}

// The groups of a table the host packed (read here, on the host, and
// passed to the kernel by value).
template <typename T>
int grouped(const GroupTable* table, cudaStream_t stream) {
  if (table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T>(*table, stream);
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` and returns cudaGetLastError() (0 on
// success); the caller checks it, because a refused launch never runs.
// The _f32, _bf16 and _f16 launchers read x as float32, bf16 or float16
// and write float32.

// One (rows, n) matrix: a table of one group.
int wire_roundtrip_f32(const float* x, float* out, int rows, int n,
                       cudaStream_t stream) {
  return one_group<float>(x, out, rows, n, stream);
}

int wire_roundtrip_bf16(const void* x, float* out, int rows, int n,
                        cudaStream_t stream) {
  return one_group<bf16_t>(x, out, rows, n, stream);
}

int wire_roundtrip_f16(const void* x, float* out, int rows, int n,
                       cudaStream_t stream) {
  return one_group<f16_t>(x, out, rows, n, stream);
}

// The groups of a table the host packed.
int wire_roundtrip_grouped_f32(const GroupTable* table, cudaStream_t stream) {
  return grouped<float>(table, stream);
}

int wire_roundtrip_grouped_bf16(const GroupTable* table,
                                cudaStream_t stream) {
  return grouped<bf16_t>(table, stream);
}

int wire_roundtrip_grouped_f16(const GroupTable* table,
                               cudaStream_t stream) {
  return grouped<f16_t>(table, stream);
}

const char* wire_roundtrip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
