// Streaming InfoNCE over per-sample negatives, forward and backward, for
// Hopper (sm_90a).
//
// The forward replaces the TPU kernel `infonce_vneg_pallas` / `_kernel` in
// src/repro/kernels/infonce_vneg.py.  For each sample b of z, z_pos (B, d)
// and z_neg (B, N, d), with s+ = z.z_pos / tau and s_n = z.z_neg[n] / tau:
//   lse[b]  = logsumexp(s+, s_1, ..., s_N)
//   loss[b] = lse[b] - s+
// The backward has no Pallas counterpart (the reference differentiates the
// jnp twin, `core/infonce.py::streaming_infonce`).  Given the cotangent
// g (B,) and the saved lse, with p0 = exp(s+ - lse), p_n = exp(s_n - lse)
// and c = g / tau:
//   dz         = c * ((p0 - 1) * z_pos + sum_n p_n * z_neg[n])
//   dz_pos     = c * (p0 - 1) * z
//   dz_neg[n]  = c * p_n * z
// z, z_pos and z_neg are float32 or bf16, all of one type.  A bf16 input is
// loaded as it is (8 bytes for 4 values at d % 4 == 0) and widened to
// float32 in registers, as the TPU kernel reads its tiles
// `.astype(jnp.float32)`: the widening is exact, and the plan and every sum
// are the float32 kernel's, so a bf16 call gives the bits of the float32
// kernels on the widened inputs.  loss and lse are float32; the backward
// writes dz, dz_pos and dz_neg in the inputs' type, each the float32 value
// rounded to nearest even once, as the reference's `astype` gives a
// gradient back in its input's type.
//
// Bound: both kernels stream z_neg (B*N*d floats) once, the backward
// writes dz_neg of the same size; 2 flops per element of z_neg each.  At
// the edge trainer's shape (B=8, N=264, d=128) that is 1.1 MB read,
// 0.3 us at 3.35 TB/s (half of it in bf16), against 8 ns of arithmetic at
// 67 TFLOP/s float32: bytes bound them, and at this size the latency of a launch and of a load
// from device memory costs more than either.
//
// Design: each call is two kernels.  The first runs a grid of (B, NS)
// blocks of 8 warps, NS splits of each sample's negatives (the wrapper's
// plan: about 128 blocks, at least 8 negatives a split; 16 splits of 17 at
// the edge trainer's shape), so the loads spread over the card.  Warp w of
// split s takes the split's negatives n0 + w, n0 + w + 8, ... in batches
// of 4, whose loads it issues together (a float4 a lane at d = 128:
// one coalesced row a load; a scalar path for d % 4 != 0 or a view not on
// 16 bytes) before their multiply-adds and their fixed xor trees, so every
// lane of the warp holds each s_n.
//   Forward: each warp keeps a running (m, l) over its negatives, a batch
//   at a time as the Pallas kernel takes a tile (the batch's max first,
//   then its exponentials, independent, added in order); thread 0 merges
//   the 8 warps in order into the split's (m, l).  The
//   second kernel, one warp a sample, merges the NS splits in split order
//   into (m, l) seeded with (s+, 1), as the Pallas kernel seeds its scratch
//   with the positive, and writes lse and loss.
//   Backward: p_n = exp(s_n - lse) needs no merge, since lse is given.
//   Each warp writes dz_neg[n] = c p_n z with float4 stores and adds
//   p_n z_neg[n] into its own row of sums in shared memory, negatives in
//   order; the split adds its 8 rows in warp order into its partial (d
//   floats).  The second kernel, one block a sample, writes dz_pos and dz,
//   the partials of the splits summed in split order.
// The second kernel is a programmatic dependent of the first (Hopper): it
// launches while the first runs, computes s+ (and dz_pos) from the inputs,
// and waits in griddepcontrol.wait before it reads the partials.  No
// floating-point atomics and a fixed order everywhere, so both are the same
// bits from run to run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // a split's block
constexpr int kThreads = 32 * kWarps;   // (and the backward's merge block)
constexpr int kRows = 4;                // negatives a warp has in flight
constexpr int kMergeWarps = 8;          // the forward's merge: a warp a sample
constexpr float kNegBig = -1e30f;

// bf16, as its bits: it widens to float32 exactly and a float32 is
// rounded to it to nearest even
struct bf16_t {
  unsigned short bits;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) {
  return __uint_as_float(static_cast<unsigned>(v.bits) << 16);
}

// a and b rounded to bf16, a in the low half
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

// Values 4i .. 4i + 3 of p, widened (p aligned to 4 values), and v stored
// there in p's type
__device__ __forceinline__ float4 load4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 load4(const bf16_t* p, int i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, int i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}
__device__ __forceinline__ void store4(bf16_t* p, int i, float4 v) {
  reinterpret_cast<uint2*>(p)[i] =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store1(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store1(bf16_t* p, size_t i, float v) {
  p[i] = bf16_t{static_cast<unsigned short>(pack_bf16(v, 0.0f))};
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// s+ = z.z_pos / tau of one sample, the lanes of one warp in a fixed order;
// every lane gets it
template <typename T>
__device__ __forceinline__ float positive(const T* __restrict__ zb,
                                          const T* __restrict__ zpb,
                                          int d, int lane, float tau) {
  float acc = 0.0f;
  for (int j = lane; j < d; j += 32) {
    acc = fmaf(widen(zb[j]), widen(zpb[j]), acc);
  }
  return __fdiv_rn(warp_sum(acc), tau);
}

// The partial dot products z.z_neg[n] of negatives n = base + kWarps*r
// (r < kRows, n < n1) of one lane: 4-value columns 4 lane, 4 lane + 128,
// ... where `vec`, else columns lane, lane + 32, ...; all the batch's loads
// of a column step issue before its multiply-adds.
template <typename T>
__device__ __forceinline__ void lane_dots(float (&acc)[kRows],
                                          const T* __restrict__ zb,
                                          const T* __restrict__ znb,
                                          int base, int n1, int d, int lane,
                                          bool vec) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  if (vec) {
    const int d4 = d / 4;
    for (int j = lane; j < d4; j += 32) {
      const float4 a = load4(zb, j);
      float4 x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = base + kWarps * r;
        x[r] = n < n1 ? load4(znb + static_cast<size_t>(n) * d, j)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] = fmaf(a.x, x[r].x, acc[r]);
        acc[r] = fmaf(a.y, x[r].y, acc[r]);
        acc[r] = fmaf(a.z, x[r].z, acc[r]);
        acc[r] = fmaf(a.w, x[r].w, acc[r]);
      }
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float a = widen(zb[j]);
      float x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = base + kWarps * r;
        x[r] = n < n1 ? widen(znb[static_cast<size_t>(n) * d + j]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(a, x[r], acc[r]);
    }
  }
}

// (m, l) <- (m, l) merged with the n pairs (wm[i], wl[i]) in order, as
// the Pallas kernel's online softmax takes a tile: the new max first (exact
// in any order), then l * exp(m - max) plus each wl * exp(wm - max) in
// order, whose exponentials are independent
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, const float* wm,
                                      const float* wl, int n) {
  float m_new = m;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) m_new = fmaxf(m_new, wm[i]);
  }
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = i < n ? __fmul_rn(wl[i], expf(__fsub_rn(wm[i], m_new))) : 0.0f;
  }
  l = __fmul_rn(l, expf(__fsub_rn(m, m_new)));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) l = __fadd_rn(l, t[i]);
  }
  m = m_new;
}

// The negatives [n0, n1) of split `split` of a sample
__device__ __forceinline__ void split_range(int N, int NS, int split, int* n0,
                                            int* n1) {
  const int per = (N + NS - 1) / NS;
  *n0 = min(N, split * per);
  *n1 = min(N, *n0 + per);
}

// The forward's merge of sample b by one warp: the NS splits' (m, l) in
// split order into (s+, 1), the max over all first (a fixed xor tree of
// fmaxf, exact), then each split's l * exp(m - max), a split a lane,
// added in split order to exp(s+ - max); lane 0 writes lse and loss
__device__ __forceinline__ void fwd_merge(const float* part,
                                          float* __restrict__ loss,
                                          float* __restrict__ lse, int b,
                                          int B, int NS, float pos,
                                          int lane) {
  const float* pm = part + static_cast<size_t>(b) * NS;
  const float* pl = part + static_cast<size_t>(B) * NS +
                    static_cast<size_t>(b) * NS;
  float mx = pos;
  for (int s = lane; s < NS; s += 32) mx = fmaxf(mx, pm[s]);
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  float ll = expf(__fsub_rn(pos, mx));  // the seed (s+, 1)
  for (int s0 = 0; s0 < NS; s0 += 32) {
    const int s = s0 + lane;
    const float t =
        s < NS ? __fmul_rn(pl[s], expf(__fsub_rn(pm[s], mx))) : 0.0f;
    const int cnt = min(32, NS - s0);
    for (int i = 0; i < cnt; ++i) {
      ll = __fadd_rn(ll, __shfl_sync(0xffffffffu, t, i));
    }
  }
  if (lane == 0) {
    const float out = __fadd_rn(mx, logf(ll));
    lse[b] = out;
    loss[b] = __fsub_rn(out, pos);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
infonce_fwd_split_kernel(const T* __restrict__ z,
                         const T* __restrict__ zn,
                         float* __restrict__ part, int B, int N, int d,
                         int NS, float tau, bool vec) {
  __shared__ float wm[kWarps], wl[kWarps];
  const int b = blockIdx.x, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the merge may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  int n0, n1;
  split_range(N, NS, split, &n0, &n1);
  const T* zb = z + static_cast<size_t>(b) * d;
  const T* znb = zn + static_cast<size_t>(b) * N * d;
  float m = kNegBig, l = 0.0f;
  for (int base = n0 + warp; base < n1; base += kWarps * kRows) {
    // the batch's rows, the same in every lane: the others are skipped
    const int rows = min(kRows, (n1 - base + kWarps - 1) / kWarps);
    float acc[kRows], ones[kRows];
    lane_dots(acc, zb, znb, base, n1, d, lane, vec);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) acc[r] = __fdiv_rn(warp_sum(acc[r]), tau);
      ones[r] = 1.0f;
    }
    merge<kRows>(m, l, acc, ones, rows);
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = wm[0], ll = wl[0];
    merge<kWarps - 1>(mm, ll, wm + 1, wl + 1, kWarps - 1);
    part[static_cast<size_t>(b) * NS + split] = mm;
    part[static_cast<size_t>(B) * NS + static_cast<size_t>(b) * NS + split] =
        ll;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMergeWarps)
infonce_fwd_merge_kernel(const T* __restrict__ z,
                         const T* __restrict__ zp,
                         const float* __restrict__ part,
                         float* __restrict__ loss, float* __restrict__ lse,
                         int B, int d, int NS, float tau) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (b >= B) return;
  // s+ reads only the inputs: before the wait, beside the first kernel
  const float pos = positive(z + static_cast<size_t>(b) * d,
                             zp + static_cast<size_t>(b) * d, d, lane, tau);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  fwd_merge(part, loss, lse, b, B, NS, pos, lane);
}

// The backward's merge of sample b by a block of kThreads: dz_pos, then dz
// with the NS partials summed in split order (pos in every thread)
template <typename T>
__device__ __forceinline__ void bwd_dz(const T* __restrict__ zp,
                                       const float* part,
                                       T* __restrict__ dz, int b, int d,
                                       int NS, float c, float p0m1) {
  const float* pb = part + static_cast<size_t>(b) * NS * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float a = pb[j];
    for (int s0 = 1; s0 < NS; s0 += 8) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p[i] = s0 + i < NS ? pb[static_cast<size_t>(s0 + i) * d + j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (s0 + i < NS) a = __fadd_rn(a, p[i]);
      }
    }
    const size_t o = static_cast<size_t>(b) * d + j;
    store1(dz, o, __fmul_rn(c, fmaf(p0m1, widen(zp[o]), a)));
  }
}

template <typename T>
__device__ __forceinline__ void bwd_dz_pos(const T* __restrict__ z,
                                           T* __restrict__ dzp, int b,
                                           int d, float c, float p0m1) {
  const float cp0 = __fmul_rn(c, p0m1);
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const size_t o = static_cast<size_t>(b) * d + j;
    store1(dzp, o, __fmul_rn(cp0, widen(z[o])));
  }
}

// s+ of sample b by warp 0, shared with the block
template <typename T>
__device__ __forceinline__ float block_positive(const T* __restrict__ z,
                                                const T* __restrict__ zp,
                                                int b, int d, float tau) {
  __shared__ float pos;
  if (threadIdx.x < 32) {
    const float s = positive(z + static_cast<size_t>(b) * d,
                             zp + static_cast<size_t>(b) * d, d, threadIdx.x,
                             tau);
    if (threadIdx.x == 0) pos = s;
  }
  __syncthreads();
  return pos;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
infonce_bwd_split_kernel(const T* __restrict__ z,
                         const T* __restrict__ zn,
                         const float* __restrict__ lse,
                         const float* __restrict__ g, T* __restrict__ dzn,
                         float* __restrict__ part, int N, int d, int NS,
                         float tau, bool vec) {
  extern __shared__ __align__(16) float sums[];   // kWarps x d
  const int b = blockIdx.x, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  int n0, n1;
  split_range(N, NS, split, &n0, &n1);
  const float lse_b = lse[b];
  const float c = __fdiv_rn(g[b], tau);
  const T* zb = z + static_cast<size_t>(b) * d;
  const T* znb = zn + static_cast<size_t>(b) * N * d;
  T* dznb = dzn + static_cast<size_t>(b) * N * d;
  float* mine = sums + warp * d;        // lane j's columns j, j + 32, ...
  for (int j = lane; j < d; j += 32) mine[j] = 0.0f;
  for (int base = n0 + warp; base < n1; base += kWarps * kRows) {
    const int rows = min(kRows, (n1 - base + kWarps - 1) / kWarps);
    float acc[kRows], p[kRows], cp[kRows];
    lane_dots(acc, zb, znb, base, n1, d, lane, vec);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = r < rows
                 ? expf(__fsub_rn(__fdiv_rn(warp_sum(acc[r]), tau), lse_b))
                 : 0.0f;
      cp[r] = __fmul_rn(c, p[r]);
    }
    if (vec) {
      float4* mine4 = reinterpret_cast<float4*>(mine);
      for (int j = lane; j < d / 4; j += 32) {
        const float4 a = load4(zb, j);
        float4 s = mine4[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = base + kWarps * r;
          if (n >= n1) continue;
          const size_t row = static_cast<size_t>(n) * d;
          const float4 x = load4(znb + row, j);
          store4(dznb + row, j,
                 make_float4(__fmul_rn(cp[r], a.x), __fmul_rn(cp[r], a.y),
                             __fmul_rn(cp[r], a.z), __fmul_rn(cp[r], a.w)));
          s.x = fmaf(p[r], x.x, s.x);
          s.y = fmaf(p[r], x.y, s.y);
          s.z = fmaf(p[r], x.z, s.z);
          s.w = fmaf(p[r], x.w, s.w);
        }
        mine4[j] = s;
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float a = widen(zb[j]);
        float s = mine[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = base + kWarps * r;
          if (n >= n1) continue;
          const size_t row = static_cast<size_t>(n) * d;
          store1(dznb, row + j, __fmul_rn(cp[r], a));
          s = fmaf(p[r], widen(znb[row + j]), s);
        }
        mine[j] = s;
      }
    }
  }
  __syncthreads();
  float* pb = part + (static_cast<size_t>(b) * NS + split) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float a = sums[j];
    for (int w = 1; w < kWarps; ++w) a = __fadd_rn(a, sums[w * d + j]);
    pb[j] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
infonce_bwd_merge_kernel(const T* __restrict__ z,
                         const T* __restrict__ zp,
                         const float* __restrict__ lse,
                         const float* __restrict__ g,
                         const float* __restrict__ part,
                         T* __restrict__ dz, T* __restrict__ dzp,
                         int d, int NS, float tau) {
  const int b = blockIdx.x;
  // s+ and dz_pos read only the inputs: before the wait
  const float c = __fdiv_rn(g[b], tau);
  const float p0m1 = __fsub_rn(
      expf(__fsub_rn(block_positive(z, zp, b, d, tau), lse[b])), 1.0f);
  bwd_dz_pos(z, dzp, b, d, c, p0m1);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  bwd_dz(zp, part, dz, b, d, NS, c, p0m1);
}

// whether p lies on a multiple of `bytes`
bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Past the 48 KB that a launch gets by default, the kernel must opt in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

// The merge kernel as a programmatic dependent of the split kernel
template <typename Kernel, typename... Args>
cudaError_t launch_dependent(Kernel kernel, int blocks, int threads,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

bool bad_shape(int B, int N, int d, int NS, float tau) {
  return B <= 0 || N <= 0 || d <= 0 || NS <= 0 || NS > N || NS > 65535 ||
         !(tau > 0.0f);
}

// Both launch two kernels on `stream` and return the first CUDA error (0
// on success); the caller checks it, because a refused launch never runs.
// NS is the number of splits of each sample's negatives (the wrapper's
// plan, 1 <= NS <= N); `part` is scratch of 2*B*NS floats (forward) or
// B*NS*d floats (backward).

template <typename T>
int launch_fwd(const T* z, const T* zp, const T* zn, float* loss, float* lse,
               float* part, int B, int N, int d, int NS, float tau,
               cudaStream_t stream) {
  if (bad_shape(B, N, d, NS, tau)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec =
      d % 4 == 0 && aligned(z, 4 * sizeof(T)) && aligned(zn, 4 * sizeof(T));
  infonce_fwd_split_kernel<T><<<dim3(B, NS), kThreads, 0, stream>>>(
      z, zn, part, B, N, d, NS, tau, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(
      infonce_fwd_merge_kernel<T>, (B + kMergeWarps - 1) / kMergeWarps,
      32 * kMergeWarps, stream, z, zp, static_cast<const float*>(part), loss,
      lse, B, d, NS, tau));
}

template <typename T>
int launch_bwd(const T* z, const T* zp, const T* zn, const float* lse,
               const float* g, T* dz, T* dzp, T* dzn, float* part, int B,
               int N, int d, int NS, float tau, cudaStream_t stream) {
  if (bad_shape(B, N, d, NS, tau)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 && aligned(z, 4 * sizeof(T)) &&
                   aligned(zn, 4 * sizeof(T)) && aligned(dzn, 4 * sizeof(T));
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(d);
  cudaError_t err = allow_smem(infonce_bwd_split_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  infonce_bwd_split_kernel<T><<<dim3(B, NS), kThreads, smem, stream>>>(
      z, zn, lse, g, dzn, part, N, d, NS, tau, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(
      infonce_bwd_merge_kernel<T>, B, kThreads, stream, z, zp, lse, g,
      static_cast<const float*>(part), dz, dzp, d, NS, tau));
}

}  // namespace

extern "C" {

// The _f32 launchers take float32 z, z_pos and z_neg (and write float32
// gradients), the _bf16 ones bf16 (and write bf16 gradients); loss, lse,
// g and `part` are float32 either way.

int infonce_vneg_fwd_f32(const float* z, const float* zp, const float* zn,
                         float* loss, float* lse, float* part, int B, int N,
                         int d, int NS, float tau, cudaStream_t stream) {
  return launch_fwd(z, zp, zn, loss, lse, part, B, N, d, NS, tau, stream);
}

int infonce_vneg_fwd_bf16(const void* z, const void* zp, const void* zn,
                          float* loss, float* lse, float* part, int B, int N,
                          int d, int NS, float tau, cudaStream_t stream) {
  return launch_fwd(static_cast<const bf16_t*>(z),
                    static_cast<const bf16_t*>(zp),
                    static_cast<const bf16_t*>(zn), loss, lse, part, B, N, d,
                    NS, tau, stream);
}

int infonce_vneg_bwd_f32(const float* z, const float* zp, const float* zn,
                         const float* lse, const float* g, float* dz,
                         float* dzp, float* dzn, float* part, int B, int N,
                         int d, int NS, float tau, cudaStream_t stream) {
  return launch_bwd(z, zp, zn, lse, g, dz, dzp, dzn, part, B, N, d, NS, tau,
                    stream);
}

int infonce_vneg_bwd_bf16(const void* z, const void* zp, const void* zn,
                          const float* lse, const float* g, void* dz,
                          void* dzp, void* dzn, float* part, int B, int N,
                          int d, int NS, float tau, cudaStream_t stream) {
  return launch_bwd(
      static_cast<const bf16_t*>(z), static_cast<const bf16_t*>(zp),
      static_cast<const bf16_t*>(zn), lse, g, static_cast<bf16_t*>(dz),
      static_cast<bf16_t*>(dzp), static_cast<bf16_t*>(dzn), part, B, N, d, NS,
      tau, stream);
}

const char* infonce_vneg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
