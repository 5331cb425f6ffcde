// The gradient of the hybrid loss's two regularisers with respect to the
// embeddings, in one launch, for Hopper (sm_90a).
//
// No Pallas counterpart: the TPU kernels `swd_pallas`
// (src/repro/kernels/swd_kernel.py) and `laplacian_energy_pallas`
// (src/repro/kernels/laplacian_energy.py) compute the two terms' forward
// only, and the reference differentiates their jnp twins
// (src/repro/core/swd.py `sliced_w2`, src/repro/core/laplacian.py
// `dirichlet_energy`).  Both terms read the same z (B, T, d): the SW term
// as the W = B*T rows of z.reshape(-1, d), the Laplacian term as B rows of
// T frames.  For row i = b*T + t of dz and column j, with K = min(k, T-1):
//   sw[i, j]  = sum over m = 0..M-1, in order, of gp[i, m] * dirs[m, j]
//   gp[i, m]  = 2*g_sw*(proj[i, m] - prior_q[rank[i, m], m]) / (W*M)
//   lap[i, j] = 2*g_tot[b] * sum over delta = 1..K of
//               ( m[t] * m[t-delta] * (z[t] - z[t-delta])      if t >= delta
//               - m[t] * m[t+delta] * (z[t+delta] - z[t]) )    if t+delta < T
//   dz[i, j]  = sw[i, j] + lap[i, j]
// proj and rank are `swd_rank_fwd_f32`'s outputs (swd.cu).  g_tot is read
// through its stride, so the expanded cotangent of tot.sum() needs no copy.
// Either half may be absent (its cotangent pointer null): `swd_rank_bwd`
// and `laplacian_energy_bwd` are this kernel with one half, so each
// formula has one body.
//
// The operations are those of the two one-half kernels this one replaced,
// in their order: gp's difference, product and division each rounded
// (__fsub_rn, __fmul_rn, __fdiv_rn), the sum over m by fmaf, the deltas in
// order with every operation rounded, all built with -fmad=false; the two
// halves are joined by one __fadd_rn.  Float addition commutes, so dz is
// bitwise the two one-half outputs added by torch, in either order.
//
// Bound: bytes.  Each input read once and dz written once is
// 4*(2*W*d + W + B + 1 + 3*W*M + M*d) bytes, against 2*W*M*d flops of the
// SW half and about 8*K*W*d of the Laplacian's.  At the LM step's
// (8, 16, 1,024), M 50, k 5: 1.33 MB, 0.40 us at 3.35 TB/s, above 13 MFLOP's
// 0.20 us at 67 TFLOP/s.  At the edge learner's (1, 104, 128), M 32, k 3:
// 163 KB, 0.05 us, where a launch alone costs ~3 us; so the step's backward
// is this one launch where it had two kernels and an add (and at B > 1 a
// copy of the expanded g_tot).
//
// Design: the grid tiles dz into kRows = 8 rows x kCols = 32 columns, a
// block of 256 threads a tile, warp w the tile's row w and lane l its
// column l.  For each chunk of kDirChunk directions the block stages its
// rows' weights gp and the chunk's slab of dirs in shared memory, the slab
// transposed so that a thread reads four directions as one float4; so dirs
// is read once a tile, not once a row (the one-block-a-row kernel before
// read all 205 KB of it for each of the LM step's 128 rows: 26 MB from L2
// for a 1.3 MB job).  The chunk's loads go out together, the Laplacian
// half's with them (an element's 2K neighbours, from L1/L2), before the
// gather of prior_q by rank and the barrier.  Every element of dz is
// written once, by one thread: no atomics, no scratch, the same bits from
// run to run.  Its time on an H100 is launch and latency: this grid with an
// empty body takes ~1.8-2.0 us a launch, and the rest is two dependent
// trips to L2 (the loads, then the gather) and, at the LM step's shape, the
// slab's shared-memory reads (4 bytes a multiply-add);
// tools/hybrid_reg_variants.py splits it with probes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;     // a tile's rows: a warp's row
constexpr int kCols = 32;                // a tile's columns: a warp's lanes
constexpr int kDirChunk = 64;            // directions staged at a time
constexpr int kSlabStride = kDirChunk + 4;  // float4 reads, no bank conflict
constexpr int kGpPerThread = kRows * kDirChunk / kThreads;
constexpr int kSlabPerThread = kDirChunk * kCols / kThreads;
constexpr int kMaxColTiles = 65535;      // gridDim.y
static_assert(kDirChunk % 4 == 0 && kRows * kDirChunk % kThreads == 0 &&
                  kDirChunk * kCols % kThreads == 0,
              "a chunk's weights and slab are dealt evenly, read as float4");

// The Laplacian half of element (row i = b*T + t, column j), its
// neighbours read from L1/L2.
__device__ __forceinline__ float lap_half(const float* __restrict__ z,
                                          const float* __restrict__ mask,
                                          const float* __restrict__ g_tot,
                                          long long g_stride, int i, int j,
                                          int T, int d, int K) {
  const int b = i / T, t = i - b * T;
  const size_t row = static_cast<size_t>(b) * T;
  const float* zr = z + row * d;
  const float* mr = mask + row;
  const size_t e = static_cast<size_t>(t) * d + j;
  const size_t step = static_cast<size_t>(d);
  const float zt = zr[e], mt = mr[t];
  float acc = 0.0f;
#pragma unroll 4
  for (int delta = 1; delta <= K; ++delta) {
    if (t >= delta) {
      const float pair = __fmul_rn(mr[t - delta], mt);
      acc = __fadd_rn(acc,
                      __fmul_rn(pair, __fsub_rn(zt, zr[e - delta * step])));
    }
    if (t + delta < T) {
      const float pair = __fmul_rn(mt, mr[t + delta]);
      acc = __fsub_rn(acc,
                      __fmul_rn(pair, __fsub_rn(zr[e + delta * step], zt)));
    }
  }
  return __fmul_rn(__fmul_rn(2.0f, g_tot[b * g_stride]), acc);
}

template <bool kSW, bool kLap>
__global__ void __launch_bounds__(kThreads)
hybrid_reg_bwd_kernel(const float* __restrict__ z,
                      const float* __restrict__ mask,
                      const float* __restrict__ g_tot, long long g_stride,
                      int T, int K, const float* __restrict__ g_sw,
                      const float* __restrict__ proj,
                      const int* __restrict__ rank,
                      const float* __restrict__ prior_q,
                      const float* __restrict__ dirs, float* __restrict__ dz,
                      int W, int d, int M) {
  // a chunk's staging: the tile's rows' weights gp, and its slab of dirs
  // transposed (directions along a row) so a thread reads 4 at once
  __shared__ __align__(16) float gp[kRows][kDirChunk];
  __shared__ __align__(16) float slab[kCols][kSlabStride];
  const int lane = threadIdx.x % 32, rr = threadIdx.x / 32;
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * kCols;
  const int i = row0 + rr, j = col0 + lane;
  const bool live = i < W && j < d;
  if (!kSW) {
    if (live) {
      dz[static_cast<size_t>(i) * d + j] =
          lap_half(z, mask, g_tot, g_stride, i, j, T, d, K);
    }
    return;
  }
  const float g2 = __fmul_rn(2.0f, g_sw[0]);
  const float count = static_cast<float>(W) * static_cast<float>(M);
  float sw = 0.0f, lap = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kDirChunk) {
    const int mc = min(kDirChunk, M - m0);
    // the chunk's loads first, in flight together: the weights' inputs
    // and the slab, then (once) the Laplacian half's
    float pv[kGpPerThread], dv[kSlabPerThread];
    int rk[kGpPerThread];
#pragma unroll
    for (int s = 0; s < kGpPerThread; ++s) {
      const int e = threadIdx.x + s * kThreads;
      if (e < kRows * mc && row0 + e / mc < W) {
        const size_t o = static_cast<size_t>(row0 + e / mc) * M + m0 + e % mc;
        pv[s] = proj[o];
        rk[s] = rank[o];
      }
    }
#pragma unroll
    for (int s = 0; s < kSlabPerThread; ++s) {
      const int e = threadIdx.x + s * kThreads;
      const int m = e / kCols, c = e % kCols;
      dv[s] = m < mc && col0 + c < d
                  ? dirs[static_cast<size_t>(m0 + m) * d + col0 + c]
                  : 0.0f;
    }
    if (kLap && m0 == 0 && live) {
      lap = lap_half(z, mask, g_tot, g_stride, i, j, T, d, K);
    }
#pragma unroll
    for (int s = 0; s < kGpPerThread; ++s) {
      const int e = threadIdx.x + s * kThreads;
      if (e < kRows * mc && row0 + e / mc < W) {
        const float q = prior_q[static_cast<size_t>(rk[s]) * M + m0 + e % mc];
        gp[e / mc][e % mc] =
            __fdiv_rn(__fmul_rn(g2, __fsub_rn(pv[s], q)), count);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlabPerThread; ++s) {
      const int e = threadIdx.x + s * kThreads;
      slab[e % kCols][e / kCols] = dv[s];
    }
    __syncthreads();
    // the row's sum over the chunk's directions in order, by fmaf
    const int m4 = mc & ~3;
    for (int m = 0; m < m4; m += 4) {
      const float4 dj = *reinterpret_cast<const float4*>(&slab[lane][m]);
      const float4 w = *reinterpret_cast<const float4*>(&gp[rr][m]);
      sw = fmaf(w.x, dj.x, sw);
      sw = fmaf(w.y, dj.y, sw);
      sw = fmaf(w.z, dj.z, sw);
      sw = fmaf(w.w, dj.w, sw);
    }
    for (int m = m4; m < mc; ++m) sw = fmaf(gp[rr][m], slab[lane][m], sw);
    __syncthreads();
  }
  if (live) {
    dz[static_cast<size_t>(i) * d + j] = kLap ? __fadd_rn(sw, lap) : sw;
  }
}

}  // namespace

extern "C" {

// dz (B, T, d) on `stream`: the SW half where g_sw is not null (proj,
// rank, prior_q (W, M) and dirs (M, d), W = B*T), the Laplacian half where
// g_tot is not null (z, mask (B, T), g_tot[b * g_stride]); at least one.
// Returns the launch's error (0 on success), which the caller checks,
// because a refused launch never runs.
int hybrid_reg_bwd_f32(const float* z, const float* mask, const float* g_tot,
                       long long g_stride, int k, const float* g_sw,
                       const float* proj, const int* rank,
                       const float* prior_q, const float* dirs, float* dz,
                       int B, int T, int d, int M, cudaStream_t stream) {
  const bool sw = g_sw != nullptr, lap = g_tot != nullptr;
  const long long W = static_cast<long long>(B) * T;
  if ((!sw && !lap) || B <= 0 || T <= 0 || d <= 0 || k < 0 ||
      (sw && M <= 0) || W >= (1LL << 31) ||
      (d + kCols - 1) / kCols > kMaxColTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = k < T - 1 ? k : T - 1;
  const dim3 grid(static_cast<unsigned>((W + kRows - 1) / kRows),
                  static_cast<unsigned>((d + kCols - 1) / kCols));
  const int w = static_cast<int>(W);
  if (sw && lap) {
    hybrid_reg_bwd_kernel<true, true><<<grid, kThreads, 0, stream>>>(
        z, mask, g_tot, g_stride, T, K, g_sw, proj, rank, prior_q, dirs, dz,
        w, d, M);
  } else if (sw) {
    hybrid_reg_bwd_kernel<true, false><<<grid, kThreads, 0, stream>>>(
        z, mask, g_tot, g_stride, T, K, g_sw, proj, rank, prior_q, dirs, dz,
        w, d, M);
  } else {
    hybrid_reg_bwd_kernel<false, true><<<grid, kThreads, 0, stream>>>(
        z, mask, g_tot, g_stride, T, K, g_sw, proj, rank, prior_q, dirs, dz,
        w, d, M);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hybrid_reg_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
