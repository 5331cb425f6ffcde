// Temporal Dirichlet energy per buffer row, for Hopper (sm_90a).
//
// Replaces the TPU kernel `laplacian_energy_pallas` / `_kernel` in
// src/repro/kernels/laplacian_energy.py.  For each row b of z (B, T, d) with
// validity mask (B, T) and K = min(k, T - 1):
//   tot[b] = sum over delta = 1..K and t = 0..T-delta-1 of
//            m[t] * m[t+delta] * ||z[t+delta] - z[t]||^2
//   cnt[b] = sum over the same pairs of m[t] * m[t+delta]
// which are the Pallas call's own per-row outputs.  The refine round's
// per-session Laplacian term is tot / max(cnt, 1) (`laplacian.py`'s
// `dirichlet_energy` of one session).
//
// Bound: every z element is read once and takes a few flops per pair it
// belongs to; at the refine shape (B=256, T=100, d=128, k=5) reading z's
// 13.1 MB takes 3.9 us at 3.35 TB/s against 0.7 us of arithmetic at
// 67 TFLOP/s float32: bytes bound it.  Each row's z (51 KB) is re-read up to
// 2k times by the block, from L1/L2.
//
// Design (simple and right first): one 256-thread block per row.  The
// row's (delta, t) pairs are dealt to the 8 warps in a fixed order; for each
// pair the 32 lanes read the two frames' d values coalesced, square the
// differences in a fixed per-lane order and add them in a fixed xor tree,
// so every lane holds the same squared distance.  Each warp keeps its own
// (tot, cnt); thread 0 adds the warps' sums in warp order.  No atomics and
// no shared state across blocks, so the result is the same bits from run to
// run.  k >= T (K clamps to T-1), T = 1 and rows with no valid frame all
// give tot = cnt = 0 without a special case.
//
// The edge trainer differentiates tot (`laplacian_energy_bwd_f32`; no Pallas
// counterpart, the reference differentiates the jnp twin
// `core/laplacian.py::dirichlet_energy`).  Given the cotangent g (B,):
//   dz[b, t] = 2 * g[b] * sum over delta = 1..K of
//              ( m[t] * m[t-delta] * (z[t] - z[t-delta])      if t >= delta
//              - m[t] * m[t+delta] * (z[t+delta] - z[t]) )    if t+delta < T
// cnt has no gradient.  One thread per element of z, the deltas in order,
// so it too is the same bits from run to run; it reads z about 2K+1 times
// (from L1/L2) and writes dz once: bytes bound it, 2*B*T*d*4 of them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
laplacian_energy_kernel(const float* __restrict__ z,
                        const float* __restrict__ mask,
                        float* __restrict__ tot, float* __restrict__ cnt,
                        int T, int d, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* zr = z + static_cast<size_t>(blockIdx.x) * T * d;
  const float* mr = mask + static_cast<size_t>(blockIdx.x) * T;
  float wt = 0.0f, wc = 0.0f;
  for (int delta = 1; delta <= K; ++delta) {
    for (int t = warp; t < T - delta; t += kWarps) {
      const float* a = zr + static_cast<size_t>(t) * d;
      const float* b = a + static_cast<size_t>(delta) * d;
      float acc = 0.0f;
      for (int j = lane; j < d; j += 32) {
        const float diff = __fsub_rn(b[j], a[j]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      }
      const float pair = __fmul_rn(mr[t], mr[t + delta]);
      wt = __fadd_rn(wt, __fmul_rn(acc, pair));
      wc = __fadd_rn(wc, pair);
    }
  }
  __shared__ float s_tot[kWarps], s_cnt[kWarps];
  if (lane == 0) {
    s_tot[warp] = wt;
    s_cnt[warp] = wc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float st = s_tot[0], sc = s_cnt[0];
    for (int w = 1; w < kWarps; ++w) {
      st = __fadd_rn(st, s_tot[w]);
      sc = __fadd_rn(sc, s_cnt[w]);
    }
    tot[blockIdx.x] = st;
    cnt[blockIdx.x] = sc;
  }
}

__global__ void __launch_bounds__(kThreads)
laplacian_energy_bwd_kernel(const float* __restrict__ z,
                            const float* __restrict__ mask,
                            const float* __restrict__ g,
                            float* __restrict__ dz, int T, int d, int K) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= T * d) return;
  const int t = e / d;
  const size_t row = static_cast<size_t>(blockIdx.y) * T;
  const float* zr = z + row * d;
  const float* mr = mask + row;
  const float zt = zr[e], mt = mr[t];
  float acc = 0.0f;
  for (int delta = 1; delta <= K; ++delta) {
    if (t >= delta) {
      const float pair = __fmul_rn(mr[t - delta], mt);
      acc = __fadd_rn(acc, __fmul_rn(pair, __fsub_rn(zt, zr[e - delta * d])));
    }
    if (t + delta < T) {
      const float pair = __fmul_rn(mt, mr[t + delta]);
      acc = __fsub_rn(acc, __fmul_rn(pair, __fsub_rn(zr[e + delta * d], zt)));
    }
  }
  dz[row * d + e] = __fmul_rn(__fmul_rn(2.0f, g[blockIdx.y]), acc);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller checks it, because a refused launch never runs.
int laplacian_energy_f32(const float* z, const float* mask, float* tot,
                         float* cnt, int B, int T, int d, int k,
                         cudaStream_t stream) {
  if (B <= 0 || T <= 0 || d <= 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = k < T - 1 ? k : T - 1;
  laplacian_energy_kernel<<<B, kThreads, 0, stream>>>(z, mask, tot, cnt, T,
                                                      d, K);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of tot: dz (B, T, d) from the cotangent g (B,); launches on
// `stream` and returns cudaGetLastError().
int laplacian_energy_bwd_f32(const float* z, const float* mask,
                             const float* g, float* dz, int B, int T, int d,
                             int k, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || d <= 0 || k < 0 || B > 65535 ||
      static_cast<long long>(T) * d >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = k < T - 1 ? k : T - 1;
  const dim3 grid((T * d + kThreads - 1) / kThreads, B);
  laplacian_energy_bwd_kernel<<<grid, kThreads, 0, stream>>>(z, mask, g, dz,
                                                             T, d, K);
  return static_cast<int>(cudaGetLastError());
}

const char* laplacian_energy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
