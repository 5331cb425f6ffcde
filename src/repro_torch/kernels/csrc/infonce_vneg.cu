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
//
// Bound: both kernels stream z_neg (B*N*d floats) once, the backward
// writes dz_neg of the same size; 2 flops per element of z_neg each.  At
// the edge trainer's shape (B=8, N=264, d=128) that is 1.1 MB read,
// 0.3 us at 3.35 TB/s, against 8 ns of arithmetic at 67 TFLOP/s float32:
// bytes bound them, and at this size the launch itself (a few us) costs
// more than either.
//
// Design (simple and right first): one 512-thread block per sample, any B
// and N (no divisibility, unlike the Pallas grid).  z[b] is staged in
// shared memory.  The 16 warps take the negatives in a fixed round robin;
// for each one the 32 lanes read z_neg[n] coalesced, multiply-add in a
// fixed per-lane order and add in a fixed xor tree, so every lane holds
// s_n.  Forward: each warp keeps a running (m, l); thread 0 merges the
// warps' pairs in warp order into (m, l) seeded with (s+, 1), as the Pallas
// kernel seeds its scratch with the positive.  Backward, in the same one
// pass over z_neg: each warp, with p_n of its negative in hand, writes
// dz_neg[n] and adds p_n * z_neg[n] into its own row of partial sums in
// shared memory (lane j owns column j); then thread j adds the 16 warps'
// partials in warp order into dz[j].  No atomics, so both are the same bits
// from run to run.  Shared memory is dynamic: z and z_pos (2*d floats), and
// in the backward the warps' partial sums (16*d floats).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// z.row / tau over d, the lanes of one warp; every lane gets the result.
__device__ __forceinline__ float warp_dot(const float* __restrict__ zs,
                                          const float* __restrict__ row,
                                          int d, int lane, float tau) {
  float acc = 0.0f;
  for (int j = lane; j < d; j += 32) acc = fmaf(zs[j], row[j], acc);
  return __fdiv_rn(warp_sum(acc), tau);
}

// s+ of sample b computed by warp 0 into *pos (all threads see it after the
// barrier that follows).
__device__ __forceinline__ void positive(const float* zs, const float* zps,
                                         int d, float tau, float* pos) {
  if (threadIdx.x < 32) {
    const float s = warp_dot(zs, zps, d, threadIdx.x, tau);
    if (threadIdx.x == 0) *pos = s;
  }
}

__global__ void __launch_bounds__(kThreads)
infonce_fwd_kernel(const float* __restrict__ z, const float* __restrict__ zp,
                   const float* __restrict__ zn, float* __restrict__ loss,
                   float* __restrict__ lse, int N, int d, float tau) {
  extern __shared__ float smem[];
  float* zs = smem;            // d
  float* zps = zs + d;         // d
  __shared__ float wm[kWarps], wl[kWarps], pos;
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    zs[j] = z[static_cast<size_t>(b) * d + j];
    zps[j] = zp[static_cast<size_t>(b) * d + j];
  }
  __syncthreads();
  positive(zs, zps, d, tau, &pos);

  const float* znb = zn + static_cast<size_t>(b) * N * d;
  float m = kNegBig, l = 0.0f;
  for (int n = warp; n < N; n += kWarps) {
    const float s = warp_dot(zs, znb + static_cast<size_t>(n) * d, d, lane,
                             tau);
    const float m_new = fmaxf(m, s);
    l = __fadd_rn(__fmul_rn(l, expf(__fsub_rn(m, m_new))),
                  expf(__fsub_rn(s, m_new)));
    m = m_new;
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = pos, ll = 1.0f;             // exp(s+ - s+) = 1
    for (int w = 0; w < kWarps; ++w) {
      const float m_new = fmaxf(mm, wm[w]);
      ll = __fadd_rn(__fmul_rn(ll, expf(__fsub_rn(mm, m_new))),
                     __fmul_rn(wl[w], expf(__fsub_rn(wm[w], m_new))));
      mm = m_new;
    }
    const float out = __fadd_rn(mm, logf(ll));
    lse[b] = out;
    loss[b] = __fsub_rn(out, pos);
  }
}

__global__ void __launch_bounds__(kThreads)
infonce_bwd_kernel(const float* __restrict__ z, const float* __restrict__ zp,
                   const float* __restrict__ zn,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dz, float* __restrict__ dzp,
                   float* __restrict__ dzn, int N, int d, float tau) {
  extern __shared__ float smem[];
  float* zs = smem;            // d
  float* zps = zs + d;         // d
  float* acc = zps + d;        // kWarps x d: each warp's sum of p_n z_neg[n]
  __shared__ float pos;
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    zs[j] = z[static_cast<size_t>(b) * d + j];
    zps[j] = zp[static_cast<size_t>(b) * d + j];
  }
  for (int j = threadIdx.x; j < kWarps * d; j += kThreads) acc[j] = 0.0f;
  __syncthreads();
  positive(zs, zps, d, tau, &pos);
  const float lse_b = lse[b];
  const float c = __fdiv_rn(g[b], tau);

  const float* znb = zn + static_cast<size_t>(b) * N * d;
  float* dznb = dzn + static_cast<size_t>(b) * N * d;
  float* accw = acc + warp * d;
  for (int n = warp; n < N; n += kWarps) {
    const float* row = znb + static_cast<size_t>(n) * d;
    const float pn = expf(__fsub_rn(warp_dot(zs, row, d, lane, tau), lse_b));
    const float cp = __fmul_rn(c, pn);
    float* drow = dznb + static_cast<size_t>(n) * d;
    for (int j = lane; j < d; j += 32) {
      drow[j] = __fmul_rn(cp, zs[j]);
      accw[j] = fmaf(pn, row[j], accw[j]);
    }
  }
  __syncthreads();
  const float p0m1 = __fsub_rn(expf(__fsub_rn(pos, lse_b)), 1.0f);
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float a = acc[j];
    for (int w = 1; w < kWarps; ++w) a = __fadd_rn(a, acc[w * d + j]);
    const size_t o = static_cast<size_t>(b) * d + j;
    dz[o] = __fmul_rn(c, fmaf(p0m1, zps[j], a));
    dzp[o] = __fmul_rn(__fmul_rn(c, p0m1), zs[j]);
  }
}

size_t fwd_smem(int d) { return sizeof(float) * 2 * static_cast<size_t>(d); }

size_t bwd_smem(int d) {
  return sizeof(float) * (2 + kWarps) * static_cast<size_t>(d);
}

// Past the 48 KB that a launch gets by default, the kernel must opt in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the first CUDA error (0 on success);
// the caller checks it, because a refused launch never runs.

int infonce_vneg_fwd_f32(const float* z, const float* zp, const float* zn,
                         float* loss, float* lse, int B, int N, int d,
                         float tau, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || d <= 0 || !(tau > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fwd_smem(d);
  cudaError_t err = allow_smem(infonce_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  infonce_fwd_kernel<<<B, kThreads, smem, stream>>>(z, zp, zn, loss, lse, N,
                                                    d, tau);
  return static_cast<int>(cudaGetLastError());
}

int infonce_vneg_bwd_f32(const float* z, const float* zp, const float* zn,
                         const float* lse, const float* g, float* dz,
                         float* dzp, float* dzn, int B, int N, int d,
                         float tau, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || d <= 0 || !(tau > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_smem(d);
  cudaError_t err = allow_smem(infonce_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  infonce_bwd_kernel<<<B, kThreads, smem, stream>>>(z, zp, zn, lse, g, dz,
                                                    dzp, dzn, N, d, tau);
  return static_cast<int>(cudaGetLastError());
}

const char* infonce_vneg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
