// Diagonal-GMM posterior and its entropy, for Hopper (sm_90a).
//
// Replaces the TPU kernel `gmm_posterior_pallas` / `_kernel` in
// src/repro/kernels/gmm_posterior.py.  For z (B, d) against C components
// with means mu (C, d), variances var (C, d) and log weights logpi (C,):
//   lj[b,c]  = logpi[c] - 0.5 * (maha[b,c] + logdet[c] + d*log(2*pi))
//   maha     = sum_j (z[b,j] - mu[c,j])^2 / var[c,j]
//   logdet   = sum_j log var[c,j]
//   resp[b,c] = exp(lj - m) / s,  m = max_c lj,  s = sum_c exp(lj - m)
//   ent[b]   = -sum_c resp * (lj - m - log s)
// Mahalanobis is computed directly, as the refine path's reference
// (`gmm.log_joint`) does, not as the Pallas kernel's expansion
// z^2.inv - 2 z.(mu.inv) + mu^2.inv, which cancels catastrophically when a
// variance sits at its 1e-4 floor.
//
// Bound: the direct form takes 4 float operations (subtract, square,
// divide, add) per (b, c, j): 839 MFLOP at the refine shape (B=25,600,
// C=64, d=128), 12.5 us at 67 TFLOP/s float32, against 19.8 MB of z, resp
// and ent (5.9 us at 3.35 TB/s): operations bound it.
//
// Design (simple and right first): a block of 256 threads owns kRows rows
// and walks d in chunks of kChunk = 128 columns.  Each chunk stages its
// slice of mu and var (C x 129) and of the block's z rows (kRows x 129) in
// dynamic shared memory; the pitch of 129 puts the 32 components a warp
// reads at once in 32 banks.  One warp per component sums its
// log-variances, each lane over j = lane, lane+32, ... in order, and keeps
// its partial in shared memory across chunks; one thread per (row,
// component) sums its Mahalanobis terms over j in order, its accumulator
// kept in the (row, component) slot of the log-joint table across chunks.
// After the last chunk the lanes' log-variance partials meet in a fixed xor
// tree, and one warp per row takes the max, the sum of exponentials and the
// entropy with fixed xor trees.  The chunks reorder no sum, so the result
// does not depend on kChunk.  No atomics, so the result is the same bits
// from run to run.  Shared memory is 4*((2C + kRows)*129 + kRows*C + 33*C)
// bytes whatever d is: 99,200 at C = 64.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;
constexpr int kChunk = 128;
constexpr int kPitch = kChunk + 1;

__global__ void __launch_bounds__(kThreads)
gmm_posterior_kernel(const float* __restrict__ z,
                     const float* __restrict__ mu,
                     const float* __restrict__ var,
                     const float* __restrict__ logpi,
                     float* __restrict__ resp, float* __restrict__ ent,
                     int B, int C, int d, float d_log2pi) {
  extern __shared__ float smem[];
  float* mu_s = smem;                       // C x kPitch, one chunk
  float* var_s = mu_s + C * kPitch;         // C x kPitch
  float* z_s = var_s + C * kPitch;          // kRows x kPitch
  float* lj_s = z_s + kRows * kPitch;       // kRows x C: Mahalanobis, then lj
  float* part_s = lj_s + kRows * C;         // C x 32 lanes' log-var partials
  float* logdet_s = part_s + 32 * C;        // C

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);

  for (int i = tid; i < rows * C; i += kThreads) lj_s[i] = 0.0f;
  for (int i = tid; i < 32 * C; i += kThreads) part_s[i] = 0.0f;

  for (int j0 = 0; j0 < d; j0 += kChunk) {
    const int w = min(kChunk, d - j0);
    __syncthreads();                        // the last chunk is consumed
    for (int i = tid; i < C * w; i += kThreads) {
      const int c = i / w, j = i % w;
      mu_s[c * kPitch + j] = mu[static_cast<size_t>(c) * d + j0 + j];
      var_s[c * kPitch + j] = var[static_cast<size_t>(c) * d + j0 + j];
    }
    for (int i = tid; i < rows * w; i += kThreads) {
      const int r = i / w, j = i % w;
      z_s[r * kPitch + j] = z[static_cast<size_t>(row0 + r) * d + j0 + j];
    }
    __syncthreads();

    for (int c = warp; c < C; c += kWarps) {
      float acc = part_s[c * 32 + lane];
      for (int j = lane; j < w; j += 32) {
        acc = __fadd_rn(acc, logf(var_s[c * kPitch + j]));
      }
      part_s[c * 32 + lane] = acc;
    }

    for (int e = tid; e < rows * C; e += kThreads) {
      const int r = e / C, c = e % C;
      const float* zr = z_s + r * kPitch;
      const float* mr = mu_s + c * kPitch;
      const float* vr = var_s + c * kPitch;
      float maha = lj_s[e];
      for (int j = 0; j < w; ++j) {
        const float diff = __fsub_rn(zr[j], mr[j]);
        maha = __fadd_rn(maha, __fdiv_rn(__fmul_rn(diff, diff), vr[j]));
      }
      lj_s[e] = maha;
    }
  }
  __syncthreads();

  for (int c = warp; c < C; c += kWarps) {
    float acc = part_s[c * 32 + lane];
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) logdet_s[c] = acc;
  }
  __syncthreads();

  for (int e = tid; e < rows * C; e += kThreads) {
    const int c = e % C;
    const float inner = __fadd_rn(__fadd_rn(lj_s[e], logdet_s[c]), d_log2pi);
    lj_s[e] = __fsub_rn(logpi[c], __fmul_rn(0.5f, inner));
  }
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    const float* l = lj_s + r * C;
    float m = -CUDART_INF_F;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, l[c]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) {
      s = __fadd_rn(s, expf(__fsub_rn(l[c], m)));
    }
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    }
    const float log_s = logf(s);
    float h = 0.0f;
    float* out = resp + static_cast<size_t>(row0 + r) * C;
    for (int c = lane; c < C; c += 32) {
      const float shifted = __fsub_rn(l[c], m);
      const float p = __fdiv_rn(expf(shifted), s);
      out[c] = p;
      h = __fadd_rn(h, __fmul_rn(p, __fsub_rn(shifted, log_s)));
    }
    for (int off = 16; off > 0; off >>= 1) {
      h = __fadd_rn(h, __shfl_xor_sync(0xffffffffu, h, off));
    }
    if (lane == 0) ent[row0 + r] = -h;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success); the
// caller checks it, because a refused launch never runs.  d_log2pi is
// d*log(2*pi) rounded once to float32, as the reference's constant is.
int gmm_posterior_f32(const float* z, const float* mu, const float* var,
                      const float* logpi, float* resp, float* ent, int B,
                      int C, int d, float d_log2pi, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * ((2 * static_cast<size_t>(C) + kRows) * kPitch +
                       static_cast<size_t>(kRows) * C + 33 * C);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_posterior_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_posterior_kernel<<<(B + kRows - 1) / kRows, kThreads, smem, stream>>>(
      z, mu, var, logpi, resp, ent, B, C, d, d_log2pi);
  return static_cast<int>(cudaGetLastError());
}

const char* gmm_posterior_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
