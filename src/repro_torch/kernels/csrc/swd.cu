// Per-session sliced-Wasserstein distance to a sorted prior, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `swd_pallas` / `_kernel` in
// src/repro/kernels/swd_kernel.py, batched over the fleet's sessions.  For
// each session s of z (S, W, d), against directions dirs (M, d) and the
// prior's sorted slice quantiles prior_q (W, M):
//   proj   = z[s] @ dirs^T                      (W, M)
//   sorted = each column of proj sorted ascending
//   out[s] = sum over the W rows and M columns of (sorted - prior_q)^2,
//            divided by W*M
// which is the refine round's SW term (`fleet_refiner.py`: the mean of
// (bitonic_diff_sort(z @ dirs^T) - prior_q)^2) and `swd_pallas`'s sum over
// valid rows divided by valid_n*M.  Gap frames (z = 0) are not excluded:
// the reference does not mask the SW term either.
//
// Bound: 2*S*W*d*M flops of projection against S*W*d*4 bytes of z.  At the
// refine shape (S=256, W=100, d=128, M=50) that is 328 MFLOP, 4.9 us at the
// card's 67 TFLOP/s float32 rate, above the 3.9 us that reading z takes at
// 3.35 TB/s: operations bound it.  The sort network's compares come on top.
//
// Design (simple and right first): grid (S, ceil(M/kDirs)); a block owns
// kDirs directions of one session.  It stages the directions and, chunk by
// chunk of kChunk columns, the session's z rows in shared memory, and each
// thread accumulates its (direction, frame) dot products with fmaf in a fixed
// order over d.  Each column is padded to P = next power of two >= W with
// +3.0e38 sentinels, which sort after every finite projection, and a bitonic
// network sorts the kDirs columns in shared memory with a __syncthreads
// between stages.  The W real rows (never the sentinels) and the real
// directions (never the zero-filled tail of the last block) are summed in a
// fixed tree into one partial per block; a second launch sums each
// session's partials in block order.  No atomics anywhere, so the result is
// the same bits from run to run.  Shared memory is dynamic
// (4*(kDirs*d + kDirs*P + W*(kChunk+1)) bytes, 21 KB at the refine shape).
//
// The edge trainer differentiates the SW term of one point set, so two more
// entry points serve it (`swd_rank_fwd_f32`, `swd_rank_bwd_f32`).  The
// forward projects x (W, d) on dirs (M, d), sorts each column as (value,
// row) pairs, so that ties break by row index as torch.sort(stable=True)
// and the reference's jnp.argsort break them, and writes the loss
// sum (sorted - prior_q)^2 / (W*M), the projections proj (W, M) and each
// row's rank in its column (W, M) int32.  The backward (no Pallas
// counterpart: the reference differentiates the jnp twin) writes
//   dx[i] = sum over m of 2*g*(proj[i, m] - prior_q[rank[i, m], m])/(W*M)
//           * dirs[m]
// one block per row, the row's M weights staged in shared memory, each
// thread one column of dx summing over m in order.  Ties are the normal
// case there: the edge trainer's buffer starts as 96 identical rows.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDirs = 8;
constexpr int kChunk = 32;
constexpr float kBig = 3.0e38f;
constexpr int kBwdThreads = 128;

__global__ void __launch_bounds__(kThreads)
swd_partial_kernel(const float* __restrict__ z,
                   const float* __restrict__ dirs,
                   const float* __restrict__ prior_q,
                   float* __restrict__ partial, int W, int P, int d, int M) {
  extern __shared__ float smem[];
  float* ds = smem;                     // kDirs x d
  float* cols = ds + kDirs * d;         // kDirs x P, one column per direction
  float* zc = cols + kDirs * P;         // W x (kChunk + 1)
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kDirs;
  const float* zs = z + static_cast<size_t>(blockIdx.x) * W * d;

  for (int i = tid; i < kDirs * d; i += kThreads) {
    const int m = i / d;
    ds[i] = (m0 + m < M) ? dirs[static_cast<size_t>(m0) * d + i] : 0.0f;
  }
  for (int i = tid; i < kDirs * P; i += kThreads) {
    cols[i] = (i % P < W) ? 0.0f : kBig;
  }
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    const int cw = min(kChunk, d - c0);
    __syncthreads();               // the previous chunk has been consumed
    for (int i = tid; i < W * kChunk; i += kThreads) {
      const int t = i / kChunk, j = i % kChunk;
      zc[t * (kChunk + 1) + j] =
          (j < cw) ? zs[static_cast<size_t>(t) * d + c0 + j] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < kDirs * W; e += kThreads) {
      const int m = e / W, t = e % W;
      const float* zr = zc + t * (kChunk + 1);
      const float* dr = ds + m * d + c0;
      float acc = cols[m * P + t];
      for (int j = 0; j < cw; ++j) acc = fmaf(zr[j], dr[j], acc);
      cols[m * P + t] = acc;
    }
  }
  __syncthreads();

  // bitonic network, ascending, on each of the kDirs columns
  const int half = P / 2;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < kDirs * half; q += kThreads) {
        const int m = q / half, p = q % half;
        const int i = 2 * j * (p / j) + p % j;     // bit j of i is clear
        float* col = cols + m * P;
        const float a = col[i], b = col[i + j];
        if ((a > b) == ((i & k) == 0)) {
          col[i] = b;
          col[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  float acc = 0.0f;
  for (int e = tid; e < kDirs * W; e += kThreads) {
    const int m = e / W, t = e % W;
    if (m0 + m < M) {
      const float q = prior_q[static_cast<size_t>(t) * M + m0 + m];
      const float diff = __fsub_rn(cols[m * P + t], q);
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (tid % 32 == 0) red[tid / 32] = acc;
  __syncthreads();
  if (tid == 0) {
    float sum = red[0];
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, red[w]);
    partial[static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y] = sum;
  }
}

__global__ void swd_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int S, int G,
                                  float count) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const float* ps = partial + static_cast<size_t>(s) * G;
  float sum = ps[0];
  for (int g = 1; g < G; ++g) sum = __fadd_rn(sum, ps[g]);
  out[s] = __fdiv_rn(sum, count);
}


// The forward of the edge trainer's SW term: grid ceil(M / kDirs), as
// swd_partial_kernel for one session, with the row index carried beside
// each value through the network and compared when values tie.
__global__ void __launch_bounds__(kThreads)
swd_rank_partial_kernel(const float* __restrict__ x,
                        const float* __restrict__ dirs,
                        const float* __restrict__ prior_q,
                        float* __restrict__ proj, int* __restrict__ rank,
                        float* __restrict__ partial, int W, int P, int d,
                        int M) {
  extern __shared__ float smem[];
  float* ds = smem;                     // kDirs x d
  float* cols = ds + kDirs * d;         // kDirs x P values
  int* rows = reinterpret_cast<int*>(cols + kDirs * P);   // kDirs x P
  float* xc = reinterpret_cast<float*>(rows + kDirs * P); // W x (kChunk+1)
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kDirs;
  for (int i = tid; i < kDirs * d; i += kThreads) {
    const int m = i / d;
    ds[i] = (m0 + m < M) ? dirs[static_cast<size_t>(m0) * d + i] : 0.0f;
  }
  for (int i = tid; i < kDirs * P; i += kThreads) {
    cols[i] = (i % P < W) ? 0.0f : kBig;
    rows[i] = i % P;
  }
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    const int cw = min(kChunk, d - c0);
    __syncthreads();
    for (int i = tid; i < W * kChunk; i += kThreads) {
      const int t = i / kChunk, j = i % kChunk;
      xc[t * (kChunk + 1) + j] =
          (j < cw) ? x[static_cast<size_t>(t) * d + c0 + j] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < kDirs * W; e += kThreads) {
      const int m = e / W, t = e % W;
      const float* xr = xc + t * (kChunk + 1);
      const float* dr = ds + m * d + c0;
      float acc = cols[m * P + t];
      for (int j = 0; j < cw; ++j) acc = fmaf(xr[j], dr[j], acc);
      cols[m * P + t] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < kDirs * W; e += kThreads) {
    const int m = e / W, t = e % W;
    if (m0 + m < M) proj[static_cast<size_t>(t) * M + m0 + m] = cols[m * P + t];
  }

  // bitonic network, ascending in (value, row)
  const int half = P / 2;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int q = tid; q < kDirs * half; q += kThreads) {
        const int m = q / half, p = q % half;
        const int i = 2 * j * (p / j) + p % j;     // bit j of i is clear
        float* col = cols + m * P;
        int* row = rows + m * P;
        const float a = col[i], b = col[i + j];
        const int ra = row[i], rb = row[i + j];
        const bool greater = a > b || (a == b && ra > rb);
        if (greater == ((i & k) == 0)) {
          col[i] = b;
          col[i + j] = a;
          row[i] = rb;
          row[i + j] = ra;
        }
      }
    }
  }
  __syncthreads();

  float acc = 0.0f;
  for (int e = tid; e < kDirs * W; e += kThreads) {
    const int m = e / W, r = e % W;
    if (m0 + m < M) {
      const float q = prior_q[static_cast<size_t>(r) * M + m0 + m];
      const float diff = __fsub_rn(cols[m * P + r], q);
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      rank[static_cast<size_t>(rows[m * P + r]) * M + m0 + m] = r;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (tid % 32 == 0) red[tid / 32] = acc;
  __syncthreads();
  if (tid == 0) {
    float sum = red[0];
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, red[w]);
    partial[blockIdx.x] = sum;
  }
}

// dx for one row per block; g is the loss's cotangent (one float).
__global__ void __launch_bounds__(kBwdThreads)
swd_rank_bwd_kernel(const float* __restrict__ g,
                    const float* __restrict__ proj,
                    const int* __restrict__ rank,
                    const float* __restrict__ prior_q,
                    const float* __restrict__ dirs, float* __restrict__ dx,
                    int W, int d, int M) {
  extern __shared__ float gp[];         // M weights of this row
  const int i = blockIdx.x;
  const float g2 = __fmul_rn(2.0f, g[0]);
  const float count = static_cast<float>(W) * static_cast<float>(M);
  for (int m = threadIdx.x; m < M; m += kBwdThreads) {
    const size_t o = static_cast<size_t>(i) * M + m;
    const float q = prior_q[static_cast<size_t>(rank[o]) * M + m];
    gp[m] = __fdiv_rn(__fmul_rn(g2, __fsub_rn(proj[o], q)), count);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += kBwdThreads) {
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) {
      acc = fmaf(gp[m], dirs[static_cast<size_t>(m) * d + j], acc);
    }
    dx[static_cast<size_t>(i) * d + j] = acc;
  }
}

}  // namespace

extern "C" {

// Directions per block: the wrapper allocates S * ceil(M / this) partials.
int swd_dirs_per_block() { return kDirs; }

// Launches on `stream` and returns the first CUDA error (0 on success); the
// caller checks it, because a refused launch never runs.  `partial` is
// scratch of S * ceil(M / kDirs) floats.
int swd_sessions_f32(const float* z, const float* dirs, const float* prior_q,
                     float* partial, float* out, int S, int W, int d, int M,
                     cudaStream_t stream) {
  if (S <= 0 || W <= 0 || d <= 0 || M <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int P = 1;
  while (P < W) P <<= 1;
  const int G = (M + kDirs - 1) / kDirs;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kDirs) * d +
                                       static_cast<size_t>(kDirs) * P +
                                       static_cast<size_t>(W) * (kChunk + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  swd_partial_kernel<<<dim3(S, G), kThreads, smem, stream>>>(
      z, dirs, prior_q, partial, W, P, d, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swd_reduce_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, out, S, G, static_cast<float>(W) * static_cast<float>(M));
  return static_cast<int>(cudaGetLastError());
}

// The edge trainer's forward: `loss` (1 float), `proj` (W, M), `rank`
// (W, M) int32; `partial` is scratch of ceil(M / kDirs) floats.
int swd_rank_fwd_f32(const float* x, const float* dirs, const float* prior_q,
                     float* loss, float* proj, int* rank, float* partial,
                     int W, int d, int M, cudaStream_t stream) {
  if (W <= 0 || d <= 0 || M <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int P = 1;
  while (P < W) P <<= 1;
  const int G = (M + kDirs - 1) / kDirs;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kDirs) * d +
                                       2 * static_cast<size_t>(kDirs) * P +
                                       static_cast<size_t>(W) * (kChunk + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swd_rank_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  swd_rank_partial_kernel<<<G, kThreads, smem, stream>>>(
      x, dirs, prior_q, proj, rank, partial, W, P, d, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swd_reduce_kernel<<<1, kThreads, 0, stream>>>(
      partial, loss, 1, G, static_cast<float>(W) * static_cast<float>(M));
  return static_cast<int>(cudaGetLastError());
}

// The edge trainer's backward: `dx` (W, d) from the cotangent `g` (1 float)
// and the forward's `proj` and `rank`.
int swd_rank_bwd_f32(const float* g, const float* proj, const int* rank,
                     const float* prior_q, const float* dirs, float* dx,
                     int W, int d, int M, cudaStream_t stream) {
  if (W <= 0 || d <= 0 || M <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(M);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swd_rank_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  swd_rank_bwd_kernel<<<W, kBwdThreads, smem, stream>>>(g, proj, rank,
                                                        prior_q, dirs, dx, W,
                                                        d, M);
  return static_cast<int>(cudaGetLastError());
}

const char* swd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
