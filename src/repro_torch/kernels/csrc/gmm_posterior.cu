// Diagonal-GMM posterior and its entropy, for Hopper (sm_90a).
//
// Replaces the TPU kernel `gmm_posterior_pallas` / `_kernel` in
// src/repro/kernels/gmm_posterior.py.  For z (B, d), float32 or bf16,
// against C components
// with means mu (C, d), variances var (C, d) and log weights logpi (C,):
//   lj[b,c]  = logpi[c] - 0.5 * (maha[b,c] + logdet[c] + d*log(2*pi))
//   maha     = sum_j (z[b,j] - mu[c,j])^2 / var[c,j]
//   logdet   = sum_j log var[c,j]
//   resp[b,c] = exp(lj - m) / s,  m = max_c lj,  s = sum_c exp(lj - m)
//   ent[b]   = -sum_c resp * (lj - m - log s)
// Mahalanobis is computed directly, as the refine path's reference
// (`gmm.log_joint`) does, not as the Pallas kernel's expansion
// z^2.inv - 2 z.(mu.inv) + mu^2.inv, which cancels catastrophically when a
// variance sits at its 1e-4 floor.  Each term is (z - mu)^2 times 1/var,
// the reciprocal rounded once per (c, j) as a block stages it: a rounding
// more than the quotient, far inside the tolerances (chip_smoke.py phase 3
// holds the floor case).  A bf16 z is staged as it is read, widened to
// float32 (exact), as the TPU kernel reads its tile `.astype(jnp.float32)`
// under float32 mu, var and logpi: the same plan and the same sums, so a
// bf16 z gives the bits of the float32 kernel on the widened z.
//
// Bound: the direct form takes 4 float operations (subtract, square,
// divide, add) per (b, c, j): 839 MFLOP at the refine shape (B=25,600,
// C=64, d=128), 12.5 us at 67 TFLOP/s float32, against 19.8 MB of z, resp
// and ent (5.9 us at 3.35 TB/s): operations bound it.  At the cascade's (8,
// 64, 1,024) and the edge learner's (96, 16, 128) the work is a few
// microseconds' worth of either, so a launch's latency bounds them.
//
// Design: two kernels, one call.
//   gmm_maha_kernel: the grid runs over (row tiles x component tiles x
//   splits of d).  A block of 256 threads, a 16 x 16 grid, owns RT = 16 TR
//   rows and CT = 16 TC components and walks its columns of d in chunks of
//   32, staged in shared memory (z rows, mu and 1/var, pitch 33); thread
//   (tx, ty) keeps a TR x TC register micro-tile of sums for rows ty + 16i
//   and components tx + 16k, so each z, mu and 1/var it loads serves TC, TR
//   and TR terms.  Each thread sums its terms over j in order; in the
//   blocks of the first row tile the threads also sum log var over the
//   chunk, 256 / CT threads a component meeting in a fixed xor tree.
//   Both go to scratch, a partial per split.
//   gmm_softmax_kernel: each block sums the log-determinant partials once,
//   then one warp per row adds the Mahalanobis partials of the splits in
//   order, forms lj in shared memory, and takes the max, the sum of
//   exponentials and the entropy with fixed xor trees.  It is launched as
//   a programmatic dependent of the first (Hopper), so its launch overlaps
//   the first's tail; it waits for the first's writes before it reads.
// The split of d is what fills the card when the rows are few (the
// cascade's 8 rows: 32 splits of 32 columns); at the refine shape the row
// tiles fill it but for a split in two, which keeps more blocks in flight
// (8 % faster than none: tools/gmm_variants.py).  The plan (plan() below) depends
// on the shape and the card's SM count only.  No atomics and a fixed order
// everywhere, so the result is the same bits from run to run.  Scratch:
// splits * (B * C + C) floats, which the wrapper allocates
// (gmm_posterior_scratch_floats).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // columns of d staged at once
constexpr int kPitch = kChunk + 1;
// the blocks the Mahalanobis pass aims at for each SM, and the most
// splits of d it takes to get there (each split adds a partial per (b, c)
// for the softmax pass to sum)
constexpr int kBlocksPerSM = 4;
constexpr int kMaxSplits = 32;

// bf16 z, as its bits: it widens to float32 exactly
struct bf16_t {
  unsigned short bits;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) {
  return __uint_as_float(static_cast<unsigned>(v.bits) << 16);
}

struct Plan {
  int tr, tc;              // micro-tile: rows and components a thread
  int row_tiles, comp_tiles, splits, cols;   // cols: columns a split
};

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0) {
    return 132;
  }
  return n;
}

// Tiles of 64 rows (16 where the rows are few) by 64 components (16 where
// they are few); d split until the blocks reach kBlocksPerSM per SM, into
// at most kMaxSplits.
Plan plan(int B, int C, int d) {
  Plan p;
  p.tr = B >= 64 ? 4 : 1;
  p.tc = C > 16 ? 4 : 1;
  p.row_tiles = (B + 16 * p.tr - 1) / (16 * p.tr);
  p.comp_tiles = (C + 16 * p.tc - 1) / (16 * p.tc);
  const long long tiles = static_cast<long long>(p.row_tiles) * p.comp_tiles;
  const int chunks = (d + kChunk - 1) / kChunk;
  const long long want = (kBlocksPerSM * static_cast<long long>(sm_count())
                          + tiles - 1) / tiles;
  const int splits = static_cast<int>(
      want < chunks ? (want < kMaxSplits ? want : kMaxSplits)
                    : (chunks < kMaxSplits ? chunks : kMaxSplits));
  p.cols = (chunks + splits - 1) / splits * kChunk;
  p.splits = (d + p.cols - 1) / p.cols;
  return p;
}

template <typename T, int TR, int TC>
__global__ void __launch_bounds__(kThreads)
gmm_maha_kernel(const T* __restrict__ z, const float* __restrict__ mu,
                const float* __restrict__ var, float* __restrict__ maha,
                float* __restrict__ logdet, int B, int C, int d, int cols) {
  constexpr int RT = 16 * TR, CT = 16 * TC;
  __shared__ float z_s[RT * kPitch];
  __shared__ float mu_s[CT * kPitch];
  __shared__ float inv_s[CT * kPitch];
  __shared__ float lv_s[CT * kPitch];

  // the log-variance sums: TPC threads a component, CPT columns each
  constexpr int TPC = kThreads / CT, CPT = kChunk / TPC;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * RT, c0 = blockIdx.y * CT;
  const int split = blockIdx.z, j_lo = split * cols;
  const int j_hi = min(d, j_lo + cols);
  const bool first_rows = blockIdx.x == 0;

  float acc[TR][TC], ld = 0.0f;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int k = 0; k < TC; ++k) acc[i][k] = 0.0f;
  }

  for (int j0 = j_lo; j0 < j_hi; j0 += kChunk) {
    const int w = min(kChunk, j_hi - j0);
    __syncthreads();                        // the last chunk is consumed
    // columns past w and rows or components past the ends stage as z = mu
    // = 0 and 1/var = 0: their terms are exactly 0
    for (int i = tid; i < RT * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i % kChunk, row = row0 + r;
      z_s[r * kPitch + j] =
          row < B && j < w ? widen(z[static_cast<size_t>(row) * d + j0 + j])
                           : 0.0f;
    }
    for (int i = tid; i < CT * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i % kChunk, c = c0 + r;
      const bool in = c < C && j < w;
      const size_t at = static_cast<size_t>(in ? c : 0) * d + j0 + j;
      const float vr = in ? var[at] : 1.0f;
      mu_s[r * kPitch + j] = in ? mu[at] : 0.0f;
      inv_s[r * kPitch + j] = in ? __frcp_rn(vr) : 0.0f;
      if (first_rows) lv_s[r * kPitch + j] = in ? logf(vr) : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      float zr[TR], m[TC], iv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) zr[i] = z_s[(ty + 16 * i) * kPitch + j];
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        m[k] = mu_s[(tx + 16 * k) * kPitch + j];
        iv[k] = inv_s[(tx + 16 * k) * kPitch + j];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int k = 0; k < TC; ++k) {
          const float diff = __fsub_rn(zr[i], m[k]);
          acc[i][k] = __fadd_rn(acc[i][k],
                                __fmul_rn(__fmul_rn(diff, diff), iv[k]));
        }
      }
    }
    if (first_rows) {
      // thread tid sums CPT columns of component tid / TPC in order, the
      // TPC threads of a component (neighbouring lanes) meet in a fixed
      // xor tree, and the first of them keeps the sum
      const float* lv = lv_s + (tid / TPC) * kPitch + (tid % TPC) * CPT;
      float x = lv[0];
#pragma unroll
      for (int j = 1; j < CPT; ++j) x = __fadd_rn(x, lv[j]);
#pragma unroll
      for (int off = TPC / 2; off > 0; off >>= 1) {
        x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
      }
      ld = __fadd_rn(ld, x);
    }
  }

  float* out = maha + static_cast<size_t>(split) * B * C;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= B) continue;
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      const int c = c0 + tx + 16 * k;
      if (c < C) out[static_cast<size_t>(row) * C + c] = acc[i][k];
    }
  }
  if (first_rows && tid % TPC == 0 && c0 + tid / TPC < C) {
    logdet[static_cast<size_t>(split) * C + c0 + tid / TPC] = ld;
  }
  // the softmax pass may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// MAXS bounds the splits: the combines below issue all MAXS - 1 loads of
// a sum before its adds, which a small MAXS keeps in few registers where
// many blocks run (the refine round's rows) and a large one serves the
// few rows of a heavily split d (the cascade's)
template <int MAXS>
__global__ void __launch_bounds__(kThreads)
gmm_softmax_kernel(const float* __restrict__ maha,
                   const float* __restrict__ logdet,
                   const float* __restrict__ logpi, float* __restrict__ resp,
                   float* __restrict__ ent, int B, int C, int splits,
                   float d_log2pi) {
  extern __shared__ float smem[];
  float* ld_s = smem;                        // C: the log-determinants
  float* lj_s = ld_s + C;                    // kWarps x C
  // launched early (programmatic dependent launch): wait for the
  // Mahalanobis pass to finish and its writes to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // the partials of the splits, in order (splits <= MAXS)
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float ldc = logdet[c];
#pragma unroll
    for (int s = 1; s < MAXS; ++s) {
      if (s < splits) {
        ldc = __fadd_rn(ldc, logdet[static_cast<size_t>(s) * C + c]);
      }
    }
    ld_s[c] = ldc;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;
  float* l = lj_s + warp * C;
  const size_t plane = static_cast<size_t>(B) * C;
  for (int c = lane; c < C; c += 32) {
    const float* mp = maha + static_cast<size_t>(row) * C + c;
    float mh = mp[0];
#pragma unroll
    for (int s = 1; s < MAXS; ++s) {
      if (s < splits) mh = __fadd_rn(mh, mp[s * plane]);
    }
    const float inner = __fadd_rn(__fadd_rn(mh, ld_s[c]), d_log2pi);
    l[c] = __fsub_rn(logpi[c], __fmul_rn(0.5f, inner));
  }
  __syncwarp();

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
  float* out = resp + static_cast<size_t>(row) * C;
  for (int c = lane; c < C; c += 32) {
    const float shifted = __fsub_rn(l[c], m);
    const float p = __fdiv_rn(expf(shifted), s);
    out[c] = p;
    h = __fadd_rn(h, __fmul_rn(p, __fsub_rn(shifted, log_s)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    h = __fadd_rn(h, __shfl_xor_sync(0xffffffffu, h, off));
  }
  if (lane == 0) ent[row] = -h;
}

template <int MAXS>
cudaError_t launch_softmax(const Plan& p, const float* maha,
                           const float* logdet, const float* logpi,
                           float* resp, float* ent, int B, int C,
                           float d_log2pi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kWarps + 1) * static_cast<size_t>(C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_softmax_kernel<MAXS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // programmatic dependent launch: the softmax pass is scheduled while the
  // Mahalanobis pass drains, and waits in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gmm_softmax_kernel<MAXS>, maha, logdet,
                            logpi, resp, ent, B, C, p.splits, d_log2pi);
}

template <typename T, int TR, int TC>
cudaError_t launch_maha(const Plan& p, const T* z, const float* mu,
                        const float* var, float* maha, float* logdet, int B,
                        int C, int d, cudaStream_t stream) {
  const dim3 grid(p.row_tiles, p.comp_tiles, p.splits);
  gmm_maha_kernel<T, TR, TC><<<grid, kThreads, 0, stream>>>(
      z, mu, var, maha, logdet, B, C, d, p.cols);
  return cudaGetLastError();
}

template <typename T>
int launch_posterior(const T* z, const float* mu, const float* var,
                     const float* logpi, float* resp, float* ent,
                     float* scratch, int B, int C, int d, float d_log2pi,
                     cudaStream_t stream) {
  if (B <= 0 || C <= 0 || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(B, C, d);
  if (p.comp_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* maha = scratch;
  float* logdet = scratch + static_cast<size_t>(p.splits) * B * C;
  cudaError_t err;
  if (p.tr == 4) {
    err = p.tc == 4 ? launch_maha<T, 4, 4>(p, z, mu, var, maha, logdet, B, C,
                                           d, stream)
                    : launch_maha<T, 4, 1>(p, z, mu, var, maha, logdet, B, C,
                                           d, stream);
  } else {
    err = p.tc == 4 ? launch_maha<T, 1, 4>(p, z, mu, var, maha, logdet, B, C,
                                           d, stream)
                    : launch_maha<T, 1, 1>(p, z, mu, var, maha, logdet, B, C,
                                           d, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      p.splits <= 4
          ? launch_softmax<4>(p, maha, logdet, logpi, resp, ent, B, C,
                              d_log2pi, stream)
          : launch_softmax<kMaxSplits>(p, maha, logdet, logpi, resp, ent, B,
                                       C, d_log2pi, stream));
}

}  // namespace

extern "C" {

// Floats of scratch that gmm_posterior_f32 needs for this shape on the
// current device (the partials of each split of d), or -1 if the shape is
// out of range.
long long gmm_posterior_scratch_floats(int B, int C, int d) {
  if (B <= 0 || C <= 0 || d <= 0) return -1;
  const Plan p = plan(B, C, d);
  return static_cast<long long>(p.splits) * (static_cast<long long>(B) * C +
                                             C);
}

// Launches both kernels on `stream` and returns the first CUDA error (0 on
// success); the caller checks it, because a refused launch never runs.
// scratch holds gmm_posterior_scratch_floats(B, C, d) floats.  d_log2pi is
// d*log(2*pi) rounded once to float32, as the reference's constant is.  z
// is float32 (_f32) or bf16 (_bf16); mu, var and logpi are float32.
int gmm_posterior_f32(const float* z, const float* mu, const float* var,
                      const float* logpi, float* resp, float* ent,
                      float* scratch, int B, int C, int d, float d_log2pi,
                      cudaStream_t stream) {
  return launch_posterior(z, mu, var, logpi, resp, ent, scratch, B, C, d,
                          d_log2pi, stream);
}

int gmm_posterior_bf16(const void* z, const float* mu, const float* var,
                       const float* logpi, float* resp, float* ent,
                       float* scratch, int B, int C, int d, float d_log2pi,
                       cudaStream_t stream) {
  return launch_posterior(static_cast<const bf16_t*>(z), mu, var, logpi,
                          resp, ent, scratch, B, C, d, d_log2pi, stream);
}

const char* gmm_posterior_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
