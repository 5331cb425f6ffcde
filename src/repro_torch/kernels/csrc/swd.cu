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
// Design: one block of 256 threads per session, two blocks an SM at the
// refine shape (105.6 KB of shared memory each), so the 256 sessions run
// in one wave.  The block stages the session's z and the directions once,
// with cp.async, in chunks of DC columns of d (one chunk at d = 128; the
// plan shrinks DC, and takes the directions in groups of MG, only where
// shared memory would overflow).  The projection is a register-tiled
// product: thread (tx, ty) of a 16 x 16 grid keeps a 7 x 4 tile of (frame
// ty + 16i, direction tx + 16j) sums over d in order (fmaf), so each
// float4 it loads from shared memory feeds 16 or 28 FMAs; the sums are
// carried across chunks through shared memory.  The (W, M) projections
// land column by column in shared memory, and the warps sort whole columns
// in registers: a column padded to P (the next power of two >= W, at
// least 32) with +3.0e38 sentinels sits on LANES lanes of a warp (16
// values a lane, on 8 to 32 lanes: 8 at the refine shape, four columns a
// warp at once), lane l of the column holding positions lV .. lV+V-1;
// strides below V inside the thread and the others by __shfl_xor_sync,
// the network in its ascending form (no pair needs a direction); no
// barrier inside the network.  The same block then sums (sorted -
// prior_q)^2 over the W real positions in a fixed order (each lane over
// its columns and values, a fixed xor tree, the warps in order) and writes
// out[s]: one launch, no atomics, the same bits from run to run.  P runs
// to 2,048 (W <= 2,048).
//
// The edge trainer and the LM trainer differentiate the SW term of one
// point set, so one more entry point serves them (`swd_rank_fwd_f32`; the
// backward is `hybrid_reg_bwd.cu` with its SW half alone).  It projects x
// (W, d) on dirs (M, d), sorts each column as (value, row) pairs, so that
// ties break by row index as torch.sort(stable=True) and the reference's
// jnp.argsort break them, and writes the loss sum (sorted - prior_q)^2 /
// (W*M), the projections proj (W, M) and each row's rank in its column
// (W, M) int32.  Ties are the normal case there: the edge trainer's buffer
// starts as 96 identical rows, whose projections are bitwise equal because
// every row's sum runs in the same order.  Design: one block of 128 threads per direction (32 blocks
// on the edge learner, 50 on the LM step), each streaming x over d in
// chunks through a two-stage cp.async ring (the LM step's x is 512 KB at
// d = 1,024 and does not fit in shared memory); thread t sums rows t,
// t + 128, ... in order over d.  Warp 0 sorts the column with the same
// network on (value, row) pairs, writes the ranks and the column's partial
// loss.  A second one-block kernel, launched as a programmatic dependent
// (Hopper), sums the M partials in direction order into the loss.  V runs
// to 32 (W <= 1,024).
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 256;           // swd_sessions: a 16 x 16 grid
constexpr int kWarps = kThreads / 32;
constexpr int kTX = kThreads / 16;      // the 16 x kTX grid
constexpr int kTR = 7;                  // projection tile: frames a thread
constexpr int kDirsPerPass = 64;
constexpr int kTC = kDirsPerPass / kTX; // and directions a thread
constexpr int kRowsPerPass = 16 * kTR;  // 112 frames
constexpr int kValuesPerLane = 16;      // swd_sessions: a column's values
                                        // a lane, on 8 to 32 lanes
constexpr int kRankThreads = 128;
constexpr int kRankLanes = 32;          // swd_rank_fwd: lanes a column
constexpr int kRankMaxV = 32;           // swd_rank_fwd: P <= 1,024
constexpr int kSmemCap = 227 * 1024;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, R) x columns [c0, c0 + cw) of the row-major (R, d) matrix src
// into dst (pitch floats a row) by cp.async, the columns from cw up to the
// next multiple of 4 zero-filled; 16-byte copies where `vec` (d % 4 == 0
// and src on 16 bytes), else 4-byte ones.  The caller commits the group.
__device__ __forceinline__ void stage(float* dst, const float* src, int R,
                                      int d, int c0, int cw, int pitch,
                                      bool vec) {
  if (vec) {
    const int q = cw / 4;
    for (int i = threadIdx.x; i < R * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      cp_async16(dst + r * pitch + c, src + static_cast<size_t>(r) * d + c0 +
                                          c);
    }
  } else {
    const int cw4 = (cw + 3) & ~3;
    for (int i = threadIdx.x; i < R * cw4; i += blockDim.x) {
      const int r = i / cw4, c = i % cw4;
      if (c < cw) {
        cp_async4(dst + r * pitch + c, src + static_cast<size_t>(r) * d +
                                           c0 + c);
      } else {
        dst[r * pitch + c] = 0.0f;
      }
    }
  }
}

template <int V>
struct Log2 {
  static constexpr int value = 1 + Log2<V / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// (a, ra) after (b, rb) in ascending (value, row) order
__device__ __forceinline__ bool after(float a, int ra, float b, int rb) {
  return a > b || (a == b && ra > rb);
}

// Compare-and-exchange of two of one thread's pairs: the smaller (in
// (value, row) order with ROWS) to (a, ra)
template <bool ROWS>
__device__ __forceinline__ void cas(float& a, float& b, int& ra, int& rb) {
  if constexpr (ROWS) {
    if (after(a, ra, b, rb)) {
      const float t = a;
      a = b;
      b = t;
      const int u = ra;
      ra = rb;
      rb = u;
    }
  } else {
    const float lo = fminf(a, b);
    b = fmaxf(a, b);
    a = lo;
  }
}

// The strides j < V of a merge, inside each thread (all ascending)
template <int V, int LJ, bool ROWS>
__device__ __forceinline__ void thread_stages(float (&v)[V], int (&r)[V]) {
#pragma unroll
  for (int lj = LJ; lj >= 0; --lj) {
    const int j = 1 << lj;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if ((i & j) == 0) cas<ROWS>(v[i], v[i | j], r[i], r[i | j]);
    }
  }
}

// One stage across lanes: register i against the partner lane's register
// i, or V - 1 - i in a merge's first stage (FLIP); the lane holding the
// lower positions keeps the smaller of each pair
template <int V, bool ROWS, bool FLIP>
__device__ __forceinline__ void lane_stage(float (&v)[V], int (&r)[V],
                                           int mask, bool keep_min) {
  float o[V];
  int ro[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int src = FLIP ? V - 1 - i : i;
    o[i] = __shfl_xor_sync(0xffffffffu, v[src], mask);
    if constexpr (ROWS) ro[i] = __shfl_xor_sync(0xffffffffu, r[src], mask);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (ROWS) {
      const bool take = keep_min ? after(v[i], r[i], o[i], ro[i])
                                 : after(o[i], ro[i], v[i], r[i]);
      if (take) {
        v[i] = o[i];
        r[i] = ro[i];
      }
    } else {
      v[i] = keep_min ? fminf(v[i], o[i]) : fmaxf(v[i], o[i]);
    }
  }
}

// Ascending sort of one column of P = LANES * V values held by LANES lanes
// of a warp (32 / LANES columns a warp at once), lane l of the column
// holding positions l*V .. l*V + V - 1 in v and, with ROWS, each value's
// row in r, compared as (value, row) so that ties break by row.  The
// bitonic network in its ascending form: each merge of width k first pairs
// position p with p ^ (k - 1), then p with p ^ j for j = k/4, ..., 1, the
// lower position always keeping the smaller, so no pair needs a direction.
// Pairs within a thread are compare-and-exchanges of two registers; pairs
// across lanes go by __shfl_xor_sync (a merge's first stage sends register
// V - 1 - i for register i).  No barrier: the warp's lanes run in step.
template <int V, int LANES, bool ROWS>
__device__ __forceinline__ void warp_sort(float (&v)[V], int (&r)[V],
                                          int lane) {
  constexpr int P = LANES * V;
  constexpr int LV = Log2<V>::value;
  const int cl = lane % LANES;          // the lane's place in its column
#pragma unroll
  for (int lk = 1; lk <= LV; ++lk) {    // merges of width k <= V
    const int k = 1 << lk;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if ((i & (k >> 1)) == 0) {
        cas<ROWS>(v[i], v[i ^ (k - 1)], r[i], r[i ^ (k - 1)]);
      }
    }
#pragma unroll
    for (int lj = lk - 2; lj >= 0; --lj) {   // strides k/4 .. 1
      const int j = 1 << lj;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if ((i & j) == 0) cas<ROWS>(v[i], v[i | j], r[i], r[i | j]);
      }
    }
  }
#pragma unroll 1
  for (int k = 2 * V; k <= P; k <<= 1) {  // the wider merges
    lane_stage<V, ROWS, true>(v, r, k / V - 1, (cl & (k / (2 * V))) == 0);
#pragma unroll 1
    for (int j = k >> 2; j >= V; j >>= 1) {
      lane_stage<V, ROWS, false>(v, r, j / V, (cl & (j / V)) == 0);
    }
    thread_stages<V, LV - 1, ROWS>(v, r);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// One pass of the projection over the staged chunk: frames r0 .. r0 + 111
// and directions g0 .. g0 + 63 of the group.  Thread (tx, ty) keeps a
// kTR x kTC tile of sums, frames r0 + ty + 16i and directions g0 + tx +
// kTX j, each over the chunk's columns in order (fmaf), so each float4 of
// a direction it loads feeds 4*kTR FMAs and each of a frame 4*kTC.  The
// sums land in cols (direction-major, pitch cp), carried from the earlier
// chunks unless `first`.  A thread reads and writes only its own tile of
// cols, so passes need no barrier between them.
__device__ __forceinline__ void project_pass(const float* zs,
                                             const float* ds, float* cols,
                                             int pitch, int cp, int cw4,
                                             int r0, int g0, int W, int mg,
                                             bool first) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  float acc[kTR][kTC];
  const float* zr[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + ty + 16 * i;
    zr[i] = zs + min(r, W - 1) * pitch;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int m = g0 + tx + kTX * j;
      acc[i][j] = (first || r >= W || m >= mg) ? 0.0f : cols[m * cp + r];
    }
  }
  int dr[kTC];                          // the directions' rows in ds
#pragma unroll
  for (int j = 0; j < kTC; ++j) {
    dr[j] = min(g0 + tx + kTX * j, mg - 1) * pitch;
  }
  for (int k = 0; k < cw4; k += 4) {
    float4 a[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      a[i] = *reinterpret_cast<const float4*>(zr[i] + k);
    }
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(ds + dr[j] + k);
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        acc[i][j] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int m = g0 + tx + kTX * j;
      if (r < W && m < mg) cols[m * cp + r] = acc[i][j];
    }
  }
}

// The V values of lane `lane` of a column (positions past W are the
// +3.0e38 sentinel); col is 16-byte aligned
template <int V>
__device__ __forceinline__ void load_column(float (&v)[V], const float* col,
                                            int lane, int W) {
  const int p0 = lane * V;
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(col + p0 + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = col[p0 + i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (p0 + i >= W) v[i] = kBig;
  }
}

template <int V, int LANES>
__global__ void __launch_bounds__(kThreads, 2)
swd_sessions_kernel(const float* __restrict__ z,
                    const float* __restrict__ dirs,
                    const float* __restrict__ prior_q,
                    float* __restrict__ out, int W, int d, int M, int DC,
                    int MG, bool vec) {
  constexpr int P = LANES * V;
  constexpr int kCols = 32 / LANES;     // columns a warp sorts at once
  constexpr int cp = P + 4;             // column pitch: 2-way stores at most
  extern __shared__ __align__(16) float smem[];
  const int pitch = DC + 4;             // float4 rows, odd in 16-byte units
  float* zs = smem;                     // W x pitch: the session's z chunk
  float* ds = zs + W * pitch;           // MG x pitch: the directions' chunk
  float* cols = ds + MG * pitch;        // MG x cp: the projections
  __shared__ float red[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* zsrc = z + static_cast<size_t>(blockIdx.x) * W * d;

  float part = 0.0f;                    // this lane's (sorted - q)^2, in order
  for (int m0 = 0; m0 < M; m0 += MG) {
    const int mg = min(MG, M - m0);
    for (int c0 = 0; c0 < d; c0 += DC) {
      const int cw = min(DC, d - c0);
      __syncthreads();                  // the last chunk or group is consumed
      stage(zs, zsrc, W, d, c0, cw, pitch, vec);
      stage(ds, dirs + static_cast<size_t>(m0) * d, mg, d, c0, cw, pitch,
            vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int cw4 = (cw + 3) & ~3;
      for (int r0 = 0; r0 < W; r0 += kRowsPerPass) {
        for (int g0 = 0; g0 < mg; g0 += kDirsPerPass) {
          project_pass(zs, ds, cols, pitch, cp, cw4, r0, g0, W, mg, c0 == 0);
        }
      }
    }
    __syncthreads();                    // the group's projections are in
    const int cl = lane % LANES;        // the lane's place in its column
    for (int c0 = warp * kCols; c0 < mg; c0 += kWarps * kCols) {
      // a column past mg sorts sentinels beside the others, unsummed
      const int c = c0 + lane / LANES;
      const bool real = c < mg;
      float v[V], q[V];
      int unused[V];
      load_column<V>(v, cols + min(c, mg - 1) * cp, cl, real ? W : 0);
#pragma unroll
      for (int i = 0; i < V; ++i) {   // issued before the sort needs them
        const int pos = cl * V + i;
        q[i] = real && pos < W
                   ? prior_q[static_cast<size_t>(pos) * M + m0 + c]
                   : 0.0f;
      }
      warp_sort<V, LANES, false>(v, unused, lane);
      if (real) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (cl * V + i < W) {
            const float diff = __fsub_rn(v[i], q[i]);
            part = __fadd_rn(part, __fmul_rn(diff, diff));
          }
        }
      }
    }
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = red[0];
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, red[w]);
    out[blockIdx.x] = __fdiv_rn(sum, static_cast<float>(W) *
                                         static_cast<float>(M));
  }
}

// The M partials summed in direction order, over count, into loss[0]
__device__ __forceinline__ void sum_partials(const float* partial,
                                             float* loss, int M,
                                             float count) {
  float sum = partial[0];
  for (int m0 = 1; m0 < M; m0 += 8) {
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = m0 + i < M ? partial[m0 + i] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (m0 + i < M) sum = __fadd_rn(sum, p[i]);
    }
  }
  loss[0] = __fdiv_rn(sum, count);
}

// The edge trainer's forward, one block per direction m: x streamed over d
// through a two-stage ring of DC-column chunks (one stage when d <= DC),
// each row's sum carried in col[] across chunks; then warp 0 sorts the
// column as (value, row) pairs, writes the ranks and the partial loss.
template <int V>
__global__ void __launch_bounds__(kRankThreads)
swd_rank_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                const float* __restrict__ prior_q, float* __restrict__ proj,
                int* __restrict__ rank, float* partial, int W, int d,
                int M, int DC, bool vec) {
  constexpr int P = kRankLanes * V;
  extern __shared__ __align__(16) float smem[];
  const int pitch = DC + 4;
  const int d4 = (d + 3) & ~3;
  float* col = smem;                    // P: the column's projections
  float* ds = col + P;                  // d4: direction m
  float* xs = ds + d4;                  // 2 x W x pitch: the ring
  const int m = blockIdx.x, tid = threadIdx.x;
  // the loss pass may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const float* dm = dirs + static_cast<size_t>(m) * d;
  for (int j = tid; j < d4; j += kRankThreads) ds[j] = j < d ? dm[j] : 0.0f;
  const int chunks = (d + DC - 1) / DC;
  stage(xs, x, W, d, 0, min(DC, d), pitch, vec);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * DC, cw = min(DC, d - c0);
    if (c + 1 < chunks) {
      const int n0 = c0 + DC;
      stage(xs + ((c + 1) & 1) * W * pitch, x, W, d, n0, min(DC, d - n0),
            pitch, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // chunk c (and ds) are in
    const float* xb = xs + (c & 1) * W * pitch;
    const int cw4 = (cw + 3) & ~3;
    for (int r = tid; r < W; r += kRankThreads) {
      const float* xr = xb + r * pitch;
      const float* dr = ds + c0;
      float s = c == 0 ? 0.0f : col[r];
#pragma unroll 4
      for (int k = 0; k < cw4; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(xr + k);
        const float4 b = *reinterpret_cast<const float4*>(dr + k);
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
      col[r] = s;
    }
    __syncthreads();                    // chunk c is consumed
  }
  for (int r = tid; r < W; r += kRankThreads) {
    proj[static_cast<size_t>(r) * M + m] = col[r];
  }
  if (tid < 32) {                       // warp 0 sorts the column
    // lanes past kRankLanes (none unless a column takes fewer than 32)
    // sort sentinels beside it and write nothing
    const int cl = tid % kRankLanes;
    const bool real = tid < kRankLanes;
    float v[V], q[V];
    int rows[V];
    load_column<V>(v, col, cl, real ? W : 0);
#pragma unroll
    for (int i = 0; i < V; ++i) {     // issued before the sort needs them
      const int pos = cl * V + i;
      rows[i] = pos;
      q[i] = real && pos < W ? prior_q[static_cast<size_t>(pos) * M + m]
                             : 0.0f;
    }
    warp_sort<V, kRankLanes, true>(v, rows, tid);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int pos = cl * V + i;
      if (real && pos < W) {
        const float diff = __fsub_rn(v[i], q[i]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        rank[static_cast<size_t>(rows[i]) * M + m] = pos;
      }
    }
    acc = warp_sum(acc);
    if (tid == 0) partial[m] = acc;
  }
}

// The loss: the M partials summed in direction order, over W*M.  Launched
// as a programmatic dependent of swd_rank_kernel.
__global__ void swd_rank_loss_kernel(const float* partial, float* loss,
                                     int M, float count) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (threadIdx.x == 0) sum_partials(partial, loss, M, count);
}

int pow2_at_least(int n, int lo) {
  int p = lo;
  while (p < n) p <<= 1;
  return p;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// swd_sessions' plan: the widest chunk of d (at most 128 columns, a
// multiple of 4) and then the largest group of directions (at most all M)
// whose shared memory fits; false if none does
bool sessions_plan(int W, int d, int M, int P, int* DC, int* MG,
                   size_t* smem) {
  const int d4 = (d + 3) & ~3;
  for (int dc = 128; dc >= 4; dc >>= 1) {
    const int c = min(dc, d4);
    for (int mg = M; mg >= 1; mg = mg > 8 ? (mg + 1) / 2 : mg - 1) {
      const size_t bytes = sizeof(float) *
                           (static_cast<size_t>(W + mg) * (c + 4) +
                            static_cast<size_t>(mg) * (P + 4));
      if (bytes <= static_cast<size_t>(kSmemCap)) {
        *DC = c;
        *MG = mg;
        *smem = bytes;
        return true;
      }
    }
  }
  return false;
}

// The lanes that sort a column of P values: kValuesPerLane values a lane,
// on at least 8 lanes (P = 32 and 64) and at most 32 (P >= 1,024)
constexpr int lanes_for(int P) {
  return P / kValuesPerLane < 8 ? 8
         : P / kValuesPerLane > 32 ? 32 : P / kValuesPerLane;
}

// The sessions kernel for a column of P (32 <= P <= 2,048) and its plan
template <int P>
struct Sessions {
  static constexpr int LANES = lanes_for(P), V = P / LANES;

  static cudaError_t launch(const float* z, const float* dirs,
                            const float* prior_q, float* out, int S, int W,
                            int d, int M, bool vec, cudaStream_t stream) {
    int DC = 0, MG = 0;
    size_t smem = 0;
    if (!sessions_plan(W, d, M, P, &DC, &MG, &smem)) {
      return cudaErrorInvalidValue;
    }
    const cudaError_t err = allow_smem(swd_sessions_kernel<V, LANES>, smem);
    if (err != cudaSuccess) return err;
    swd_sessions_kernel<V, LANES><<<S, kThreads, smem, stream>>>(
        z, dirs, prior_q, out, W, d, M, DC, MG, vec);
    return cudaGetLastError();
  }
};

// f.template operator()<Sessions<P>>() for the column length P of W
// (P = the next power of two >= W, at least 32); invalid past 2,048
template <typename F>
auto with_sessions(int W, F&& f) {
  switch (pow2_at_least(W, 32)) {
    case 32: return f(Sessions<32>());
    case 64: return f(Sessions<64>());
    case 128: return f(Sessions<128>());
    case 256: return f(Sessions<256>());
    case 512: return f(Sessions<512>());
    case 1024: return f(Sessions<1024>());
    case 2048: return f(Sessions<2048>());
    default: return f(nullptr);
  }
}

// swd_rank_fwd's plan: the widest chunk of d (at most 128 columns) whose
// ring (two stages when d needs more than one chunk) fits
bool rank_plan(int W, int d, int P, int* DC, size_t* smem) {
  const int d4 = (d + 3) & ~3;
  for (int dc = 128; dc >= 4; dc >>= 1) {
    const int c = min(dc, d4);
    const int stages = c < d4 ? 2 : 1;
    const size_t bytes =
        sizeof(float) * (static_cast<size_t>(P) + d4 +
                         static_cast<size_t>(stages) * W * (c + 4));
    if (bytes <= static_cast<size_t>(kSmemCap)) {
      *DC = c;
      *smem = bytes;
      return true;
    }
  }
  return false;
}

template <int V>
cudaError_t launch_rank(const float* x, const float* dirs,
                        const float* prior_q, float* loss, float* proj,
                        int* rank, float* partial, int W, int d, int M,
                        bool vec, cudaStream_t stream) {
  int DC = 0;
  size_t smem = 0;
  if (!rank_plan(W, d, kRankLanes * V, &DC, &smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(swd_rank_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  swd_rank_kernel<V><<<M, kRankThreads, smem, stream>>>(
      x, dirs, prior_q, proj, rank, partial, W, d, M, DC, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the loss pass is scheduled while the
  // direction blocks run, and waits in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, swd_rank_loss_kernel,
                            static_cast<const float*>(partial), loss, M,
                            static_cast<float>(W) * static_cast<float>(M));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success); the
// caller checks it, because a refused launch never runs.
int swd_sessions_f32(const float* z, const float* dirs, const float* prior_q,
                     float* out, int S, int W, int d, int M,
                     cudaStream_t stream) {
  if (S <= 0 || W <= 0 || d <= 0 || M <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 && aligned16(z) && aligned16(dirs);
  return static_cast<int>(with_sessions(W, [&](auto k) {
    if constexpr (std::is_same_v<decltype(k), std::nullptr_t>) {
      return cudaErrorInvalidValue;
    } else {
      return decltype(k)::launch(z, dirs, prior_q, out, S, W, d, M, vec,
                                 stream);
    }
  }));
}

// The edge trainer's forward: `loss` (1 float), `proj` (W, M), `rank`
// (W, M) int32; `partial` is scratch of M floats, one a direction.
int swd_rank_fwd_f32(const float* x, const float* dirs, const float* prior_q,
                     float* loss, float* proj, int* rank, float* partial,
                     int W, int d, int M, cudaStream_t stream) {
  if (W <= 0 || d <= 0 || M <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 && aligned16(x);
  const int V = pow2_at_least(W, kRankLanes) / kRankLanes;
  cudaError_t err;
  switch (V) {
    case 1: err = launch_rank<1>(x, dirs, prior_q, loss, proj, rank, partial,
                                 W, d, M, vec, stream); break;
    case 2: err = launch_rank<2>(x, dirs, prior_q, loss, proj, rank, partial,
                                 W, d, M, vec, stream); break;
    case 4: err = launch_rank<4>(x, dirs, prior_q, loss, proj, rank, partial,
                                 W, d, M, vec, stream); break;
    case 8: err = launch_rank<8>(x, dirs, prior_q, loss, proj, rank, partial,
                                 W, d, M, vec, stream); break;
    case 16: err = launch_rank<16>(x, dirs, prior_q, loss, proj, rank,
                                   partial, W, d, M, vec, stream); break;
    case kRankMaxV: err = launch_rank<kRankMaxV>(x, dirs, prior_q, loss,
                                                 proj, rank, partial, W, d,
                                                 M, vec, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* swd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
