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
// 67 TFLOP/s float32: bytes bound it.  The instructions take longer than
// that count says: 15 a lane and pair, none fused (-fmad=false), about
// 2.1 us of the card's SIMT issue at the refine shape.
//
// Design.  A lane owns columns of d (a float4 of 4 columns where z is
// 16-byte aligned and d % 4 == 0, else one column), so the sum over d is
// left to the end: the lane walks frames in order and adds
// m[a] * m[b] * (its columns' share of ||z[b] - z[a]||^2) for every pair
// (a, b = a + delta) it owns into one float, and the block sums its lanes
// once, at the end, in a fixed tree.  A warp's task is one column slice
// (32 lanes) of one chunk of `frames` frames along t: the pairs whose
// later frame b lies in the chunk.  The lane keeps the last kRing frames
// it read (and their mask values) in a register ring, so for K <= kRing
// it reads each frame of its chunk plus a K-frame halo before it once,
// kBatch frames at a time, their loads in flight together; a larger K
// runs in groups of kRing deltas, each re-reading the chunk for its later
// ends.  A walk whose ring is full before its first pair tests no pair;
// one that starts near frame 0, or has fewer than kRing deltas, tests each
// (a >= 0, delta <= K).  Each row's tasks are dealt to the warps of a
// thread-block cluster of up to kMaxCluster blocks in a fixed order; the
// plan (`make_plan`) sizes chunks so that the grid holds about
// kTargetWarps warps: the refine round's 256 rows one block each (8
// chunks of 13 frames), the edge learner's one row a cluster of 7 blocks
// (52 chunks of 2), the LM step's 8 rows of d 1,024 8 blocks each (8
// slices x 8 chunks).  Sums: each lane's pairs in walk order (delta
// groups, later frames, deltas), the warp's lanes by an xor tree, the
// block's warps in order, and the cluster's blocks in rank order by the
// leader, into whose shared memory each block stores its partials through
// distributed shared memory; a warp's pair count task by task.  No
// atomics, no scratch, one launch, and the same bits from run to run.
// k >= T (K clamps to T-1), T = 1, k = 0 and rows with no valid frame
// give tot = cnt = 0 (no pair, or only zero-weight pairs) without a
// special case.  The choices it rejected (ring and batch sizes, blocks an
// SM, chunk and cluster sizes, checks on every pair, fused multiply-adds)
// are text patches in tools/laplacian_variants.py.
//
// The edge trainer differentiates tot: its gradient is `hybrid_reg_bwd.cu`
// with the Laplacian half alone (cnt has no gradient).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 5;           // frames a lane keeps: deltas a group
constexpr int kBatch = kRing;      // frames whose loads go together
constexpr int kMinFrames = 2;      // a chunk's fewest frames
constexpr int kTargetWarps = 2048;  // ~16 warps on each of 132 SMs
constexpr int kMaxCluster = 8;     // blocks of a row (the portable limit)

// How one launch cuts the rows: `vec` floats a lane (4 or 1), `slices`
// column slices of 32 lanes, `chunks` chunks of `frames` frames, and
// `cluster` blocks a row, whose warps take the row's slices x chunks
// tasks in order.
struct Plan {
  int vec, slices, frames, chunks, cluster;
};

Plan make_plan(int B, int T, int d, bool vec) {
  Plan p;
  p.vec = vec ? 4 : 1;
  p.slices = (d + 32 * p.vec - 1) / (32 * p.vec);
  // tasks a row that put about kTargetWarps warps on the card, and at
  // least a block's worth
  const int per_row = std::max(kTargetWarps / B, kWarps);
  const int chunks = std::max((per_row + p.slices - 1) / p.slices, 1);
  p.frames = std::max((T + chunks - 1) / chunks, kMinFrames);
  // a row's tasks beyond its cluster's warps: longer chunks instead
  const int cap = kMaxCluster * kWarps;
  if (p.slices * ((T + p.frames - 1) / p.frames) > cap) {
    const int fit = std::max(cap / p.slices, 1);
    p.frames = std::max(p.frames, (T + fit - 1) / fit);
  }
  p.chunks = (T + p.frames - 1) / p.frames;
  const int tasks = p.slices * p.chunks;
  p.cluster = std::min((tasks + kWarps - 1) / kWarps, kMaxCluster);
  return p;
}

template <int V>
struct Lanes;
template <>
struct Lanes<4> {
  using T = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // the lane's share of ||b - a||^2, in a fixed order
  static __device__ __forceinline__ float sq(float4 b, float4 a) {
    const float x = __fsub_rn(b.x, a.x), y = __fsub_rn(b.y, a.y);
    const float z = __fsub_rn(b.z, a.z), w = __fsub_rn(b.w, a.w);
    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                     __fadd_rn(__fmul_rn(z, z), __fmul_rn(w, w)));
  }
};
template <>
struct Lanes<1> {
  using T = float;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float sq(float b, float a) {
    const float x = __fsub_rn(b, a);
    return __fmul_rn(x, x);
  }
};

// The cluster's own rank of this block; its barrier, whole (every thread
// of every block arrives, and writes before it are seen after it) or in
// halves; and a float stored into a peer block's shared memory
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void store_peer(float* p, unsigned rank,
                                           float v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;"
               :: "r"(remote), "f"(v) : "memory");
}

// Frames base..base+kBatch-1 of the walk (those before `end`) and their
// mask values, all loads issued together; zeros past `end` and in lanes
// past d
template <int V>
__device__ __forceinline__ void load_frames(
    const float* __restrict__ zr, const float* __restrict__ mr, int d,
    int col, bool live, int base, int end,
    typename Lanes<V>::T (&fz)[kBatch], float (&fm)[kBatch]) {
#pragma unroll
  for (int s = 0; s < kBatch; ++s) {
    const int bp = base + s;
    fz[s] = Lanes<V>::zero();
    fm[s] = 0.0f;
    if (bp < end) {
      fm[s] = mr[bp];
      if (live) {
        fz[s] = *reinterpret_cast<const typename Lanes<V>::T*>(
            zr + static_cast<size_t>(bp) * d + col);
      }
    }
  }
}

// One task's pairs of one delta group, deltas D+1..D+J (J <= kRing): the
// pairs (a, b = a + D + j) whose later frame b lies in the chunk [t0, t1),
// a >= 0.  The walk's step bp takes frame bp into the ring (the earlier
// ends) and, from bp = t0 - D on, pairs the later end, frame bp + D, with
// the ring's last J frames; the walk starts J frames earlier, at w0 (not
// before frame 0), to fill the ring.  Frame bp + D is frame bp itself in
// the first group (SHIFTED false, D = 0) and else read apart.  Steps go
// kBatch (a multiple of kRing) at a time, their loads issued together, so
// frame bp sits in ring slot (bp - w0) % kRing, a compile-time index.
// CHECKED tests each pair (j <= J, a >= 0); a walk with J = kRing whose
// ring fills before its first pair needs no test.
template <int V, bool SHIFTED, bool CHECKED>
__device__ __forceinline__ void walk(const float* __restrict__ zr,
                                     const float* __restrict__ mr, int d,
                                     int col, bool live, int t0, int t1,
                                     int D, int J,
                                     typename Lanes<V>::T (&ring)[kRing],
                                     float (&mring)[kRing], float& acc,
                                     float& pairs) {
  using L = Lanes<V>;
  using Vec = typename L::T;
  const int first = t0 - D, end = t1 - D;     // the steps that make pairs
  const int w0 = max(first - J, 0);
  for (int base = w0; base < end; base += kBatch) {
    Vec nz[kBatch];
    float nm[kBatch];
    load_frames<V>(zr, mr, d, col, live, base, end, nz, nm);
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int bp = base + s;
      if (bp >= end) break;
      if (bp >= first) {
        Vec zb = nz[s];
        float mb = nm[s];
        if constexpr (SHIFTED) {
          mb = mr[bp + D];
          zb = live ? *reinterpret_cast<const Vec*>(
                          zr + static_cast<size_t>(bp + D) * d + col)
                    : L::zero();
        }
#pragma unroll
        for (int j = 1; j <= kRing; ++j) {
          if (CHECKED && (j > J || bp - j < 0)) continue;
          const int slot = (s - j + kBatch) % kRing;
          const float w = __fmul_rn(mring[slot], mb);
          acc = __fadd_rn(acc, __fmul_rn(w, L::sq(zb, ring[slot])));
          pairs = __fadd_rn(pairs, w);
        }
      }
      ring[s % kRing] = nz[s];
      mring[s % kRing] = nm[s];
    }
  }
}

// One task's delta groups in order
template <int V>
__device__ __forceinline__ void task_pairs(const float* __restrict__ zr,
                                           const float* __restrict__ mr,
                                           int d, int col, bool live, int t0,
                                           int t1, int K,
                                           typename Lanes<V>::T (&ring)[kRing],
                                           float (&mring)[kRing], float& acc,
                                           float& pairs) {
  if (K >= kRing && t0 >= kRing) {
    walk<V, false, false>(zr, mr, d, col, live, t0, t1, 0, kRing, ring,
                          mring, acc, pairs);
  } else if (K > 0) {
    walk<V, false, true>(zr, mr, d, col, live, t0, t1, 0, min(K, kRing),
                         ring, mring, acc, pairs);
  }
  for (int D = kRing; D < K; D += kRing) {
    walk<V, true, true>(zr, mr, d, col, live, t0, t1, D, min(kRing, K - D),
                        ring, mring, acc, pairs);
  }
}

// Grid: `cluster` blocks a row, rows in order; launched as clusters of
// `cluster` blocks along x when cluster > 1.
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
laplacian_energy_kernel(const float* __restrict__ z,
                        const float* __restrict__ mask,
                        float* __restrict__ tot, float* __restrict__ cnt,
                        int T, int d, int K, int slices, int frames,
                        int chunks, int cluster) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x / cluster;
  const unsigned rank = cluster > 1 ? cluster_rank() : 0u;
  // the first half of a barrier whose second half, at the end, tells that
  // every block of the cluster has started (so the leader's shared memory
  // may be written)
  if (cluster > 1) cluster_arrive();
  const float* zr = z + static_cast<size_t>(row) * T * d;
  const float* mr = mask + static_cast<size_t>(row) * T;
  float acc = 0.0f, pairs = 0.0f;
  typename Lanes<V>::T ring[kRing];
  float mring[kRing];
  const int tasks = slices * chunks;
  for (int task = rank * kWarps + warp; task < tasks;
       task += cluster * kWarps) {
    const int slice = task % slices, chunk = task / slices;
    const int col = (slice * 32 + lane) * V;
    const int t0 = chunk * frames, t1 = min(t0 + frames, T);
    float count = 0.0f;                  // the task's pair count
    task_pairs<V>(zr, mr, d, col, col < d, t0, t1, K, ring, mring, acc,
                  count);
    if (slice == 0) pairs = __fadd_rn(pairs, count);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  __shared__ float s_tot[kWarps], s_cnt[kWarps], s_part[2 * kMaxCluster];
  if (lane == 0) {
    s_tot[warp] = acc;
    s_cnt[warp] = pairs;
  }
  __syncthreads();
  // the block's (tot, cnt), its warps in order, into the leader's s_part
  // at this block's rank; the leader sums the blocks in rank order
  float st = 0.0f, sc = 0.0f;
  if (threadIdx.x == 0) {
    st = s_tot[0];
    sc = s_cnt[0];
    for (int w = 1; w < kWarps; ++w) {
      st = __fadd_rn(st, s_tot[w]);
      sc = __fadd_rn(sc, s_cnt[w]);
    }
  }
  if (cluster > 1) {
    cluster_wait();                      // every block has started
    if (threadIdx.x == 0) {
      store_peer(s_part + 2 * rank, 0u, st);
      store_peer(s_part + 2 * rank + 1, 0u, sc);
    }
    cluster_arrive();                    // every block's (tot, cnt) is in
    cluster_wait();
  } else if (threadIdx.x == 0) {
    s_part[0] = st;
    s_part[1] = sc;
  }
  if (rank == 0 && threadIdx.x == 0) {
    st = s_part[0];
    sc = s_part[1];
    for (int r = 1; r < cluster; ++r) {
      st = __fadd_rn(st, s_part[2 * r]);
      sc = __fadd_rn(sc, s_part[2 * r + 1]);
    }
    tot[row] = st;
    cnt[row] = sc;
  }
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its error (0 on success), which the
// caller checks, because a refused launch never runs.
int laplacian_energy_f32(const float* z, const float* mask, float* tot,
                         float* cnt, int B, int T, int d, int k,
                         cudaStream_t stream) {
  if (B <= 0 || T <= 0 || d <= 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = k < T - 1 ? k : T - 1;
  const bool vec = reinterpret_cast<uintptr_t>(z) % 16 == 0 && d % 4 == 0;
  const Plan p = make_plan(B, T, d, vec);
  if (static_cast<long long>(B) * p.cluster >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, laplacian_energy_kernel<4>, z, mask, tot,
                               cnt, T, d, K, p.slices, p.frames, p.chunks,
                               p.cluster)
          : cudaLaunchKernelEx(&cfg, laplacian_energy_kernel<1>, z, mask, tot,
                               cnt, T, d, K, p.slices, p.frames, p.chunks,
                               p.cluster);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

const char* laplacian_energy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
