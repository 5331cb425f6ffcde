// Flash attention, forward and backward, float32 and bf16, on Hopper's
// tensor cores (sm_90a).  The float32 kernels come first; the bf16
// forward, which shares their structure, is in the section "bf16", and
// the bf16 backward, on warpgroup MMAs fed by TMA, in the section "bf16
// backward on Hopper's warpgroup tensor cores".
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py: the
// forward `_fwd` / `_fwd_kernel` (flash_fwd_kernel) and `_bwd_rule`'s
// `_dq_kernel` and `_dkv_kernel` (see the section "Backward").  For q (B,
// H, Sq, hd) and k, v (B, KV, Sk, hd), query head h reading KV head h / (H
// / KV) (the grouping of models/attention.py), and each query row i:
//   s_ij  = scale * (q_i . k_j),  masked to -1e30 where causal and i < j
//   o_i   = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)
//   lse_i = m_i + log(max(l_i, 1e-30))
// with the running max m and sum l of an online softmax over key tiles, so
// no (Sq, Sk) score matrix reaches device memory.  Unlike the TPU kernel it
// takes any Sq and Sk (ragged tiles are masked: keys past Sk weigh 0) and
// GQA without expanding k and v.  The reference scales q before the
// product; here the scale multiplies the product, as in the backward: a
// difference at the level of rounding.
//
// Numerics: every product runs on the tensor cores in 3xTF32.  Each operand
// x is split as hi = tf32(x), lo = tf32(x - hi) (to nearest, ties away, at
// mantissa bit 13), and a product is lo*hi + hi*lo + hi*hi, three mma.sync
// m16n8k8 TF32 issues: the error of a float32 product, not of a TF32 one
// (tests/test_torch_flash_attention.py emulates both on the CPU: 3xTF32
// keeps chip_smoke.py's tolerances, one TF32 product misses them).  The
// sums over a whole sequence (o over keys here; dq over keys, dk and dv
// over queries in the backward) join float32 accumulators by rounded adds,
// a tile at a time (see accumulate), and so do dp's sums over the head
// dim, 16 columns at a time (see product_t).  The forward and the dq
// kernel compute s with the same code (product_t), so the backward's p =
// exp(s - lse) recomputes the forward's probabilities from the very scores
// the forward summed.
//
// Bound (forward): two products, 4 * Sq * Sk * hd * B * H float operations
// (about half of that under the causal mask), against 4 bytes for each
// element of q, k, v, o and lse.  At the small tier's layer (B 8, H 16, S
// 1,024, hd 64, causal) that is 17.2 GFLOP: 0.10 ms at the 165 TFLOP/s of
// float32-accurate products that 3xTF32 leaves of the 495 TFLOP/s dense
// TF32 of NVIDIA's H100 SXM data sheet (700 W), against 134 MB, 0.04 ms at
// 3.35 TB/s: operations bound it, at every shape of the cascade and the
// trainer.
//
// Design (forward).  A warp owns 16 query rows of one (b, h) and runs both
// products of those rows.  The block's q tile is loaded once with cp.async
// and split once (hi in place, lo beside it); k and v tiles stream through
// a two-stage ring of cp.async copies (16 bytes, zero-filled past Sk), the
// next tile in flight while this one is multiplied, and their fragments
// split as they load (PRE: each tile split once as it lands instead).  The
// score tile s = scale * (q k^T) comes out of the tensor cores as m16n8
// accumulators: lane (g, t) holds columns 2t and 2t+1 of rows g and g+8, so
// the online softmax runs in registers, the row max and sum over the 4
// lanes of a quad by xor shuffles 1 and 2.  The probabilities then feed the
// P V product from registers (acc_to_a: its k index permuted, V read by
// load_b to match), with no pass through shared memory.  Each key tile's P
// V sums in the tensor cores from 0 and joins o, rescaled by alpha first,
// in one rounded add.  Key tiles past the causal diagonal are skipped, and
// within the diagonal tile a warp whose rows all precede the tile's first
// key skips it (exactly: alpha would be 1 and p 0); the query tiles with
// the most key tiles start first.  No atomics and a fixed order
// everywhere, so two launches give the same bits.
// Tiles and shared memory a block (BQ query rows, a warp per 16; BK keys a
// tile; 4 bytes x (2 BQ + 4 BK) x max(hd, 32)):
//   hd 16, 32: BQ 64, BK 32, 32 KB
//   hd 64:     BQ 64, BK 32, 64 KB, three blocks an SM (BK 64: 96 KB,
//              two blocks, 11 % slower)
//   hd 112, 128: BQ 128 (8 warps), BK 32, 192 KB
// (A row's pitch is hd rounded up to a multiple of 32 floats, so the
// swizzle stays inside the row: hd 112 is laid out as 128.)
// At hd 128 the o accumulator alone is 64 registers a thread: BK 32 keeps
// the score tile and its A fragments small enough that ptxas spills
// nothing (tools/ptxas_report.py; the variants measured are
// tools/flash_fwd_variants.py's).
// Inputs must be 16-byte aligned (the launchers refuse others).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr float kMaskValue = -1e30f;

// The tensor-core building blocks both directions share.
namespace tc {

template <int HD>
__host__ __device__ constexpr int pitch() {
  return (HD + 31) / 32 * 32;
}

// column c of row r of a tile sits at r * P + (c ^ swizzle(r)): bits 2-4
// from r mod 8, so that lanes (g, t) reading (row g, column t) or (row 2t
// + e, column g) of any 8-aligned block fall in 32 distinct banks
__device__ __forceinline__ int swizzle(int r) {
  return ((r & 1) << 2) | (((r >> 1) & 1) << 3) | (((r ^ (r >> 2)) & 1) << 4);
}

template <int P>
__device__ __forceinline__ int at(int r, int c) {
  return r * P + (c ^ swizzle(r));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0 + ROWS - 1 of a (S, HD) matrix into a tile, by NT
// threads; rows past S are zero
template <int ROWS, int HD, int P, int NT>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int row0, int S) {
  constexpr int kChunks = HD / 4;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks, c = (e % kChunks) * 4, row = row0 + r;
    const bool in = row < S;
    cp_async16(tile + at<P>(r, c),
               src + static_cast<size_t>(in ? row : 0) * HD + c, in);
  }
}

// entries row0 .. row0 + ROWS - 1 of a length-S vector; past S zero
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const bool in = row0 + r < S;
    cp_async4(dst + r, src + (in ? row0 + r : 0), in);
  }
}

// x to TF32, rounded to nearest with ties away from zero at mantissa bit
// 13: what cvt.rna.tf32.f32 gives, in two integer operations, which take
// 15 % off the backward pair's time against the conversion instruction
// (tools/flash_bwd_variants.py, H100 80GB HBM3, 700 W)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// this thread's chunks of a tile that it loaded with load_tile (the same
// mapping), once they have landed: raw values become hi in place, lo goes
// to the same place in `lo`
template <int ROWS, int HD, int P, int NT>
__device__ __forceinline__ void split_tile(float* x, float* lo) {
  constexpr int kChunks = HD / 4;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += NT) {
    const int i = at<P>(e / kChunks, (e % kChunks) * 4);
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(x + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// a tile as an mma operand: split by split_tile (PRE: hi at x, lo at lo)
// or raw at x, split as its fragments load
template <int P, bool PRE>
struct Operand {
  const float* x;
  const float* lo;
  __device__ __forceinline__ void get(int r, int c, uint32_t& h,
                                      uint32_t& l) const {
    const int i = at<P>(r, c);
    if constexpr (PRE) {
      h = __float_as_uint(x[i]);
      l = __float_as_uint(lo[i]);
    } else {
      split(x[i], h, l);
    }
  }
};

struct FragA {          // m16n8k8 A operand (16 x 8), split
  uint32_t hi[4], lo[4];
};
struct FragB {          // m16n8k8 B operand (8 x 8), split
  uint32_t hi[2], lo[2];
};

// A of rows r0 .. r0+15, columns c0 .. c0+7: a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4)
template <int P, bool PRE>
__device__ __forceinline__ void load_a(FragA& a, const Operand<P, PRE>& m,
                                       int r0, int c0, int g, int t) {
  m.get(r0 + g, c0 + t, a.hi[0], a.lo[0]);
  m.get(r0 + g + 8, c0 + t, a.hi[1], a.lo[1]);
  m.get(r0 + g, c0 + t + 4, a.hi[2], a.lo[2]);
  m.get(r0 + g + 8, c0 + t + 4, a.hi[3], a.lo[3]);
}

// A from an m16n8 accumulator (c0, c1 at row g, columns 2t, 2t+1; c2, c3
// at row g+8), k permuted: logical column t is 2t, t+4 is 2t+1
__device__ __forceinline__ void acc_to_a(FragA& a, const float (&c)[4]) {
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
}

// B of x . y^T for y row-major (n, k): b0 = y[n0+g][c0+t], b1 =
// y[n0+g][c0+t+4]
template <int P, bool PRE>
__device__ __forceinline__ void load_b_t(FragB& b, const Operand<P, PRE>& m,
                                         int n0, int c0, int g, int t) {
  m.get(n0 + g, c0 + t, b.hi[0], b.lo[0]);
  m.get(n0 + g, c0 + t + 4, b.hi[1], b.lo[1]);
}

// B of x . y for y row-major (k, n), k permuted as acc_to_a's:
// b0 = y[k0+2t][n0+g], b1 = y[k0+2t+1][n0+g]
template <int P, bool PRE>
__device__ __forceinline__ void load_b(FragB& b, const Operand<P, PRE>& m,
                                       int k0, int n0, int g, int t) {
  m.get(k0 + 2 * t, n0 + g, b.hi[0], b.lo[0]);
  m.get(k0 + 2 * t + 1, n0 + g, b.hi[1], b.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.0f;
  }
}

// c[m] = x[m] . y[m]^T for m < M, the M products interleaved (the forward
// runs one, s = q k^T; the dq kernel two, s and dp = dO v^T, so both
// compute s alike; the dk/dv kernel s^T and dp^T): rows r0 .. r0+15 of
// x[m] against rows 0 .. 8N-1 of y[m], both row-major with KD * 8 columns;
// c[m][n] is the m16n8 tile of y's rows 8n .. 8n+7.  Product 0 sums in the
// tensor cores over L0 steps of 8 columns at a time, the others over L1,
// each chain from 0 and joined to c by a rounded float32 add (L = KD: one
// chain over the head dim).  The tensor cores' sums truncate: dp chained
// over hd puts dq and dk at Sq = Sk = 1 (exactly 0 there) over
// chip_smoke.py phase 11's bar on one draw in four at hd 64 and three in
// five at hd 128 (tools/tc_truncation.py emulates the truncation on the
// CPU, 400 draws); chains of 2 steps cut that error 3-7 fold, and no draw
// missed.  s is chained: that moves the forward's lse by about 1.5e-6 at
// hd 128 (the same emulation), inside phase 9's 1e-5, and rounded adds on
// it cost the forward 13 % (tools/flash_fwd_variants.py).
template <int KD, int L0, int L1 = L0, int M, int N, int P, bool PX,
          bool PY>
__device__ __forceinline__ void product_t(float (&c)[M][N][4],
                                          const Operand<P, PX> (&x)[M],
                                          const Operand<P, PY> (&y)[M],
                                          int r0, int g, int t) {
  float part[M][N][4];
#pragma unroll
  for (int m = 0; m < M; ++m) zero(c[m]);
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    FragA a[M];
#pragma unroll
    for (int m = 0; m < M; ++m) load_a(a[m], x[m], r0, 8 * kd, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      FragB b[M];
#pragma unroll
      for (int m = 0; m < M; ++m) load_b_t(b[m], y[m], 8 * n, 8 * kd, g, t);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int L = m == 0 ? L0 : L1;
        if (kd < L) {                       // the first chain: into c
          mma3(c[m][n], a[m], b[m]);
          continue;
        }
        if (kd % L == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[m][n][e] = 0.0f;
        }
        mma3(part[m][n], a[m], b[m]);
        if (kd % L == L - 1 || kd == KD - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c[m][n][e] = __fadd_rn(c[m][n][e], part[m][n][e]);
          }
        }
      }
    }
  }
}

// KD output fragments (16 x 8 each) that a lane accumulates over the
// whole loop: in registers, or where registers run out in a slab of shared
// memory that only this lane touches (float4 nd * 32 + lane), so it needs
// no barrier
template <int KD>
struct RegAcc {
  static constexpr int kFrags = KD;
  float v[KD][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[nd][e] = 0.0f;
    }
  }
  // row g times a0, row g + 8 times a1
  __device__ __forceinline__ void scale(float a0, float a1) {
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      v[nd][0] = __fmul_rn(v[nd][0], a0);
      v[nd][1] = __fmul_rn(v[nd][1], a0);
      v[nd][2] = __fmul_rn(v[nd][2], a1);
      v[nd][3] = __fmul_rn(v[nd][3], a1);
    }
  }
  __device__ __forceinline__ void add(int nd, const float (&x)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[nd][e] = __fadd_rn(v[nd][e], x[e]);
  }
  // row g (half 0) or g + 8 (half 1), columns 2t and 2t + 1
  __device__ __forceinline__ float2 get(int nd, int half) const {
    return make_float2(v[nd][2 * half], v[nd][2 * half + 1]);
  }
};

template <int KD>
struct SlabAcc {
  static constexpr int kFrags = KD;
  float4* p;                          // this lane's first float4
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) p[32 * nd] = make_float4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void add(int nd, const float (&x)[4]) {
    float4 r = p[32 * nd];
    r.x = __fadd_rn(r.x, x[0]);
    r.y = __fadd_rn(r.y, x[1]);
    r.z = __fadd_rn(r.z, x[2]);
    r.w = __fadd_rn(r.w, x[3]);
    p[32 * nd] = r;
  }
  __device__ __forceinline__ float2 get(int nd, int half) const {
    const float4 r = p[32 * nd];
    return half ? make_float2(r.z, r.w) : make_float2(r.x, r.y);
  }
};

// acc += c . y: c the K accumulator fragments of a 16 x 8K score tile
// (the A operand, k permuted as acc_to_a takes it), y row-major (8K, 8KD).
// Each output fragment sums the tile in the tensor cores from 0, then
// joins acc in one rounded float32 add.  A chain of tensor-core sums
// truncates as it goes: chained over a whole sequence, the error reached
// 4.7e-5 of the largest gradient at S 4,096, over chip_smoke.py phase
// 11's 1e-5 (tools/flash_bwd_variants.py); a tile's chain keeps it small,
// and the adds across tiles round to nearest.
template <int K, class Acc, int P, bool PRE>
__device__ __forceinline__ void accumulate(Acc& acc, const float (&c)[K][4],
                                           const Operand<P, PRE>& y, int g,
                                           int t) {
  FragA a[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) acc_to_a(a[kk], c[kk]);
#pragma unroll
  for (int nd = 0; nd < Acc::kFrags; ++nd) {
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      FragB b;
      load_b(b, y, 8 * kk, 8 * nd, g, t);
      mma3(x, a[kk], b);
    }
    acc.add(nd, x);
  }
}

// x over the 4 lanes of a quad (t = 0..3, one row of an m16n8 tile), in a
// fixed order that leaves every lane of the quad the same bits
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Forward.

template <int HD, int BQ, int BK, bool PRE>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (2 * BQ + 2 * 2 * (PRE ? 2 : 1) * BK) *
         tc::pitch<HD>();
}

template <int HD, int BQ, int BK, bool PRE>
__global__ void __launch_bounds__(2 * BQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int BH, int H, int KV, int Sq,
                 int Sk, float scale, int causal) {
  using namespace tc;
  constexpr int kWarpThreads = 2 * BQ;        // a warp per 16 query rows
  constexpr int P = pitch<HD>();
  constexpr int NT = BK / 8, KD = HD / 8;
  constexpr int kTile = BK * P, kStage = 2 * (PRE ? 2 : 1) * kTile;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x P: q, then its hi
  float* qlo = qs + BQ * P;                      // BQ x P: q's lo
  float* ring = qlo + BQ * P;   // 2 stages: k (and its lo), v (and its lo)

  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x % BH, qt = blockIdx.x / BH;
  // under the mask the last query tiles have the most keys: they go first
  const int q0 = (causal ? (Sq + BQ - 1) / BQ - 1 - qt : qt) * BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const size_t rows0 = static_cast<size_t>(bh) * Sq;
  const float* kp = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const float* vp = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  auto k_at = [&](int st) { return ring + st * kStage; };
  auto v_at = [&](int st) { return ring + st * kStage + kStage / 2; };

  load_tile<BQ, HD, P, kWarpThreads>(qs, q + rows0 * HD, q0, Sq);
  load_tile<BK, HD, P, kWarpThreads>(k_at(0), kp, 0, Sk);
  load_tile<BK, HD, P, kWarpThreads>(v_at(0), vp, 0, Sk);
  cp_async_commit();

  int rows[2];
  float m[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rows[e] = q0 + r0 + g + 8 * e;
    m[e] = kMaskValue;
    l[e] = 0.0f;
  }
  RegAcc<KD> acc;
  acc.zero();
  const Operand<P, true> qop{qs, qlo};

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK, st = it & 1;
    if (it + 1 < n_kt) {
      load_tile<BK, HD, P, kWarpThreads>(k_at(st ^ 1), kp, k0 + BK, Sk);
      load_tile<BK, HD, P, kWarpThreads>(v_at(st ^ 1), vp, k0 + BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (it == 0) split_tile<BQ, HD, P, kWarpThreads>(qs, qlo);
    if constexpr (PRE) {
      split_tile<BK, HD, P, kWarpThreads>(k_at(st), k_at(st) + kTile);
      split_tile<BK, HD, P, kWarpThreads>(v_at(st), v_at(st) + kTile);
    }
    __syncthreads();
    const Operand<P, PRE> kop{k_at(st), k_at(st) + kTile};
    const Operand<P, PRE> vop{v_at(st), v_at(st) + kTile};
    // a warp whose rows all precede the tile's first key has nothing here
    if (!causal || k0 <= q0 + r0 + 15) {
      float sc[1][NT][4];
      product_t<KD, KD>(sc, {qop}, {kop}, r0, g, t);
      float (&s)[NT][4] = sc[0];
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          float x = __fmul_rn(s[n][e], scale);
          if (j >= Sk) {
            x = -CUDART_INF_F;                 // past the end: weighs 0
          } else if (causal && j > rows[e / 2]) {
            x = kMaskValue;
          }
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m_new = fmaxf(m[e], quad_max(mx[e]));
        alpha[e] = expf(__fsub_rn(m[e], m_new));
        m[e] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(__fsub_rn(s[n][e], m[e / 2]));
          sum[e / 2] = __fadd_rn(sum[e / 2], s[n][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[e] = __fmaf_rn(l[e], alpha[e], quad_sum(sum[e]));
      }
      acc.scale(alpha[0], alpha[1]);
      accumulate(acc, s, vop, g, t);              // o += p v
    }
    __syncthreads();                 // the stage is consumed before refill
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows[e] >= Sq) continue;
    const float denom = fmaxf(l[e], 1e-30f);
    float* out = o + (rows0 + rows[e]) * HD;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const float2 r = acc.get(nd, e);
      *reinterpret_cast<float2*>(out + 8 * nd + 2 * t) =
          make_float2(__fdiv_rn(r.x, denom), __fdiv_rn(r.y, denom));
    }
    if (t == 0) lse[rows0 + rows[e]] = __fadd_rn(m[e], logf(denom));
  }
}

template <int HD, int BQ, int BK, bool PRE>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int B, int H, int KV, int Sq, int Sk, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD, BQ, BK, PRE>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, BQ, BK, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<HD, BQ, BK, PRE>
      <<<static_cast<unsigned>(blocks), 2 * BQ, smem, stream>>>(
          q, k, v, o, lse, B * H, H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward.
//
// The function of the TPU kernel's `_bwd_rule` (its blocks not carried
// over).  delta_i = sum_d dO_id * O_id comes in (one torch op, as the
// reference computes it in jnp outside its kernels).  Both kernels
// recompute, from the lse the forward wrote,
//   s_ij  = scale * (q_i . k_j)
//   p_ij  = exp(s_ij - lse_i), 0 where masked (causal j > i, keys past Sk,
//           queries past Sq)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)
// flash_bwd_dq_kernel, one block per BQ query rows of one (b, h), over the
// key tiles up to the diagonal:
//   dq_i = scale * sum_j ds_ij k_j
// flash_bwd_dkv_kernel, one block per BK keys of one (b, KV head g), over
// the G = H / KV query heads g*G .. g*G+G-1 in order and, for each, the
// query tiles from the causal lower bound:
//   dv_j = sum_i p_ij dO_i,   dk_j = scale * sum_i ds_ij q_i
// so GQA's sum over a group runs inside the block in a fixed order: no
// atomics, and two launches give the same bits.  The dq kernel computes s
// as the forward does (product_t, q split once there, as its fragments
// load here: the same bits), so its p is the forward's probabilities up to
// the rounding of lse; the dk/dv kernel computes s^T, k . q, whose sums
// the tensor cores may round otherwise.
//
// Bound: the backward's least work is five products (s, dp, dq, dk, dv),
// 2.5x the forward's operations; this two-pass design recomputes s and dp
// in both kernels, so dq does three products and dk/dv four.  At the small
// tier's layer (B 8, H 16, S 1,024, hd 64, causal) the five are 43 GFLOP:
// 0.26 ms at 165 TFLOP/s, against 0.05 ms of bytes at 3.35 TB/s:
// operations bound both.
//
// Design.  As the forward's: a warp owns 16 rows of the output (query rows
// in dq, keys in dk/dv) and runs every product of those rows, so the score
// tile it computes is the A operand of its accumulation product without
// leaving its registers: the m16n8 accumulator holds columns 2t and 2t+1
// of rows g and g+8 (lane 4g + t), the m16n8k8 A fragment wants columns t
// and t+4, and the kernel reads that product's k index permuted (logical t
// is 2t, t+4 is 2t+1) in both operands, which leaves the sum as it is.
// Every tile lives once in shared memory, row-major, its pitch a multiple
// of 32 floats, column c of row r at c ^ swizzle(r): both fragment
// patterns, (row g, column t) and (row 2t or 2t+1, column g), hit 32
// distinct banks.  The block's own operands (q and dO in dq, k and v in
// dk/dv) are loaded once; the streamed ones (k and v; q, dO, lse and
// delta) come through a two-stage ring of cp.async copies.  In dk/dv at hd
// <= 64 each streamed tile is split once as it lands (PRE: hi in place, lo
// beside it), 5 % faster there than every warp splitting its fragments;
// elsewhere fragments split as they load.  At hd 128 the dv accumulator
// lives in shared memory (VS): with dk and dv both in registers (128 of
// them a thread) the kernel spills, though it runs 15 % faster
// (tools/flash_bwd_variants.py).  Blocks with the most tiles start first.
// Tiles and shared memory a block:
//   dq   hd 16, 32: BQ 64, BK 32, 32 KB; hd 64: 64 KB, three blocks an
//        SM; hd 112, 128: BQ 128 (8 warps), BK 32, 192 KB
//   dkv  hd 16, 32: BK 64, BQ 32, 48.5 KB; hd 64: 96.5 KB, two blocks an
//        SM; hd 128: BK 128 (8 warps), BQ 16, 224.3 KB; hd 112 as 128,
//        216.3 KB

template <int HD, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * BQ + 2 * 2 * BK) * tc::pitch<HD>();
}

template <int HD, int BK, int BQ, bool PRE, bool VS>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((2 * BK + 2 * 2 * (PRE ? 2 : 1) * BQ) *
                              tc::pitch<HD>() +
                          4 * BQ + (VS ? BK * HD : 0));
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int BH, int H, int KV, int Sq, int Sk, float scale,
                    int causal) {
  using namespace tc;
  constexpr int kWarpThreads = 2 * BQ;        // a warp per 16 query rows
  constexpr int P = pitch<HD>();
  constexpr int NT = BK / 8, KD = HD / 8;
  constexpr int kStage = 2 * BK * P;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x P
  float* dos = qs + BQ * P;                      // BQ x P
  float* ring = dos + BQ * P;                    // 2 stages: k, v

  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x % BH, qt = blockIdx.x / BH;
  // under the mask the last query tiles have the most keys: they go first
  const int q0 = (causal ? (Sq + BQ - 1) / BQ - 1 - qt : qt) * BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const size_t rows0 = static_cast<size_t>(bh) * Sq;
  const float* kp = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const float* vp = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  auto k_at = [&](int st) { return ring + st * kStage; };
  auto v_at = [&](int st) { return ring + st * kStage + kStage / 2; };

  load_tile<BQ, HD, P, kWarpThreads>(qs, q + rows0 * HD, q0, Sq);
  load_tile<BQ, HD, P, kWarpThreads>(dos, dout + rows0 * HD, q0, Sq);
  load_tile<BK, HD, P, kWarpThreads>(k_at(0), kp, 0, Sk);
  load_tile<BK, HD, P, kWarpThreads>(v_at(0), vp, 0, Sk);
  cp_async_commit();

  int rows[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rows[e] = q0 + r0 + g + 8 * e;
    const bool in = rows[e] < Sq;
    lse_r[e] = in ? lse[rows0 + rows[e]] : 0.0f;
    delta_r[e] = in ? delta[rows0 + rows[e]] : 0.0f;
  }
  RegAcc<KD> acc;
  acc.zero();
  const Operand<P, false> qop{qs, nullptr}, oop{dos, nullptr};

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK, st = it & 1;
    if (it + 1 < n_kt) {
      load_tile<BK, HD, P, kWarpThreads>(k_at(st ^ 1), kp, k0 + BK, Sk);
      load_tile<BK, HD, P, kWarpThreads>(v_at(st ^ 1), vp, k0 + BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Operand<P, false> kop{k_at(st), nullptr}, vop{v_at(st), nullptr};
    // a warp whose rows all precede the tile's first key has nothing here
    if (!causal || k0 <= q0 + r0 + 15) {
      float sd[2][NT][4];
      product_t<KD, KD, 2>(sd, {qop, oop}, {kop, vop}, r0, g, t);
      float (&s)[NT][4] = sd[0];
      float (&dp)[NT][4] = sd[1];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e / 2], j = k0 + 8 * n + 2 * t + (e & 1);
          float ds = 0.0f;
          if (j < Sk && !(causal && j > i)) {
            const float p = expf(
                __fsub_rn(__fmul_rn(s[n][e], scale), lse_r[e / 2]));
            ds = __fmul_rn(p, __fsub_rn(dp[n][e], delta_r[e / 2]));
          }
          s[n][e] = ds;
        }
      }
      accumulate(acc, s, kop, g, t);
    }
    __syncthreads();                 // the stage is consumed before refill
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows[e] >= Sq) continue;
    float* out = dq + (rows0 + rows[e]) * HD;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const float2 r = acc.get(nd, e);
      *reinterpret_cast<float2*>(out + 8 * nd + 2 * t) =
          make_float2(__fmul_rn(r.x, scale), __fmul_rn(r.y, scale));
    }
  }
}

template <int HD, int BK, int BQ, bool PRE, bool VS>
__global__ void __launch_bounds__(2 * BK, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int BKV,
                     int H, int KV, int Sq, int Sk, float scale, int causal) {
  using namespace tc;
  constexpr int kWarpThreads = 2 * BK;        // a warp per 16 keys
  constexpr int P = pitch<HD>();
  constexpr int NQ = BQ / 8, KD = HD / 8;
  constexpr int kTile = BQ * P, kStage = 2 * (PRE ? 2 : 1) * kTile;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // BK x P
  float* vs = ks + BK * P;                       // BK x P
  float* ring = vs + BK * P;    // 2 stages: q (and its lo), dO (and its lo)
  float* ls = ring + 2 * kStage;                 // 2 stages of BQ lse
  float* dls = ls + 2 * BQ;                      // 2 stages of BQ delta

  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  // blockIdx.x / BKV is the key tile: under the mask the first ones see the
  // most queries, and they go first
  const int bkv = blockIdx.x % BKV, k0 = (blockIdx.x / BKV) * BK;
  const int b = bkv / KV, kvh = bkv % KV, G = H / KV;
  const size_t kv_rows0 = static_cast<size_t>(bkv) * Sk;
  auto q_at = [&](int st) { return ring + st * kStage; };
  auto o_at = [&](int st) { return ring + st * kStage + kStage / 2; };

  // query rows before k0 see none of this block's keys under the mask
  const int q_lo = causal ? (k0 / BQ) * BQ : 0;
  const int n_qt = q_lo < Sq ? (Sq - q_lo + BQ - 1) / BQ : 0;
  const int n_steps = G * n_qt;
  auto issue = [&](int step, int st) {
    const int gi = step / n_qt, q0 = q_lo + (step % n_qt) * BQ;
    const size_t rows0 = (static_cast<size_t>(b) * H + kvh * G + gi) * Sq;
    load_tile<BQ, HD, P, kWarpThreads>(q_at(st), q + rows0 * HD, q0, Sq);
    load_tile<BQ, HD, P, kWarpThreads>(o_at(st), dout + rows0 * HD, q0, Sq);
    load_rows<BQ, kWarpThreads>(ls + st * BQ, lse + rows0, q0, Sq);
    load_rows<BQ, kWarpThreads>(dls + st * BQ, delta + rows0, q0, Sq);
  };
  if (n_steps > 0) {
    load_tile<BK, HD, P, kWarpThreads>(ks, k + kv_rows0 * HD, k0, Sk);
    load_tile<BK, HD, P, kWarpThreads>(vs, v + kv_rows0 * HD, k0, Sk);
    issue(0, 0);
    cp_async_commit();
  }
  RegAcc<KD> acc_k;
  std::conditional_t<VS, SlabAcc<KD>, RegAcc<KD>> acc_v;
  if constexpr (VS) {               // KD x 32 float4 a warp, after delta
    acc_v.p = reinterpret_cast<float4*>(dls + 2 * BQ) +
              (threadIdx.x / 32) * KD * 32 + threadIdx.x % 32;
  }
  acc_k.zero();
  acc_v.zero();
  const Operand<P, false> kop{ks, nullptr}, vop{vs, nullptr};

  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step + 1 < n_steps) {
      issue(step + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (PRE) {
      split_tile<BQ, HD, P, kWarpThreads>(q_at(st), q_at(st) + kTile);
      split_tile<BQ, HD, P, kWarpThreads>(o_at(st), o_at(st) + kTile);
    }
    __syncthreads();
    const int q0 = q_lo + (step % n_qt) * BQ;
    const Operand<P, PRE> qop{q_at(st), q_at(st) + kTile};
    const Operand<P, PRE> oop{o_at(st), o_at(st) + kTile};
    const float* lt = ls + st * BQ;
    const float* dt = dls + st * BQ;
    // a warp whose keys all follow the tile's last query has nothing here
    if (!causal || k0 + r0 <= q0 + BQ - 1) {
      float sd[2][NQ][4];
      product_t<KD, KD, 2>(sd, {kop, vop}, {qop, oop}, r0, g, t);
      float (&s)[NQ][4] = sd[0];
      float (&dp)[NQ][4] = sd[1];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + r0 + g + 8 * (e / 2);
          const int c = 8 * n + 2 * t + (e & 1), i = q0 + c;
          float p = 0.0f, ds = 0.0f;
          if (i < Sq && j < Sk && !(causal && j > i)) {
            p = expf(__fsub_rn(__fmul_rn(s[n][e], scale), lt[c]));
            ds = __fmul_rn(p, __fsub_rn(dp[n][e], dt[c]));
          }
          s[n][e] = p;
          dp[n][e] = ds;
        }
      }
      accumulate(acc_v, s, oop, g, t);          // dv += p^T dO
      accumulate(acc_k, dp, qop, g, t);         // dk += ds^T q
    }
    __syncthreads();                 // the stage is consumed before refill
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = k0 + r0 + g + 8 * e;
    if (key >= Sk) continue;
    float* outk = dk + (kv_rows0 + key) * HD;
    float* outv = dv + (kv_rows0 + key) * HD;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const float2 rk = acc_k.get(nd, e);
      *reinterpret_cast<float2*>(outk + 8 * nd + 2 * t) =
          make_float2(__fmul_rn(rk.x, scale), __fmul_rn(rk.y, scale));
      *reinterpret_cast<float2*>(outv + 8 * nd + 2 * t) = acc_v.get(nd, e);
    }
  }
}

template <int HD, int BQ, int BK>
int launch_bwd_dq(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int B, int H, int KV, int Sq, int Sk,
                  float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD, BQ, BK>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<HD, BQ, BK>
      <<<static_cast<unsigned>(blocks), 2 * BQ, smem, stream>>>(
          q, k, v, dout, lse, delta, dq, B * H, H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK, int BQ, bool PRE, bool VS>
int launch_bwd_dkv(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int B, int H, int KV, int Sq, int Sk,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD, BK, BQ, PRE, VS>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  const long long blocks =
      static_cast<long long>((Sk + BK - 1) / BK) * B * KV;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD, BK, BQ, PRE, VS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<HD, BK, BQ, PRE, VS>
      <<<static_cast<unsigned>(blocks), 2 * BK, smem, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, B * KV, H, KV, Sq, Sk, scale,
          causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16.
//
// The three kernels for bf16 q, k, v and dO, which the TPU kernel takes as
// well: it upcasts its tiles, computes in float32, and writes o, dq, dk
// and dv in the input dtype, lse (and takes delta) in float32.  Here
// every product runs on the tensor cores in bf16 with float32
// accumulation: the forward below as a bf16 mma.sync
// (m16n8k16.row.col.f32.bf16.bf16.f32), one issue where 3xTF32 takes
// three, and 8 values a 16-byte cp.async; dq and dk/dv on wgmma (the next
// section), with these numerics.  The
// products q k^T and dO v^T are exact (a bf16 product fits a float32),
// summed in float32.  The other operand of P V is bf16 already, but P
// itself must be rounded to bf16 to meet it, and so must dS in dS k and
// dS^T q, and P^T in P^T dO: the one place where these kernels depart
// from the reference's float32 arithmetic, and why their gradients are
// held to a bar relative to each gradient's max (chip_smoke.py phase 20)
// and not to the float32 kernels' 1e-5.  The softmax statistics m, l and
// lse, p before it is rounded, ds, delta and every accumulator stay
// float32; o, dq, dk and dv are rounded to bf16 (to nearest even) once,
// as they are written.
//
// Bound: the float32 kernels' products at the H100's 989 TFLOP/s of dense
// bf16 (NVIDIA's H100 SXM data sheet, 700 W), against 2 bytes an element
// of q, k, v, dO, o, dq, dk and dv and 4 of lse and delta: operations
// bound all three at the trainer's layers (chip_smoke.py phase 20 prints
// each bound beside each time).
//
// Design (forward): the float32 kernel's (a warp owns 16 rows of the
// output and runs every product of those rows; a two-stage cp.async ring;
// the causal skips; a fixed order and no atomics, so two launches give
// the same bits), with bf16 tiles in shared memory at a row pitch of hd + 8
// values, (hd + 8) / 2 words: both fragment patterns of any 8 rows, a
// word of one row (row g, columns 2t and 2t + 1) and a value of each of
// two rows (rows 2t and 2t + 1, column g), then fall in distinct banks.
// The m16n8 score accumulators of two neighbouring 8-column tiles are, in
// the same registers, the m16n8k16 A fragment of the next product (lane
// (g, t) holds columns 2t, 2t + 1 of rows g and g + 8 in both), so P goes
// from the softmax to the tensor cores without leaving registers.
// The o accumulator sums in the tensor cores across all tiles.  hd is a
// multiple of 16 (7 k-steps at hd 112).  Tiles a block (4 warps): BQ 64,
// BK 64: 45 KB at hd 64, 85 KB at hd 128.
namespace bf {

using u16 = unsigned short;

template <int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 8;
}

__device__ __forceinline__ void cp_async16(u16* dst, const u16* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// rows row0 .. row0 + ROWS - 1 of a (S, HD) bf16 matrix into a tile, by
// NT threads, 8 values a copy; rows past S are zero
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void load_tile(u16* tile, const u16* src,
                                          int row0, int S) {
  constexpr int kChunks = HD / 8, P = pitch<HD>();
  for (int e = threadIdx.x; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks, c = (e % kChunks) * 8, row = row0 + r;
    const bool in = row < S;
    cp_async16(tile + r * P + c,
               src + static_cast<size_t>(in ? row : 0) * HD + c, in);
  }
}

// columns c and c + 1 of row r (c even): one word
template <int P>
__device__ __forceinline__ uint32_t pair(const u16* x, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(x + r * P + c);
}

// rows r and r + 1 of column c
template <int P>
__device__ __forceinline__ uint32_t pair_t(const u16* x, int r, int c) {
  return static_cast<uint32_t>(x[r * P + c]) |
         (static_cast<uint32_t>(x[(r + 1) * P + c]) << 16);
}

// lo and hi rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[m] = x[m] . y[m]^T for m < M: rows r0 .. r0+15 of x[m] against rows
// 0 .. 8N-1 of y[m], both row-major (., HD) tiles; c[m][n] is the m16n8
// tile of y's rows 8n .. 8n+7, summed over HD in the tensor cores
template <int HD, int M, int N>
__device__ __forceinline__ void scores(float (&c)[M][N][4],
                                       const u16* const (&x)[M],
                                       const u16* const (&y)[M], int r0,
                                       int g, int t) {
  constexpr int P = pitch<HD>();
#pragma unroll
  for (int m = 0; m < M; ++m) tc::zero(c[m]);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c0 = 16 * kk + 2 * t;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const uint32_t a[4] = {pair<P>(x[m], r0 + g, c0),
                             pair<P>(x[m], r0 + g + 8, c0),
                             pair<P>(x[m], r0 + g, c0 + 8),
                             pair<P>(x[m], r0 + g + 8, c0 + 8)};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        mma(c[m][n], a, pair<P>(y[m], 8 * n + g, c0),
            pair<P>(y[m], 8 * n + g, c0 + 8));
      }
    }
  }
}

// acc += c . y: c a 16 x 8N float32 score tile (N even), rounded to bf16
// as the A operand, and y a row-major (8N, HD) tile; acc[nd] the m16n8
// tile of output columns 8nd .. 8nd+7
template <int HD, int N>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4],
                                           const float (&c)[N][4],
                                           const u16* y, int g, int t) {
  constexpr int P = pitch<HD>();
  static_assert(N % 2 == 0, "the product's k steps are 16 wide");
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const uint32_t a[4] = {pack(c[2 * j][0], c[2 * j][1]),
                           pack(c[2 * j][2], c[2 * j][3]),
                           pack(c[2 * j + 1][0], c[2 * j + 1][1]),
                           pack(c[2 * j + 1][2], c[2 * j + 1][3])};
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      mma(acc[nd], a, pair_t<P>(y, 16 * j + 2 * t, 8 * nd + g),
          pair_t<P>(y, 16 * j + 8 + 2 * t, 8 * nd + g));
    }
  }
}

// row g (half 0) or g + 8 (half 1) of an accumulator's columns 2t and
// 2t + 1 times f, rounded to bf16, at out[8 nd + 2t]
template <int ND>
__device__ __forceinline__ void store_row(u16* out,
                                          const float (&acc)[ND][4],
                                          int half, int t, float f) {
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<uint32_t*>(out + 8 * nd + 2 * t) =
        pack(__fmul_rn(acc[nd][2 * half], f),
             __fmul_rn(acc[nd][2 * half + 1], f));
  }
}

template <int HD, int BQ, int BK>
constexpr size_t fwd_smem_bytes() {
  return sizeof(u16) * (BQ + 2 * 2 * BK) * pitch<HD>();
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ)
flash_fwd_bf16_kernel(const u16* __restrict__ q, const u16* __restrict__ k,
                      const u16* __restrict__ v, u16* __restrict__ o,
                      float* __restrict__ lse, int BH, int H, int KV, int Sq,
                      int Sk, float scale, int causal) {
  constexpr int kThreads = 2 * BQ;            // a warp per 16 query rows
  constexpr int P = pitch<HD>();
  constexpr int NT = BK / 8, ND = HD / 8;
  constexpr int kStage = 2 * BK * P;
  extern __shared__ float4 smem4[];
  u16* qs = reinterpret_cast<u16*>(smem4);      // BQ x P
  u16* ring = qs + BQ * P;                      // 2 stages: k, v

  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x % BH, qt = blockIdx.x / BH;
  // under the mask the last query tiles have the most keys: they go first
  const int q0 = (causal ? (Sq + BQ - 1) / BQ - 1 - qt : qt) * BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const size_t rows0 = static_cast<size_t>(bh) * Sq;
  const u16* kp = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const u16* vp = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  auto k_at = [&](int st) { return ring + st * kStage; };
  auto v_at = [&](int st) { return ring + st * kStage + kStage / 2; };

  load_tile<BQ, HD, kThreads>(qs, q + rows0 * HD, q0, Sq);
  load_tile<BK, HD, kThreads>(k_at(0), kp, 0, Sk);
  load_tile<BK, HD, kThreads>(v_at(0), vp, 0, Sk);
  tc::cp_async_commit();

  int rows[2];
  float m[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rows[e] = q0 + r0 + g + 8 * e;
    m[e] = kMaskValue;
    l[e] = 0.0f;
  }
  float acc[ND][4];
  tc::zero(acc);

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK, st = it & 1;
    if (it + 1 < n_kt) {
      load_tile<BK, HD, kThreads>(k_at(st ^ 1), kp, k0 + BK, Sk);
      load_tile<BK, HD, kThreads>(v_at(st ^ 1), vp, k0 + BK, Sk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    // a warp whose rows all precede the tile's first key has nothing here
    if (!causal || k0 <= q0 + r0 + 15) {
      float sc[1][NT][4];
      scores<HD, 1, NT>(sc, {qs}, {k_at(st)}, r0, g, t);
      float (&s)[NT][4] = sc[0];
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          float x = __fmul_rn(s[n][e], scale);
          if (j >= Sk) {
            x = -CUDART_INF_F;                 // past the end: weighs 0
          } else if (causal && j > rows[e / 2]) {
            x = kMaskValue;
          }
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m_new = fmaxf(m[e], tc::quad_max(mx[e]));
        alpha[e] = expf(__fsub_rn(m[e], m_new));
        m[e] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(__fsub_rn(s[n][e], m[e / 2]));
          sum[e / 2] = __fadd_rn(sum[e / 2], s[n][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[e] = __fmaf_rn(l[e], alpha[e], tc::quad_sum(sum[e]));
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][0] = __fmul_rn(acc[nd][0], alpha[0]);
        acc[nd][1] = __fmul_rn(acc[nd][1], alpha[0]);
        acc[nd][2] = __fmul_rn(acc[nd][2], alpha[1]);
        acc[nd][3] = __fmul_rn(acc[nd][3], alpha[1]);
      }
      accumulate<HD, NT>(acc, s, v_at(st), g, t);      // o += p v
    }
    __syncthreads();                 // the stage is consumed before refill
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows[e] >= Sq) continue;
    const float denom = fmaxf(l[e], 1e-30f);
    store_row(o + (rows0 + rows[e]) * HD, acc, e, t,
              __fdiv_rn(1.0f, denom));
    if (t == 0) lse[rows0 + rows[e]] = __fadd_rn(m[e], logf(denom));
  }
}

// a kernel on `blocks` blocks of `threads`, with `smem` bytes of dynamic
// shared memory (its maximum set first)
template <class... P, class... A>
int launch(void (*kernel)(P...), long long blocks, int threads, size_t smem,
           cudaStream_t stream, A... args) {
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BQ, int BK>
int launch_fwd(const u16* q, const u16* k, const u16* v, u16* o, float* lse,
               int B, int H, int KV, int Sq, int Sk, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD, BQ, BK>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  return launch(flash_fwd_bf16_kernel<HD, BQ, BK>,
                static_cast<long long>((Sq + BQ - 1) / BQ) * B * H, 2 * BQ,
                smem, stream, q, k, v, o, lse, B * H, H, KV, Sq, Sk, scale,
                causal);
}

}  // namespace bf

// ---------------------------------------------------------------------------
// bf16 backward on Hopper's warpgroup tensor cores.
//
// The dq and dk/dv kernels for bf16 q, k, v and dO: the products of the
// float32 backward (S = q k^T, dP = dO v^T, then dq += dS k, dv += P^T dO,
// dk += dS^T q), each on `wgmma.mma_async` m64nNk16 bf16 with float32
// accumulators, the only way to Hopper's bf16 rate (the forward above
// keeps mma.sync).  The numerics are the section "bf16"'s: bf16 products
// summed in float32, P and dS rounded to bf16 (to nearest even) where they
// meet dO, q and k, everything else float32, dq, dk and dv rounded once as
// they are written; the k steps of every product in ascending order, a
// fixed order of sums and no atomics, so two launches give the same bits.
// P = exp(S scale - lse) is one fmaf and one ex2.approx with the scale and
// lse taken to base 2 (a few float32 ulps, far below the bf16 rounding of
// P that follows): at the layer shapes the softmax's instructions, not
// the products, set these kernels' time, and expf's range reduction is
// several instructions more an element.
//
// Bound: as the mma.sync kernels' note above says, the products at 989
// TFLOP/s bound both at the trainer's layers (dq 3 products, dk/dv 4).
//
// Design (warp specialisation).  A block is two consumer warpgroups and
// one producer warpgroup (384 threads).  Each consumer owns 64 rows of the
// output: keys in dk/dv, queries in dq.  One producer thread issues every
// copy as a TMA load (`cp.async.bulk.tensor.3d`) into a ring of kStages
// stages, each with a full and an empty `mbarrier`; the consumers never
// copy and the main loop has no __syncthreads().  The tensor maps are 3-D
// over (B*H, S, hd), so the rows of a ragged tile past S are zero-filled
// inside their own head; a row of a tile is at most 64 values (128 bytes,
// the 128-byte swizzle), hd 112 and 128 take two such boxes (at 112 the
// second box's last 16 columns are zero-filled), hd 16 and 32 one box of
// 32 or 64 bytes under the 32- and 64-byte swizzles.
//   dk/dv: a block holds BK = 128 keys of one KV head, two 64-key tiles (K and
//   V resident, loaded once), and streams BQ = 64 queries a step, each of the
//   G query heads of the group in turn: Q and dO by TMA, lse and delta by the
//   producer warp's plain loads into the stage (+inf and 0 past Sq, so P and
//   dS vanish there without a mask).  S^T = K Q^T and dP^T = V dO^T read both
//   operands from shared memory by descriptor (K-major); P^T and dS^T are
//   rounded to bf16 straight from the accumulator registers, which are the
//   m16n8k16 A fragments of the next products (each warp's 16 rows, columns
//   2t, 2t + 1 of rows g and g + 8), and dV += P^T dO, dK += dS^T Q take them
//   as register A operands, with dO and Q as B through the descriptor's
//   transpose bit (MN-major).  64 queries a step at every hd.
//   dq: a block holds BQ = 128 queries of one head (Q and dO resident) and
//   streams BK = 64 keys a step: S = Q K^T and dP = dO V^T from shared
//   memory, dS from the registers, dQ += dS K with K transposed.  dq keeps
//   its own kernel: summing dq in dk/dv with float32 atomics would change
//   its bits from run to run.
// Causal tiles wholly above the diagonal are skipped by the warpgroup they
// fall to (the producer still streams the block's tiles), the diagonal
// tiles (and dq's last ragged key tile) mask, the rest do not.  Registers:
// the producer drops to kProducerRegs with `setmaxnreg` and the consumers
// rise to kConsumerRegs; at hd 128 dk and dv for 64 keys are 128 float32 a
// consumer thread, S^T and dP^T 64 more.  Why two consumers and BK 128 (BQ
// 128 for dq): one block an SM holds 2 x 64 output rows in 232 registers a
// thread (65,536 on an SM), and the grid fills the 132 SMs at the layer
// shapes: dk/dv 4 x 8 x 8 = 256 blocks at the large tier, 2 x 8 x 8 = 128 at
// kimi-k2's, dq 512 and 1,024.  Where the grid is one wave (kimi-k2's
// dk/dv), under the causal mask a block of the first 128 keys would set
// the time at about twice the mean block's work, so a block pairs a tile
// with its mirror from the far end of Sk (the host picks this from the
// grid and the card's SMs); over several waves adjacent tiles keep both
// warpgroups of a block equally busy.  The two warpgroups share each
// streamed tile, which halves the copies a key costs against one
// warpgroup a block, and the blocks with the most work go first.  Shared
// memory (hd 128): dk/dv 64 KB of K and V and 3 stages of 33 KB; dq 64 KB
// of Q and dO and 3 stages of 32 KB.
namespace hb {

using bf::pack;
using bf::u16;

constexpr int kConsumers = 2;                      // warpgroups that compute
constexpr int kThreads = 128 * (kConsumers + 1);   // and the producer's
constexpr int kStages = 3;
// 384 x 168 registers at launch; the producer gives back 128 of its 168 a
// thread, which raise each consumer thread to 232
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kDkvBK = 64 * kConsumers, kDkvBQ = 64;
constexpr int kDqBQ = 64 * kConsumers, kDqBK = 64;

// A tile of rows of hd bf16 values in shared memory, as TMA writes it:
// kBoxes boxes of `rows` rows of kRowBytes each (one box's columns a row),
// swizzled over their kRowBytes; a wgmma k step covers 16 columns (32
// bytes), kSteps of them span hd
template <int HD>
struct Geo {
  static constexpr int kRowBytes = HD >= 64 ? 128 : 2 * HD;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = (HD + kBoxCols - 1) / kBoxCols;
  static constexpr int kSteps = HD / 16;
  static constexpr int kStepsPerBox = kRowBytes / 32;
  // the descriptor's layout: 1 the 128-byte swizzle, 2 the 64, 3 the 32
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2
                                                                        : 3;
  static constexpr unsigned kAtom = 8 * kRowBytes;   // 8 rows: the swizzle's
  static constexpr int tile(int rows) { return kBoxes * rows * kRowBytes; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// an arrival that also expects `bytes` of TMA copies before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 3-D tensor map at (column, row, head) into dst
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// rows row0 .. row0 + 63 of head `head` (all hd columns) into rows 64 half
// .. 64 half + 63 of a tile of `rows` rows
template <int HD>
__device__ __forceinline__ void tma_rows64(unsigned char* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int row0, int head,
                                           int rows, int half) {
  using G = Geo<HD>;
#pragma unroll
  for (int b = 0; b < G::kBoxes; ++b) {
    tma_load3(dst + (b * rows + 64 * half) * G::kRowBytes, map, bar,
              b * G::kBoxCols, row0, head);
  }
}

// rows row0 .. row0 + rows - 1 of head `head` (all hd columns) into a tile
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row0, int head,
                                         int rows) {
  using G = Geo<HD>;
#pragma unroll
  for (int b = 0; b < G::kBoxes; ++b) {
    tma_load3(dst + b * rows * G::kRowBytes, map, bar, b * G::kBoxCols, row0,
              head);
  }
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving an accumulator across a wgmma boundary
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// K-major operand: rows r0 .. r0 + 63 (A) or all rows (B) of a tile of
// `rows` rows at `tile`, hd columns 16kk .. 16kk + 15
template <int HD>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r0,
                                           int kk) {
  using G = Geo<HD>;
  return desc(tile + (kk / G::kStepsPerBox) * rows * G::kRowBytes +
                  r0 * G::kRowBytes + (kk % G::kStepsPerBox) * 32,
              16, G::kAtom, G::kLayout);
}

// MN-major B (the transpose bit): rows 16kq .. 16kq + 15 of a tile of
// `rows` rows as the k dimension, all hd columns as N; the boxes lie
// rows * kRowBytes apart
template <int HD>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kq) {
  using G = Geo<HD>;
  return desc(tile + 16 * kq * G::kRowBytes, rows * G::kRowBytes, G::kAtom,
              G::kLayout);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x, one MUFU.EX2 (flushes denormal results to 0; 2^-inf = 0): with the
// scale and lse taken to base 2, exp(s scale - lse) as one fmaf and this
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// d (+)= A . B^T, m64n64k16: A (64 x 16) and B (64 x 16) K-major in shared
// memory by descriptor; `acc` 0 overwrites d
__device__ __forceinline__ void ss_m64n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A . B, m64n16k16: A (64 x 16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 16) MN-major in shared memory
// by descriptor (the transpose bit)
__device__ __forceinline__ void rs_m64n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n32k16: A (64 x 16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 32) MN-major in shared memory
// by descriptor (the transpose bit)
__device__ __forceinline__ void rs_m64n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n64k16: A (64 x 16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 64) MN-major in shared memory
// by descriptor (the transpose bit)
__device__ __forceinline__ void rs_m64n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n112k16: A (64 x 16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 112) MN-major in shared memory
// by descriptor (the transpose bit)
__device__ __forceinline__ void rs_m64n112(float (&d)[56],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n128k16: A (64 x 16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 128) MN-major in shared memory
// by descriptor (the transpose bit)
__device__ __forceinline__ void rs_m64n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t db) {
  if constexpr (N == 16) {
    rs_m64n16(d, a, db);
  } else if constexpr (N == 32) {
    rs_m64n32(d, a, db);
  } else if constexpr (N == 64) {
    rs_m64n64(d, a, db);
  } else if constexpr (N == 112) {
    rs_m64n112(d, a, db);
  } else {
    static_assert(N == 128, "hd is one of 16, 32, 64, 112, 128");
    rs_m64n128(d, a, db);
  }
}

// the 64 x 64 accumulator's 32 values, rounded to bf16, as the four
// m64k16 A fragments of a product over its 64 columns
__device__ __forceinline__ void a_fragments(uint32_t (&a)[4][4],
                                            const float (&c)[32]) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      a[kq][x] = pack(c[8 * kq + 2 * x], c[8 * kq + 2 * x + 1]);
    }
  }
}

// row `half` (g or g + 8) of an accumulator of N columns times f, rounded
// to bf16, at out[8n + 2t]
template <int N>
__device__ __forceinline__ void store_row(u16* out, const float (&acc)[N / 2],
                                          int half, int t, float f) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) =
        pack(__fmul_rn(acc[4 * n + 2 * half], f),
             __fmul_rn(acc[4 * n + 2 * half + 1], f));
  }
}

// dk/dv's shared memory: K and V (kDkvBK rows each, half of each in
// the block's second tile), then kStages stages
// of Q, dO (kDkvBQ rows each), lse and delta, then the barriers
template <int HD>
struct DkvSmem {
  using G = Geo<HD>;
  static constexpr int kKV = G::tile(kDkvBK);   // (kKV / 2: one tile)
  static constexpr int kQ = G::tile(kDkvBQ);
  static constexpr int kStage = (2 * kQ + 8 * kDkvBQ + 1023) / 1024 * 1024;
  static constexpr int kBars = 2 * kKV + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          u16* __restrict__ dk, u16* __restrict__ dv,
                          int BKV, int H, int KV, int Sq, int Sk, float scale,
                          int causal, int mirrored) {
  using G = Geo<HD>;
  using L = DkvSmem<HD>;
  constexpr int BK = kDkvBK, BQ = kDkvBQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::kKV;
  unsigned char* stages = smem + 2 * L::kKV;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  // the block's keys, two of the 64-key tiles of Sk, one a warpgroup
  // (none for warpgroup 1 past the end or where a pair meets): tiles 2i
  // and 2i + 1 of block i, or `mirrored`, tile i and its mirror from the
  // far end, so under the mask each block sees about as many queries as
  // any other; the blocks with the most work go first
  const int bkv = blockIdx.x % BKV, i = blockIdx.x / BKV;
  const int n64 = (Sk + 63) / 64;
  const int t0 = mirrored ? i : 2 * i;
  const int t1 = mirrored ? n64 - 1 - i : 2 * i + 1;
  const int tiles = t1 != t0 && t1 < n64 ? 2 : 1;
  const int b = bkv / KV, kvh = bkv % KV, group = H / KV;
  // query rows before tile t0 see none of the block's keys under the mask
  const int q_lo = causal ? 64 * t0 : 0;
  const int n_qt = q_lo < Sq ? (Sq - q_lo + BQ - 1) / BQ : 0;
  const int n_steps = group * n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                   // the producer warp
      mbar_init(&empty[s], 128 * kConsumers);    // every consumer thread
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: its first warp loads; the others leave
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32 || n_steps == 0) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(kv_full, tiles * L::kKV);
      for (int half = 0; half < tiles; ++half) {
        const int row0 = 64 * (half == 0 ? t0 : t1);
        tma_rows64<HD>(ks, &tk, kv_full, row0, bkv, BK, half);
        tma_rows64<HD>(vs, &tv, kv_full, row0, bkv, BK, half);
      }
    }
    for (int step = 0; step < n_steps; ++step) {
      const int s = step % kStages;
      mbar_wait(&empty[s], ((step / kStages) & 1) ^ 1);
      const int q0 = q_lo + (step % n_qt) * BQ;
      const int bh = b * H + kvh * group + step / n_qt;
      unsigned char* st = stages + s * L::kStage;
      float* ls = reinterpret_cast<float*>(st + 2 * L::kQ);
      const size_t rows0 = static_cast<size_t>(bh) * Sq;
      for (int r = lane; r < BQ; r += 32) {
        const int i = q0 + r;
        ls[r] = i < Sq ? __fmul_rn(lse[rows0 + i], kLog2e) : CUDART_INF_F;
        ls[BQ + r] = i < Sq ? delta[rows0 + i] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::kQ);
        tma_tile<HD>(st, &tq, &full[s], q0, bh, BQ);
        tma_tile<HD>(st + L::kQ, &tdo, &full[s], q0, bh, BQ);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw = 64 * (wg == 0 ? t0 : t1);     // this warpgroup's keys
    const bool keys = wg < tiles;
    const float scale2 = __fmul_rn(scale, kLog2e);
    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      acc_k[i] = 0.0f;
      acc_v[i] = 0.0f;
    }
    const uint32_t ks_a = smem_u32(ks), vs_a = smem_u32(vs);
    if (n_steps > 0) mbar_wait(kv_full, 0);
    for (int step = 0; step < n_steps; ++step) {
      const int s = step % kStages;
      mbar_wait(&full[s], (step / kStages) & 1);
      const int q0 = q_lo + (step % n_qt) * BQ;
      // a tile wholly above the diagonal has nothing for these keys
      if (keys && (!causal || q0 + BQ - 1 >= kw)) {
        const uint32_t qa = smem_u32(stages + s * L::kStage), oa = qa + L::kQ;
        const float* ls =
            reinterpret_cast<const float*>(stages + s * L::kStage + 2 * L::kQ);
        float sc[32], dp[32];                    // S^T and dP^T
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < G::kSteps; ++kk) {
          ss_m64n64(sc, kmajor<HD>(ks_a, BK, 64 * wg, kk),
                    kmajor<HD>(qa, BQ, 0, kk), kk);
        }
#pragma unroll
        for (int kk = 0; kk < G::kSteps; ++kk) {
          ss_m64n64(dp, kmajor<HD>(vs_a, BK, 64 * wg, kk),
                    kmajor<HD>(oa, BQ, 0, kk), kk);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        const bool diag = causal && q0 < kw + 63;
        // lse and delta of queries 8n + 2t and 8n + 2t + 1, one 8-byte load
        const float2* l2 = reinterpret_cast<const float2*>(ls) + t;
        const float2* d2 = reinterpret_cast<const float2*>(ls + BQ) + t;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 lse2 = l2[4 * n], delta2 = d2[4 * n];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = 4 * n + x, c = 8 * n + 2 * t + (x & 1);
            const int j = kw + 16 * w + g + 8 * (x >> 1);
            float p = ex2(__fmaf_rn(sc[e], scale2,
                                    -(x & 1 ? lse2.y : lse2.x)));
            if (diag && j > q0 + c) p = 0.0f;           // query q0 + c
            sc[e] = p;
            dp[e] = __fmul_rn(p, __fsub_rn(dp[e],
                                           x & 1 ? delta2.y : delta2.x));
          }
        }
        uint32_t pa[4][4], da[4][4];
        a_fragments(pa, sc);
        a_fragments(da, dp);
        wg_fence();
        fence_regs(acc_v);
        fence_regs(acc_k);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          rs<HD>(acc_v, pa[kq], mnmajor<HD>(oa, BQ, kq));   // dv += P^T dO
        }
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          rs<HD>(acc_k, da[kq], mnmajor<HD>(qa, BQ, kq));   // dk += dS^T q
        }
        wg_commit();
        wg_wait_all();
        fence_regs(acc_v);
        fence_regs(acc_k);
      }
      mbar_arrive(&empty[s]);
    }
    const size_t kv_rows0 = static_cast<size_t>(bkv) * Sk;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kw + 16 * w + g + 8 * half;
      if (!keys || key >= Sk) continue;
      store_row<HD>(dk + (kv_rows0 + key) * HD, acc_k, half, t, scale);
      store_row<HD>(dv + (kv_rows0 + key) * HD, acc_v, half, t, 1.0f);
    }
  }
}

// dq's shared memory: Q and dO (kDqBQ rows each), then kStages stages of
// K and V (kDqBK rows each), then the barriers
template <int HD>
struct DqSmem {
  using G = Geo<HD>;
  static constexpr int kQ = G::tile(kDqBQ);
  static constexpr int kK = G::tile(kDqBK);
  static constexpr int kStage = 2 * kK;
  static constexpr int kBars = 2 * kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         u16* __restrict__ dq, int BH, int H, int KV, int Sq,
                         int Sk, float scale, int causal) {
  using G = Geo<HD>;
  using L = DqSmem<HD>;
  constexpr int BQ = kDqBQ, BK = kDqBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + L::kQ;
  unsigned char* stages = smem + 2 * L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int bh = blockIdx.x % BH, qt = blockIdx.x / BH;
  // under the mask the last query tiles have the most keys: they go first
  const int q0 = (causal ? (Sq + BQ - 1) / BQ - 1 - qt : qt) * BQ;
  const int b = bh / H, kvh = (bh % H) / (H / KV);
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread loads; the others leave
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 != 0) return;
    mbar_expect_tx(q_full, 2 * L::kQ);
    tma_tile<HD>(qs, &tq, q_full, q0, bh, BQ);
    tma_tile<HD>(dos, &tdo, q_full, q0, bh, BQ);
    const int bkv = b * KV + kvh;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
      unsigned char* st = stages + s * L::kStage;
      mbar_expect_tx(&full[s], L::kStage);
      tma_tile<HD>(st, &tk, &full[s], kt * BK, bkv, BK);
      tma_tile<HD>(st + L::kK, &tv, &full[s], kt * BK, bkv, BK);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int qw = q0 + 64 * wg;                 // this warpgroup's queries
    const size_t rows0 = static_cast<size_t>(bh) * Sq;
    int rows[2];
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rows[half] = qw + 16 * w + g + 8 * half;
      const bool in = rows[half] < Sq;
      lse_r[half] = in ? __fmul_rn(lse[rows0 + rows[half]], kLog2e) : 0.0f;
      delta_r[half] = in ? delta[rows0 + rows[half]] : 0.0f;
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    const uint32_t qs_a = smem_u32(qs), dos_a = smem_u32(dos);
    const float scale2 = __fmul_rn(scale, kLog2e);
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages, k0 = kt * BK;
      mbar_wait(&full[s], (kt / kStages) & 1);
      // a tile wholly above the diagonal has nothing for these queries
      if (!causal || k0 <= qw + 63) {
        const uint32_t ka = smem_u32(stages + s * L::kStage), va = ka + L::kK;
        float sc[32], dp[32];                    // S and dP
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < G::kSteps; ++kk) {
          ss_m64n64(sc, kmajor<HD>(qs_a, BQ, 64 * wg, kk),
                    kmajor<HD>(ka, BK, 0, kk), kk);
        }
#pragma unroll
        for (int kk = 0; kk < G::kSteps; ++kk) {
          ss_m64n64(dp, kmajor<HD>(dos_a, BQ, 64 * wg, kk),
                    kmajor<HD>(va, BK, 0, kk), kk);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        // the diagonal tile and the ragged last one mask; keys past Sk
        // are zero rows of K but must not weigh: exp(-lse) may overflow
        const bool masked = (causal && k0 + BK - 1 > qw) || k0 + BK > Sk;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int j = k0 + 8 * (e / 4) + 2 * t + (e & 1);
          const int h = (e >> 1) & 1;
          float p = ex2(__fmaf_rn(sc[e], scale2, -lse_r[h]));
          if (masked && (j >= Sk || (causal && j > rows[h]))) p = 0.0f;
          dp[e] = __fmul_rn(p, __fsub_rn(dp[e], delta_r[h]));
        }
        uint32_t da[4][4];
        a_fragments(da, dp);
        wg_fence();
        fence_regs(acc);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          rs<HD>(acc, da[kq], mnmajor<HD>(ka, BK, kq));   // dq += dS k
        }
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (rows[half] < Sq) {
        store_row<HD>(dq + (rows0 + rows[half]) * HD, acc, half, t, scale);
      }
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (so the library needs no -lcuda), or null
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (heads, S, HD) bf16 tensor as a 3-D map of boxes of `rows` rows and
// one box's columns, swizzled as the tiles are; rows past S, and columns
// past HD, read as zeros
template <int HD>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int S, int heads,
                       int rows) {
  using G = Geo<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {2ull * HD, 2ull * HD * S};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::kBoxCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the four maps of q, k, v and dO: q and dO in boxes of `q_rows` rows, k
// and v of `k_rows`
template <int HD>
cudaError_t maps(CUtensorMap (&m)[4], const u16* q, const u16* k,
                 const u16* v, const u16* dout, int B, int H, int KV, int Sq,
                 int Sk, int q_rows, int k_rows) {
  cudaError_t err = tensor_map<HD>(&m[0], q, Sq, B * H, q_rows);
  if (err == cudaSuccess) err = tensor_map<HD>(&m[1], k, Sk, B * KV, k_rows);
  if (err == cudaSuccess) err = tensor_map<HD>(&m[2], v, Sk, B * KV, k_rows);
  if (err == cudaSuccess) {
    err = tensor_map<HD>(&m[3], dout, Sq, B * H, q_rows);
  }
  return err;
}

template <int HD>
int launch_bwd_dq(const u16* q, const u16* k, const u16* v, const u16* dout,
                  const float* lse, const float* delta, u16* dq, int B, int H,
                  int KV, int Sq, int Sk, float scale, int causal,
                  cudaStream_t stream) {
  constexpr size_t smem = DqSmem<HD>::kBytes;
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  CUtensorMap m[4];
  const cudaError_t err =
      maps<HD>(m, q, k, v, dout, B, H, KV, Sq, Sk, kDqBQ, kDqBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  return bf::launch(flash_bwd_dq_bf16_kernel<HD>,
                    static_cast<long long>((Sq + kDqBQ - 1) / kDqBQ) * B * H,
                    kThreads, smem, stream, m[0], m[1], m[2], m[3], lse,
                    delta, dq, B * H, H, KV, Sq, Sk, scale, causal);
}

template <int HD>
int launch_bwd_dkv(const u16* q, const u16* k, const u16* v, const u16* dout,
                   const float* lse, const float* delta, u16* dk, u16* dv,
                   int B, int H, int KV, int Sq, int Sk, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<HD>::kBytes;
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  CUtensorMap m[4];
  cudaError_t err =
      maps<HD>(m, q, k, v, dout, B, H, KV, Sq, Sk, kDkvBQ, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((Sk + kDkvBK - 1) / kDkvBK) * B * KV;
  // one wave (a block an SM): the longest block sets the time, so under
  // the mask the tiles pair with their mirrors; over several waves the
  // blocks in order of work keep both warpgroups of a block busy
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mirrored = causal && blocks <= sms;
  return bf::launch(flash_bwd_dkv_bf16_kernel<HD>, blocks, kThreads, smem,
                    stream, m[0], m[1], m[2], m[3], lse, delta, dk, dv,
                    B * KV, H, KV, Sq, Sk, scale, causal, mirrored);
}

template <int HD>
cudaError_t attributes(cudaFuncAttributes* dq, cudaFuncAttributes* dkv) {
  const cudaError_t err =
      cudaFuncGetAttributes(dq, flash_bwd_dq_bf16_kernel<HD>);
  return err != cudaSuccess
             ? err
             : cudaFuncGetAttributes(dkv, flash_bwd_dkv_bf16_kernel<HD>);
}

}  // namespace hb

}  // namespace

extern "C" {

// Each launcher launches on `stream` and returns the first CUDA error (0 on
// success); the caller checks it, because a refused launch never runs.  q,
// o (B, H, Sq, hd), k, v (B, KV, Sk, hd) and lse (B, H, Sq), contiguous,
// float32 (the _f32 launchers) or bf16 with lse and delta float32 (the
// _bf16 ones); hd one of 16, 32, 64, 112, 128 and KV a divisor of H (the
// wrappers check both).  The (B, ., S, hd) tensors must start on 16 bytes (cp.async
// copies 16; the launchers refuse others).
static cudaError_t args_check(int B, int H, int KV, int Sq, int Sk,
                              std::initializer_list<const void*> tiles) {
  if (!(B > 0 && H > 0 && KV > 0 && H % KV == 0 && Sq > 0 && Sk > 0 &&
        B * H <= 65535)) {
    return cudaErrorInvalidValue;
  }
  for (const void* p : tiles) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  return cudaSuccess;
}

#define FWD_ARGS q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, stream

int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            float* o, float* lse, int B, int H, int KV,
                            int Sq, int Sk, int hd, float scale, int causal,
                            cudaStream_t stream) {
  const cudaError_t bad = args_check(B, H, KV, Sq, Sk, {q, k, v, o});
  if (bad != cudaSuccess) return static_cast<int>(bad);
  switch (hd) {
    case 16:
      return launch_fwd<16, 64, 32, false>(FWD_ARGS);
    case 32:
      return launch_fwd<32, 64, 32, false>(FWD_ARGS);
    case 64:
      return launch_fwd<64, 64, 32, false>(FWD_ARGS);
    case 112:
      return launch_fwd<112, 128, 32, false>(FWD_ARGS);
    case 128:
      return launch_fwd<128, 128, 32, false>(FWD_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's launchers: same layouts as the forward's, plus dout (B, H,
// Sq, hd), the forward's lse and delta = rowsum(dout * o) (B, H, Sq); dq
// (B, H, Sq, hd) from the first, dk and dv (B, KV, Sk, hd) from the second.
#define BWD_DQ_ARGS \
  q, k, v, dout, lse, delta, dq, B, H, KV, Sq, Sk, scale, causal, stream
#define BWD_DKV_ARGS \
  q, k, v, dout, lse, delta, dk, dv, B, H, KV, Sq, Sk, scale, causal, stream

int flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* delta, float* dq, int B, int H,
                               int KV, int Sq, int Sk, int hd, float scale,
                               int causal, cudaStream_t stream) {
  const cudaError_t bad =
      args_check(B, H, KV, Sq, Sk, {q, k, v, dout, dq});
  if (bad != cudaSuccess) return static_cast<int>(bad);
  switch (hd) {
    case 16:
      return launch_bwd_dq<16, 64, 32>(BWD_DQ_ARGS);
    case 32:
      return launch_bwd_dq<32, 64, 32>(BWD_DQ_ARGS);
    case 64:
      return launch_bwd_dq<64, 64, 32>(BWD_DQ_ARGS);
    case 112:
      return launch_bwd_dq<112, 128, 32>(BWD_DQ_ARGS);
    case 128:
      return launch_bwd_dq<128, 128, 32>(BWD_DQ_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_dkv_f32(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* delta,
                                float* dk, float* dv, int B, int H, int KV,
                                int Sq, int Sk, int hd, float scale,
                                int causal, cudaStream_t stream) {
  const cudaError_t bad =
      args_check(B, H, KV, Sq, Sk, {q, k, v, dout, dk, dv});
  if (bad != cudaSuccess) return static_cast<int>(bad);
  switch (hd) {
    case 16:
      return launch_bwd_dkv<16, 64, 32, true, false>(BWD_DKV_ARGS);
    case 32:
      return launch_bwd_dkv<32, 64, 32, true, false>(BWD_DKV_ARGS);
    case 64:
      return launch_bwd_dkv<64, 64, 32, true, false>(BWD_DKV_ARGS);
    case 112:
      return launch_bwd_dkv<112, 128, 16, false, true>(BWD_DKV_ARGS);
    case 128:
      return launch_bwd_dkv<128, 128, 16, false, true>(BWD_DKV_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 launchers: the same arguments, the tensors bf16 (as 16-bit
// words) but lse and delta float32.
using bf::u16;

int flash_attention_fwd_bf16(const u16* q, const u16* k, const u16* v,
                             u16* o, float* lse, int B, int H, int KV,
                             int Sq, int Sk, int hd, float scale, int causal,
                             cudaStream_t stream) {
  const cudaError_t bad = args_check(B, H, KV, Sq, Sk, {q, k, v, o});
  if (bad != cudaSuccess) return static_cast<int>(bad);
  switch (hd) {
    case 16:
      return bf::launch_fwd<16, 64, 64>(FWD_ARGS);
    case 32:
      return bf::launch_fwd<32, 64, 64>(FWD_ARGS);
    case 64:
      return bf::launch_fwd<64, 64, 64>(FWD_ARGS);
    case 112:
      return bf::launch_fwd<112, 64, 64>(FWD_ARGS);
    case 128:
      return bf::launch_fwd<128, 64, 64>(FWD_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_dq_bf16(const u16* q, const u16* k, const u16* v,
                                const u16* dout, const float* lse,
                                const float* delta, u16* dq, int B, int H,
                                int KV, int Sq, int Sk, int hd, float scale,
                                int causal, cudaStream_t stream) {
  const cudaError_t bad =
      args_check(B, H, KV, Sq, Sk, {q, k, v, dout, dq});
  if (bad != cudaSuccess) return static_cast<int>(bad);
  switch (hd) {
    case 16:
      return hb::launch_bwd_dq<16>(BWD_DQ_ARGS);
    case 32:
      return hb::launch_bwd_dq<32>(BWD_DQ_ARGS);
    case 64:
      return hb::launch_bwd_dq<64>(BWD_DQ_ARGS);
    case 112:
      return hb::launch_bwd_dq<112>(BWD_DQ_ARGS);
    case 128:
      return hb::launch_bwd_dq<128>(BWD_DQ_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_dkv_bf16(const u16* q, const u16* k, const u16* v,
                                 const u16* dout, const float* lse,
                                 const float* delta, u16* dk, u16* dv, int B,
                                 int H, int KV, int Sq, int Sk, int hd,
                                 float scale, int causal,
                                 cudaStream_t stream) {
  const cudaError_t bad =
      args_check(B, H, KV, Sq, Sk, {q, k, v, dout, dk, dv});
  if (bad != cudaSuccess) return static_cast<int>(bad);
  switch (hd) {
    case 16:
      return hb::launch_bwd_dkv<16>(BWD_DKV_ARGS);
    case 32:
      return hb::launch_bwd_dkv<32>(BWD_DKV_ARGS);
    case 64:
      return hb::launch_bwd_dkv<64>(BWD_DKV_ARGS);
    case 112:
      return hb::launch_bwd_dkv<112>(BWD_DKV_ARGS);
    case 128:
      return hb::launch_bwd_dkv<128>(BWD_DKV_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 backward kernels' attributes at head dim hd, for the record:
// out[0], out[1] the dq kernel's registers a thread at launch and its local
// memory (spills and stack) in bytes a thread, out[2], out[3] dk/dv's.
// The consumer warpgroups run with kConsumerRegs after setmaxnreg.
int flash_attention_bwd_bf16_attributes(int hd, int* out) {
  cudaFuncAttributes dq, dkv;
  cudaError_t err;
  switch (hd) {
    case 16:
      err = hb::attributes<16>(&dq, &dkv);
      break;
    case 32:
      err = hb::attributes<32>(&dq, &dkv);
      break;
    case 64:
      err = hb::attributes<64>(&dq, &dkv);
      break;
    case 112:
      err = hb::attributes<112>(&dq, &dkv);
      break;
    case 128:
      err = hb::attributes<128>(&dq, &dkv);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = dq.numRegs;
  out[1] = static_cast<int>(dq.localSizeBytes);
  out[2] = dkv.numRegs;
  out[3] = static_cast<int>(dkv.localSizeBytes);
  return 0;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
