// Flash attention, forward and backward, float32 and bf16, on Hopper's
// tensor cores (sm_90a).  The float32 kernels come first; the bf16 ones,
// which share their structure, are in the section "bf16".
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
// The same three kernels for bf16 q, k, v and dO, which the TPU kernel
// takes as well: it upcasts its tiles, computes in float32, and writes o,
// dq, dk and dv in the input dtype, lse (and takes delta) in float32.
// Here every product runs on the tensor cores as a bf16 mma.sync
// (m16n8k16.row.col.f32.bf16.bf16.f32) with float32 accumulation: one
// issue where 3xTF32 takes three, and 8 values a 16-byte cp.async.  The
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
// Design: the float32 kernels' (a warp owns 16 rows of the output and
// runs every product of those rows; two-stage cp.async rings; the causal
// skips; a fixed order and no atomics, so two launches give the same
// bits), with bf16 tiles in shared memory at a row pitch of hd + 8
// values, (hd + 8) / 2 words: both fragment patterns of any 8 rows, a
// word of one row (row g, columns 2t and 2t + 1) and a value of each of
// two rows (rows 2t and 2t + 1, column g), then fall in distinct banks.
// The m16n8 score accumulators of two neighbouring 8-column tiles are, in
// the same registers, the m16n8k16 A fragment of the next product (lane
// (g, t) holds columns 2t, 2t + 1 of rows g and g + 8 in both), so P and
// dS go from the softmax to the tensor cores without leaving registers.
// The o, dq, dk and dv accumulators sum in the tensor cores across all
// tiles.  hd is a multiple of 16 (7 k-steps at hd 112).
// Tiles a block (4 warps each):
//   forward BQ 64, BK 64: 45 KB at hd 64, 85 KB at hd 128
//   dq      BQ 64, BK 32 (dq's accumulator and two score tiles in
//           registers): 36 KB at hd 64, 68 KB at hd 128
//   dk/dv   BK 64 keys, BQ 32 queries a step at hd <= 64, 16 above (dk
//           and dv both in registers): 36 KB at hd 64, 51 KB at hd 128
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

template <int HD, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(u16) * (2 * BQ + 2 * 2 * BK) * pitch<HD>();
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ)
flash_bwd_dq_bf16_kernel(const u16* __restrict__ q,
                         const u16* __restrict__ k,
                         const u16* __restrict__ v,
                         const u16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         u16* __restrict__ dq, int BH, int H, int KV, int Sq,
                         int Sk, float scale, int causal) {
  constexpr int kThreads = 2 * BQ;            // a warp per 16 query rows
  constexpr int P = pitch<HD>();
  constexpr int NT = BK / 8, ND = HD / 8;
  constexpr int kStage = 2 * BK * P;
  extern __shared__ float4 smem4[];
  u16* qs = reinterpret_cast<u16*>(smem4);      // BQ x P
  u16* dos = qs + BQ * P;                       // BQ x P
  u16* ring = dos + BQ * P;                     // 2 stages: k, v

  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x % BH, qt = blockIdx.x / BH;
  const int q0 = (causal ? (Sq + BQ - 1) / BQ - 1 - qt : qt) * BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const size_t rows0 = static_cast<size_t>(bh) * Sq;
  const u16* kp = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const u16* vp = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  auto k_at = [&](int st) { return ring + st * kStage; };
  auto v_at = [&](int st) { return ring + st * kStage + kStage / 2; };

  load_tile<BQ, HD, kThreads>(qs, q + rows0 * HD, q0, Sq);
  load_tile<BQ, HD, kThreads>(dos, dout + rows0 * HD, q0, Sq);
  load_tile<BK, HD, kThreads>(k_at(0), kp, 0, Sk);
  load_tile<BK, HD, kThreads>(v_at(0), vp, 0, Sk);
  tc::cp_async_commit();

  int rows[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rows[e] = q0 + r0 + g + 8 * e;
    const bool in = rows[e] < Sq;
    lse_r[e] = in ? lse[rows0 + rows[e]] : 0.0f;
    delta_r[e] = in ? delta[rows0 + rows[e]] : 0.0f;
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
    if (!causal || k0 <= q0 + r0 + 15) {
      float sd[2][NT][4];                      // s and dp
      scores<HD, 2, NT>(sd, {qs, dos}, {k_at(st), v_at(st)}, r0, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e / 2], j = k0 + 8 * n + 2 * t + (e & 1);
          float ds = 0.0f;
          if (j < Sk && !(causal && j > i)) {
            const float p = expf(
                __fsub_rn(__fmul_rn(sd[0][n][e], scale), lse_r[e / 2]));
            ds = __fmul_rn(p, __fsub_rn(sd[1][n][e], delta_r[e / 2]));
          }
          sd[0][n][e] = ds;
        }
      }
      accumulate<HD, NT>(acc, sd[0], k_at(st), g, t);   // dq += ds k
    }
    __syncthreads();                 // the stage is consumed before refill
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows[e] < Sq) {
      store_row(dq + (rows0 + rows[e]) * HD, acc, e, t, scale);
    }
  }
}

template <int HD, int BK, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(u16) * (2 * BK + 2 * 2 * BQ) * pitch<HD>() +
         sizeof(float) * 4 * BQ;
}

template <int HD, int BK, int BQ>
__global__ void __launch_bounds__(2 * BK, 1)
flash_bwd_dkv_bf16_kernel(const u16* __restrict__ q,
                          const u16* __restrict__ k,
                          const u16* __restrict__ v,
                          const u16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          u16* __restrict__ dk, u16* __restrict__ dv,
                          int BKV, int H, int KV, int Sq, int Sk, float scale,
                          int causal) {
  constexpr int kThreads = 2 * BK;            // a warp per 16 keys
  constexpr int P = pitch<HD>();
  constexpr int NQ = BQ / 8, ND = HD / 8;
  constexpr int kStage = 2 * BQ * P;
  extern __shared__ float4 smem4[];
  u16* ks = reinterpret_cast<u16*>(smem4);      // BK x P
  u16* vs = ks + BK * P;                        // BK x P
  u16* ring = vs + BK * P;                      // 2 stages: q, dO
  float* ls = reinterpret_cast<float*>(ring + 2 * kStage);  // 2 x BQ lse
  float* dls = ls + 2 * BQ;                                 // 2 x BQ delta

  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  // under the mask the first key tiles see the most queries: they go first
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
    load_tile<BQ, HD, kThreads>(q_at(st), q + rows0 * HD, q0, Sq);
    load_tile<BQ, HD, kThreads>(o_at(st), dout + rows0 * HD, q0, Sq);
    tc::load_rows<BQ, kThreads>(ls + st * BQ, lse + rows0, q0, Sq);
    tc::load_rows<BQ, kThreads>(dls + st * BQ, delta + rows0, q0, Sq);
  };
  if (n_steps > 0) {
    load_tile<BK, HD, kThreads>(ks, k + kv_rows0 * HD, k0, Sk);
    load_tile<BK, HD, kThreads>(vs, v + kv_rows0 * HD, k0, Sk);
    issue(0, 0);
    tc::cp_async_commit();
  }
  float acc_k[ND][4], acc_v[ND][4];
  tc::zero(acc_k);
  tc::zero(acc_v);

  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step + 1 < n_steps) {
      issue(step + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = q_lo + (step % n_qt) * BQ;
    const float* lt = ls + st * BQ;
    const float* dt = dls + st * BQ;
    // a warp whose keys all follow the tile's last query has nothing here
    if (!causal || k0 + r0 <= q0 + BQ - 1) {
      float sd[2][NQ][4];                      // s^T and dp^T
      scores<HD, 2, NQ>(sd, {ks, vs}, {q_at(st), o_at(st)}, r0, g, t);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + r0 + g + 8 * (e / 2);
          const int c = 8 * n + 2 * t + (e & 1), i = q0 + c;
          float p = 0.0f, ds = 0.0f;
          if (i < Sq && j < Sk && !(causal && j > i)) {
            p = expf(__fsub_rn(__fmul_rn(sd[0][n][e], scale), lt[c]));
            ds = __fmul_rn(p, __fsub_rn(sd[1][n][e], dt[c]));
          }
          sd[0][n][e] = p;
          sd[1][n][e] = ds;
        }
      }
      accumulate<HD, NQ>(acc_v, sd[0], o_at(st), g, t);   // dv += p^T dO
      accumulate<HD, NQ>(acc_k, sd[1], q_at(st), g, t);   // dk += ds^T q
    }
    __syncthreads();                 // the stage is consumed before refill
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = k0 + r0 + g + 8 * e;
    if (key >= Sk) continue;
    store_row(dk + (kv_rows0 + key) * HD, acc_k, e, t, scale);
    store_row(dv + (kv_rows0 + key) * HD, acc_v, e, t, 1.0f);
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

template <int HD, int BQ, int BK>
int launch_bwd_dq(const u16* q, const u16* k, const u16* v, const u16* dout,
                  const float* lse, const float* delta, u16* dq, int B, int H,
                  int KV, int Sq, int Sk, float scale, int causal,
                  cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD, BQ, BK>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  return launch(flash_bwd_dq_bf16_kernel<HD, BQ, BK>,
                static_cast<long long>((Sq + BQ - 1) / BQ) * B * H, 2 * BQ,
                smem, stream, q, k, v, dout, lse, delta, dq, B * H, H, KV,
                Sq, Sk, scale, causal);
}

template <int HD, int BK, int BQ>
int launch_bwd_dkv(const u16* q, const u16* k, const u16* v, const u16* dout,
                   const float* lse, const float* delta, u16* dk, u16* dv,
                   int B, int H, int KV, int Sq, int Sk, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD, BK, BQ>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  return launch(flash_bwd_dkv_bf16_kernel<HD, BK, BQ>,
                static_cast<long long>((Sk + BK - 1) / BK) * B * KV, 2 * BK,
                smem, stream, q, k, v, dout, lse, delta, dk, dv, B * KV, H,
                KV, Sq, Sk, scale, causal);
}

}  // namespace bf

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
      return bf::launch_bwd_dq<16, 64, 32>(BWD_DQ_ARGS);
    case 32:
      return bf::launch_bwd_dq<32, 64, 32>(BWD_DQ_ARGS);
    case 64:
      return bf::launch_bwd_dq<64, 64, 32>(BWD_DQ_ARGS);
    case 112:
      return bf::launch_bwd_dq<112, 64, 32>(BWD_DQ_ARGS);
    case 128:
      return bf::launch_bwd_dq<128, 64, 32>(BWD_DQ_ARGS);
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
      return bf::launch_bwd_dkv<16, 64, 32>(BWD_DKV_ARGS);
    case 32:
      return bf::launch_bwd_dkv<32, 64, 32>(BWD_DKV_ARGS);
    case 64:
      return bf::launch_bwd_dkv<64, 64, 32>(BWD_DKV_ARGS);
    case 112:
      return bf::launch_bwd_dkv<112, 64, 16>(BWD_DKV_ARGS);
    case 128:
      return bf::launch_bwd_dkv<128, 64, 16>(BWD_DKV_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
