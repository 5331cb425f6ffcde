// Flash attention, forward and backward, float32 and bf16, on Hopper's
// tensor cores (sm_90a).  The float32 kernels come first; the bf16
// numerics are in the section "bf16", and the bf16 forward and backward,
// on warpgroup MMAs fed by TMA, in the section "bf16 on Hopper's
// warpgroup tensor cores"; the float32 backward at hd 112, on warpgroup
// MMAs fed by TMA too, in the section "float32 at hd 112 on Hopper's
// warpgroup tensor cores".
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py: the
// forward `_fwd` / `_fwd_kernel` (flash_fwd_kernel) and `_bwd_rule`'s
// `_dq_kernel` and `_dkv_kernel` (see the section "Backward").  For q (B,
// H, Sq, hd) and k, v (B, KV, Sk, hd), query head h reading KV head h / (H
// / KV) (the grouping of models/attention.py), and each query row i:
//   s_ij  = scale * (q_i . k_j),  masked to -1e30 where causal and
//           i + off < j
//   o_i   = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)
//   lse_i = m_i + log(max(l_i, 1e-30))
// with the running max m and sum l of an online softmax over key tiles, so
// no (Sq, Sk) score matrix reaches device memory.  The forwards take a
// query offset off >= 0 (0 without the mask; the backward has none): q's
// rows are the positions off + i of the keys' 0 .. Sk - 1, a block of a
// prompt split over 'data' meeting the keys gathered from position 0.
// Every causal bound of a forward (the key tiles a query tile reads, the
// tiles a warp skips, the element mask) is the diagonal moved right by
// off, so at off = 0 each does exactly what it did without one.  Unlike the TPU kernel it
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
                 int Sk, float scale, int causal, int off) {
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

  const int k_end = causal ? min(Sk, q0 + off + BQ) : Sk;
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
    if (!causal || k0 <= q0 + off + r0 + 15) {
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
          } else if (causal && j > rows[e / 2] + off) {
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
               int causal, int off, cudaStream_t stream) {
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
          q, k, v, o, lse, B * H, H, KV, Sq, Sk, scale, causal, off);
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
// Tiles and shared memory a block (hd 112 takes the kernels of the
// section "float32 at hd 112 on Hopper's warpgroup tensor cores"):
//   dq   hd 16, 32: BQ 64, BK 32, 32 KB; hd 64: 64 KB, three blocks an
//        SM; hd 128: BQ 128 (8 warps), BK 32, 192 KB
//   dkv  hd 16, 32: BK 64, BQ 32, 48.5 KB; hd 64: 96.5 KB, two blocks an
//        SM; hd 128: BK 128 (8 warps), BQ 16, 224.3 KB

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
// every product runs on Hopper's warpgroup tensor cores (`wgmma`, fed by
// TMA copies: the section "bf16 on Hopper's warpgroup tensor cores") in
// bf16 with float32 accumulation.  The
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
namespace bf {

using u16 = unsigned short;

// lo and hi rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
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

}  // namespace bf

// ---------------------------------------------------------------------------
// bf16 on Hopper's warpgroup tensor cores.
//
// The forward, dq and dk/dv kernels for bf16 q, k, v and dO: the forward's
// products (S = q k^T, then o += P v) and the float32 backward's (S = q
// k^T, dP = dO v^T, then dq += dS k, dv += P^T dO, dk += dS^T q), each on
// `wgmma.mma_async` m64nNk16 bf16 with float32 accumulators, the only way
// to Hopper's bf16 rate.  The numerics are the section "bf16"'s: bf16
// products summed in float32, P and dS rounded to bf16 (to nearest even)
// where they meet v, dO, q and k, everything else float32, o, dq, dk and
// dv rounded once as they are written; the k steps of every product in
// ascending order, a fixed order of sums and no atomics, so two launches
// give the same bits.  P = exp(S scale - lse) (the backward) and exp(S
// scale - m) (the forward's online softmax) are one fmaf and one
// ex2.approx with the scale and lse or m taken to base 2 (a few float32
// ulps, far below the bf16 rounding of P that follows): at the layer
// shapes the softmax's instructions, not the products, set these kernels'
// time, and expf's range reduction is several instructions more an
// element.
//
// Bound: as the section "bf16" says, the products at 989 TFLOP/s bound
// all three at the trainer's layers (forward 2 products, dq 3, dk/dv 4).
//
// Design of the backward (warp specialisation; the forward's is above its
// kernel).  A block is two consumer warpgroups and
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
  // where byte b of row r of a box lies: the 16-byte chunk's index XOR
  // the row's place in the swizzle (TMA's swizzle of kRowBytes)
  static __device__ __forceinline__ int at(int r, int b) {
    const int off = r * kRowBytes + b;
    return off ^ (((off >> 7) & (kRowBytes / 16 - 1)) << 4);
  }
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

// orders this thread's generic-proxy accesses to shared memory before the
// async-proxy ones (a TMA load) that a later barrier arrive releases: the
// PTX memory model orders the two proxies only through this fence
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// until at most one of this warpgroup's committed wgmma groups is pending
// (the older ones complete first)
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// named barrier `id` of `n` threads: waits until all n have arrived
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

// Design of the forward (FlashAttention-3's, on the backward's pieces).
// A block is two consumer warpgroups of 64 query rows each (kFwdBQ = 128
// rows of one (b, h) a query tile) and a producer warpgroup, 384 threads,
// and it is persistent: one block an SM walks over query tiles (the ones
// with the most key tiles first, dealt to the blocks in a snake order so
// that each block's sum of work is about the mean), so that one tile's
// loads run under the last one's softmax and store.  One producer thread
// loads each tile's q by TMA into one of kFwdQBufs Q buffers, each with a
// full and an empty `mbarrier`, and streams K and V through a ring of
// stages of kFwdBK keys (as many as fit, up to kFwdMaxStages: 5 at hd 112
// and 128, 8 below), each with a full and an empty `mbarrier`; the
// consumers never copy and the main loop has no __syncthreads().  The
// tensor maps are the backward's (3-D over (B*H, Sq, hd) and (B*KV, Sk,
// hd)), so a ragged tile's rows past S are zero inside their own head and
// hd 112's second box is zero past column 112.
// Each consumer warpgroup computes S = Q K^T from shared memory (both
// operands K-major, one m64n64 wgmma a k step), runs the online softmax in
// registers (lane (g, t) of warp w holds columns 2t, 2t + 1 of rows 16w + g
// and 16w + g + 8 of each 8-column group: the row max and sum over the 4
// lanes of a quad by xor shuffles 1 and 2, a fixed order), rounds P to bf16
// into the m64k16 A fragments straight from the accumulator registers, and
// sums O += P V as register-A wgmma against V through the descriptor's
// transpose bit (MN-major), dq's dS K.  m stays in natural units: the max
// of s is taken raw (a positive scale keeps the order, so the rounded
// product of the max is the max of the rounded products), p = ex2(fmaf(s,
// scale log2e, -m log2e)), and lse = m + log(l).  l is summed by each lane
// over its own columns and over the quad once at the end; O is rescaled by
// alpha once a key tile, in registers.  o, rounded to bf16 once as acc (1 /
// max(l, 1e-30)), goes into the warpgroup's own rows of its Q buffer (the
// swizzle TMA wrote q in) and out as 16-byte stores of whole rows (4 bytes
// a lane straight from the registers took longer, a TMA store about as
// long); lse from the registers.
// The schedule: after the first key tile, a warpgroup issues S of key tile
// j, then O += P V of tile j - 1, as two commit groups, and runs tile j's
// softmax while the second is on the tensor cores (FlashAttention-3's
// in-warpgroup overlap: S_j and P_{j-1} live at once).  The
// inter-warpgroup ping-pong (the two warpgroups taking turns to issue on
// named barriers) was no faster here, and P V before S with no overlap
// slower: both stay as patches in tools/flash_fwd_bf16_variants.py.
// ptxas waits after every wgmma where a wgmma's
// registers are touched while it runs, or where it takes a branch around
// a wgmma or its wait for divergent (its notes C7514 and C7518;
// tools/ptxas_report.py fails on them): so the loop is peeled (the first S
// alone, the last P V alone), o is rescaled before a stage's first
// wgmma, and the warpgroup index is broadcast by a shuffle, which ptxas
// sees as uniform.  tools/flash_fwd_bf16_variants.py builds and times the
// schedules, key tiles, rings, stores and grids this source does not
// take, and probes that drop one part of the work.
// Causal: a warpgroup skips the key tiles whose first key lies past all of
// its 64 rows (exact: alpha 1, p 0), and one whose rows all lie past Sq
// skips every tile; only the diagonal tile and the ragged last tile mask
// (a zero-filled K row past Sk gives s = 0 and must weigh 0).  Registers:
// at hd 128 O is 64 floats a consumer thread, S 32 and P 16 words.
constexpr int kFwdBQ = 64 * kConsumers;
constexpr int kFwdBK = 64, kFwdMaxStages = 8, kFwdQBufs = 2;

// the forward's shared memory: kFwdQBufs Q buffers (kFwdBQ rows each),
// then kStages stages of K and V (kFwdBK rows each: as many as fit, up to
// kFwdMaxStages), then the barriers
template <int HD>
struct FwdSmem {
  using G = Geo<HD>;
  static constexpr int kQ = G::tile(kFwdBQ);
  static constexpr int kK = G::tile(kFwdBK);
  static constexpr int kStage = 2 * kK;
  static constexpr int kFit =
      (232448 - 1024 - 8 * (2 * kFwdMaxStages + 2 * kFwdQBufs) -
       kFwdQBufs * kQ) / kStage;
  static constexpr int kStages = kFit < kFwdMaxStages ? kFit : kFwdMaxStages;
  static constexpr int kBars = kFwdQBufs * kQ + kStages * kStage;
  static constexpr int kBytes =
      kBars + 8 * (2 * kStages + 2 * kFwdQBufs) + 1024;
};

// a query tile: head bh (of B*H), rows q0 .. q0 + kFwdBQ - 1, n_kt key
// tiles (none past the diagonal, moved right by the offset, under the
// mask)
struct FwdTile {
  int bh, q0, n_kt;
};

// the block's round-th query tile, or bh -1 past the last: tile i is head
// i % BH's query tile i / BH counted from the end under the mask (the
// most key tiles first); round r deals tiles r G .. r G + G - 1 to the G
// blocks, in reverse order on odd rounds
__device__ __forceinline__ FwdTile fwd_tile(int round, int n_tiles, int BH,
                                            int Sq, int Sk, int causal,
                                            int off) {
  const int G = gridDim.x;
  const int i = round * G + (round & 1 ? G - 1 - blockIdx.x : blockIdx.x);
  if (i >= n_tiles) return {-1, 0, 0};
  const int qt = i / BH;
  const int q0 = (causal ? (Sq + kFwdBQ - 1) / kFwdBQ - 1 - qt : qt) * kFwdBQ;
  const int k_end = causal ? min(Sk, q0 + off + kFwdBQ) : Sk;
  return {i % BH, q0, (k_end + kFwdBK - 1) / kFwdBK};
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      u16* __restrict__ o, float* __restrict__ lse, int BH,
                      int H, int KV, int Sq, int Sk, float scale, int causal,
                      int off, int n_tiles) {
  using G = Geo<HD>;
  using L = FwdSmem<HD>;
  constexpr int BQ = kFwdBQ, BK = kFwdBK, NS = BK / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* stages = smem + kFwdQBufs * L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  uint64_t* q_empty = q_full + kFwdQBufs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    for (int b = 0; b < kFwdQBufs; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], kConsumers);      // a thread a warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, as a value ptxas sees is the same across each warp:
  // the wgmma issues and waits below sit under branches on it, and a
  // branch ptxas takes for divergent serializes every wgmma (C7518)
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers) {
    // the producer: one thread loads; the others leave
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 != 0) return;
    int kv = 0;                                  // K/V tiles streamed
    for (int round = 0;; ++round) {
      const FwdTile tile =
          fwd_tile(round, n_tiles, BH, Sq, Sk, causal, off);
      if (tile.bh < 0) break;
      const int b = round % kFwdQBufs;
      mbar_wait(&q_empty[b], ((round / kFwdQBufs) & 1) ^ 1);
      mbar_expect_tx(&q_full[b], L::kQ);
      tma_tile<HD>(smem + b * L::kQ, &tq, &q_full[b], tile.q0, tile.bh, BQ);
      const int bkv = tile.bh / H * KV + tile.bh % H / (H / KV);
      for (int kt = 0; kt < tile.n_kt; ++kt, ++kv) {
        const int s = kv % L::kStages;
        mbar_wait(&empty[s], ((kv / L::kStages) & 1) ^ 1);
        unsigned char* st = stages + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        tma_tile<HD>(st, &tk, &full[s], kt * BK, bkv, BK);
        tma_tile<HD>(st + L::kK, &tv, &full[s], kt * BK, bkv, BK);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale2 = __fmul_rn(scale, kLog2e);
  const uint32_t st0 = smem_u32(stages);
  int kv = 0;                                    // K/V tiles consumed
  for (int round = 0;; ++round) {
    const FwdTile tile = fwd_tile(round, n_tiles, BH, Sq, Sk, causal, off);
    if (tile.bh < 0) break;
    const int n_kt = tile.n_kt;
    const int qb = round % kFwdQBufs;
    unsigned char* qs = smem + qb * L::kQ;
    const uint32_t qa = smem_u32(qs);
    const int qw = tile.q0 + 64 * wg;            // this warpgroup's queries
    // its key tiles: the first n_own of the tile's (none past its rows'
    // diagonal, none at all if its rows all lie past Sq)
    const int n_own = qw >= Sq ? 0
                      : causal ? min(n_kt, (qw + off + 63) / BK + 1)
                               : n_kt;
    int rows[2];
    float m[2], l[2], alpha[2] = {1.0f, 1.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h] = qw + 16 * w + g + 8 * h;
      m[h] = kMaskValue;
      l[h] = 0.0f;
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    float sc[NS][32];                            // S, then P, of a tile
    uint32_t pa[NS][4][4];                       // P of the one before, bf16

    auto issue_s = [&](uint32_t ka) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::kSteps; ++kk) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          ss_m64n64(sc[n], kmajor<HD>(qa, BQ, 64 * wg, kk),
                    kmajor<HD>(ka, BK, 64 * n, kk), kk);
        }
      }
      wg_commit();
    };
    auto issue_pv = [&](uint32_t va) {          // o += P v
      wg_fence();
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          rs<HD>(acc, pa[n][kq], mnmajor<HD>(va, BK, 4 * n + kq));
        }
      }
      wg_commit();
    };

    // the online softmax of key tile kt's S, in place: sc becomes P
    auto softmax = [&](int kt) {
#pragma unroll
      for (int n = 0; n < NS; ++n) fence_regs(sc[n]);
      const int k0 = kt * BK;
      // the diagonal tile and the ragged last one mask
      if ((causal && k0 + BK - 1 > qw + off) || k0 + BK > Sk) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int j = k0 + 64 * n + 8 * (e / 4) + 2 * t + (e & 1);
            if (j >= Sk || (causal && j > rows[(e >> 1) & 1] + off)) {
              sc[n][e] = -CUDART_INF_F;          // weighs 0
            }
          }
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[n][e]);
        }
      }
      float mneg[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new =
            fmaxf(m[h], __fmul_rn(tc::quad_max(mx[h]), scale));
        alpha[h] = ex2(__fmul_rn(__fsub_rn(m[h], m_new), kLog2e));
        m[h] = m_new;
        mneg[h] = -__fmul_rn(m_new, kLog2e);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int h = (e >> 1) & 1;
          sc[n][e] = ex2(__fmaf_rn(sc[n][e], scale2, mneg[h]));
          sum[h] = __fadd_rn(sum[h], sc[n][e]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = __fmaf_rn(l[h], alpha[h], sum[h]);
    };
    // o = alpha o, before any wgmma of a stage is issued: ptxas serializes
    // every wgmma if o's registers are touched while S is in flight
    auto rescale = [&] {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        acc[i] = __fmul_rn(acc[i], alpha[(i >> 1) & 1]);
      }
    };
    auto stage = [&](int kt) { return (kv + kt) % L::kStages; };
    auto wait_full = [&](int kt) {
      mbar_wait(&full[stage(kt)], ((kv + kt) / L::kStages) & 1);
    };
    auto k_at = [&](int kt) { return st0 + stage(kt) * L::kStage; };

    mbar_wait(&q_full[qb], (round / kFwdQBufs) & 1);
    if (n_own > 0) {
      wait_full(0);
      issue_s(k_at(0));
      wg_wait_all();
      softmax(0);
#pragma unroll
      for (int n = 0; n < NS; ++n) a_fragments(pa[n], sc[n]);
    }
    // key tile kt's S and softmax, and key tile kt - 1's P V, in one stage
    for (int kt = 1; kt < n_own; ++kt) {
      wait_full(kt);
      rescale();
      issue_s(k_at(kt));
      issue_pv(k_at(kt - 1) + L::kK);
      wg_wait_one();                              // S is done, P V runs on
      softmax(kt);
      wg_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int n = 0; n < NS; ++n) fence_regs(sc[n]);
      mbar_arrive(&empty[stage(kt - 1)]);
#pragma unroll
      for (int n = 0; n < NS; ++n) a_fragments(pa[n], sc[n]);
    }
    if (n_own > 0) {                             // the last tile's P V
      rescale();
      issue_pv(k_at(n_own - 1) + L::kK);
      wg_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[stage(n_own - 1)]);
    }
    // the key tiles past this warpgroup's rows: released unread
    for (int kt = n_own; kt < n_kt; ++kt) {
      wait_full(kt);
      mbar_arrive(&empty[stage(kt)]);
    }
    kv += n_kt;

    // o = acc / max(l, 1e-30), rounded to bf16 into this warpgroup's rows
    // of the Q buffer (its last S is done; the other warpgroup reads only
    // its own rows), swizzled as TMA wrote q; then the warpgroup copies the
    // rows out and, once every thread has fenced its accesses against the
    // next TMA load of q, one thread frees the buffer
    if (qw < Sq) {
      const size_t rows0 = static_cast<size_t>(tile.bh) * Sq;
      float f[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float denom = fmaxf(tc::quad_sum(l[h]), 1e-30f);
        f[h] = __fdiv_rn(1.0f, denom);
        if (t == 0 && rows[h] < Sq) {
          lse[rows0 + rows[h]] = __fadd_rn(m[h], logf(denom));
        }
      }
      unsigned char* os = qs + 64 * wg * G::kRowBytes;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int c = 8 * n + 2 * t;             // this lane's two columns
        unsigned char* box = os + (c / G::kBoxCols) * BQ * G::kRowBytes;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<uint32_t*>(
              box + G::at(16 * w + g + 8 * h, 2 * (c % G::kBoxCols))) =
              pack(__fmul_rn(acc[4 * n + 2 * h], f[h]),
                   __fmul_rn(acc[4 * n + 2 * h + 1], f[h]));
        }
      }
      // 16 bytes a thread a copy, a row's in order: whole lines
      bar_sync(3 + wg, 128);
      constexpr int kRowChunks = HD / 8;
      for (int q = threadIdx.x % 128; q < 64 * kRowChunks; q += 128) {
        const int r = q / kRowChunks, c = 8 * (q % kRowChunks);
        if (qw + r < Sq) {
          const unsigned char* box =
              os + (c / G::kBoxCols) * BQ * G::kRowBytes;
          *reinterpret_cast<uint4*>(o + (rows0 + qw + r) * HD + c) =
              *reinterpret_cast<const uint4*>(
                  box + G::at(r, 2 * (c % G::kBoxCols)));
        }
      }
      fence_proxy_async();
      bar_sync(3 + wg, 128);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(&q_empty[qb]);
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
int launch_fwd(const u16* q, const u16* k, const u16* v, u16* o, float* lse,
               int B, int H, int KV, int Sq, int Sk, float scale, int causal,
               int off, cudaStream_t stream) {
  constexpr size_t smem = FwdSmem<HD>::kBytes;
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  // q in boxes of the block's rows, k and v of a tile's
  CUtensorMap m[3];
  cudaError_t err = tensor_map<HD>(&m[0], q, Sq, B * H, kFwdBQ);
  if (err == cudaSuccess) err = tensor_map<HD>(&m[1], k, Sk, B * KV, kFwdBK);
  if (err == cudaSuccess) err = tensor_map<HD>(&m[2], v, Sk, B * KV, kFwdBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((Sq + kFwdBQ - 1) / kFwdBQ) * B * H;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // a block an SM, each walking over its share of the query tiles
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return bf::launch(flash_fwd_bf16_kernel<HD>, tiles < sms ? tiles : sms,
                    kThreads, smem, stream, m[0], m[1], m[2], o, lse,
                    B * H, H, KV, Sq, Sk, scale, causal, off,
                    static_cast<int>(tiles));
}

template <int HD>
cudaError_t attributes(cudaFuncAttributes* dq, cudaFuncAttributes* dkv) {
  const cudaError_t err =
      cudaFuncGetAttributes(dq, flash_bwd_dq_bf16_kernel<HD>);
  return err != cudaSuccess
             ? err
             : cudaFuncGetAttributes(dkv, flash_bwd_dkv_bf16_kernel<HD>);
}

template <int HD>
cudaError_t fwd_attributes(cudaFuncAttributes* fwd) {
  return cudaFuncGetAttributes(fwd, flash_fwd_bf16_kernel<HD>);
}

}  // namespace hb

// ---------------------------------------------------------------------------
// float32 at hd 112 on Hopper's warpgroup tensor cores.
//
// The dq and dk/dv kernels for float32 q, k, v and dO at hd 112 (kimi-k2's
// head dim): the function of the section "Backward" (the TPU kernel's
// `_dq_kernel` and `_dkv_kernel` under `_bwd_rule`), with the score
// products on `wgmma` m64n32k8 TF32 fed by TMA copies and the accumulation
// products on `mma.sync` m16n8k8 TF32, all in 3xTF32.  The other head dims
// keep the kernels of the section "Backward".
//
// Operands.  TF32 `wgmma` reads both shared-memory operands K-major only (it
// has no transpose bit).  The score products have both K-major as stored
// (hd contiguous): S = Q K^T and dP = dO V^T in dq, S^T = K Q^T and dP^T =
// V dO^T in dk/dv, so they go to `wgmma` from shared memory.  The three
// accumulation products (dq += dS K, dv += P^T dO, dk += dS^T Q) sum over
// keys or queries, the rows of their B as stored (MN-major): a transposed
// copy of each streamed tile, hi and lo, has no room beside two stages
// (below), so they stay on `mma.sync`, fed straight from the `wgmma`
// accumulators (each warp's 16 rows of an m64n32 accumulator have the
// m16n8 layout that tc::acc_to_a takes) and reading B from the tiles the
// score products read.  Those reads are conflict-free: under the 64-byte
// swizzle rows 2t and 2t + 1 lie in the two halves of one 128-byte line,
// so lanes g < 4 read row 2t and lanes g >= 4 row 2t + 1 in one load and
// the other in the next, and each lane swaps its pair back (load_b).  A
// fragment's chain of `mma.sync` is dependent throughout, so the output
// fragments go two at a time, their chains interleaved
// (tools/flash_bwd_f32_variants.py times other counts).
//
// 3xTF32.  Every tile that TMA lands is split once by the producer
// warpgroup, as the section "Backward" splits: hi = tf32(x) (to nearest,
// ties away) in place, lo = tf32(x - hi) in a tile beside it, so the
// tensor cores read hi exactly.  A raw float32 tile would be read as a
// truncated hi, whose dropped lo * lo term is four times larger: it puts
// dq and dk at Sq = Sk = 1 over phase 20's bar on 0.25 % of draws
// (tools/tc_truncation.py; tests/test_torch_flash_bwd_f32_hd112.py).  A
// product is lo*hi + hi*lo + hi*hi; `wgmma` sums each of its 8 columns into
// the accumulator and truncates, so a chain drifts with its length.  S
// sums its 28 cross terms first (small, so their truncation is too) and
// then its 14 hi * hi steps in one chain; dP the same but with its hi * hi
// steps dealt in turn to kDpChains = 4 accumulators, joined in order by
// rounded adds (tools/tc_truncation.py: one chain puts dq and dk at Sq =
// Sk = 1 over the bar on 4.3 % of 4,000 draws at hd 112, two on 0.25 %,
// four on none, with the most margin).  The
// accumulation products sum each step's 32 rows in the tensor cores from
// 0 (tc::mma3's order) and join their float32 accumulators by one rounded
// add a step, as the section "Backward" does a tile.  p = exp(s scale -
// lse) is one fmaf and one ex2.approx with the scale and lse taken to base
// 2 (a few float32 ulps).  No atomics and a fixed order: two launches give
// the same bits.
//
// Bound: the section "Backward"'s (dq 3 products, dk/dv 4, at 3xTF32's 165
// TFLOP/s of the 495 TFLOP/s dense TF32 of NVIDIA's H100 SXM data sheet,
// 700 W): operations bound both at kimi-k2's layer (chip_smoke.py phase 20
// prints each bound beside each time).
//
// Design.  A block is one consumer warpgroup, which owns kRows = 64 output
// rows (keys in dk/dv, queries in dq), and one producer warpgroup (256
// threads).  The producer's thread 0 issues every copy as a TMA load
// (`cp.async.bulk.tensor.3d`, 3-D maps over (B*H or B*KV, S, hd), so a
// ragged tile's rows past S are zero inside their own head), and its 128
// threads split each tile once it lands and release it to the consumer
// on a `ready` mbarrier after a `fence.proxy.async` (their generic writes
// come before the tensor cores' reads and before TMA refills the buffer);
// the consumer never copies and the main loop has no __syncthreads().
// The producer splits step i, then issues step i + 1's copy once the
// consumer has released its stage, so a step's copy and split run under
// the step before.
//   dk/dv: the block holds K and V of its 64 keys (hi and lo, resident) and
//   streams kStep = 32 queries a step through kStages stages (Q and dO, hi
//   and lo; lse * log2 e and delta by the producer's plain loads, +inf and 0
//   past Sq, so P and dS vanish there), each of the G query heads of the
//   group in turn: GQA's sum runs inside the block in a fixed order.  Where
//   the grid is one wave under the mask (kimi-k2's: 16 key tiles x 16 KV
//   heads), a block takes a key tile and its mirror from the far end of Sk
//   in turn, so every block walks as many query steps as any other (272 at
//   kimi-k2's shape); over several waves, one tile a block, the most work
//   first.  Query steps before the tile's first key are not streamed, the
//   two diagonal steps mask.
//   dq: persistent, one block an SM, walking its share of the 64-query
//   tiles (the most key steps first, dealt in a snake order, as
//   hb::flash_fwd_bf16_kernel deals them); the block holds Q and dO (hi and
//   lo) of its tile and streams kStep = 32 keys a step, up to the diagonal.
//   The next tile's first K and V copy runs under the last step.
// Shared memory at hd 112 (pitch 112, the 64-byte swizzle: 7 boxes of 16
// columns a row): a 64-row tile is 28 KB, so the resident hi and lo of two
// tensors are 112 KB; a stage of 32 rows of two tensors, hi and lo, is 56
// KB, and two stages 112 KB: 224 KB, with lse, delta and the barriers
// 225.6 KB of the 227 KB a block can use.  Two consumer warpgroups (128
// output rows) or stages of 64 rows would need 112 KB more, a transposed
// copy of the accumulation products' B 28 KB a stage; one stage would
// leave every copy exposed.  One block an SM.
// Registers: with 256 threads a block every thread may take 255, so the
// producer needs no `setmaxnreg` to give any back.  dk and dv are 56 + 56 a
// consumer thread (dv stays in registers); the four dP^T chains and S^T
// would be 80 more, so dk/dv issues its score products in five commit
// groups (dP's chains one at a time, each joined as it is done, then S:
// no more than two accumulators at once), and dq, with room, in one.  A step's
// descriptors are one a tile, each instruction adding its offset
// (ss_m64n32), and the resident tiles' and the lanes' offsets are rebuilt
// each step (opaque), not held through the loop.  chip_smoke.py phase 20
// (b) prints both kernels' registers and local bytes, and fails on a
// spill.
namespace tf {

constexpr int kThreads = 256;   // the consumer warpgroup, then the producer's
constexpr int kRows = 64;       // a block's output rows: keys or queries
constexpr int kStep = 32;       // the rows a step streams: queries or keys
constexpr int kStages = 2;
constexpr int kDpChains = 4;    // dP's hi * hi steps in 4 chains
constexpr int kDkvChainsAtOnce = 1;  // dP's chains a commit group in dk/dv
// output fragments an accumulation product interleaves (more would spill
// in dk/dv: tools/flash_bwd_f32_variants.py)
constexpr int kAccDv = 2, kAccDk = 2, kAccDq = 2;

// A tile of rows of HD float32 values in shared memory, as TMA writes it:
// HD / 16 boxes of `rows` rows of 64 bytes (16 columns), each under the
// 64-byte swizzle; a wgmma k step covers 8 columns (32 bytes), two a box
template <int HD>
struct Geo {
  static_assert(HD % 16 == 0, "whole boxes of 16 columns");
  static constexpr int kSteps = HD / 8;
  __host__ __device__ static constexpr int tile(int rows) {
    return 4 * rows * HD;
  }
};

// rows row0 .. row0 + rows - 1 of head `head` (all HD columns) into a tile
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row0, int head,
                                         int rows) {
#pragma unroll
  for (int b = 0; b < HD / 16; ++b) {
    hb::tma_load3(dst + b * rows * 64, map, bar, 16 * b, row0, head);
  }
}

// the tile of `rows` rows at x, as TMA landed it, split by the 128 threads
// of the producer (p its thread): hi in place, lo to the same place at lo
template <int HD>
__device__ __forceinline__ void split_tile(unsigned char* x,
                                           unsigned char* lo, int rows,
                                           int p) {
  float4* x4 = reinterpret_cast<float4*>(x);
  uint4* lo4 = reinterpret_cast<uint4*>(lo);
  for (int e = p; e < rows * HD / 4; e += 128) {
    const float4 v = x4[e];
    uint4 h, l;
    tc::split(v.x, h.x, l.x);
    tc::split(v.y, h.y, l.y);
    tc::split(v.z, h.z, l.z);
    tc::split(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(x4)[e] = h;
    lo4[e] = l;
  }
}

// A K-major operand's descriptor: all rows of a tile at shared address
// `tile` (8 rows of 64 bytes a swizzle atom); the hd columns 8kk .. 8kk +
// 7 of a tile of R rows lie kmajor_at(R, kk) 16-byte units on
__device__ __forceinline__ uint64_t kmajor(uint32_t tile) {
  return hb::desc(tile, 16, 512, 2);
}

__host__ __device__ constexpr int kmajor_at(int rows, int kk) {
  return (kk >> 1) * rows * 4 + (kk & 1) * 2;
}

// x, as the compiler cannot see through: the resident tiles'
// descriptors, derived from it inside the step loop, are not hoisted out
// of it to hold registers through the loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// d (+)= A . B^T, m64n32k8 TF32: A (64 x 8) and B (32 x 8) K-major in
// shared memory, their descriptors da + OA and db + OB (added here, so the
// compiler keeps one descriptor a tile and no copy an instruction); ACC 0
// overwrites d
template <int OA, int OB, int ACC>
__device__ __forceinline__ void ss_m64n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "add.s64 a, %16, %18;\nadd.s64 b, %17, %19;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, a, b, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "n"(OA), "n"(OB), "n"(ACC));
}

// A step's eight tiles, by their place after the first of their four:
// x hi, x lo, a hi, a lo (the block's 64 rows, at descriptor dx), y hi,
// y lo, b hi, b lo (the step's 32, at dy)
enum { kHi = 0, kLo = 1, kBHi = 2, kBLo = 3 };

// ss_m64n32 on hd step KK of the block's tile TA and the step's tile TB
template <int HD, int KK, int TA, int TB, int ACC>
__device__ __forceinline__ void ss(float (&d)[16], uint64_t dx,
                                   uint64_t dy) {
  ss_m64n32<kmajor_at(kRows, KK) + TA * (Geo<HD>::tile(kRows) >> 4),
            kmajor_at(kStep, KK) + TB * (Geo<HD>::tile(kStep) >> 4), ACC>(
      d, dx, dy);
}

// Turn I of a score product, I < 2 kSteps: the cross terms of hd step I
// (I < kSteps), then the hi * hi product of hd step I - kSteps.  dP's hi *
// hi step kk belongs to chain kk kDpChains / kSteps; dp_turn issues dP's
// chains LO .. LO + CA - 1, chain 0 (its cross terms first) into dp[0],
// the others into dp[1] on (chain 0's group: dp[c]); s_turn issues S into
// sc
template <int HD, int LO, int CA, int I>
__device__ __forceinline__ void dp_turn(float (&dp)[kDpChains + 1][16],
                                        uint64_t dx, uint64_t dy) {
  constexpr int K = Geo<HD>::kSteps;
  if constexpr (I < 2 * K) {
    constexpr int kk = I % K;
    constexpr int c = kk * kDpChains / K;
    constexpr bool first = kk == 0 || (kk - 1) * kDpChains / K != c;
    constexpr int slot = LO == 0 ? c : 1 + c - LO;
    if constexpr (I < K && LO == 0) {
      ss<HD, kk, kBLo, kBHi, (kk > 0)>(dp[0], dx, dy);
      ss<HD, kk, kBHi, kBLo, 1>(dp[0], dx, dy);
    } else if constexpr (I >= K && c >= LO && c < LO + CA) {
      ss<HD, kk, kBHi, kBHi, (c > 0 && first ? 0 : 1)>(dp[slot], dx, dy);
    }
    dp_turn<HD, LO, CA, I + 1>(dp, dx, dy);
  }
}

template <int HD, int I>
__device__ __forceinline__ void s_turn(float (&sc)[16], uint64_t dx,
                                       uint64_t dy) {
  constexpr int K = Geo<HD>::kSteps;
  if constexpr (I < 2 * K) {
    constexpr int kk = I % K;
    if constexpr (I < K) {
      ss<HD, kk, kLo, kHi, (kk > 0)>(sc, dx, dy);
      ss<HD, kk, kHi, kLo, 1>(sc, dx, dy);
    } else {
      ss<HD, kk, kHi, kHi, 1>(sc, dx, dy);
    }
    s_turn<HD, I + 1>(sc, dx, dy);
  }
}

// dP's chains LO on, CA a commit group, each group joined into dp[0] in
// chain order by rounded adds once it is done
template <int HD, int CA, int LO = 0>
__device__ __forceinline__ void dp_groups(float (&dp)[kDpChains + 1][16],
                                          uint64_t dx, uint64_t dy) {
  if constexpr (LO < kDpChains) {
    static_assert(kDpChains % CA == 0, "whole groups of chains");
    hb::wg_fence();
    dp_turn<HD, LO, CA, 0>(dp, dx, dy);
    hb::wg_commit();
    hb::wg_wait_all();
    constexpr int used = LO == 0 ? CA : CA + 1;     // accumulators
#pragma unroll
    for (int c = 0; c < used; ++c) hb::fence_regs(dp[c]);
#pragma unroll
    for (int c = 1; c < used; ++c) {
#pragma unroll
      for (int e = 0; e < 16; ++e) dp[0][e] = __fadd_rn(dp[0][e], dp[c][e]);
    }
    dp_groups<HD, CA, LO + CA>(dp, dx, dy);
  }
}

// A step's two score products, sc = x . y^T and dp = a . b^T over the hd
// columns (x and a the block's 64 rows, y and b the step's 32; the
// descriptors dx and dy), each chain summing its cross terms lo*hi and
// hi*lo first, then its hi*hi steps; dp's hi*hi steps in kDpChains
// chains, joined in order by rounded adds -> dp in dp[0].  dP's chains go
// CA a commit group, then S in its own, so that no more than CA + 1
// accumulators hold registers at once
template <int HD, int CA>
__device__ __forceinline__ void scores(float (&sc)[16],
                                       float (&dp)[kDpChains + 1][16],
                                       uint64_t dx, uint64_t dy) {
  dp_groups<HD, CA>(dp, dx, dy);
  hb::wg_fence();
  s_turn<HD, 0>(sc, dx, dy);
  hb::wg_commit();
  hb::wg_wait_all();
  hb::fence_regs(sc);
  hb::fence_regs(dp[0]);
}

// score_turn in one commit group: S into sc, dP's chain c into dp[c]
template <int HD, int I>
__device__ __forceinline__ void score_turn_all(float (&sc)[16],
                                               float (&dp)[kDpChains][16],
                                               uint64_t dx, uint64_t dy) {
  constexpr int K = Geo<HD>::kSteps;
  if constexpr (I < 2 * K) {
    constexpr int kk = I % K;
    constexpr int c = kk * kDpChains / K;
    constexpr bool first = c > 0 && (kk - 1) * kDpChains / K != c;
    if constexpr (I < K) {
      ss<HD, kk, kLo, kHi, (kk > 0)>(sc, dx, dy);
      ss<HD, kk, kHi, kLo, 1>(sc, dx, dy);
      ss<HD, kk, kBLo, kBHi, (kk > 0)>(dp[0], dx, dy);
      ss<HD, kk, kBHi, kBLo, 1>(dp[0], dx, dy);
    } else {
      ss<HD, kk, kHi, kHi, 1>(sc, dx, dy);
      ss<HD, kk, kBHi, kBHi, (first ? 0 : 1)>(dp[c], dx, dy);
    }
    score_turn_all<HD, I + 1>(sc, dp, dx, dy);
  }
}

// scores in one commit group, every chain's accumulator at once (dq's
// registers have the room; dk/dv's do not): the same chains, joined in the
// same order -> dp in dp[0]
template <int HD>
__device__ __forceinline__ void scores_one_group(
    float (&sc)[16], float (&dp)[kDpChains][16], uint64_t dx, uint64_t dy) {
  hb::wg_fence();
  score_turn_all<HD, 0>(sc, dp, dx, dy);
  hb::wg_commit();
  hb::wg_wait_all();
  hb::fence_regs(sc);
#pragma unroll
  for (int c = 0; c < kDpChains; ++c) hb::fence_regs(dp[c]);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    float x = dp[0][e];
#pragma unroll
    for (int c = 1; c < kDpChains; ++c) x = __fadd_rn(x, dp[c][e]);
    dp[0][e] = x;
  }
}

// This lane's float offsets in a step's (kStep, hd) tile for the B
// operand of c . y, k permuted as tc::acc_to_a's: b0 = y[k0 + 2t][n0 + g],
// b1 = y[k0 + 2t + 1][n0 + g].  Lanes g >= 4 load row 2t + 1 first, so
// each load's 32 lanes fall in 32 distinct banks (rows 2t and 2t + 1 lie
// in the two halves of one 128-byte line), and swap the pair back.  Under
// the 64-byte swizzle, element (r, c) of a tile of R rows is float (c >>
// 4) R 16 + r 16 + 4 (((c & 15) >> 2) ^ ((r >> 1) & 3)) + (c & 3); here r
// >> 1 & 3 is t for every k0 (a multiple of 8), so a lane's offset is one
// of four, by load and by n0 / 8 even or odd, plus a constant
struct BLanes {
  int first[2], second[2];        // [n0 / 8 odd]
  __device__ __forceinline__ BLanes(int g, int t) {
    const int sw = g >> 2;
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int col = 4 * ((2 * odd + sw) ^ t) + (g & 3);
      first[odd] = (2 * t + sw) * 16 + col;
      second[odd] = (2 * t + 1 - sw) * 16 + col;
    }
  }
};

template <int K0, int N0>
__device__ __forceinline__ void load_b(tc::FragB& b, const float* yh,
                                       const float* yl, const BLanes& ln,
                                       int sw) {
  constexpr int base = (N0 >> 4) * kStep * 16 + K0 * 16;
  const int i0 = base + ln.first[(N0 >> 3) & 1];
  const int i1 = base + ln.second[(N0 >> 3) & 1];
  const uint32_t h0 = __float_as_uint(yh[i0]), h1 = __float_as_uint(yh[i1]);
  const uint32_t l0 = __float_as_uint(yl[i0]), l1 = __float_as_uint(yl[i1]);
  b.hi[0] = sw ? h1 : h0;
  b.hi[1] = sw ? h0 : h1;
  b.lo[0] = sw ? l1 : l0;
  b.lo[1] = sw ? l0 : l1;
}

// B of output fragments N0 / 8 + I .. N0 / 8 + W - 1, rows K0 .. K0 + 7
template <int K0, int N0, int W, int I = 0>
__device__ __forceinline__ void load_bs(tc::FragB (&b)[W], const float* yh,
                                        const float* yl, const BLanes& ln,
                                        int sw) {
  if constexpr (I < W) {
    load_b<K0, N0 + 8 * I>(b[I], yh, yl, ln, sw);
    load_bs<K0, N0, W, I + 1>(b, yh, yl, ln, sw);
  }
}

// rows K0 .. K0 + 7 of W output fragments' chains: the A fragment split
// here from the accumulator c (again for each group of fragments: the raw
// accumulator holds half the registers of its split fragments), each
// chain in tc::mma3's order, the W chains interleaved
template <int K0, int N0, int W>
__device__ __forceinline__ void acc_step(float (&x)[W][4],
                                         const float (&c)[16],
                                         const float* yh, const float* yl,
                                         const BLanes& ln, int sw) {
  tc::FragA a;
  tc::acc_to_a(a, reinterpret_cast<const float(&)[4]>(c[K0 / 2]));
  tc::FragB b[W];
  load_bs<K0, N0, W>(b, yh, yl, ln, sw);
#pragma unroll
  for (int i = 0; i < W; ++i) tc::mma_tf32(x[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < W; ++i) tc::mma_tf32(x[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < W; ++i) tc::mma_tf32(x[i], a.hi, b[i].hi);
}

// the output fragments ND .. HD / 8 - 1 of accumulate, W at a time: a
// fragment's chain of mma.sync is dependent throughout, so the chains of W
// fragments interleave
template <int HD, int W, int ND>
__device__ __forceinline__ void accumulate_from(
    tc::RegAcc<HD / 8>& acc, float (&c)[16], const float* yh,
    const float* yl, const BLanes& ln, int sw) {
  static_assert((HD / 8) % W == 0, "whole groups of fragments");
  if constexpr (ND < HD / 8) {
    hb::fence_regs(c);          // so the compiler splits c anew, not once
    float x[W][4];
#pragma unroll
    for (int i = 0; i < W; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][e] = 0.0f;
    }
    acc_step<0, 8 * ND, W>(x, c, yh, yl, ln, sw);
    acc_step<8, 8 * ND, W>(x, c, yh, yl, ln, sw);
    acc_step<16, 8 * ND, W>(x, c, yh, yl, ln, sw);
    acc_step<24, 8 * ND, W>(x, c, yh, yl, ln, sw);
#pragma unroll
    for (int i = 0; i < W; ++i) acc.add(ND + i, x[i]);
    accumulate_from<HD, W, ND + W>(acc, c, yh, yl, ln, sw);
  }
}

// acc += c . y: c this warp's 16 rows of a step's 64 x 32 accumulator (the
// A operand, each 8 columns by tc::acc_to_a), y the step's (kStep, hd)
// tile as B, its hi at yh and lo at yl.  Each output fragment sums the
// step in the tensor cores from 0, then joins acc in one rounded float32
// add.  The lane's offsets are computed here, from a lane index the compiler
// cannot see through, so they hold no registers between steps
template <int HD, int W>
__device__ __forceinline__ void accumulate(tc::RegAcc<HD / 8>& acc,
                                           float (&c)[16], const float* yh,
                                           const float* yl) {
  static_assert(kStep == 32, "four k steps of 8");
  const int lane = static_cast<int>(opaque(threadIdx.x % 32));
  const BLanes ln(lane / 4, lane % 4);
  accumulate_from<HD, W, 0>(acc, c, yh, yl, ln, lane >> 4);
}

// The shared memory of both kernels: the block's four 64-row tiles (x hi,
// x lo, a hi, a lo: K and V in dk/dv, Q and dO in dq), kStages stages of
// four kStep-row tiles (y hi, y lo, b hi, b lo: Q and dO, or K and V),
// dk/dv's lse and delta of each stage, then the barriers
template <int HD>
struct Smem {
  static constexpr int kBig = Geo<HD>::tile(kRows);
  static constexpr int kSmall = Geo<HD>::tile(kStep);
  static constexpr int kStage = 4 * kSmall;
  static constexpr int kStagesAt = 4 * kBig;
  static constexpr int kRowsAt = kStagesAt + kStages * kStage;
  static constexpr int kBarsAt = kRowsAt + 4 * 2 * kStep * kStages;
  // full, ready and empty a stage; the block tile's full, ready, empty
  static constexpr int kBytes = kBarsAt + 8 * (3 * kStages + 3) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int BKV, int H, int KV, int Sq, int Sk, float scale,
                         int causal, int mirrored) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hb::align1024(smem_raw);
  unsigned char* ks = smem;                         // K hi, K lo, V hi, V lo
  unsigned char* stages = smem + L::kStagesAt;      // Q hi, lo, dO hi, lo
  float* rows_f = reinterpret_cast<float*>(smem + L::kRowsAt);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarsAt);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_ready = kv_full + 1;
  uint64_t* kv_empty = kv_ready + 1;
  auto stage = [&](int s, int i) {                  // tile i of stage s
    return stages + s * L::kStage + i * L::kSmall;
  };

  // the block's key tiles of 64: tile i of Sk's, or `mirrored` tile i and
  // then its mirror from the far end (none where the two meet).  These
  // and the tile's numbers below are computed where they are used, from
  // the block's index (opaque: not hoisted), so that none holds a register
  // through the consumer's loop
  auto block = [&] { return static_cast<int>(opaque(blockIdx.x)); };
  auto n_tiles = [&] {
    const int bt = block() / BKV, t1 = (Sk + kRows - 1) / kRows - 1 - bt;
    return mirrored && t1 != bt ? 2 : 1;
  };
  const int group = H / KV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hb::mbar_init(&full[s], 1);                   // the producer's thread 0
      hb::mbar_init(&ready[s], 128);                // every producer thread
      hb::mbar_init(&empty[s], 128);                // every consumer thread
    }
    hb::mbar_init(kv_full, 1);
    hb::mbar_init(kv_ready, 128);
    hb::mbar_init(kv_empty, 128);
    hb::mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, as a value ptxas sees is the same across each warp (a
  // branch it takes for divergent serializes every wgmma: C7518)
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  // key tile j of the block: its first key, first query row (query rows
  // before k0 see none of its keys under the mask), query tiles and steps
  struct KeyTile {
    int k0, q_lo, n_qt, n_steps;
  };
  auto key_tile = [&](int j) {
    const int bt = block() / BKV;
    KeyTile kt;
    kt.k0 = kRows * (j == 0 ? bt : (Sk + kRows - 1) / kRows - 1 - bt);
    kt.q_lo = causal ? kt.k0 : 0;
    kt.n_qt = kt.q_lo < Sq ? (Sq - kt.q_lo + kStep - 1) / kStep : 0;
    kt.n_steps = group * kt.n_qt;
    return kt;
  };
  if (wg == 1) {
    const int p = threadIdx.x - 128;
    const int bkv = blockIdx.x % BKV, tiles = n_tiles();
    const int b = bkv / KV, kvh = bkv % KV;
    int n = 0;                                      // query steps before
    for (int j = 0; j < tiles; ++j) {
      const KeyTile kt = key_tile(j);
      if (j > 0) hb::mbar_wait(kv_empty, (j - 1) & 1);
      if (p == 0) {
        hb::mbar_expect_tx(kv_full, 2 * L::kBig);
        tma_tile<HD>(ks, &tk, kv_full, kt.k0, bkv, kRows);
        tma_tile<HD>(ks + 2 * L::kBig, &tv, kv_full, kt.k0, bkv, kRows);
      }
      // step i's copies into stage (n + i) % kStages, once it is free
      auto issue = [&](int i) {
        const int m = n + i, s = m % kStages;
        hb::mbar_wait(&empty[s], ((m / kStages) & 1) ^ 1);
        const int q0 = kt.q_lo + (i % kt.n_qt) * kStep;
        const int bh = b * H + kvh * group + i / kt.n_qt;
        if (p < kStep) {
          float* ls = rows_f + s * 2 * kStep;
          const int row = q0 + p;
          const size_t r = static_cast<size_t>(bh) * Sq + row;
          ls[p] = row < Sq ? __fmul_rn(lse[r], hb::kLog2e) : CUDART_INF_F;
          ls[kStep + p] = row < Sq ? delta[r] : 0.0f;
        }
        if (p == 0) {
          hb::mbar_expect_tx(&full[s], 2 * L::kSmall);
          tma_tile<HD>(stage(s, 0), &tq, &full[s], q0, bh, kStep);
          tma_tile<HD>(stage(s, 2), &tdo, &full[s], q0, bh, kStep);
        }
      };
      if (kt.n_steps > 0) issue(0);
      hb::mbar_wait(kv_full, j & 1);
      split_tile<HD>(ks, ks + L::kBig, kRows, p);
      split_tile<HD>(ks + 2 * L::kBig, ks + 3 * L::kBig, kRows, p);
      hb::fence_proxy_async();
      hb::mbar_arrive(kv_ready);
      for (int i = 0; i < kt.n_steps; ++i) {
        const int m = n + i, s = m % kStages;
        hb::mbar_wait(&full[s], (m / kStages) & 1);
        split_tile<HD>(stage(s, 0), stage(s, 1), kStep, p);
        split_tile<HD>(stage(s, 2), stage(s, 3), kStep, p);
        hb::fence_proxy_async();
        hb::mbar_arrive(&ready[s]);
        if (i + 1 < kt.n_steps) issue(i + 1);
      }
      n += kt.n_steps;
    }
    return;
  }
  // this lane's first key row, 16 w + g of warp w, and its t
  const int row = static_cast<int>(threadIdx.x / 32 * 16 +
                                   threadIdx.x / 4 % 8);
  const int t = threadIdx.x % 4;
  const float scale2 = __fmul_rn(scale, hb::kLog2e);
  const uint32_t ka = hb::smem_u32(ks);
  for (int j = 0; j < n_tiles(); ++j) {
    const KeyTile kt = key_tile(j);
    // the block's query steps before this tile's (none, or the first
    // tile's), anew: no count lives from one tile to the next
    int m = j == 0 ? 0 : key_tile(0).n_steps;
    tc::RegAcc<HD / 8> acc_k, acc_v;
    acc_k.zero();
    acc_v.zero();
    hb::mbar_wait(kv_ready, j & 1);
    // the step's query tile of its head, 0 .. n_qt - 1: under the mask the
    // queries start at the tile's first key, so only the first
    // kRows / kStep tiles reach past the diagonal, and a key's place
    // against a query there is row - (kStep qi + column): the loop holds
    // no key or query index
    int qi = 0;
    for (int i = 0; i < kt.n_steps; ++i, ++m) {
      const int s = m % kStages;
      hb::mbar_wait(&ready[s], (m / kStages) & 1);
      const uint32_t qa = hb::smem_u32(stage(s, 0));
      float sc[16], dp[kDpChains + 1][16];          // S^T and dP^T
      scores<HD, kDkvChainsAtOnce>(sc, dp, kmajor(opaque(ka)), kmajor(qa));
      const bool diag = causal && qi < kRows / kStep;
      const float* ls = rows_f + s * 2 * kStep;
      // lse and delta of queries 8n + 2t and 8n + 2t + 1, one 8-byte load
      const float2* l2 = reinterpret_cast<const float2*>(ls) + t;
      const float2* d2 = reinterpret_cast<const float2*>(ls + kStep) + t;
#pragma unroll
      for (int nq = 0; nq < kStep / 8; ++nq) {
        const float2 lse2 = l2[4 * nq], delta2 = d2[4 * nq];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int e = 4 * nq + x, c = 8 * nq + 2 * t + (x & 1);
          float pe = hb::ex2(__fmaf_rn(sc[e], scale2,
                                       -(x & 1 ? lse2.y : lse2.x)));
          if (diag && row + 8 * (x >> 1) > kStep * qi + c) pe = 0.0f;
          sc[e] = pe;
          dp[0][e] = __fmul_rn(pe, __fsub_rn(dp[0][e], x & 1 ? delta2.y
                                                              : delta2.x));
        }
      }
      const float* oh = reinterpret_cast<const float*>(stage(s, 2));
      const float* ol = reinterpret_cast<const float*>(stage(s, 3));
      const float* qh = reinterpret_cast<const float*>(stage(s, 0));
      const float* ql = reinterpret_cast<const float*>(stage(s, 1));
      accumulate<HD, kAccDv>(acc_v, sc, oh, ol);    // dv += P^T dO
      accumulate<HD, kAccDk>(acc_k, dp[0], qh, ql); // dk += dS^T q
      hb::mbar_arrive(&empty[s]);
      if (++qi == kt.n_qt) qi = 0;
    }
    if (j + 1 < n_tiles()) hb::mbar_arrive(kv_empty);
    const size_t kv_rows0 = static_cast<size_t>(block() % BKV) * Sk;
    const int k0 = key_tile(static_cast<int>(opaque(j))).k0;  // anew
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + row + 8 * half;
      if (key >= Sk) continue;
      float* outk = dk + (kv_rows0 + key) * HD;
      float* outv = dv + (kv_rows0 + key) * HD;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const float2 rk = acc_k.get(nd, half);
        *reinterpret_cast<float2*>(outk + 8 * nd + 2 * t) =
            make_float2(__fmul_rn(rk.x, scale), __fmul_rn(rk.y, scale));
        *reinterpret_cast<float2*>(outv + 8 * nd + 2 * t) =
            acc_v.get(nd, half);
      }
    }
  }
}

// a 64-query tile of dq: head bh (of B*H), rows q0 .. q0 + 63, n_kt key
// steps (none past the diagonal under the mask)
struct DqTile {
  int bh, q0, n_kt;
};

// the block's round-th tile, or bh -1 past the last: tile i is head i %
// BH's query tile i / BH counted from the end under the mask (the most key
// steps first); round r deals tiles r G .. r G + G - 1 to the G blocks, in
// reverse order on odd rounds
__device__ __forceinline__ DqTile dq_tile(int round, int n_tiles, int BH,
                                          int Sq, int Sk, int causal) {
  const int G = gridDim.x;
  const int i = round * G + (round & 1 ? G - 1 - blockIdx.x : blockIdx.x);
  if (i >= n_tiles) return {-1, 0, 0};
  const int qt = i / BH;
  const int q0 = (causal ? (Sq + kRows - 1) / kRows - 1 - qt : qt) * kRows;
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  return {i % BH, q0, (k_end + kStep - 1) / kStep};
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int BH, int H, int KV, int Sq,
                        int Sk, float scale, int causal, int n_tiles) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hb::align1024(smem_raw);
  unsigned char* qs = smem;                         // Q hi, Q lo, dO hi, lo
  unsigned char* stages = smem + L::kStagesAt;      // K hi, lo, V hi, lo
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarsAt);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_ready = q_full + 1;
  uint64_t* q_empty = q_ready + 1;
  auto stage = [&](int s, int i) {
    return stages + s * L::kStage + i * L::kSmall;
  };
  auto kv_head = [&](int bh) { return bh / H * KV + bh % H / (H / KV); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hb::mbar_init(&full[s], 1);
      hb::mbar_init(&ready[s], 128);
      hb::mbar_init(&empty[s], 128);
    }
    hb::mbar_init(q_full, 1);
    hb::mbar_init(q_ready, 128);
    hb::mbar_init(q_empty, 128);
    hb::mbar_init_fence();
  }
  __syncthreads();

  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 1) {
    const int p = threadIdx.x - 128;
    // step m's K and V into stage m % kStages, once it is free
    auto issue = [&](const DqTile& tl, int kt, int m) {
      const int s = m % kStages;
      hb::mbar_wait(&empty[s], ((m / kStages) & 1) ^ 1);
      if (p == 0) {
        hb::mbar_expect_tx(&full[s], 2 * L::kSmall);
        tma_tile<HD>(stage(s, 0), &tk, &full[s], kt * kStep, kv_head(tl.bh),
                     kStep);
        tma_tile<HD>(stage(s, 2), &tv, &full[s], kt * kStep, kv_head(tl.bh),
                     kStep);
      }
    };
    // the step to issue next: one ahead of the one split, issued once
    // that one is released
    DqTile nt = dq_tile(0, n_tiles, BH, Sq, Sk, causal);
    int n_round = 0, nkt = 0, issued = 0;
    auto next = [&] {
      issue(nt, nkt, issued++);
      if (++nkt == nt.n_kt) {
        nkt = 0;
        nt = dq_tile(++n_round, n_tiles, BH, Sq, Sk, causal);
      }
    };
    if (nt.bh >= 0) next();
    int m = 0;
    for (int round = 0;; ++round) {
      const DqTile tl = dq_tile(round, n_tiles, BH, Sq, Sk, causal);
      if (tl.bh < 0) break;
      for (int kt = 0; kt < tl.n_kt; ++kt, ++m) {
        if (kt == 0) {                    // the tile's Q and dO, once free
          hb::mbar_wait(q_empty, (round & 1) ^ 1);
          if (p == 0) {
            hb::mbar_expect_tx(q_full, 2 * L::kBig);
            tma_tile<HD>(qs, &tq, q_full, tl.q0, tl.bh, kRows);
            tma_tile<HD>(qs + 2 * L::kBig, &tdo, q_full, tl.q0, tl.bh,
                         kRows);
          }
        }
        const int s = m % kStages;
        hb::mbar_wait(&full[s], (m / kStages) & 1);
        split_tile<HD>(stage(s, 0), stage(s, 1), kStep, p);
        split_tile<HD>(stage(s, 2), stage(s, 3), kStep, p);
        if (kt == 0) {
          hb::mbar_wait(q_full, round & 1);
          split_tile<HD>(qs, qs + L::kBig, kRows, p);
          split_tile<HD>(qs + 2 * L::kBig, qs + 3 * L::kBig, kRows, p);
        }
        hb::fence_proxy_async();
        if (kt == 0) hb::mbar_arrive(q_ready);
        hb::mbar_arrive(&ready[s]);
        if (nt.bh >= 0) next();
      }
    }
    return;
  }
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale2 = __fmul_rn(scale, hb::kLog2e);
  const uint32_t qa = hb::smem_u32(qs);
  int m = 0;                                        // key steps consumed
  for (int round = 0;; ++round) {
    const DqTile tl = dq_tile(round, n_tiles, BH, Sq, Sk, causal);
    if (tl.bh < 0) break;
    const size_t rows0 = static_cast<size_t>(tl.bh) * Sq;
    int rows[2];
    float lse2[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h] = tl.q0 + 16 * w + g + 8 * h;
      const bool in = rows[h] < Sq;
      lse2[h] = in ? __fmul_rn(lse[rows0 + rows[h]], hb::kLog2e) : 0.0f;
      delta_r[h] = in ? delta[rows0 + rows[h]] : 0.0f;
    }
    tc::RegAcc<HD / 8> acc;
    acc.zero();
    hb::mbar_wait(q_ready, round & 1);
    for (int kt = 0; kt < tl.n_kt; ++kt, ++m) {
      const int s = m % kStages, k0 = kt * kStep;
      hb::mbar_wait(&ready[s], (m / kStages) & 1);
      const uint32_t ka = hb::smem_u32(stage(s, 0));
      float sc[16], dp[kDpChains][16];              // S and dP
      scores_one_group<HD>(sc, dp, kmajor(opaque(qa)), kmajor(ka));
      // the diagonal step and the ragged last one mask; keys past Sk are
      // zero rows of K but must not weigh: exp(-lse) may overflow
      const bool masked =
          (causal && k0 + kStep - 1 > tl.q0) || k0 + kStep > Sk;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int j = k0 + 8 * (e / 4) + 2 * t + (e & 1);
        const int h = (e >> 1) & 1;
        float pe = hb::ex2(__fmaf_rn(sc[e], scale2, -lse2[h]));
        if (masked && (j >= Sk || (causal && j > rows[h]))) pe = 0.0f;
        dp[0][e] = __fmul_rn(pe, __fsub_rn(dp[0][e], delta_r[h]));
      }
      accumulate<HD, kAccDq>(acc, dp[0],              // dq += dS k
                             reinterpret_cast<const float*>(stage(s, 0)),
                             reinterpret_cast<const float*>(stage(s, 1)));
      hb::mbar_arrive(&empty[s]);
    }
    hb::mbar_arrive(q_empty);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= Sq) continue;
      float* out = dq + (rows0 + rows[h]) * HD;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const float2 r = acc.get(nd, h);
        *reinterpret_cast<float2*>(out + 8 * nd + 2 * t) =
            make_float2(__fmul_rn(r.x, scale), __fmul_rn(r.y, scale));
      }
    }
  }
}

// A (heads, S, HD) float32 tensor as a 3-D map of boxes of `rows` rows and
// 16 columns, under the 64-byte swizzle; rows past S read as zeros
template <int HD>
cudaError_t tensor_map(CUtensorMap* map, const float* base, int S, int heads,
                       int rows) {
  const hb::EncodeTiled encode = hb::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {4ull * HD, 4ull * HD * S};
  const cuuint32_t box[3] = {16, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q and dO in boxes of `q_rows` rows, k and v of `k_rows`
template <int HD>
cudaError_t maps(CUtensorMap (&m)[4], const float* q, const float* k,
                 const float* v, const float* dout, int B, int H, int KV,
                 int Sq, int Sk, int q_rows, int k_rows) {
  cudaError_t err = tensor_map<HD>(&m[0], q, Sq, B * H, q_rows);
  if (err == cudaSuccess) err = tensor_map<HD>(&m[1], k, Sk, B * KV, k_rows);
  if (err == cudaSuccess) err = tensor_map<HD>(&m[2], v, Sk, B * KV, k_rows);
  if (err == cudaSuccess) {
    err = tensor_map<HD>(&m[3], dout, Sq, B * H, q_rows);
  }
  return err;
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return err;
}

template <int HD>
int launch_bwd_dq(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int B, int H, int KV, int Sq, int Sk,
                  float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::kBytes;
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  CUtensorMap m[4];
  cudaError_t err = maps<HD>(m, q, k, v, dout, B, H, KV, Sq, Sk, kRows,
                             kStep);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((Sq + kRows - 1) / kRows) * B * H;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // a block an SM, each walking over its share of the query tiles
  return bf::launch(flash_bwd_dq_f32_kernel<HD>, tiles < sms ? tiles : sms,
                    kThreads, smem, stream, m[0], m[1], m[2], m[3], lse,
                    delta, dq, B * H, H, KV, Sq, Sk, scale, causal,
                    static_cast<int>(tiles));
}

template <int HD>
int launch_bwd_dkv(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int B, int H, int KV, int Sq, int Sk,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::kBytes;
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  CUtensorMap m[4];
  cudaError_t err = maps<HD>(m, q, k, v, dout, B, H, KV, Sq, Sk, kStep,
                             kRows);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave (a block an SM) under the mask: the longest block sets the
  // time, so a block takes a tile and its mirror; otherwise a tile a
  // block, the first tiles (the most queries) first
  const long long n64 = (Sk + kRows - 1) / kRows;
  const long long pairs = (n64 + 1) / 2 * B * KV;
  const int mirrored = causal && pairs <= sms;
  return bf::launch(flash_bwd_dkv_f32_kernel<HD>,
                    mirrored ? pairs : n64 * B * KV, kThreads, smem, stream,
                    m[0], m[1], m[2], m[3], lse, delta, dk, dv, B * KV, H,
                    KV, Sq, Sk, scale, causal, mirrored);
}

template <int HD>
cudaError_t attributes(cudaFuncAttributes* dq, cudaFuncAttributes* dkv) {
  const cudaError_t err =
      cudaFuncGetAttributes(dq, flash_bwd_dq_f32_kernel<HD>);
  return err != cudaSuccess
             ? err
             : cudaFuncGetAttributes(dkv, flash_bwd_dkv_f32_kernel<HD>);
}

}  // namespace tf

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

// the forwards' query offset: >= 0, and 0 without the mask
static cudaError_t offset_check(int q_offset, int causal) {
  return q_offset < 0 || (q_offset != 0 && !causal) ? cudaErrorInvalidValue
                                                    : cudaSuccess;
}

#define FWD_ARGS \
  q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, q_offset, stream

int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            float* o, float* lse, int B, int H, int KV,
                            int Sq, int Sk, int hd, float scale, int causal,
                            int q_offset, cudaStream_t stream) {
  cudaError_t bad = args_check(B, H, KV, Sq, Sk, {q, k, v, o});
  if (bad == cudaSuccess) bad = offset_check(q_offset, causal);
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
      return tf::launch_bwd_dq<112>(BWD_DQ_ARGS);
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
      return tf::launch_bwd_dkv<112>(BWD_DKV_ARGS);
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
                             int q_offset, cudaStream_t stream) {
  cudaError_t bad = args_check(B, H, KV, Sq, Sk, {q, k, v, o});
  if (bad == cudaSuccess) bad = offset_check(q_offset, causal);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  switch (hd) {
    case 16:
      return hb::launch_fwd<16>(FWD_ARGS);
    case 32:
      return hb::launch_fwd<32>(FWD_ARGS);
    case 64:
      return hb::launch_fwd<64>(FWD_ARGS);
    case 112:
      return hb::launch_fwd<112>(FWD_ARGS);
    case 128:
      return hb::launch_fwd<128>(FWD_ARGS);
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

// The bf16 forward kernel's attributes at head dim hd, for the record:
// out[0] its registers a thread at launch, out[1] its local memory (spills
// and stack) in bytes a thread.  The consumer warpgroups run with
// kConsumerRegs after setmaxnreg.
int flash_attention_fwd_bf16_attributes(int hd, int* out) {
  cudaFuncAttributes fwd;
  cudaError_t err;
  switch (hd) {
    case 16:
      err = hb::fwd_attributes<16>(&fwd);
      break;
    case 32:
      err = hb::fwd_attributes<32>(&fwd);
      break;
    case 64:
      err = hb::fwd_attributes<64>(&fwd);
      break;
    case 112:
      err = hb::fwd_attributes<112>(&fwd);
      break;
    case 128:
      err = hb::fwd_attributes<128>(&fwd);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fwd.numRegs;
  out[1] = static_cast<int>(fwd.localSizeBytes);
  return 0;
}

// The float32 backward kernels on wgmma (hd 112, the only head dim that
// takes them) as built, for the record: out[0], out[1] the dq kernel's
// registers a thread and its local memory (spills and stack) in bytes a
// thread, out[2], out[3] dk/dv's.
int flash_attention_bwd_f32_attributes(int hd, int* out) {
  if (hd != 112) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes dq, dkv;
  const cudaError_t err = tf::attributes<112>(&dq, &dkv);
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
