// Flash attention, forward and backward, float32, for Hopper (sm_90a).
//
// The forward replaces the TPU kernel `_fwd` / `_fwd_kernel` in
// src/repro/kernels/flash_attention.py; the two backward kernels below
// replace `_bwd_rule`'s `_dq_kernel` and `_dkv_kernel` (see the section
// "Backward").  For q (B, H, Sq, hd) and k, v
// (B, KV, Sk, hd), query head h reading KV head h / (H / KV) (the grouping
// of models/attention.py), and each query row i:
//   s_ij = (q_i * scale) . k_j,  masked to -1e30 where causal and i < j
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)
//   lse_i = m_i + log(max(l_i, 1e-30))
// with the running max m and sum l of an online softmax over key tiles, so
// no (Sq, Sk) score matrix reaches device memory.  Unlike the TPU kernel it
// takes any Sq and Sk (ragged tiles are masked: keys past Sk weigh 0) and
// GQA without expanding k and v.
//
// Bound: 4 * Sq * Sk * hd * B * H float operations (two products; half of
// that under the causal mask), against 4 bytes for each element of q, k, v,
// o and lse.  At the small tier's layer (B 8, H 16, S 1,024, hd 64, causal)
// that is 17.2 GFLOP, 0.26 ms at 67 TFLOP/s float32, against 134 MB, 0.04 ms
// at 3.35 TB/s: operations bound it, as they do at every shape of the cascade.
//
// Design (simple and right first): one block of 256 threads per 64 query
// rows of one (b, h).  The scaled q tile and each 64-key tile of k sit
// transposed in dynamic shared memory (hd x 68, so a float4 of 4 rows or 4
// keys is one aligned load), v as it is (64 x hd), and the tile's
// probabilities transposed (64 x 68): 120 KB at hd = 128, above the 48 KB
// default, so the launcher raises the limit first.  Thread (tx, ty) of a
// 16 x 16 grid owns rows 4ty..4ty+3: it computes their scores against keys
// 4tx..4tx+3 by float32 FMA over hd in order, and their output columns
// tx-strided by 4 (hd / 16 of them).  The 16 threads of a row meet in fixed
// xor shuffles for the row's max and sum, which every one of them then
// holds.  Key tiles past the causal diagonal are skipped.  No atomics and a
// fixed order everywhere, so two launches give the same bits.  Tensor cores
// (wgmma in TF32 or bf16) and TMA are later work: they would give up the
// float32 parity this kernel keeps.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kPitch = 68;        // 64 + 4: rows stay 16-byte aligned
constexpr float kMaskValue = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * HD * kPitch + kBlockK * HD + kBlockK * kPitch);
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                 float scale, int causal) {
  constexpr int kDims = HD / 16;              // output columns a thread owns
  constexpr int kVec = kDims < 4 ? kDims : 4;
  constexpr int kGroups = kDims / kVec;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // HD x kPitch
  float* kT = qT + HD * kPitch;                  // HD x kPitch
  float* vs = kT + HD * kPitch;                  // kBlockK x HD
  float* pT = vs + kBlockK * HD;                 // kBlockK x kPitch

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBlockQ;
  const float* qp = q + static_cast<size_t>(bh) * Sq * HD;
  const float* kp = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const float* vp = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;

  for (int e = tid; e < kBlockQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD, row = q0 + i;
    qT[d * kPitch + i] =
        row < Sq ? __fmul_rn(qp[static_cast<size_t>(row) * HD + d], scale)
                 : 0.0f;
  }

  float m[4], l[4], acc[4][kDims];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                 // the last tile's v and p are consumed
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, key = k0 + j;
      const bool in = key < Sk;
      const size_t at = static_cast<size_t>(key) * HD + d;
      kT[d * kPitch + j] = in ? kp[at] : 0.0f;
      vs[j * HD + d] = in ? vp[at] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
      load_vec<4>(qT + d * kPitch + 4 * ty, a);
      load_vec<4>(kT + d * kPitch + 4 * tx, bk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = __fmaf_rn(a[r], bk[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + 4 * ty + r;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 4 * tx + c;
        if (key >= Sk) {
          s[r][c] = -CUDART_INF_F;           // past the end: weighs 0
        } else if (causal && key > row) {
          s[r][c] = kMaskValue;
        }
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(__fsub_rn(m[r], m_new));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(__fsub_rn(s[r][c], m_new));
        sum = __fadd_rn(sum, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      }
      l[r] = __fmaf_rn(l[r], alpha, sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[r][c] = __fmul_rn(acc[r][c], alpha);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(pT + (4 * tx + c) * kPitch + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

    const int n_keys = min(kBlockK, k_end - k0);
    for (int j = 0; j < n_keys; ++j) {
      float p[4];
      load_vec<4>(pT + j * kPitch + 4 * ty, p);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float vv[kVec];
        load_vec<kVec>(vs + j * HD + g * 16 * kVec + tx * kVec, vv);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[r][g * kVec + e] = __fmaf_rn(p[r], vv[e], acc[r][g * kVec + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* out = o + (static_cast<size_t>(bh) * Sq + row) * HD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        out[g * 16 * kVec + tx * kVec + e] =
            __fdiv_rn(acc[r][g * kVec + e], denom);
      }
    }
    if (tx == 0) {
      lse[static_cast<size_t>(bh) * Sq + row] = __fadd_rn(m[r], logf(denom));
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int H, int KV, int Sq, int Sk, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    p[0] = in[0];
  }
}

// ---------------------------------------------------------------------------
// Backward.
//
// The function of the TPU kernel's `_bwd_rule` (its blocks not carried
// over).  delta_i = sum_d dO_id * O_id comes in (one torch op, as the
// reference computes it in jnp outside its kernels).  Both kernels
// recompute, from the lse the forward wrote,
//   s_ij  = (q_i * scale) . k_j       (the forward's s, bit for bit: the same
//                                       scaled q and FMA order over hd)
//   p_ij  = exp(s_ij - lse_i), 0 where masked (causal j > i, keys past Sk)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)
// flash_bwd_dq_kernel, one block per 64 query rows of one (b, h), over the
// key tiles up to the diagonal:
//   dq_i = scale * sum_j ds_ij k_j
// flash_bwd_dkv_kernel, one block per BK keys of one (b, KV head g), over
// the G = H / KV query heads g*G .. g*G+G-1 in order and, for each, the
// query tiles from the causal lower bound:
//   dv_j = sum_i p_ij dO_i,   dk_j = sum_i ds_ij (q_i * scale)
// so GQA's sum over a group runs inside the block in a fixed order: no
// atomics, and two launches give the same bits.
//
// Bound: the backward's least work is five products (s, dp, dq, dk, dv),
// 2.5x the forward's operations; this two-pass design recomputes s and dp
// in both kernels, so dq does three products and dk/dv four.  At the small
// tier's layer (B 8, H 16, S 1,024, hd 64, causal) the five are 43 GFLOP,
// 0.64 ms at 67 TFLOP/s float32, against 0.05 ms of bytes: operations bound
// both kernels, as they bound the forward.
//
// Design (simple and right first), the forward's: 256 threads as a 16 x 16
// grid, float4 loads from transposed tiles (pitch +4) for the two score
// products, a register micro-tile per thread, explicit __fmaf_rn under the
// build's -fmad=false.  Shared memory: the dq block holds q (scaled), dO, k
// and v transposed, k as it is and the ds tile, 185 KB at hd 128; the dk/dv
// block holds its k and v transposed, each query tile's q (scaled) and dO
// both transposed and as they are, and the p and ds tiles: with 64 keys a
// block that is 234 KB at hd 128, over the 227 KB limit, so at hd 128 a
// block takes 32 keys (186 KB).
template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (4 * HD * kPitch + kBlockK * HD + kBlockK * kPitch);
}

template <int HD, int BK>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * HD * (BK + 4) + 2 * HD * kPitch +
                          2 * kBlockQ * HD + 2 * kBlockQ * (BK + 4));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int KV, int Sq, int Sk, float scale, int causal) {
  constexpr int kDims = HD / 16;              // dq columns a thread owns
  constexpr int kVec = kDims < 4 ? kDims : 4;
  constexpr int kGroups = kDims / kVec;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // HD x kPitch, scaled
  float* doT = qT + HD * kPitch;                 // HD x kPitch
  float* kT = doT + HD * kPitch;                 // HD x kPitch
  float* vT = kT + HD * kPitch;                  // HD x kPitch
  float* ks = vT + HD * kPitch;                  // kBlockK x HD
  float* dsT = ks + kBlockK * HD;                // kBlockK x kPitch

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBlockQ;
  const size_t rows0 = static_cast<size_t>(bh) * Sq;
  const float* qp = q + rows0 * HD;
  const float* dop = dout + rows0 * HD;
  const float* kp = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const float* vp = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;

  for (int e = tid; e < kBlockQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD, row = q0 + i;
    const bool in = row < Sq;
    const size_t at = static_cast<size_t>(row) * HD + d;
    qT[d * kPitch + i] = in ? __fmul_rn(qp[at], scale) : 0.0f;
    doT[d * kPitch + i] = in ? dop[at] : 0.0f;
  }
  float lse_r[4], delta_r[4], acc[4][kDims];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    lse_r[r] = row < Sq ? lse[rows0 + row] : 0.0f;
    delta_r[r] = row < Sq ? delta[rows0 + row] : 0.0f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                 // the last tile's k and ds are consumed
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, key = k0 + j;
      const bool in = key < Sk;
      const size_t at = static_cast<size_t>(key) * HD + d;
      const float kv = in ? kp[at] : 0.0f;
      kT[d * kPitch + j] = kv;
      ks[j * HD + d] = kv;
      vT[d * kPitch + j] = in ? vp[at] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = 0.0f;
        dp[r][c] = 0.0f;
      }
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
      load_vec<4>(qT + d * kPitch + 4 * ty, a);
      load_vec<4>(kT + d * kPitch + 4 * tx, bk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = __fmaf_rn(a[r], bk[c], s[r][c]);
      }
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bv[4];
      load_vec<4>(doT + d * kPitch + 4 * ty, a);
      load_vec<4>(vT + d * kPitch + 4 * tx, bv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[r][c] = __fmaf_rn(a[r], bv[c], dp[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 4 * tx + c;
        float ds = 0.0f;
        if (key < Sk && !(causal && key > row)) {
          const float p = expf(__fsub_rn(s[r][c], lse_r[r]));
          ds = __fmul_rn(p, __fsub_rn(dp[r][c], delta_r[r]));
        }
        s[r][c] = ds;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(dsT + (4 * tx + c) * kPitch + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

    const int n_keys = min(kBlockK, k_end - k0);
    for (int j = 0; j < n_keys; ++j) {
      float ds4[4];
      load_vec<4>(dsT + j * kPitch + 4 * ty, ds4);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float kk[kVec];
        load_vec<kVec>(ks + j * HD + g * 16 * kVec + tx * kVec, kk);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[r][g * kVec + e] = __fmaf_rn(ds4[r], kk[e], acc[r][g * kVec + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= Sq) continue;
    float* out = dq + (rows0 + row) * HD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        out[g * 16 * kVec + tx * kVec + e] =
            __fmul_rn(acc[r][g * kVec + e], scale);
      }
    }
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int KV, int Sq, int Sk, float scale, int causal) {
  constexpr int kKeys = BK / 16;              // keys a thread owns
  constexpr int kPitchK = BK + 4;             // rows stay 16-byte aligned
  constexpr int kDims = HD / 16;              // dk/dv columns a thread owns
  constexpr int kVec = kDims < 4 ? kDims : 4;
  constexpr int kGroups = kDims / kVec;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);   // HD x kPitchK
  float* vT = kT + HD * kPitchK;                 // HD x kPitchK
  float* qT = vT + HD * kPitchK;                 // HD x kPitch, scaled
  float* doT = qT + HD * kPitch;                 // HD x kPitch
  float* qs = doT + HD * kPitch;                 // kBlockQ x HD, scaled
  float* dos = qs + kBlockQ * HD;                // kBlockQ x HD
  float* ps = dos + kBlockQ * HD;                // kBlockQ x kPitchK
  float* dss = ps + kBlockQ * kPitchK;           // kBlockQ x kPitchK

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / KV, g = blockIdx.y % KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * BK;
  const size_t kv_rows0 = (static_cast<size_t>(b) * KV + g) * Sk;
  const float* kp = k + kv_rows0 * HD;
  const float* vp = v + kv_rows0 * HD;

  for (int e = tid; e < BK * HD; e += kThreads) {
    const int j = e / HD, d = e % HD, key = k0 + j;
    const bool in = key < Sk;
    const size_t at = static_cast<size_t>(key) * HD + d;
    kT[d * kPitchK + j] = in ? kp[at] : 0.0f;
    vT[d * kPitchK + j] = in ? vp[at] : 0.0f;
  }
  float acc_k[kKeys][kDims], acc_v[kKeys][kDims];
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      acc_k[r][c] = 0.0f;
      acc_v[r][c] = 0.0f;
    }
  }

  // query rows before k0 see none of this block's keys under the mask
  const int q_lo = causal ? (k0 / kBlockQ) * kBlockQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const size_t rows0 = (static_cast<size_t>(b) * H + g * G + gi) * Sq;
    const float* qp = q + rows0 * HD;
    const float* dop = dout + rows0 * HD;
    for (int q0 = q_lo; q0 < Sq; q0 += kBlockQ) {
      __syncthreads();               // the last tile's q, dO, p, ds consumed
      for (int e = tid; e < kBlockQ * HD; e += kThreads) {
        const int i = e / HD, d = e % HD, row = q0 + i;
        const bool in = row < Sq;
        const size_t at = static_cast<size_t>(row) * HD + d;
        const float qv = in ? __fmul_rn(qp[at], scale) : 0.0f;
        const float ov = in ? dop[at] : 0.0f;
        qT[d * kPitch + i] = qv;
        doT[d * kPitch + i] = ov;
        qs[i * HD + d] = qv;
        dos[i * HD + d] = ov;
      }
      float lse_c[4], delta_c[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + 4 * tx + c;
        lse_c[c] = row < Sq ? lse[rows0 + row] : 0.0f;
        delta_c[c] = row < Sq ? delta[rows0 + row] : 0.0f;
      }
      __syncthreads();

      // keys kKeys*ty + r against queries 4tx + c
      float s[kKeys][4], dp[kKeys][4];
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = 0.0f;
          dp[r][c] = 0.0f;
        }
      }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], bk[kKeys];
        load_vec<4>(qT + d * kPitch + 4 * tx, a);
        load_vec<kKeys>(kT + d * kPitchK + kKeys * ty, bk);
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = __fmaf_rn(a[c], bk[r], s[r][c]);
        }
      }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], bv[kKeys];
        load_vec<4>(doT + d * kPitch + 4 * tx, a);
        load_vec<kKeys>(vT + d * kPitchK + kKeys * ty, bv);
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) dp[r][c] = __fmaf_rn(a[c], bv[r], dp[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + 4 * tx + c;
        float p_out[kKeys], ds_out[kKeys];
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          const int key = k0 + kKeys * ty + r;
          float p = 0.0f, ds = 0.0f;
          if (row < Sq && key < Sk && !(causal && key > row)) {
            p = expf(__fsub_rn(s[r][c], lse_c[c]));
            ds = __fmul_rn(p, __fsub_rn(dp[r][c], delta_c[c]));
          }
          p_out[r] = p;
          ds_out[r] = ds;
        }
        store_vec<kKeys>(ps + (4 * tx + c) * kPitchK + kKeys * ty, p_out);
        store_vec<kKeys>(dss + (4 * tx + c) * kPitchK + kKeys * ty, ds_out);
      }
      __syncthreads();

      const int n_rows = min(kBlockQ, Sq - q0);
      for (int i = 0; i < n_rows; ++i) {
        float pv[kKeys], dsv[kKeys];
        load_vec<kKeys>(ps + i * kPitchK + kKeys * ty, pv);
        load_vec<kKeys>(dss + i * kPitchK + kKeys * ty, dsv);
#pragma unroll
        for (int gg = 0; gg < kGroups; ++gg) {
          float ov[kVec], qv[kVec];
          load_vec<kVec>(dos + i * HD + gg * 16 * kVec + tx * kVec, ov);
          load_vec<kVec>(qs + i * HD + gg * 16 * kVec + tx * kVec, qv);
#pragma unroll
          for (int r = 0; r < kKeys; ++r) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              const int c = gg * kVec + e;
              acc_v[r][c] = __fmaf_rn(pv[r], ov[e], acc_v[r][c]);
              acc_k[r][c] = __fmaf_rn(dsv[r], qv[e], acc_k[r][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int key = k0 + kKeys * ty + r;
    if (key >= Sk) continue;
    float* outk = dk + (kv_rows0 + key) * HD;
    float* outv = dv + (kv_rows0 + key) * HD;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        outk[gg * 16 * kVec + tx * kVec + e] = acc_k[r][gg * kVec + e];
        outv[gg * 16 * kVec + tx * kVec + e] = acc_v[r][gg * kVec + e];
      }
    }
  }
}

template <int HD>
int launch_bwd_dq(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int B, int H, int KV, int Sq, int Sk,
                  float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK>
int launch_bwd_dkv(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int B, int H, int KV, int Sq, int Sk,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD, BK>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + BK - 1) / BK, B * KV);
  flash_bwd_dkv_kernel<HD, BK><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success); the
// caller checks it, because a refused launch never runs.  q, o (B, H, Sq,
// hd), k, v (B, KV, Sk, hd) and lse (B, H, Sq), contiguous float32; hd one
// of 16, 32, 64, 128 and KV a divisor of H (the wrapper checks both).
int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            float* o, float* lse, int B, int H, int KV,
                            int Sq, int Sk, int hd, float scale, int causal,
                            cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal,
                        stream);
    case 32:
      return launch<32>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's launchers: same layouts as the forward's, plus dout (B, H,
// Sq, hd), the forward's lse and delta = rowsum(dout * o) (B, H, Sq); dq
// (B, H, Sq, hd) from the first, dk and dv (B, KV, Sk, hd) from the second.
static int bwd_args_ok(int B, int H, int KV, int Sq, int Sk) {
  return B > 0 && H > 0 && KV > 0 && H % KV == 0 && Sq > 0 && Sk > 0 &&
         B * H <= 65535;
}

int flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* delta, float* dq, int B, int H,
                               int KV, int Sq, int Sk, int hd, float scale,
                               int causal, cudaStream_t stream) {
  if (!bwd_args_ok(B, H, KV, Sq, Sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 16:
      return launch_bwd_dq<16>(q, k, v, dout, lse, delta, dq, B, H, KV, Sq,
                               Sk, scale, causal, stream);
    case 32:
      return launch_bwd_dq<32>(q, k, v, dout, lse, delta, dq, B, H, KV, Sq,
                               Sk, scale, causal, stream);
    case 64:
      return launch_bwd_dq<64>(q, k, v, dout, lse, delta, dq, B, H, KV, Sq,
                               Sk, scale, causal, stream);
    case 128:
      return launch_bwd_dq<128>(q, k, v, dout, lse, delta, dq, B, H, KV, Sq,
                                Sk, scale, causal, stream);
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
  if (!bwd_args_ok(B, H, KV, Sq, Sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 16:
      return launch_bwd_dkv<16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    KV, Sq, Sk, scale, causal, stream);
    case 32:
      return launch_bwd_dkv<32, 64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    KV, Sq, Sk, scale, causal, stream);
    case 64:
      return launch_bwd_dkv<64, 64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    KV, Sq, Sk, scale, causal, stream);
    case 128:
      return launch_bwd_dkv<128, 32>(q, k, v, dout, lse, delta, dk, dv, B,
                                     H, KV, Sq, Sk, scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
