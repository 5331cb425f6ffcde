// Flash-attention forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd` / `_fwd_kernel` in
// src/repro/kernels/flash_attention.py.  For q (B, H, Sq, hd) and k, v
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

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
