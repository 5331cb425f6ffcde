#!/usr/bin/env python3
"""The float32 flash backward at hd 112 against probes and the variants
its design rejected.

    python3 tools/flash_bwd_f32_variants.py      # from the repository root, one CUDA card

``csrc/flash_attention.cu``'s hd-112 float32 dq and dk/dv (the ``tf``
namespace: score products on TF32 ``wgmma`` fed by TMA, accumulation
products on ``mma.sync``) are built beside copies of the source with one
change each, into ``build/flash_bwd_f32_variants/`` with the build's
flags and ``-Xptxas -v`` (``tools/flash_bwd_variants.py``'s
``compile_all``):

- ``no_accumulate`` (a probe: wrong gradients): the accumulation
  products left out, so the time left is the score products, the
  softmax and the copies; what it saves bounds what moving the
  accumulation products to ``wgmma`` (from a transposed copy of each
  streamed tile, which has no room beside two stages) could save;
- ``no_scores`` (a probe: wrong gradients): the score products left out
  (S and dP zero), their ``wgmma`` time;
- ``no_split`` (a probe: wrong gradients): the producer's split of each
  landed tile left out, so the consumer waits on the copies alone;
- ``dq_three_groups``: dq's score products in three commit groups (dP's
  chains two at a time, then S) instead of one;
- ``dkv_chains_2``, ``dkv_chains_4``: dk/dv's dP chains two or four a
  commit group instead of one (more accumulators at once, fewer waits);
- ``acc_1``, ``dv_1``, ``dk_7``, ``acc_7``: the accumulation products'
  output fragments one at a time everywhere, one in dk/dv's dv product,
  seven in its dk product, seven in every product, instead of two (each
  fragment's chain of ``mma.sync`` is dependent; interleaved chains hide
  its latency, at the cost of registers: dk/dv has none to spare);
- ``acc_split_once``: each accumulation product's A fragments split once
  a step and held (32 registers) instead of split anew for each group of
  fragments from the raw accumulator (16);
- ``raw_hi``: the tensor cores read each tile as TMA landed it (a
  truncated hi, as they read a raw float32 operand) and the producer
  writes lo = tf32(x - trunc(x)) only, one store an element fewer.  Its
  dropped lo * lo term is four times larger (``tools/tc_truncation.py``:
  dq and dk at Sq = Sk = 1 over phase 20's bar on 0.25 % of draws even
  in four dp chains).

For the source and each copy it prints the two kernels' registers and
spills, holds dq and dk/dv to phase 20's float32 bar (1e-5 of each
gradient's max against the plain backward; misses counted, not fatal)
at kimi-k2's layer and the hd-112 edges of ``chip_smoke.LM20_EDGES``, and
times them at kimi-k2's layer (causal) with ``chip_smoke.device_ms`` in
the order source, copies, copies reversed, source.  Prints the card's
name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

import chip_smoke as cs  # noqa: E402
import flash_bwd_variants as fv  # noqa: E402

SPLIT = """    tc::split(v.x, h.x, l.x);
    tc::split(v.y, h.y, l.y);
    tc::split(v.z, h.z, l.z);
    tc::split(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(x4)[e] = h;
"""
RAW_HI = "".join(
    f"    h.{c} = __float_as_uint(v.{c}) & 0xffffe000u;\n"
    f"    l.{c} = tc::tf32_rna(__fsub_rn(v.{c}, __uint_as_float(h.{c})));\n"
    for c in "xyzw")
ACC_DKV = """      accumulate<HD, kAccDv>(acc_v, sc, oh, ol);    // dv += P^T dO
      accumulate<HD, kAccDk>(acc_k, dp[0], qh, ql); // dk += dS^T q
"""
ACC_DQ = """      accumulate<HD, kAccDq>(acc, dp[0],              // dq += dS k
                             reinterpret_cast<const float*>(stage(s, 0)),
                             reinterpret_cast<const float*>(stage(s, 1)));
"""
# keep the probes' values alive, so the compiler drops no other work
KEEP = """      hb::fence_regs(sc);
      hb::fence_regs(dp[0]);
"""
NO_SCORES = """template <int HD, int CA>
__device__ __forceinline__ void scores(float (&sc)[16],
                                       float (&dp)[kDpChains + 1][16],
                                       uint64_t dx, uint64_t dy) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    sc[e] = 0.0f;
    dp[0][e] = 0.0f;
  }
  hb::fence_regs(sc);
  hb::fence_regs(dp[0]);
}
"""
NO_SCORES_ONE = """template <int HD>
__device__ __forceinline__ void scores_one_group(
    float (&sc)[16], float (&dp)[kDpChains][16], uint64_t dx, uint64_t dy) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    sc[e] = 0.0f;
    dp[0][e] = 0.0f;
  }
  hb::fence_regs(sc);
  hb::fence_regs(dp[0]);
}
"""
SCORES_DEF = ("template <int HD, int CA>\n__device__ __forceinline__ void "
              "scores(")
SCORES_ONE_DEF = ("template <int HD>\n__device__ __forceinline__ void "
                  "scores_one_group(")
DQ_ONE = """      float sc[16], dp[kDpChains][16];              // S and dP
      scores_one_group<HD>(sc, dp, kmajor(opaque(qa)), kmajor(ka));
"""
DQ_THREE = """      float sc[16], dp[kDpChains + 1][16];          // S and dP
      scores<HD, 2>(sc, dp, kmajor(opaque(qa)), kmajor(ka));
"""
CHAINS = "constexpr int kDkvChainsAtOnce = 1;"
ACC_AT_ONCE = "constexpr int kAccDv = 2, kAccDk = 2, kAccDq = 2;"
FENCE_C = ("    hb::fence_regs(c);          // so the compiler splits c anew, "
           "not once\n")
VARIANTS = {
    "no_accumulate": {ACC_DKV: KEEP, ACC_DQ: KEEP},
    "no_scores": {SCORES_DEF: NO_SCORES + "\ntemplate <int HD, int CA>\n"
                  "__device__ __forceinline__ void scores_unused(",
                  SCORES_ONE_DEF: NO_SCORES_ONE + "\ntemplate <int HD>\n"
                  "__device__ __forceinline__ void scores_one_unused("},
    "dq_three_groups": {DQ_ONE: DQ_THREE},
    "dkv_chains_2": {CHAINS: CHAINS.replace("= 1;", "= 2;")},
    "dkv_chains_4": {CHAINS: CHAINS.replace("= 1;", "= 4;")},
    "acc_1": {ACC_AT_ONCE: "constexpr int kAccDv = 1, kAccDk = 1, "
              "kAccDq = 1;"},
    "dv_1": {ACC_AT_ONCE: "constexpr int kAccDv = 1, kAccDk = 2, "
             "kAccDq = 2;"},
    "dk_7": {ACC_AT_ONCE: "constexpr int kAccDv = 2, kAccDk = 7, "
             "kAccDq = 2;"},
    "acc_7": {ACC_AT_ONCE: "constexpr int kAccDv = 7, kAccDk = 7, "
              "kAccDq = 7;"},
    "acc_split_once": {FENCE_C: ""},
    "no_split": {SPLIT: "", "    lo4[e] = l;\n": ""},
    "raw_hi": {SPLIT: RAW_HI},
}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_f32_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = fv.compile_all(build, VARIANTS, kernels="f32_kernel",
                          out="flash_bwd_f32_variants")
    dev = ops.resolve_device("cuda")
    kimi = cs.LM20_SHAPES["kimi"]
    cases = [(kimi, True), (kimi, False)]
    cases += [(e[:6], e[6]) for e in cs.LM20_EDGES if e[5] == 112]
    g = torch.Generator(device=dev).manual_seed(38)
    inputs = []
    for shape, causal in cases:
        B, H, KV, Sq, Sk, hd = shape
        q, k, v = cs.flash_inputs(g, dev, *shape)
        do = torch.randn(B, H, Sq, hd, device=dev, generator=g)
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        plain = (ops.flash_attention_bwd_dq_ref(*args, causal),
                 *ops.flash_attention_bwd_dkv_ref(*args, causal))
        inputs.append((shape, causal, args, plain))
    for name, (lib, lines) in libs.items():
        fv.use(build, lib)
        misses, worst = 0, 0.0
        for shape, causal, args, plain in inputs:
            got = (ops.flash_attention_bwd_dq(*args, causal=causal),
                   *ops.flash_attention_bwd_dkv(*args, causal=causal))
            torch.cuda.synchronize()
            err = cs.rel_grads(got, plain)
            worst = max(worst, err)
            misses += not err <= cs.FLASH_BWD_RTOL
        print(f"{name}:\n  " + "\n  ".join(lines) + f"\n  phase 20's bar "
              f"missed at {misses} of {len(inputs)} cases, worst {worst:.3e}"
              " of each gradient's max")
    args = inputs[0][2]
    names = list(libs)
    readings = {n: {"dq": [], "dkv": []} for n in names}
    for name in names + names[::-1]:
        fv.use(build, libs[name][0])
        readings[name]["dq"].append(cs.device_ms(
            lambda a: ops.flash_attention_bwd_dq(*a), args, reps=20))
        readings[name]["dkv"].append(cs.device_ms(
            lambda a: ops.flash_attention_bwd_dkv(*a), args, reps=20))
    for name, r in readings.items():
        print(f"{name} at kimi {kimi} causal: " + "; ".join(
            f"{k} " + ", ".join(f"{x * 1e3:.2f}" for x in v) + " us (mean "
            f"{1e3 * sum(v) / len(v):.2f})" for k, v in r.items()))


if __name__ == "__main__":
    main()
