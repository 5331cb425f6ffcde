#!/usr/bin/env python3
"""The bf16 flash forward against the schedules and key tiles its design
rejected.

    python3 tools/flash_fwd_bf16_variants.py    # from the repository root, one CUDA card

``csrc/flash_attention.cu``'s bf16 forward (``hb::flash_fwd_bf16_kernel``)
streams ``kFwdBK`` keys a tile through ``kFwdStages`` stages, on a
persistent grid (a block an SM), and takes FlashAttention-3's
in-warpgroup overlap (a warpgroup issues S of tile j and P V of tile j - 1
together and runs tile j's softmax under the second).  This script builds
each other choice in a copy of the source, compiled beside it into
``build/flash_fwd_bf16_variants/`` with the build's flags and ``-Xptxas
-v`` (``VARIANTS``: text patches of the source):

- ``serial``, ``pingpong``, ``both``: the schedules that the source does
  not take (``schedule``: P V then S, then the softmax, with no overlap;
  the inter-warpgroup ping-pong alone, the two consumer warpgroups taking
  turns to issue on named barriers, one's softmax under the other's
  products; both);
- ``bk128_one_q_*``: each schedule with 128-key tiles (S one m64n128
  product) in three stages beside one Q buffer (the next tile's q waits
  for this tile's o); ``bk128``: 128-key tiles in two stages beside two
  Q buffers; ``bk128_s_two_m64n64``: ``bk128_one_q`` of the source's
  schedule with S as two m64n64 products; ``one_q``: the source with one
  Q buffer; ``stages3``, ``stages5``: rings of up to 3 or 5 stages, not
  up to 8 (as many as fit: 5 at hd 112 and 128, 8 below);
- ``store_row``: o stored from the accumulator registers, 4 bytes a
  lane, with no copy through shared memory;
- ``one_tile_a_block``: a block for each query tile, not a persistent
  grid; ``plain_wg_index``: the
  warpgroup index not broadcast by a shuffle (ptxas may then take the
  branches on it for divergent and serialize the wgmma);
- the probes ``probe_*``, which drop the causal mask, the exponential,
  the softmax, P V, S, o's or lse's writes, l's sums, o's rescaling, or
  all the products and the softmax (``probe_empty``: the loads, the
  barriers and the stores alone), to split the source's time.  (A probe
  whose o is never read would let ptxas drop P V's wgmma too.)

For the source and each variant it prints the forward kernels' registers
and spills and ptxas's notes on serialized wgmma, holds the forward to
``chip_smoke.py`` phase 20's bars at its 12 cases (``chip_smoke.fwd_hold``;
failures counted and printed, not fatal; the probes are timed only) and
times it at the small, large and kimi-k2 shapes (causal) beside
``scaled_dot_product_attention``'s bf16 forward, in the order source,
variants, variants reversed, source.  Prints the card's name and power
limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402

SOURCE = "flash_attention.cu"
with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                       SOURCE)) as _f:
    CU = _f.read()
BK = "constexpr int kFwdBK = 64, kFwdMaxStages = 8, kFwdQBufs = 2;"
# the consumers' main loop, from q's wait to the count of K/V tiles
LOOP = CU[CU.index("    mbar_wait(&q_full[qb]"):CU.index("    kv += n_kt;\n")]
# bar.arrive on a named barrier, which the ping-pong's hand-over needs
BAR_ARRIVE = ("__device__ __forceinline__ void bar_arrive(int id, int n) {\n"
              '  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(n) : '
              '"memory");\n}\n\n')
FENCE_REGS = "// keeps the compiler from moving an accumulator across a wgmma"
SCHEDULES = {"serial": (False, False), "pingpong": (False, True),
             "both": (True, True), "overlap": (True, False)}


def schedule(overlap, pingpong):
    """The consumers' main loop (``LOOP``) under the in-warpgroup overlap
    (S of tile j issued before P V of tile j - 1, the softmax of j under
    the second) or not (P V then S, then the softmax), with or without the
    ping-pong: the two warpgroups take turns to issue on named barriers 1
    and 2, warpgroup 0 first; each takes n_kt + 1 turns a query tile (one
    for each key tile's S, the first's alone and the others' with the P V
    before, one for the last P V) whatever its work, and warpgroup 0 ends
    on the last hand-over.  ``schedule(True, False)`` is the source's."""
    def turn(ind):
        return " " * ind + "turn();\n" if pingpong else ""

    def hand_over(ind):
        return " " * ind + "hand_over();\n" if pingpong else ""
    pre = ""
    if pingpong:
        pre = ("    auto turn = [&] { bar_sync(1 + wg, 256); };\n"
               "    auto hand_over = [&] { bar_arrive(2 - wg, 256); };\n"
               "    if (wg == 0) bar_arrive(1, 256);\n")
    if overlap:
        stage = ("      issue_s(k_at(kt));\n"
                 "      issue_pv(k_at(kt - 1) + L::kK);\n" + hand_over(6) +
                 "      wg_wait_one();                              "
                 "// S is done, P V runs on\n"
                 "      softmax(kt);\n"
                 "      wg_wait_all();\n")
    else:
        stage = ("      issue_pv(k_at(kt - 1) + L::kK);\n"
                 "      issue_s(k_at(kt));\n" + hand_over(6) +
                 "      wg_wait_all();\n"
                 "      softmax(kt);\n")
    last_end = "    } else {\n" + hand_over(6) + "    }\n" if pingpong \
        else "    }\n"
    return (
        pre + "    mbar_wait(&q_full[qb], (round / kFwdQBufs) & 1);\n"
        "    if (n_own > 0) {\n"
        "      wait_full(0);\n" + turn(6) +
        "      issue_s(k_at(0));\n" + hand_over(6) +
        "      wg_wait_all();\n"
        "      softmax(0);\n"
        "#pragma unroll\n"
        "      for (int n = 0; n < NS; ++n) a_fragments(pa[n], sc[n]);\n"
        "    }\n"
        "    // key tile kt's S and softmax, and key tile kt - 1's P V, in one "
        "stage\n"
        "    for (int kt = 1; kt < n_own; ++kt) {\n"
        "      wait_full(kt);\n"
        "      rescale();\n" + turn(6) + stage +
        "      fence_regs(acc);\n"
        "#pragma unroll\n"
        "      for (int n = 0; n < NS; ++n) fence_regs(sc[n]);\n"
        "      mbar_arrive(&empty[stage(kt - 1)]);\n"
        "#pragma unroll\n"
        "      for (int n = 0; n < NS; ++n) a_fragments(pa[n], sc[n]);\n"
        "    }\n" + turn(4) +
        "    if (n_own > 0) {                             // the last tile's "
        "P V\n"
        "      rescale();\n"
        "      issue_pv(k_at(n_own - 1) + L::kK);\n" + hand_over(6) +
        "      wg_wait_all();\n"
        "      fence_regs(acc);\n"
        "      mbar_arrive(&empty[stage(n_own - 1)]);\n" + last_end +
        "    // the key tiles past this warpgroup's rows: released unread\n"
        "    for (int kt = n_own; kt < n_kt; ++kt) {\n"
        "      wait_full(kt);\n" + turn(6) + hand_over(6) +
        "      mbar_arrive(&empty[stage(kt)]);\n"
        "    }\n" +
        ("    if (wg == 0) bar_sync(1, 256);\n" if pingpong else ""))


def schedule_patch(overlap, pingpong):
    """{old: new}: the source's main loop replaced by ``schedule``'s."""
    if schedule(True, False) != LOOP:
        raise RuntimeError("the source's main loop is no longer "
                           "schedule(True, False): bring schedule up to date")
    if (overlap, pingpong) == (True, False):
        return {}
    out = {LOOP: schedule(overlap, pingpong)}
    if pingpong:
        out[FENCE_REGS] = BAR_ARRIVE + FENCE_REGS
    return out
# S of a 128-key tile as one m64n128 wgmma a k step, in place of one
# m64n64 a 64-key slice
S_SLICES = """#pragma unroll
        for (int n = 0; n < NS; ++n) {
          ss_m64n64(sc[n], kmajor<HD>(qa, BQ, 64 * wg, kk),
                    kmajor<HD>(ka, BK, 64 * n, kk), kk);
        }
"""
S_ONE = """        ss_m64n128(sc, kmajor<HD>(qa, BQ, 64 * wg, kk),
                   kmajor<HD>(ka, BK, 0, kk), kk);
"""
RS_ANCHOR = "// d += A . B, m64n16k16: A (64 x 16) in registers"


def _ss_m64n128():
    """A wgmma m64n128k16 with both operands in shared memory, its 64
    accumulators as the two 64-key halves of a 128-key S tile."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i // 32}][{i % 32}])' for i in range(64))
    return (
        "__device__ __forceinline__ void ss_m64n128(float (&d)[2][32], "
        "uint64_t da,\n                                           uint64_t "
        "db, int acc) {\n  asm volatile(\n"
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"\n'
        f'      "{regs}"\n'
        '      "}, %64, %65, p, 1, 1, 0, 0;\\n}\\n"\n'
        f'      : {outs}\n'
        '      : "l"(da), "l"(db), "r"(acc));\n}\n\n')


N128 = {S_SLICES: S_ONE, RS_ANCHOR: _ss_m64n128() + RS_ANCHOR}
GRID = "flash_fwd_bf16_kernel<HD>, tiles < sms ? tiles : sms,"
# o from the accumulator registers, 4 bytes a lane (``store_row``),
# in place of the copy through shared memory
STAGED = CU[CU.index("      unsigned char* os = qs"):
            CU.index("    if (threadIdx.x % 128 == 0) mbar_arrive(&q_empty")]
STORE_ROW = """#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] < Sq) {
          store_row<HD>(o + (rows0 + rows[h]) * HD, acc, h, t, f[h]);
        }
      }
    }
"""
S_ISSUES = {"      issue_s(k_at(0));\n": "",
            "      issue_s(k_at(kt));\n": ""}
PV_ISSUES = {"      issue_pv(k_at(kt - 1) + L::kK);\n": "",
             "      issue_pv(k_at(n_own - 1) + L::kK);\n": ""}
SOFTMAX = {"      softmax(0);\n": "", "      softmax(kt);\n": ""}


def _variants():
    """{name: {old text: new text}}: the other schedules, key tiles, rings,
    stores and grids, and probes that drop one part of the work to split
    its time (their results are wrong; they are timed, not held)."""
    out = {}
    bk128 = "constexpr int kFwdBK = 128, kFwdMaxStages = 3, kFwdQBufs = 1;"
    for name, (overlap, pingpong) in SCHEDULES.items():
        patch = schedule_patch(overlap, pingpong)
        if patch:
            out[name] = patch
        out[f"bk128_one_q_{name}"] = {BK: bk128, **patch, **N128}
    out["bk128"] = {BK: "constexpr int kFwdBK = 128, kFwdMaxStages = 2, "
                    "kFwdQBufs = 2;", **N128}
    out["bk128_s_two_m64n64"] = {BK: bk128}
    out["one_q"] = {BK: "constexpr int kFwdBK = 64, kFwdMaxStages = 8, "
                    "kFwdQBufs = 1;"}
    for n in (3, 5):
        out[f"stages{n}"] = {BK: f"constexpr int kFwdBK = 64, kFwdMaxStages "
                             f"= {n}, kFwdQBufs = 2;"}
    out["store_row"] = {STAGED: STORE_ROW}
    out["plain_wg_index"] = {
        "  const int wg =\n      __shfl_sync(0xffffffffu, static_cast<int>("
        "threadIdx.x) / 128, 0);": "  const int wg = threadIdx.x / 128;"}
    out["one_tile_a_block"] = {GRID: "flash_fwd_bf16_kernel<HD>, tiles,"}
    out.update({
        "probe_no_mask": {"if ((causal && k0 + BK - 1 > qw + off) || k0 + BK "
                          "> Sk) {": "if (false) {"},
        "probe_no_exp": {
            "sc[n][e] = ex2(__fmaf_rn(sc[n][e], scale2, mneg[h]));":
            "sc[n][e] = __fmaf_rn(sc[n][e], scale2, mneg[h]);"},
        "probe_no_softmax": SOFTMAX,
        "probe_no_pv": PV_ISSUES,
        "probe_no_s": S_ISSUES,
        "probe_empty": {**SOFTMAX, **S_ISSUES, **PV_ISSUES},
        "probe_no_o_write": {
            "*reinterpret_cast<uint4*>(o + (rows0 + qw + r) * HD + c) =":
            "const uint4 x ="},
        "probe_no_lse_write": {
            "          lse[rows0 + rows[h]] = __fadd_rn(m[h], logf(denom));":
            "          f[h] = __fadd_rn(f[h], logf(denom));"},
        "probe_no_sum": {"sum[h] = __fadd_rn(sum[h], sc[n][e]);": ""},
        "probe_no_rescale": {
            "        acc[i] = __fmul_rn(acc[i], alpha[(i >> 1) & 1]);\n": ""},
    })
    return out


VARIANTS = _variants()


def hold_all(dev, ops):
    """The forward at phase 20's 12 cases against the plain version ->
    the worst o error, lse error and share of the element bar."""
    import torch
    g = torch.Generator(device=dev).manual_seed(20)
    worst = [0.0, 0.0, 0.0]
    cases = [(s, c) for s in cs.LM20_SHAPES.values() for c in (True, False)]
    cases += [(e[:6], e[6]) for e in cs.LM20_EDGES]
    for shape, causal in cases:
        what = f"{shape} causal={causal}"
        q, k, v = (x.to(torch.bfloat16)
                   for x in cs.flash_inputs(g, dev, *shape))
        o, lse = cs.same_bits(
            lambda *a: ops.flash_attention_fwd(*a, causal=causal),
            (q, k, v), f"the forward at {what}")
        errs = cs.fwd_hold(ops, q, k, v, o, lse, causal, what)
        worst = [max(a, b) for a, b in zip(worst, errs)]
        torch.cuda.empty_cache()
    return worst


def fwd_times(dev, ops, sdpa):
    """{tier: kernel ms} at phase 20's three shapes (causal), and SDPA's
    once a tier."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for tier, shape in cs.LM20_SHAPES.items():
        args = tuple(x.to(torch.bfloat16)
                     for x in cs.flash_inputs(g, dev, *shape))
        out[tier] = cs.device_ms(lambda a: ops.flash_attention_fwd(*a), args)
        if tier not in sdpa:
            sdpa[tier] = cs.device_ms(lambda a: F.scaled_dot_product_attention(
                *a, is_causal=True, enable_gqa=True), args)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_bf16_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = compile_all(build, VARIANTS, "flash_fwd_bf16",
                       "flash_fwd_bf16_variants")
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"  phase 20 miss: {msg}")
    cs.check = record
    dev = ops.resolve_device("cuda")
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        if name.startswith("probe_"):
            continue
        use(build, lib)
        before = len(failures)
        worst = hold_all(dev, ops)
        print(f"{name}: {len(failures) - before} phase 20 checks missed; "
              f"worst o {worst[0]:.3e}, lse {worst[1]:.3e}, element bar "
              f"share {worst[2]:.3f}")
    names, sdpa = list(libs), {}
    for name in names + names[::-1]:
        use(build, libs[name][0])
        times = fwd_times(dev, ops, sdpa)
        print(f"{name}: " + "; ".join(
            f"{tier} {ms * 1e3:.2f} us ({ms / sdpa[tier]:.3f}x SDPA's "
            f"{sdpa[tier] * 1e3:.2f})" for tier, ms in times.items()))


if __name__ == "__main__":
    main()
