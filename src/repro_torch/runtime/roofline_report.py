"""The dry-run's roofline tables from ``launch/dryrun.py``'s records.

Port of ``benchmarks/roofline_report.py``: the same two tables (single-pod
16x16, multi-pod 2x16x16) over the port's records, with a ``fits`` column
(a shard's traced peak within the card's memory).

  python -m repro_torch.runtime.roofline_report [experiments/dryrun_torch]
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(dirname="experiments/dryrun_torch"):
    recs = []
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_table(recs, mesh="single"):
    """One markdown table: the records of the single-pod (a 2-d mesh) or
    multi-pod (3-d) mesh; a failed cell's error in its row."""
    rows = []
    hdr = ("| arch | shape | params | compute(ms) | memory(ms) | coll(ms) | "
           "bottleneck | useful-FLOP | MFU≤ | peak mem/chip | fits |")
    sep = "|" + "---|" * 11
    rows.append(hdr)
    rows.append(sep)
    for r in recs:
        if "error" in r:
            if mesh in r.get("mesh", ""):
                rows.append(f"| {r['arch']} | {r['shape']} | ERROR: "
                            f"{r['error'][:60]} |" + " |" * 8)
            continue
        is_single = r["mesh"].count("x") == 1
        if (mesh == "single") != is_single:
            continue
        rl = r["roofline"]
        peak = r["memory"].get("peak_memory_in_bytes", 0) / 2 ** 30
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['n_params']/1e9:.2f}B "
            f"| {rl['compute_s']*1e3:.1f} | {rl['memory_s']*1e3:.1f} "
            f"| {rl['collective_s']*1e3:.1f} | {rl['bottleneck']} "
            f"| {rl['useful_flop_fraction']:.2f} "
            f"| {rl['mfu_upper_bound']*100:.1f}% | {peak:.1f} GB "
            f"| {'yes' if r['memory'].get('fits') else 'no'} |")
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    recs = load(argv[0] if argv else "experiments/dryrun_torch")
    print("## single-pod (16x16)\n")
    print(fmt_table(recs, "single"))
    print("\n## multi-pod (2x16x16)\n")
    print(fmt_table(recs, "multi"))


if __name__ == "__main__":
    main()
