#!/usr/bin/env python3
"""Registers, shared memory, spills and tensor-core instructions of every
hand-written kernel.

    python3 tools/ptxas_report.py      # from the repository root, with nvcc

Compiles each ``src/repro_torch/kernels/csrc/*.cu`` with the build's own
flags (``kernels/build.py``'s ``NVCC_FLAGS``) plus ``-Xptxas -v``, all
sources at once, into a temporary directory, and prints one line per
kernel entry: its demangled template arguments where ``c++filt`` is
there, registers, static shared memory (the dynamic part is set at
launch: the sources state it), spill stores and loads, stack frame, and
the count of its tensor-core instructions in its SASS, from ``cuobjdump
-sass`` of the library just built: ``HMMA`` (mma.sync), ``HGMMA``
(wgmma) and ``UTMALDG`` (TMA loads).  Prints the card's name and power
limit first when ``nvidia-smi`` is there, and any ``ptxas`` warning.
Exits non-zero if a flash-attention kernel (forward or backward, any head
dim) has no tensor-core instruction, if a bf16 backward kernel (dq,
dk/dv: wgmma fed by TMA) has no ``HGMMA`` or no ``UTMALDG`` or spills, or
if the forward spills; names the other backward kernels that spill.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
STATS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")
SMEM = re.compile(r"(\d+) bytes smem")
SASS_FUNCTION = re.compile(r"Function : (\S+)")
OPS = ("HMMA", "HGMMA", "UTMALDG")


def demangle(name):
    if shutil.which("c++filt") is None:
        return name
    return subprocess.run(["c++filt", name], capture_output=True,
                          text=True).stdout.strip() or name


def sass_counts(library):
    """{mangled kernel name: {op: instructions} for each of ``OPS``} from
    the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {library}:\n{r.stderr}")
    counts, name = {}, None
    for line in r.stdout.splitlines():
        if m := SASS_FUNCTION.search(line):
            name = m.group(1)
            counts[name] = dict.fromkeys(OPS, 0)
        elif name is not None:
            for op in OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def report(source, out_dir):
    library = os.path.join(out_dir, source + ".so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", library, str(build.CSRC / source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stderr}")
    sass = sass_counts(library)
    lines, bad, notes, entry, stats = [], [], [], None, None
    for line in r.stderr.splitlines():
        if "warning" in line.lower():
            lines.append(f"{source}: {line.strip()}")
        if m := ENTRY.search(line):
            entry, stats = m.group(1), None
        elif m := STATS.search(line):
            stats = m.groups()
        elif (m := REGS.search(line)) and entry is not None:
            frame, stores, loads = stats or ("?", "?", "?")
            smem = SMEM.search(line)
            name = demangle(entry).replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            ops = sass.get(entry, {})
            lines.append(f"{source}: {name}: {m.group(1)} "
                         f"registers, static smem "
                         f"{smem.group(1) if smem else 0} B, spill stores "
                         f"{stores} B, spill loads {loads} B, stack frame "
                         f"{frame} B, " + ", ".join(
                             f"{op} {ops.get(op, '?')}" for op in OPS))
            spills = stores != "0" or loads != "0"
            wgmma = "flash_bwd_" in name and "bf16" in name
            if wgmma and not (ops.get("HGMMA") and ops.get("UTMALDG")):
                bad.append(f"{name} (no HGMMA or no UTMALDG)")
            elif wgmma and spills:
                bad.append(f"{name} (spills)")
            elif "flash_" in name and not (ops.get("HMMA")
                                           or ops.get("HGMMA")):
                bad.append(f"{name} (no tensor-core instruction)")
            elif "flash_fwd" in name and spills:
                bad.append(f"{name} (spills)")
            elif "flash_" in name and spills:
                notes.append(name)
            entry = None
    return lines, bad, notes


def main():
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    bad, notes = [], []
    with tempfile.TemporaryDirectory() as out_dir, \
            ThreadPoolExecutor(max_workers=len(build.SOURCES)) as pool:
        for lines, worse, spill in pool.map(lambda s: report(s, out_dir),
                                            build.SOURCES):
            print("\n".join(lines))
            bad += worse
            notes += spill
    if notes:
        print("backward kernels that spill: " + ", ".join(notes))
    if bad:
        sys.exit("flash-attention kernels at fault: " + ", ".join(bad))
    print("every flash-attention kernel runs on the tensor cores, the bf16 "
          "backward on HGMMA fed by UTMALDG without spills; the forward "
          "spills at no head dim")


if __name__ == "__main__":
    main()
