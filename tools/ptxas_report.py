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
the count of ``HMMA`` (tensor-core) instructions in its SASS, from
``cuobjdump -sass`` of the library just built.  Prints the card's name
and power limit first when ``nvidia-smi`` is there.
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


def demangle(name):
    if shutil.which("c++filt") is None:
        return name
    return subprocess.run(["c++filt", name], capture_output=True,
                          text=True).stdout.strip() or name


def hmma_counts(library):
    """{mangled kernel name: HMMA instructions} from the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {library}:\n{r.stderr}")
    counts, name = {}, None
    for line in r.stdout.splitlines():
        if m := SASS_FUNCTION.search(line):
            name = m.group(1)
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def report(source, out_dir):
    library = os.path.join(out_dir, source + ".so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", library, str(build.CSRC / source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stderr}")
    hmma = hmma_counts(library)
    lines, entry, stats = [], None, None
    for line in r.stderr.splitlines():
        if m := ENTRY.search(line):
            entry, stats = m.group(1), None
        elif m := STATS.search(line):
            stats = m.groups()
        elif (m := REGS.search(line)) and entry is not None:
            frame, stores, loads = stats or ("?", "?", "?")
            smem = SMEM.search(line)
            name = demangle(entry).replace("(anonymous namespace)::", "")
            lines.append(f"{source}: {name.split('(')[0]}: {m.group(1)} "
                         f"registers, static smem "
                         f"{smem.group(1) if smem else 0} B, spill stores "
                         f"{stores} B, spill loads {loads} B, stack frame "
                         f"{frame} B, HMMA {hmma.get(entry, '?')}")
            entry = None
    return lines


def main():
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as out_dir, \
            ThreadPoolExecutor(max_workers=len(build.SOURCES)) as pool:
        for lines in pool.map(lambda s: report(s, out_dir), build.SOURCES):
            print("\n".join(lines))


if __name__ == "__main__":
    main()
