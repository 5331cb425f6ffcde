#!/usr/bin/env python3
"""Registers, shared memory and spills of every hand-written kernel.

    python3 tools/ptxas_report.py      # from the repository root, with nvcc

Compiles each ``src/repro_torch/kernels/csrc/*.cu`` with the build's own
flags (``kernels/build.py``'s ``NVCC_FLAGS``) plus ``-Xptxas -v``, all
sources at once, into a temporary directory, and prints one line per
kernel entry: its demangled template arguments where ``c++filt`` is
there, registers, spill stores and loads, and stack frame.  Prints the
card's name and power limit first when ``nvidia-smi`` is there.
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


def demangle(name):
    if shutil.which("c++filt") is None:
        return name
    return subprocess.run(["c++filt", name], capture_output=True,
                          text=True).stdout.strip() or name


def report(source, out_dir):
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", os.path.join(out_dir, source + ".so"),
                        str(build.CSRC / source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stderr}")
    lines, entry, stats = [], None, None
    for line in r.stderr.splitlines():
        if m := ENTRY.search(line):
            entry, stats = demangle(m.group(1)), None
        elif m := STATS.search(line):
            stats = m.groups()
        elif (m := REGS.search(line)) and entry is not None:
            frame, stores, loads = stats or ("?", "?", "?")
            name = entry.replace("(anonymous namespace)::", "")
            lines.append(f"{source}: {name.split('(')[0]}: {m.group(1)} "
                         f"registers, spill stores {stores} B, spill loads "
                         f"{loads} B, stack frame {frame} B")
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
