#!/usr/bin/env python3
"""The collectives across processes at 4 processes x 1 shard: every case
of ``tests/test_torch_multiprocess_fleet.py`` (forward, backward and
``count_collectives``) held bitwise against 1 process x 4 shards on one
device.

    python3 tools/multiprocess_collectives.py cuda   # four CUDA cards
    python3 tools/multiprocess_collectives.py cpu    # gloo on the CPU

With ``cuda`` each rank sees one card of its own
(``CUDA_VISIBLE_DEVICES``), so the join gives it an NCCL group and the
exchanges run over NCCL; with ``cpu`` they run over gloo.  Prints each
rank's NCCL flag and staging record and the mismatches; exits 1 on any.
"""
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_multiprocess_fleet as T  # noqa: E402
from repro_torch.distributed import job as jobmod  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

WORLD = 4


def on(device):
    """The test's inputs and output gradients made on ``device``."""
    real = T.shard_inputs
    T.shard_inputs = lambda R: tuple(
        [T.shd._tree_map(lambda t: t.to(device), x) for x in xs]
        for xs in real(R))
    cot = T.cotangent
    T.cotangent = lambda name, s, like: cot(name, s, like).to(like.device)


def rank_main(device, out):
    """One rank: join from the environment, run the cases on its shard,
    save them to ``out``."""
    on(device)
    assert mesh_mod.maybe_init_distributed()
    job = jobmod.current_job()
    mesh = T.case_mesh(4, np.arange(4).reshape(2, 2))
    res = T.run_cases(4, [job.rank], mesh)
    res = T.shd._tree_map(
        lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, res)
    torch.save({"cases": res, "nccl": job.nccl is not None,
                "staged": dict(job.staged)}, out)


def main(device):
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout if device == "cuda" else "cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    d = os.path.join(ROOT, "build", "multiprocess_collectives")
    os.makedirs(d, exist_ok=True)
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, REPRO_COORDINATOR=f"127.0.0.1:{port}",
                   REPRO_NUM_PROCESSES=str(WORLD), REPRO_PROCESS_ID=str(r))
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "rank", device,
             os.path.join(d, f"{r}.pt")], env=env))
    t0 = time.time()
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) \
                or time.time() - t0 > 300:
            for p in procs:
                p.kill()
            sys.exit(f"a rank failed: {[p.poll() for p in procs]}")
        time.sleep(0.1)
    on(device)
    want = T.run_cases(4, list(range(4)), T.case_mesh(4, None))
    bad = []
    for r in range(WORLD):
        got = torch.load(os.path.join(d, f"{r}.pt"), weights_only=False)
        print(f"rank {r}: nccl {got['nccl']}, staged {got['staged']}")
        for name, w in want.items():
            g = got["cases"][name]
            a, b = g["out"][0], w["out"][r]
            pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
            if not all(torch.equal(x.cpu(), y.cpu()) for x, y in pairs):
                bad.append((r, name, "out"))
            if "grad" in w and not torch.equal(g["grad"][0].cpu(),
                                               w["grad"][r].cpu()):
                bad.append((r, name, "grad"))
            if g["fwd"] != w["fwd"] or g.get("bwd") != w.get("bwd"):
                bad.append((r, name, "counts"))
    print(f"{len(want)} cases x {WORLD} ranks, mismatches: {bad}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1])
