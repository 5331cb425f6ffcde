"""The sharded plane across processes: the collectives of
``distributed/sharding.py`` over ``torch.distributed`` (gloo on
127.0.0.1), ``make_compressed_dp_step`` and ``ShardedFleetBackend``
refining one fleet from several processes.

Each job here runs this file as a script in ``world`` processes that
join through the environment contract and ``maybe_init_distributed``
(``run_job``: a free port, a deadline, the others killed when one
fails).  Every process runs the same program on the same seeded inputs
and holds only its own shards; what each returns is held BITWISE
against one process holding every shard (2 processes x 1 shard against
1 x 2, and 2 x 2 against 1 x 4): every collective forward and, where it
carries autograd, backward, their ``count_collectives`` records, the
compressed data-parallel step, and three refine rounds of the fleet
(loss, parts, per-session losses, head, GMM memory, snapshots), whose
head and memory must also be equal across the ranks.  The same
2-process fleet is held against the reference's own 2-shard
``ShardedFleetBackend`` on forced host devices, with its draws, head
and memory handed across, at ``tests/test_torch_sharded_fleet.py``'s
tolerances (loss and parts 1e-5, per-session losses 1e-5, head 1e-6,
memory 1e-5).  The join's backend choice is held through the injection
seam, and a peer that is missing, dies, or calls another collective
fails the job within its timeout.

A one-process backward accumulates a collective's output gradients as
autograd's engine does for a program built shard by shard (the last
shard's first); the tests' losses are built so, as the port's sharded
programs are.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fleet_backend import ShardedFleetBackend  # noqa: E402
from repro_torch.core.fleet_buffer import FleetBuffer  # noqa: E402
from repro_torch.core.gmm import GMMState  # noqa: E402
from repro_torch.core.hybrid import HybridCfg  # noqa: E402
from repro_torch.distributed import job as jobmod  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.grad_sync import (ef_init,  # noqa: E402
                                               make_compressed_dp_step)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.optim import sgd_init, sgd_update  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
JOB_TIMEOUT_S = 120          # a job's deadline, joins included

# the fleet at small width: 16 sessions x W 8 x d 16, M 8, k 5, a 16 -> 4
# head, a 4-component memory, 3 rounds
FLEET = dict(capacity=16, window=8, dim=16)
N_CLASSES = 4
CFG = HybridCfg(n_dirs=8)
ROUNDS = 3


# ---------------------------------------------------------------------------
# The job harness
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(program, world, tmp, *, ranks=None, timeout=JOB_TIMEOUT_S,
            check=True, env=None, script=None):
    """This file (or ``script``) as ``python <file> <program> <tmp>`` in
    ``world`` processes (``ranks`` of them started, default all; ``env``
    added to their environment) joined on 127.0.0.1 -> (exit codes, each
    rank's saved result or None).  With ``check`` a rank that exits
    non-zero fails the job: the others are killed and its error is
    raised."""
    port = free_port()
    procs = {}
    for r in range(world) if ranks is None else ranks:
        child = dict(os.environ, **(env or {}), PYTHONPATH=SRC,
                     CUDA_VISIBLE_DEVICES="",
                     REPRO_COORDINATOR=f"127.0.0.1:{port}",
                     REPRO_NUM_PROCESSES=str(world), REPRO_PROCESS_ID=str(r))
        procs[r] = subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__), program,
             str(tmp)],
            env=child, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    deadline = time.monotonic() + timeout
    failed = []
    try:
        while any(p.poll() is None for p in procs.values()):
            failed = [r for r, p in procs.items()
                      if p.poll() not in (None, 0)]
            if check and failed:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"job {program} ran past {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        errs = {r: p.communicate()[1] for r, p in procs.items()}
    rcs = {r: p.returncode for r, p in procs.items()}
    if check and any(rcs.values()):
        # the first to fail, not one this harness killed after it
        bad = (failed or [r for r, rc in rcs.items() if rc])[0]
        raise AssertionError(f"job {program}: rank {bad} exited {rcs[bad]}"
                             f"\n{errs[bad][-4000:]}")
    outs = {}
    for r in procs:
        path = os.path.join(tmp, f"{program}.{r}.pt")
        outs[r] = torch.load(path, weights_only=False) \
            if os.path.exists(path) else None
    return rcs, outs


def child_main(program, tmp):
    """One rank of a job: join, run ``program``, save what it returns."""
    if program in ("no_peer", "dies"):
        mesh_mod.TIMEOUT_S = 3.0
    assert mesh_mod.maybe_init_distributed()
    job = jobmod.current_job()
    out = PROGRAMS[program](job, tmp)
    torch.save(out, os.path.join(tmp, f"{program}.{job.rank}.pt"))


# ---------------------------------------------------------------------------
# The collectives: one set of cases, run by one process holding every shard
# and by each rank of a job on its own shards
# ---------------------------------------------------------------------------

def shard_inputs(R):
    """Every shard's value of every case, from one seed."""
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
          for _ in range(R)]
    trees = [{"a": torch.from_numpy(rng.standard_normal(4).astype(
        np.float32)), "b": [torch.from_numpy(rng.standard_normal(
            (2, 3)).astype(np.float32))]} for _ in range(R)]
    return xs, trees


def case_mesh(R, process_ids):
    """2 shards: ('x',); 4: (2, 2) ('a', 'b'), a process a row."""
    if R == 2:
        return shd.Mesh(np.array([torch.device("cpu")] * 2, dtype=object),
                        ("x",), process_ids=process_ids)
    devs = np.empty((2, 2), dtype=object)
    for i in range(4):
        devs.flat[i] = torch.device("cpu")
    return shd.Mesh(devs, ("a", "b"), process_ids=process_ids)


def cases(R, mesh):
    """name -> (collective over the shards' values, differentiable)."""
    out = {
        "psum": (shd.psum, True), "pmax": (shd.pmax, True),
        "pmean": (shd.pmean, True),
        "ppermute": (lambda xs: shd.ppermute(
            xs, [(i, (i + 1) % R) for i in range(R)]), True),
        "all_gather": (lambda xs: shd.all_gather(xs, 0), True),
        "all_gather_tiled": (lambda xs: shd.all_gather(xs, 1, tiled=True),
                             True),
        "all_to_all": (lambda xs: shd.all_to_all(xs, 0, 1), True),
        "axis_index": (lambda xs: [torch.tensor(float(i)) for i in
                                   shd.axis_index(xs)], False),
    }
    groups = [("x",)] if R == 2 else [("a",), ("b",), ("a", "b")]
    for axes in groups:
        tag = "".join(axes)
        out[f"psum_over_{tag}"] = (
            lambda xs, a=axes: shd.psum_over(xs, mesh, a), True)
        out[f"pmax_over_{tag}"] = (
            lambda xs, a=axes: shd.pmax_over(xs, mesh, a), True)
        out[f"pmean_over_{tag}"] = (
            lambda xs, a=axes: shd.pmean_over(xs, mesh, a), True)
        out[f"all_gather_over_{tag}"] = (
            lambda xs, a=axes: shd.all_gather_over(xs, mesh, a, 1,
                                                   tiled=True), True)
        out[f"all_to_all_over_{tag}"] = (
            lambda xs, a=axes: shd.all_to_all_over(xs, mesh, a, 0, 1), True)
        out[f"fsdp_gather_over_{tag}"] = (
            lambda xs, a=axes: shd.fsdp_gather_over(xs, mesh, a, 0), True)
    return out


def cotangent(name, s, like):
    """Shard s's output gradient of case ``name`` (seeded by both)."""
    rng = np.random.default_rng([sum(map(ord, name)), len(name), s])
    return torch.from_numpy(rng.standard_normal(tuple(like.shape)).astype(
        np.float32))


def run_cases(R, mine, mesh):
    """Every case on the shards ``mine`` (global indices) of an R-shard
    layout -> {case: {"out", "grad", "fwd", "bwd"}} for those shards.
    The loss is built shard by shard, in shard order."""
    xs, trees = shard_inputs(R)
    res = {}
    for name, (fn, diff) in cases(R, mesh).items():
        with shd.count_collectives() as fwd:
            outs = fn([xs[i] for i in mine])
        rec = {"out": [o.clone() for o in outs], "fwd": fwd}
        if diff:
            ins = [xs[i].clone().requires_grad_() for i in mine]
            with shd.count_collectives() as bwd:
                outs = fn(ins)
                loss = None
                for s, o in zip(mine, outs):
                    term = (o * cotangent(name, s, o)).sum()
                    loss = term if loss is None else loss + term
                loss.backward()
            rec["grad"] = [x.grad for x in ins]
            rec["bwd"] = bwd
        res[name] = rec
    with shd.count_collectives() as fwd:
        outs = shd.psum([trees[i] for i in mine])
    res["psum_tree"] = {"out": [[o["a"], o["b"][0]] for o in outs],
                        "fwd": fwd}
    return res


def prog_collectives(job, tmp):
    k = int(os.environ["REPRO_LOCAL_SHARDS"])
    R = job.world * k
    mine = list(range(job.rank * k, (job.rank + 1) * k))
    ids = [r for r in range(job.world) for _ in range(k)]
    mesh = case_mesh(R, np.array(ids).reshape((2,) if R == 2 else (2, 2)))
    assert mesh.spans and mesh.axis_local(mesh.axis_names[0]) in (
        [job.rank], [0, 1])
    return {"cases": run_cases(R, mine, mesh), "staged": dict(job.staged)}


@pytest.fixture(scope="module")
def collective_jobs(tmp_path_factory):
    """The cases at 2 processes x 1 shard and 2 x 2, run once."""
    out = {}
    for k in (1, 2):
        tmp = tmp_path_factory.mktemp(f"collectives{k}")
        out[k] = run_job("collectives", 2, tmp,
                         env={"REPRO_LOCAL_SHARDS": str(k)})[1]
    return out


@pytest.fixture(scope="module")
def one_process():
    """The cases in one process holding all 2k shards."""
    return {k: run_cases(2 * k, list(range(2 * k)), case_mesh(2 * k, None))
            for k in (1, 2)}


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("k,name", [
    (k, name) for k in (1, 2)
    for name in sorted(cases(2 * k, case_mesh(2 * k, None))) + ["psum_tree"]])
def test_collective_across_processes_is_one_process_bitwise(
        collective_jobs, one_process, k, name):
    """Each rank's shards' results (forward, and the inputs' gradients
    where the collective carries autograd) == one process holding all
    2k shards at those shards, bit for bit, with equal collective
    counts and bytes."""
    w = one_process[k][name]
    for rank, res in collective_jobs[k].items():
        got = res["cases"][name]
        mine = range(rank * k, (rank + 1) * k)
        for j, s in enumerate(mine):
            a, b = got["out"][j], w["out"][s]
            for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
                assert same(x, y), (name, rank, s)
            if "grad" in w:
                assert same(got["grad"][j], w["grad"][s]), (name, rank, s)
        assert got["fwd"] == w["fwd"], (name, got["fwd"], w["fwd"])
        assert got.get("bwd") == w.get("bwd"), (name, got.get("bwd"))


def test_collective_jobs_staged_nothing_on_the_cpu(collective_jobs):
    """On the CPU the exchange stages nothing to or from a device; it
    gathers every collective's bytes (counted apart)."""
    for k, job in collective_jobs.items():
        for res in job.values():
            st = res["staged"]
            assert st["d2h_bytes"] == st["h2d_bytes"] == 0
            assert st["calls"] > 0 and st["wire_bytes"] > 0


# ---------------------------------------------------------------------------
# The compressed data-parallel step
# ---------------------------------------------------------------------------

def dp_run(mesh):
    g = torch.Generator().manual_seed(0)
    w_true = torch.randn(8, 4, generator=g)
    X = torch.randn(16, 8, generator=g)
    batch = {"x": X, "y": X @ w_true}

    def loss_fn(params, b):
        r = b["x"] @ params["w"] - b["y"]
        return (r * r).mean()
    out = {}
    for compress in (False, True):
        p = {"w": torch.zeros(8, 4)}
        st, ef = sgd_init(p), ef_init(p)
        step = make_compressed_dp_step(mesh, loss_fn, sgd_update,
                                       axis="data", lr=0.1,
                                       compress=compress)
        for _ in range(6):
            p, st, ef = step(p, st, ef, batch)
        out[compress] = {"w": p["w"], "ef": [e["w"] for e in ef]
                         if isinstance(ef, list) else [ef["w"]]}
    return out


def prog_dp(job, tmp):
    mesh = mesh_mod.make_sessions_mesh(axis="data", devices=["cpu"])
    assert mesh.axis_process_ids("data") == [0, 1]
    return {"dp": dp_run(mesh)}


def test_compressed_dp_step_across_processes(tmp_path):
    """``make_compressed_dp_step`` in 2 processes == 1 process x 2
    shards, exact and int8-compressed, bitwise: the params on every
    rank, each rank's error-feedback residual its shard's."""
    _, res = run_job("dp", 2, tmp_path)
    want = dp_run(mesh_mod.make_test_mesh((2,), ("data",),
                                          devices=["cpu"] * 2))
    for rank, r in res.items():
        for compress in (False, True):
            got, w = r["dp"][compress], want[compress]
            assert same(got["w"], w["w"]), (rank, compress)
            if compress:
                assert len(got["ef"]) == 1
                assert same(got["ef"][0], w["ef"][rank])


# ---------------------------------------------------------------------------
# ShardedFleetBackend across processes
# ---------------------------------------------------------------------------

def fleet_ops(be):
    """The same calls on any backend: 13 admissions, 11 ticks of frames
    with per-session drops (wrapping the window), a single insert, an
    eviction re-admitted onto its dirty row, and a row imported from a
    host buffer -> the first admissions' sids."""
    rng = np.random.default_rng(3)
    sids = [be.admit() for _ in range(13)]
    for t in range(11):
        keep = [s for i, s in enumerate(sids) if (t + i) % 5 != 2]
        z = rng.standard_normal((len(keep), FLEET["dim"])).astype(np.float32)
        be.insert_batch(np.array(keep), np.full(len(keep), t), z,
                        np.full(len(keep), t % N_CLASSES))
    be.insert(sids[0], 11, rng.standard_normal(FLEET["dim"]).astype(
        np.float32), label=1)
    be.evict(sids[4])
    again = be.admit()
    be.insert(again, 0, np.ones(FLEET["dim"], np.float32), label=2)
    src = FleetBuffer(capacity=1, window=FLEET["window"], dim=FLEET["dim"])
    row = src.admit()
    for t in range(5):
        src.insert(row, t + 3, rng.standard_normal(FLEET["dim"]).astype(
            np.float32), label=t % N_CLASSES)
    be.evict(sids[7])
    moved = be.admit()
    be.import_row(moved, *src.export_row(row))
    return sids


def head_apply(p, z):
    return z @ p["w"]


def port_fleet(inputs, mesh):
    """The port's sharded fleet on ``mesh`` with the handed-across head,
    draws and memory, after ``fleet_ops``."""
    w = torch.from_numpy(inputs["w"])
    be = ShardedFleetBackend(
        **FLEET, head_init=lambda g: {"w": w}, head_apply=head_apply,
        cfg=CFG, lr=0.1, seed=0, n_components=4, mesh=mesh,
        draws=lambda r: inputs["draws"][r])
    be.memory = GMMState(*(torch.from_numpy(np.asarray(x))
                           for x in inputs["memory"]))
    fleet_ops(be)
    return be


def fleet_rounds(be):
    rounds = [be.refine(r) for r in range(ROUNDS)]
    return {"rounds": rounds, "head": be.refiner.state.params["w"].clone(),
            "memory": [x.clone() for x in be.memory],
            "snapshot": be.snapshot(), "local": be.local,
            "snapshot_h2d_bytes": be.snapshot_h2d_bytes}


def prog_fleet(job, tmp):
    inputs = torch.load(os.path.join(tmp, "fleet_inputs.pt"),
                        weights_only=False)
    be = port_fleet(inputs, mesh_mod.make_sessions_mesh(devices=["cpu"]))
    assert be.shards == 2 and be.local == [job.rank]
    out = fleet_rounds(be)
    out["rows"] = int(be.z.shape[0])
    return out


_JAX_INPUTS = """
import json, sys, jax, numpy as np
from repro.core import gmm as jgmm
from repro.core import swd as jswd
DIM, NC, W, M = 16, 4, 8, 8
def head_init(key): return {"w": 0.01 * jax.random.normal(key, (DIM, NC))}
draws = []
for r in range(3):
    kd, kp = jax.random.split(jax.random.PRNGKey(r))
    draws.append([np.asarray(jswd.random_directions(kd, M, DIM)).tolist(),
                  np.asarray(jswd.sphere_prior_samples(kp, W, DIM)).tolist()])
mem = jgmm.init_gmm(jax.random.PRNGKey(1), 4, DIM)
out = {"w": np.asarray(head_init(jax.random.PRNGKey(0))["w"]).tolist(),
       "draws": draws, "memory": [np.asarray(x).tolist() for x in mem]}
"""

_JAX_FLEET = _JAX_INPUTS + """
sys.path.insert(0, %r)
from test_torch_multiprocess_fleet import fleet_ops
from repro.core.fleet import ShardedFleetBackend
from repro.core.hybrid import HybridCfg
assert len(jax.devices()) == 2
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("sessions",))
b = ShardedFleetBackend(capacity=16, window=W, dim=DIM, head_init=head_init,
                        head_apply=lambda p, z: z @ p["w"],
                        cfg=HybridCfg(n_dirs=M), lr=0.1, seed=0,
                        n_components=4, mesh=mesh)
fleet_ops(b)
rounds = []
for r in range(3):
    loss, parts, per = b.refine(jax.random.PRNGKey(r))
    rounds.append([float(loss), {k: float(v) for k, v in parts.items()},
                   np.asarray(per).tolist()])
out["ref"] = {"rounds": rounds,
              "w": np.asarray(b.refiner.state.params["w"]).tolist(),
              "memory": [np.asarray(x).tolist() for x in b.memory]}
print("JSON" + json.dumps(out))
""" % HERE


@pytest.fixture(scope="module")
def fleet_job(tmp_path_factory):
    """The reference's 2-shard fleet and its draws, head and memory (one
    forked run on 2 forced host devices), and the port's fleet run by 2
    processes on them."""
    from conftest import run_python
    line = next(x for x in run_python(_JAX_FLEET, devices=2).splitlines()
                if x.startswith("JSON"))
    ref = json.loads(line[4:])
    inputs = {"w": np.float32(ref["w"]),
              "draws": [tuple(np.float32(a) for a in d)
                        for d in ref["draws"]],
              "memory": [np.float32(ref["memory"][0]),
                         np.float32(ref["memory"][1]),
                         np.float32(ref["memory"][2]),
                         np.int32(ref["memory"][3])]}
    tmp = tmp_path_factory.mktemp("fleet")
    torch.save(inputs, os.path.join(tmp, "fleet_inputs.pt"))
    _, res = run_job("fleet", 2, tmp)
    return inputs, ref["ref"], res


def test_fleet_refine_across_processes_is_one_process_bitwise(fleet_job):
    """2 processes x 1 shard == the port's 1 process x 2 shards, bit for
    bit: every round's loss, parts and per-session losses, the head, the
    GMM memory and the snapshot, on both ranks; each rank holds only its
    shard's rows."""
    inputs, _, res = fleet_job
    be = port_fleet(inputs, mesh_mod.make_sessions_mesh(
        devices=["cpu"] * 2))
    want = fleet_rounds(be)
    for rank, got in res.items():
        assert got["local"] == [rank] and got["rows"] == 8
        for r, ((la, pa, qa), (lb, pb, qb)) in enumerate(
                zip(got["rounds"], want["rounds"])):
            assert la == lb and pa == pb, (rank, r, la, lb, pa, pb)
            np.testing.assert_array_equal(qa, qb)
            assert qa.shape == (FLEET["capacity"],)
        assert same(got["head"], want["head"])
        for x, y in zip(got["memory"], want["memory"]):
            assert same(x, y)
        for x, y in zip(got["snapshot"], want["snapshot"]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert got["snapshot_h2d_bytes"] == 0


def test_fleet_head_and_memory_equal_across_ranks(fleet_job):
    _, _, res = fleet_job
    a, b = res[0], res[1]
    assert same(a["head"], b["head"])
    assert all(same(x, y) for x, y in zip(a["memory"], b["memory"]))
    assert [x[:2] for x in a["rounds"]] == [x[:2] for x in b["rounds"]]


def test_fleet_across_processes_matches_reference_sharded(fleet_job):
    """The 2-process fleet against the reference's 2-shard backend on
    forced host devices (same placement, frames, draws, head, memory):
    loss and parts 1e-5, per-session losses 1e-5, head 1e-6, memory
    1e-5."""
    _, ref, res = fleet_job
    for rank, got in res.items():
        for (loss, parts, per), (jl, jp, jper) in zip(got["rounds"],
                                                      ref["rounds"]):
            assert abs(loss - jl) < 1e-5
            for k in jp:
                assert abs(parts[k] - jp[k]) < 1e-5, k
            np.testing.assert_allclose(per, np.float32(jper), atol=1e-5)
        np.testing.assert_allclose(got["head"].numpy(), np.float32(ref["w"]),
                                   atol=1e-6)
        for x, y in zip(got["memory"][:3], ref["memory"][:3]):
            np.testing.assert_allclose(x.numpy(), np.float32(y), atol=1e-5)


# ---------------------------------------------------------------------------
# Joining, and the ways a job fails
# ---------------------------------------------------------------------------

class FakeDist:
    """``torch.distributed`` for the join's backend choice: records the
    calls and hands every rank's ``cards()`` out."""

    def __init__(self, places):
        self.places, self.calls = places, []

    def init_process_group(self, backend, **kw):
        self.calls.append(("init", backend, kw["world_size"], kw["rank"]))

    def all_gather_object(self, out, obj):
        out[:] = self.places

    def new_group(self, backend, **kw):
        self.calls.append(("new_group", backend))
        return "nccl-group"


@pytest.mark.parametrize("places,nccl", [
    ([("h", ["GPU-0"]), ("h", ["GPU-0"])], False),    # one card, two ranks
    ([("h", ["GPU-0"]), ("h", ["GPU-1"])], True),     # a card a rank
    ([("h", ["GPU-0", "GPU-1"]), ("h", ["GPU-1"])], False),
    ([("a", []), ("b", [])], False),                  # no card
])
def test_join_chooses_gloo_and_nccl_only_for_distinct_cards(places, nccl):
    """Every rank joins gloo; an NCCL group for the collectives' CUDA
    payloads comes only where every rank owns cards no other rank sees
    (NCCL refuses two ranks on one device)."""
    from functools import partial
    fake = FakeDist(places)
    saved, prev = dict(mesh_mod._distributed), jobmod.current_job()
    mesh_mod._distributed["initialized"] = False
    try:
        assert mesh_mod.maybe_init_distributed(
            env={"REPRO_COORDINATOR": "127.0.0.1:1", "REPRO_NUM_PROCESSES":
                 "2", "REPRO_PROCESS_ID": "1"},
            initialize=partial(mesh_mod._init_process_group, dist=fake))
        job = jobmod.current_job()
    finally:
        mesh_mod._distributed.clear()
        mesh_mod._distributed.update(saved)
        jobmod.set_job(prev)
    assert fake.calls[0] == ("init", "gloo", 2, 1)
    assert (("new_group", "nccl") in fake.calls) == nccl
    assert job.rank == 1 and job.world == 2
    assert (job.nccl == "nccl-group") == nccl
    assert mesh_mod.data_backend(places) == ("nccl" if nccl else "gloo")


def prog_joined(job, tmp):
    mesh = mesh_mod.make_sessions_mesh(devices=["cpu", "cpu"])
    return {"world": job.world, "rank": job.rank, "nccl": job.nccl,
            "backend": torch.distributed.get_backend(),
            "owners": mesh.axis_process_ids("sessions"),
            "local": mesh.axis_local("sessions"),
            "index": list(shd.axis_index([0, 0]))}


def test_two_ranks_join_over_gloo_and_span_a_mesh(tmp_path):
    """Two CPU ranks join gloo with no NCCL group; ``make_sessions_mesh``
    spans the job, each rank contributing its devices in rank order."""
    _, res = run_job("joined", 2, tmp_path)
    for rank, r in res.items():
        assert (r["world"], r["rank"], r["nccl"]) == (2, rank, None)
        assert r["backend"] == "gloo"
        assert r["owners"] == [0, 0, 1, 1]
        assert r["local"] == [2 * rank, 2 * rank + 1]
        assert r["index"] == [2 * rank, 2 * rank + 1]


def prog_misorder(job, tmp):
    x = [torch.ones(3)]
    try:
        (shd.psum if job.rank == 0 else shd.pmax)(x)
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


def prog_dies(job, tmp):
    if job.rank == 1:
        os._exit(3)
    try:
        shd.psum([torch.ones(3)])
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


def prog_no_peer(job, tmp):
    return {}


def test_collectives_called_out_of_order_fail(tmp_path):
    """Ranks that call different collectives fail at that call, with the
    header they disagree on, instead of mixing payloads."""
    _, res = run_job("misorder", 2, tmp_path)
    for r in res.values():
        assert r["raised"] and "differs across the job" in r["raised"]


def test_a_dead_peer_fails_the_job_within_its_timeout(tmp_path):
    """A rank that dies after the join fails the others' next collective
    (its own exit code fails the harness), inside the job's deadline."""
    start = time.monotonic()
    rcs, res = run_job("dies", 2, tmp_path, check=False)
    assert rcs[1] == 3
    assert rcs[0] != 0 or res[0]["raised"]
    assert time.monotonic() - start < JOB_TIMEOUT_S
    with pytest.raises(AssertionError, match="rank 1 exited 3"):
        run_job("dies", 2, tmp_path)


def test_a_missing_peer_fails_the_join_within_its_timeout(tmp_path):
    """Rank 0 of a 2-process job whose rank 1 never starts raises from
    the join at the join's timeout (3 s here) instead of waiting."""
    start = time.monotonic()
    rcs, res = run_job("no_peer", 2, tmp_path, ranks=[0], check=False)
    assert rcs[0] != 0 and res[0] is None
    assert time.monotonic() - start < 60


PROGRAMS = {"collectives": prog_collectives, "dp": prog_dp,
            "fleet": prog_fleet, "joined": prog_joined,
            "misorder": prog_misorder, "dies": prog_dies,
            "no_peer": prog_no_peer}


if __name__ == "__main__":
    torch.set_num_threads(1)
    child_main(sys.argv[1], sys.argv[2])
