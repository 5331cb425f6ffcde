"""The LM on a mesh across processes: ``Trainer`` (``make_sharded_train_
step``), ``lm.prefill`` and ``lm.decode_step`` under ``rules_for`` on a
mesh that spans a joined job (gloo on 127.0.0.1), each process holding
and computing only its own shards.

Each job runs this file as a script in two processes through
``test_torch_multiprocess_fleet.run_job`` (the environment contract,
``maybe_init_distributed``, a deadline).  Every process builds the same
mesh with ``make_test_mesh`` (each contributing its CPU shards, in rank
order) and runs the same cases on the same seeded inputs, one torch
thread each; what each returns is held BITWISE against this process
running the same case on one process holding every shard: the losses
and metrics of every step, every local block of the params and optimizer
state, the decode logits (every rank returns the same global ones) and
the decode state's blocks, and the ``count_collectives`` record.  The
exchanges are held to the crossing collectives: the one-process run
records each collective whose groups would cross the two processes'
shards (and so each gather, and the global norm's one exchange), the
ranks record each exchange they make, and ``Job.staged["calls"]`` counts
them; a collective whose groups lie within one process ('model' on
(2, 2), two shards a process) makes none.

Cases (the smoke configs at B 4 x S 32, hybrid term on): qwen1.5-0.5b on
(data 2, model 2), two processes x two shards, AdamW, two steps;
row-parallel q, k, v (3 heads, 1 kv head) on (1, 2), two x one ('model'
crosses); the kv-row case (4 heads over 2 kv heads) on (1, 4), two x two;
FSDP on (2, 2) with 2 microbatches and Adafactor; mamba2-780m,
zamba2-1.2b and arctic-480b (``moe_ep``) on (1, 2); prefill and 4 greedy
decode steps of qwen3-1.7b on (2, 2) under ``kind="decode"`` at batch 4
(kv heads over 'model') and batch 1 (the cache's positions over 'data').
One step from the reference's own state (qwen1.5-0.5b on (2, 2)) is also
held to the reference's unsharded jitted step at
``test_torch_sharded_lm.py``'s tolerances.  A ``Trainer`` with a
checkpoint directory on a spanning mesh raises, and ``launch.train.main``
joins a job by itself and prints the same final loss on both ranks (the
production mesh patched to (2, 2), as ``test_torch_launch_mesh.py``
patches it).
"""
import contextlib
import io
import os
import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import job as jobmod  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_multiprocess_fleet import run_job, same  # noqa: E402

WORLD = 2
B, S, POOL, LR, STEPS = 4, 32, 8, 1e-3, 2
DECODE_STEPS = 4
JOB_TIMEOUT_S = 240
LEAF_RTOL = 1e-4
K_BIAS, K_BIAS_LR_FRAC = "blocks/layers/attn/wk/b", 0.03
# name: (config, overrides, mesh, optimizer, microbatches, fsdp)
TRAIN = {
    "qwen1.5-2x2": ("qwen1.5-0.5b", {}, (2, 2), "adamw", 1, False),
    "kvrow-1x4": ("qwen3-1.7b", dict(n_kv_heads=2), (1, 4), "adamw", 1,
                  False),
    "fsdp-2x2": ("qwen3-1.7b", {}, (2, 2), "adafactor", 2, True),
    "rowparallel-1x2": ("qwen1.5-0.5b", dict(n_heads=3, n_kv_heads=1),
                        (1, 2), "adamw", 1, False),
    "mamba2-1x2": ("mamba2-780m", {}, (1, 2), "adamw", 1, False),
    "zamba2-1x2": ("zamba2-1.2b", {}, (1, 2), "adamw", 1, False),
    "arctic-1x2": ("arctic-480b", {}, (1, 2), "adamw", 1, False),
}
# name: (config, mesh, batch, prompt, max_len)
DECODE = {"decode-2x2": ("qwen3-1.7b", (2, 2), 4, 21, 32),
          "decode-batch1-2x2": ("qwen3-1.7b", (2, 2), 1, 21, 32),
          # the prompt's 24 positions split over 'data', which crosses the
          # ranks: k, v, the SSM's tails and states gathered across them
          "zamba2-split-2x2": ("zamba2-1.2b", (2, 2), 1, 24, 32)}
# the step held to the reference: (config, mesh)
REF = ("qwen1.5-0.5b", (2, 2))
# the cases of the job whose processes hold two shards, and of the one
# whose processes hold one
JOBS = {2: [k for k, v in TRAIN.items() if np.prod(v[2]) == 4]
        + list(DECODE) + ["ref"],
        1: [k for k, v in TRAIN.items() if np.prod(v[2]) == 2]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(name, **kw):
    return replace(base.smoke_config(base.get_config(name)), **kw)


def the_mesh(shape, k):
    """``shape`` over ``k`` CPU shards of this process (in a job: of
    every process, spanning it)."""
    return mesh_mod.make_test_mesh(shape, devices=["cpu"] * k)


def data_fn(vocab):
    def fn(step):
        g = torch.Generator().manual_seed(100 + step)
        toks = torch.randint(0, vocab, (B, S + 1), generator=g)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return fn


def local_blocks(tree):
    """{leaf path: {global shard: block}} of this process's blocks."""
    from repro_torch.checkpoint.serial import _paths
    return {k: {i: b.clone() for i, b in enumerate(t.blocks)
                if b is not None}
            for k, t in _paths(tree) if isinstance(t, shd.Placed)}


# ---------------------------------------------------------------------------
# What crosses: recorded by the ranks (their exchanges) and by one process
# (the collectives whose groups would cross the ranks' shards)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def exchanges():
    """The kinds of the exchanges made in the block (a list)."""
    seen, real = [], jobmod.exchange

    def spy(trees, owners, kind):
        seen.append(kind)
        return real(trees, owners, kind)
    jobmod.exchange = spy
    try:
        yield seen
    finally:
        jobmod.exchange = real


@contextlib.contextmanager
def crossings(k):
    """In one process: the collectives of the block whose groups would
    cross ``WORLD`` processes holding ``k`` shards each, in rank order
    -> {"forward": n, "backward": n (those whose inputs carry autograd)}.
    A gather of a ``Placed`` and the global norm count one each."""
    rec = {"forward": 0, "backward": 0}
    over, fsdp, gather = shd._over, shd.fsdp_gather_over, shd.Placed.gather
    norm, inner = tr.global_norm, {"on": False}

    def owned(mesh):
        ids = np.arange(mesh.devices.size) // k
        return shd.Mesh(mesh.devices, mesh.axis_names,
                        process_ids=ids.reshape(mesh.devices.shape))

    def note(vals, crossed):
        if not crossed or inner["on"]:
            return
        rec["forward"] += 1
        # a remat layer's replay, run by the backward, makes no node of
        # its own to differentiate: the forward's node is differentiated
        replay = torch._C._current_graph_task_id() != -1
        rec["backward"] += torch.is_grad_enabled() and not replay and any(
            t.requires_grad for v in vals for t in jobmod.leaves(v))

    def spy_over(fn, vals, mesh, axes, kind, gathered=False):
        vals = list(vals)
        note(vals, owned(mesh).crosses(axes))
        return over(fn, vals, mesh, axes, kind, gathered)

    def spy_fsdp(vals, mesh, axes, dim):
        vals = list(vals)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if np.prod([mesh.shape[a] for a in axes]) > 1:
            note(vals, owned(mesh).crosses(axes))
        inner["on"] = True
        try:
            return fsdp(vals, mesh, axes, dim)
        finally:
            inner["on"] = False

    def spy_gather(self, device=None):
        note([b for b in self.blocks], True)
        return gather(self, device)

    def spy_norm(params, grads):
        rec["forward"] += 1
        return norm(params, grads)
    shd._over, shd.fsdp_gather_over = spy_over, spy_fsdp
    shd.Placed.gather, tr.global_norm = spy_gather, spy_norm
    try:
        yield rec
    finally:
        shd._over, shd.fsdp_gather_over = over, fsdp
        shd.Placed.gather, tr.global_norm = gather, norm


def counted(k, fn):
    """``fn()`` with its collectives counted, and what crossed: the
    exchanges made (in a job) or the collectives that would cross (in one
    process holding every shard) -> (result, collectives, crossed)."""
    job = jobmod.current_job()
    with shd.count_collectives() as coll:
        if job is None:
            with crossings(k) as rec:
                out = fn()
            return out, coll, rec
        before = job.staged["calls"]
        with exchanges() as seen:
            out = fn()
    back = sum(s.endswith("(backward)") for s in seen)
    return out, coll, {"forward": len(seen) - back, "backward": back,
                       "staged": job.staged["calls"] - before}


# ---------------------------------------------------------------------------
# The cases: run by each rank of a job on its shards, and by one process
# holding every shard (k: the shards a rank holds)
# ---------------------------------------------------------------------------

def train_case(name, k, here):
    cname, kw, shape, optimizer, mb, fsdp = TRAIN[name]
    c = smoke(cname, **kw)
    tcfg = tr.TrainCfg(optimizer=optimizer, lr=LR, warmup=1, total_steps=10,
                       microbatches=mb, hybrid=True, hybrid_pool=POOL)
    rules = shd.rules_for(the_mesh(shape, here), c, batch=B, kind="train",
                          fsdp=fsdp)
    with shd.axis_rules(rules):
        t = tr.Trainer(c, tcfg, data_fn(c.vocab), device="cpu")
    hist, coll, crossed = counted(k, lambda: t.run(STEPS, log_every=0))
    return {"hist": [{m: v for m, v in h.items() if m != "time_s"}
                     for h in hist],
            "state": local_blocks({"params": t.state["params"],
                                   "opt": t.state["opt"]}),
            "collectives": coll, "crossed": crossed,
            "local": t.layout.local}


def decode_case(name, k, here):
    cname, shape, batch, prompt, max_len = DECODE[name]
    c = smoke(cname)
    p = lm.init_lm(c, torch.Generator().manual_seed(0))
    toks = torch.randint(0, c.vocab, (batch, prompt),
                         generator=torch.Generator().manual_seed(1))
    rules = shd.rules_for(the_mesh(shape, here), c, batch=batch,
                          kind="decode")

    def run():
        logits = []
        with torch.no_grad(), shd.axis_rules(rules):
            st, out = lm.prefill(c, p, tokens=toks, max_len=max_len)
            logits.append(out)
            for _ in range(DECODE_STEPS):
                out, st = lm.decode_step(c, p, st, out.argmax(-1))
                logits.append(out)
        return logits, st
    (logits, st), coll, crossed = counted(k, run)
    return {"logits": logits, "state": local_blocks(st),
            "collectives": coll, "crossed": crossed,
            "kv_seq": rules.act_rules["kv_seq"]}


def ref_case(here, tmp):
    """One ``make_sharded_train_step`` from the reference's state, batch
    and draws (saved by the test into ``tmp``)."""
    from repro_torch.weights import train_state_from_jax
    given = torch.load(os.path.join(tmp, "ref_inputs.pt"), weights_only=False)
    c = smoke(REF[0])
    tcfg = tr.TrainCfg(lr=LR, warmup=1, total_steps=10, hybrid=True,
                       hybrid_pool=POOL)
    lay = shd.ShardLayout(shd.rules_for(the_mesh(REF[1], here), c,
                                        batch=B, kind="train"))
    state = tr.place_train_state(train_state_from_jax(given["state"]), c,
                                 "adamw", lay)
    step = tr.make_sharded_train_step(c, tcfg, lay)
    params, opt, m = step(state["params"], state["opt"], given["batch"], 0,
                          [given["draws"]])
    from repro_torch.weights import lm_from_mesh
    return {"metrics": {k2: v.clone() for k2, v in m.items()},
            "whole": lm_from_mesh(params),
            "state": local_blocks({"params": params, "opt": opt})}


def ckpt_refused(k, tmp):
    """Whether a ``Trainer`` with a checkpoint directory on a mesh that
    spans the job raises."""
    c = smoke("qwen1.5-0.5b")
    with shd.axis_rules(shd.rules_for(the_mesh((2, 2), k), c, batch=B)):
        try:
            tr.Trainer(c, tr.TrainCfg(), data_fn(c.vocab), device="cpu",
                       ckpt_dir=os.path.join(tmp, "ckpt"))
        except NotImplementedError as e:
            return "spans processes" in str(e)
    return False


def run_cases(k, tmp, here):
    """The cases of the job of ``k`` shards a rank, on ``here`` shards of
    this process (``k`` in the job, ``WORLD * k`` alone)."""
    out = {}
    for name in JOBS[k]:
        if name in TRAIN:
            out[name] = train_case(name, k, here)
        elif name in DECODE:
            out[name] = decode_case(name, k, here)
        else:
            out[name] = ref_case(here, tmp)
    return out


def meshes():
    """The meshes a joined job builds: the production mesh over ``256 /
    WORLD`` CPU devices a process, and (2, 2) over 3 a process, which is
    not the job's total."""
    prod = mesh_mod.make_production_mesh(devices=["cpu"] * (256 // WORLD))
    try:
        mesh_mod.make_test_mesh((2, 2), devices=["cpu"] * 3)
        refused = False
    except ValueError:
        refused = True
    return {"shape": prod.shape, "ids": prod.process_ids.tolist(),
            "local": prod.local(), "refused": refused}


def prog_lm(job, tmp):
    k = int(os.environ["REPRO_LOCAL_SHARDS"])
    out = run_cases(k, tmp, k)
    out["ckpt_refused"] = ckpt_refused(k, tmp) if k == 2 else None
    out["meshes"] = meshes()
    out["staged"] = dict(job.staged)
    return out


def launch_argv():
    return ["--arch", "qwen1.5-0.5b", "--steps", "2", "--hybrid",
            "--device", "cpu"]


@contextlib.contextmanager
def launch_patched(k):
    """The launcher at the smoke config and shape 4 x 32, its production
    mesh a (2, 2) of ``k`` CPU shards a process."""
    real, shape = base.get_config, base.SHAPES["train_4k"]
    mk = mesh_mod.make_production_mesh
    base.get_config = lambda name: base.smoke_config(real(name))
    base.SHAPES["train_4k"] = base.ShapeCfg("train_4k", S, B, "train")
    mesh_mod.make_production_mesh = lambda *, multi_pod=False: \
        mesh_mod.make_test_mesh((2, 2), devices=["cpu"] * k)
    try:
        yield
    finally:
        base.get_config, base.SHAPES["train_4k"] = real, shape
        mesh_mod.make_production_mesh = mk


def run_launch(k):
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with launch_patched(k), contextlib.redirect_stdout(buf):
        hist = launch_train.main(launch_argv())
    return {"losses": [h["loss"] for h in hist],
            "printed": [ln for ln in buf.getvalue().splitlines()
                        if ln.startswith("final loss")]}


PROGRAMS = {"lm": prog_lm}


# ---------------------------------------------------------------------------
# The jobs and the one-process runs, each once
# ---------------------------------------------------------------------------

def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's state, batch and draws for ``ref``, and its jitted
    step's result."""
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.core import swd as jswd
    from repro.data.tokens import random_batch as jrandom_batch
    from repro.runtime import trainer as jtr
    from repro_torch.weights import tensor_from_numpy
    jc = jbase.smoke_config(jbase.get_config(REF[0]))
    jt = jtr.TrainCfg(lr=LR, warmup=1, total_steps=10, hybrid=True,
                      hybrid_pool=POOL)
    jstate = _np(jtr.init_train_state(jc, jt, jax.random.PRNGKey(4))[0])
    batch = _np(jrandom_batch(jax.random.PRNGKey(10), jc.vocab, B, S))
    key = jax.random.PRNGKey(20)
    jp, _, jm = jax.jit(jtr.make_train_step(jc, jt))(
        jstate["params"], jstate["opt"], batch, jnp.int32(0), key)
    kd, kp = jax.random.split(key)
    draws = (tensor_from_numpy(np.asarray(jswd.random_directions(
        kd, 50, jc.d_model))), tensor_from_numpy(np.asarray(
            jswd.sphere_prior_samples(kp, B * (S // POOL), jc.d_model))))
    tmp = tmp_path_factory.mktemp("lm_ref")
    torch.save({"state": jstate, "batch": {
        k: tensor_from_numpy(np.array(v)) for k, v in batch.items()},
        "draws": draws}, os.path.join(tmp, "ref_inputs.pt"))
    return tmp, _np(jp), {k: float(v) for k, v in jm.items()}


@pytest.fixture(scope="module")
def jobs(reference):
    tmp = reference[0]
    out = {}
    for k in (2, 1):
        out[k] = run_job("lm", WORLD, tmp, timeout=JOB_TIMEOUT_S,
                         env={"REPRO_LOCAL_SHARDS": str(k)},
                         script=os.path.abspath(__file__))[1]
    return out


@pytest.fixture(scope="module")
def one_process(reference):
    """Every case in this process, holding all ``WORLD * k`` shards."""
    return {k: run_cases(k, reference[0], WORLD * k) for k in (2, 1)}


CASES = [(k, name) for k in (2, 1) for name in JOBS[k]]


def _blocks_equal(got, want, rank, what):
    assert set(got) == set(want), what
    for path, blocks in got.items():
        assert blocks, (what, path)
        for i, b in blocks.items():
            assert same(b, want[path][i]), (what, rank, path, i)


@pytest.mark.parametrize("k,name", CASES)
def test_lm_across_processes_is_one_process_bitwise(jobs, one_process, k,
                                                     name):
    """Each rank's losses, metrics, logits, blocks and collective counts ==
    one process holding every shard, bit for bit; each rank holds only
    its own shards' blocks."""
    w = one_process[k][name]
    for rank, res in jobs[k].items():
        got = res[name]
        mine = set(range(rank * k, (rank + 1) * k))
        for path, blocks in got["state"].items():
            assert set(blocks) == mine, (name, rank, path)
        _blocks_equal(got["state"], {p: {i: b for i, b in bl.items()}
                                     for p, bl in w["state"].items()},
                      rank, name)
        if name in TRAIN:
            assert got["hist"] == w["hist"], (name, rank)
            assert got["local"] == sorted(mine)
        elif name in DECODE:
            assert len(got["logits"]) == DECODE_STEPS + 1
            for a, b in zip(got["logits"], w["logits"]):
                assert same(a, b), (name, rank)
        else:
            for m in w["metrics"]:
                assert same(got["metrics"][m], w["metrics"][m]), (m, rank)
        if "collectives" in w:
            assert got["collectives"] == w["collectives"], (name, rank)


@pytest.mark.parametrize("k,name", [c for c in CASES if c[1] != "ref"])
def test_exchanges_are_the_crossing_collectives(jobs, one_process, k, name):
    """Each rank exchanges once for each collective whose groups cross the
    ranks' shards (forward, and backward where its inputs carry
    autograd), and nowhere else; ``Job.staged`` counts those exchanges.
    On (2, 2) with two shards a process no 'model' collective crosses."""
    want = one_process[k][name]["crossed"]
    for rank, res in jobs[k].items():
        got = res[name]["crossed"]
        assert got["staged"] == got["forward"] + got["backward"]
        assert (got["forward"], got["backward"]) == (
            want["forward"], want["backward"]), (name, rank, got, want)


def test_decode_ranks_return_the_same_global_logits(jobs):
    """Every rank returns the whole (B, vocab) logits, the same bits; at
    batch 1 the cache's positions split over 'data', which crosses."""
    for name in DECODE:
        a, b = (jobs[2][r][name]["logits"] for r in range(WORLD))
        assert all(same(x, y) for x, y in zip(a, b))
        assert a[0].shape == (DECODE[name][2], smoke(DECODE[name][0]).vocab)
    assert jobs[2][0]["decode-batch1-2x2"]["kv_seq"] == "data"


def test_one_case_matches_the_reference_step(jobs, reference):
    """The step from the reference's state on two processes x two shards
    against the reference's unsharded jitted step (metrics rtol 1e-4,
    every updated leaf 1e-4 of its max; the k bias 3 % of the learning
    rate, as ``test_torch_sharded_lm.py``)."""
    from repro_torch.checkpoint.serial import _paths
    _, jp, jm = reference
    for rank, res in jobs[2].items():
        got = res["ref"]
        for m, v in jm.items():
            np.testing.assert_allclose(float(got["metrics"][m]), v,
                                       rtol=1e-4, atol=1e-7, err_msg=m)
        whole = {k: v.numpy() for k, v in _paths(got["whole"])}
        for k, b in _paths(jp):
            a = whole[k]
            if k.endswith(K_BIAS):
                assert np.abs(a - b).max() <= K_BIAS_LR_FRAC * LR
            else:
                scale = np.abs(b).max() or 1.0
                assert np.abs(a - b).max() / scale <= LEAF_RTOL, k


def test_production_and_test_meshes_span_a_joined_job(jobs):
    """In a joined job ``make_production_mesh`` spans it: 16 x 16 over
    every process's devices in rank order (rank r owns rows 8r .. 8r + 7),
    ``process_ids`` naming the owners; a shape that is not the job's
    total raises."""
    for k in jobs:
        for rank, res in jobs[k].items():
            m = res["meshes"]
            assert m["shape"] == {"data": 16, "model": 16}
            assert m["ids"] == [[r // 8] * 16 for r in range(16)]
            assert m["local"] == list(range(128 * rank, 128 * (rank + 1)))
            assert m["refused"]


def test_trainer_refuses_checkpoints_on_a_spanning_mesh(jobs):
    assert all(r["ckpt_refused"] for r in jobs[2].values())


def test_jobs_exchange_only_what_crosses_on_the_cpu(jobs):
    """On the CPU nothing stages to or from a device."""
    for k in jobs:
        for res in jobs[k].values():
            st = res["staged"]
            assert st["d2h_bytes"] == st["h2d_bytes"] == 0
            assert st["calls"] > 0


def test_launcher_joins_and_trains_across_processes(tmp_path):
    """``launch.train.main`` in two processes under the environment
    contract joins the job itself, trains on the production mesh (patched
    to (2, 2)) that spans it, and prints the same final loss on both
    ranks, bitwise one process's."""
    _, res = run_job("launch", WORLD, tmp_path, timeout=JOB_TIMEOUT_S,
                     script=os.path.abspath(__file__))
    want = run_launch(4)
    for rank, r in res.items():
        assert (r["rank"], r["world"]) == (rank, WORLD)
        assert r["losses"] == want["losses"]
        assert r["printed"] == want["printed"] and len(r["printed"]) == 1


if __name__ == "__main__":
    torch.set_num_threads(1)
    program, tmp = sys.argv[1], sys.argv[2]
    if program == "launch":
        out = run_launch(2)             # the launcher joins the job itself
        job = jobmod.current_job()
        out.update(rank=job.rank, world=job.world)
    else:
        assert mesh_mod.maybe_init_distributed()
        job = jobmod.current_job()
        out = PROGRAMS[program](job, tmp)
    torch.save(out, os.path.join(tmp, f"{program}.{job.rank}.pt"))
