"""The port's dry-run (``configs.base.cells``/``input_specs``,
``launch/roofline.py``, ``launch/dryrun.py``) against the reference's.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices
when it is imported, so this process never imports it: its
``build_and_compile`` runs in one ``subproc``.  Cells, input specs and the
parameter and flop counts are held exactly (they are arithmetic on shapes);
the port's traced cells on ``meta`` meshes of the reference test's shapes,
(4, 4) and (2, 2, 4), pass that test's asserts.  The traced flops of
qwen3-1.7b ``train_4k`` at 4 layers are held against the reference's HLO
flops (see ``test_traced_flops_against_reference_hlo`` for the bar).
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.runtime.roofline_report import fmt_table  # noqa: E402

LM_CONFIGS = [n for n in base.list_configs() if n != "streamsplit-audio"]
# the reference test's cells and cuts (tests/test_dryrun_cells.py)
SMALL = {"n_layers": 4}
SMALL_HY = {"n_layers": 7, "hybrid_period": 3}
CELLS = [("qwen3-1.7b", "train_4k", SMALL, False),
         ("gemma2-2b", "prefill_32k", SMALL, False),
         ("arctic-480b", "train_4k", {"n_layers": 2}, False),
         ("mamba2-780m", "long_500k", SMALL, False),
         ("zamba2-1.2b", "decode_32k", SMALL_HY, False),
         ("qwen3-1.7b", "train_4k", SMALL, True),
         ("kimi-k2-1t-a32b", "train_4k", {"n_layers": 2}, True)]


def _mesh(multi_pod):
    if multi_pod:
        return make_test_mesh((2, 2, 4), ("pod", "data", "model"),
                              devices=["meta"] * 16)
    return make_test_mesh((4, 4), devices=["meta"] * 16)


def test_cells_and_long_context_equal_reference():
    assert base.cells() == jbase.cells()
    assert base.LONG_CONTEXT_OK == jbase.LONG_CONTEXT_OK
    assert all(s != "long_500k" for _, s in base.cells(include_long=False))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_input_specs_equal_reference(dtype):
    for arch, shape in base.cells():
        got = base.input_specs(base.get_config(arch), base.SHAPES[shape],
                               dtype=dtype)
        want = jbase.input_specs(jbase.get_config(arch), jbase.SHAPES[shape],
                                 dtype=dtype)
        assert sorted(got) == sorted(want), (arch, shape)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, shape, k)
            assert str(v.dtype) == f"torch.{want[k].dtype}", (arch, shape, k)


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_param_and_flop_counts_equal_reference(name):
    """``count_params``, ``active_params``, ``model_flops`` (every shape
    kind) and the record's ``param_bytes_per_chip`` (bf16, the dry-run's
    type, on 256 chips) against the reference's functions over
    ``jax.eval_shape`` of its ``init_lm``."""
    jc = replace(jbase.get_config(name), dtype="bfloat16",
                 param_dtype="bfloat16")
    c = replace(base.get_config(name), dtype="bfloat16",
                param_dtype="bfloat16")
    want = jax.eval_shape(lambda k: jlm.init_lm(jc, k)[0],
                          jax.random.PRNGKey(0))
    got = dryrun.eval_params(c)[0]
    assert roofline.count_params(got) == jroofline.count_params(want)
    assert roofline.active_params(c, got) == jroofline.active_params(jc, want)
    for s in base.SHAPES:
        assert roofline.model_flops(c, got, base.SHAPES[s]) == \
            jroofline.model_flops(jc, want, jbase.SHAPES[s])
    n = 256
    assert int(sum(x.numel() * x.element_size()
                   for x in roofline.leaves(got)) / n) == int(
        sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(want)) / n)


@pytest.mark.parametrize("arch,shape,ovr,multi_pod", CELLS)
def test_cells_trace_on_meta_meshes(arch, shape, ovr, multi_pod):
    """The reference test's asserts on the port's record, on ``meta``
    meshes of its shapes; a train step's traced global flops cover the
    model's 6ND (remat's recompute comes on top), N without an untied
    embedding table, which a step gathers from and never multiplies (the
    kimi-k2 cut's 1.17B of its 3B).  A prefill's need not: its 2ND counts
    the table too, and the logits of one position only."""
    rec = dryrun.build_and_compile(arch, shape, _mesh(multi_pod),
                                   overrides=ovr)
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["bottleneck"] in ("compute", "memory",
                                                      "collective")
    assert rec["collectives"]["collective_bytes"] >= 0
    assert rec["memory"]["peak_memory_in_bytes"] > 0
    assert rec["mesh"] == ("2x2x4" if multi_pod else "4x4")
    assert rec["cost"]["global_flops"] == pytest.approx(
        rec["cost"]["flops"] * 16)
    if base.SHAPES[shape].kind == "train":
        cfg = base.get_config(arch)
        table = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
        tokens = base.SHAPES[shape].global_batch * base.SHAPES[shape].seq_len
        assert rec["cost"]["global_flops"] >= \
            r["model_flops"] - 6.0 * table * tokens
    assert set(rec) >= {"n_params", "n_params_active", "param_bytes_per_chip",
                        "trace_s", "memory", "cost", "collectives",
                        "roofline", "policy", "axes"}
    assert fmt_table([rec], "multi" if multi_pod else "single").count(
        "\n") == 2


def test_traced_flops_against_reference_hlo(subproc):
    """qwen3-1.7b ``train_4k`` at 4 layers on (4, 4): the port's per-shard
    traced flops against the reference's per-device HLO flops.  Both count
    the matrix products of the step with remat's recompute; the reference
    counts XLA's ``dot``s after its partitioner (which may fuse the
    online softmax's products or add the collectives' reshapes), the port
    torch's matmul, einsum and attention ops: 1.0068 of the reference's
    at this cell on this machine.  Bar: within 10 %."""
    out = subproc("""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=16'
from repro.compat import make_mesh
from repro.launch.dryrun import build_and_compile
mesh = make_mesh((4, 4), ('data', 'model'))
rec = build_and_compile('qwen3-1.7b', 'train_4k', mesh,
                        overrides={'n_layers': 4})
print('FLOPS', rec['cost']['flops'])
""", devices=16)
    want = float(out.split("FLOPS")[1].split()[0])
    rec = dryrun.build_and_compile("qwen3-1.7b", "train_4k", _mesh(False),
                                   overrides={"n_layers": 4})
    ratio = rec["cost"]["flops"] / want
    print(f"port / reference per-shard flops: {ratio:.4f} "
          f"({rec['cost']['flops']:.4e} / {want:.4e})")
    assert 0.9 <= ratio <= 1.1, ratio


def _same_layout(state, axes):
    """Whether an optimizer state's tree has the axes tree's structure, each
    tensor with one logical name a dim."""
    if isinstance(state, torch.Tensor):
        return shd.is_axes_leaf(axes) and len(axes) == state.dim()
    if isinstance(state, dict):
        return isinstance(axes, dict) and sorted(state) == sorted(axes) \
            and all(_same_layout(state[k], axes[k]) for k in state)
    return len(state) == len(axes) and all(
        _same_layout(a, b) for a, b in zip(state, axes))


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
def test_opt_axes_follow_the_optimizer_state(opt):
    """``_opt_axes`` (the reference's layout of an optimizer state's
    logical axes) names every dim of the port's optimizer state."""
    from repro_torch.optim import get_optimizer
    from repro_torch.models import lm
    c = base.smoke_config(base.get_config("kimi-k2-1t-a32b"))
    params, axes = lm.init_lm(c, None, with_axes=True)
    state = get_optimizer(opt)[0](params)
    assert _same_layout(state, dryrun._opt_axes(opt, axes))


def test_collective_counter():
    """One ``psum`` over 4 shards of a (3, 5) float32 value and one tiled
    ``all_gather`` over 2 of a (2, 8) bf16 block: a shard's result is 60
    and 64 bytes, one call each; nothing is counted outside the context,
    nor a collective over one shard."""
    mesh = make_test_mesh((2, 4), devices=["cpu"] * 8)
    xs = [torch.ones(3, 5) for _ in range(8)]
    ys = [torch.ones(2, 8, dtype=torch.bfloat16) for _ in range(8)]
    shd.psum_over(xs, mesh, ("model",))
    with shd.count_collectives() as c:
        shd.psum_over(xs, mesh, ("model",))
        shd.all_gather_over(ys, mesh, ("data",), 0, tiled=True)
        shd.psum(xs[:1])
    assert c == {"collective_bytes": 124,
                 "per_kind_bytes": {"all-reduce": 60, "all-gather": 64},
                 "per_kind_counts": {"all-reduce": 1, "all-gather": 1}}
    with shd.count_collectives() as c2:
        blocks = [torch.ones(2, 4, requires_grad=True) for _ in range(8)]
        full = shd.fsdp_gather_over(blocks, mesh, ("data",), 0)
        sum(f.sum() for f in full).backward()
    assert c2["per_kind_counts"] == {"all-gather": 1, "reduce-scatter": 1}
    assert c2["per_kind_bytes"] == {"all-gather": 64, "reduce-scatter": 32}


def test_production_meshes_of_meta_devices():
    """``make_production_mesh`` on 256 (512) ``meta`` devices, by name;
    a CUDA device that is not there still raises."""
    from repro_torch.launch.mesh import make_production_mesh
    m = make_production_mesh(devices=["meta"] * 256)
    assert m.shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_production_mesh(devices=["cuda"] * 256)


def test_dryrun_cli_writes_records(tmp_path, capsys, monkeypatch):
    """``main`` with the reference's flags writes one JSON record a cell
    (here the 500k-context decode cut to one layer, the quickest) and
    prints its line."""
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: replace(real(name), n_layers=1))
    rc = dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                      "--out", str(tmp_path)])
    assert rc == 0
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert rec["mesh"] == "16x16" and rec["memory"]["fits"]
    assert "bottleneck=" in capsys.readouterr().out
    assert np.isfinite(rec["roofline"]["step_s"])
