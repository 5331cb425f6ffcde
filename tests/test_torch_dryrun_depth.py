"""The port's dry-run at full depth: each distinct layer kind traced in a few
shallow cuts and counted by its number (``launch/dryrun.py``'s
``layer_counts``, ``cuts``, ``compose``), as the reference's HLO reader
counts a scan body once, times its trip count.

(a) The composed record equals ``trace_cut`` of the same config in every
field, exactly, on ``meta`` meshes of the reference test's shapes, (4, 4)
and (2, 2, 4): each target is the reference test's cut
(tests/test_dryrun_cells.py), or one layer past it where that cut is itself
a cut.  The MoE cells are in ``test_torch_dryrun_depth_moe.py``.
(b) ``layer_counts`` and ``cuts`` of every LM config.
(c) qwen3-1.7b ``train_4k`` at its full 28 layers, composed, against the
reference's HLO flops at 28 layers (its scan compiles one layer body).
"""
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

LM_CONFIGS = [n for n in base.list_configs() if n != "streamsplit-audio"]
COMPOSED = [("qwen3-1.7b", "train_4k", {"n_layers": 4}, False),
            ("qwen3-1.7b", "train_4k", {"n_layers": 4}, True),
            ("gemma2-2b", "prefill_32k", {"n_layers": 5}, False),
            ("mamba2-780m", "long_500k", {"n_layers": 4}, False),
            ("zamba2-1.2b", "decode_32k",
             {"n_layers": 7, "hybrid_period": 3}, False),
            ("llava-next-34b", "prefill_32k", {"n_layers": 4}, False)]
# every LM config's full layer counts
FULL_COUNTS = {
    "arctic-480b": {"moe": 35},
    "gemma2-2b": {"sliding": 13, "global": 13},
    "kimi-k2-1t-a32b": {"dense": 1, "moe": 60},
    "llava-next-34b": {"layers": 60},
    "mamba2-780m": {"mamba": 48},
    "musicgen-large": {"layers": 48},
    "nemotron-4-15b": {"layers": 32},
    "qwen1.5-0.5b": {"layers": 24},
    "qwen3-1.7b": {"layers": 28},
    # 6 groups of 6 mamba layers, each followed by the shared block, and a
    # tail of 2
    "zamba2-1.2b": {"mamba": 36, "tail": 2, "shared": 6},
}
KINDS = ("train", "prefill", "decode")
_TRACES = {}   # (config, shape, mesh shape) -> trace_cut's counts


def mesh_of(multi_pod):
    if multi_pod:
        return make_test_mesh((2, 2, 4), ("pod", "data", "model"),
                              devices=["meta"] * 16)
    return make_test_mesh((4, 4), devices=["meta"] * 16)


def trace(cfg, shape, pol, mesh, real=dryrun.trace_cut):
    """``trace_cut``, each (config, shape, mesh) traced once a module."""
    key = (cfg, shape.name, tuple(mesh.devices.shape))
    if key not in _TRACES:
        _TRACES[key] = real(cfg, shape, pol, mesh)
    return _TRACES[key]


def without_time(d):
    return {k: v for k, v in d.items() if k != "trace_s"}


def check_composed(monkeypatch, arch, shape_name, ovr, multi_pod):
    """(a): ``build_and_compile`` traces ``cuts`` (and only them) and its
    record equals the record of the full trace, field for field; the
    composed counts equal the full trace's."""
    monkeypatch.setattr(dryrun, "trace_cut", trace)
    mesh, shape = mesh_of(multi_pod), base.SHAPES[shape_name]
    cfg = dryrun.cell_config(arch, overrides=ovr)
    cuts = dryrun.cuts(cfg, shape.kind)
    assert dryrun.plan(cfg, shape.kind) == cuts
    rec = dryrun.build_and_compile(arch, shape_name, mesh, overrides=ovr)
    assert rec["cuts"] == cuts
    traced = [(o, _TRACES[(replace(cfg, **o), shape_name,
                           tuple(mesh.devices.shape))]) for o in cuts]
    full = dryrun.trace_cut(cfg, shape, dryrun.policy_for(arch), mesh)
    composed = dryrun.compose(cfg, traced)
    assert without_time(composed) == without_time(full)
    want = dryrun.record(arch, shape_name, mesh, cfg, full, cuts)
    assert without_time(rec) == without_time(want)
    assert rec["trace_s"] == round(sum(c["trace_s"] for _, c in traced), 2)
    print(f"{arch} {shape_name} {dryrun.layer_counts(cfg)} from {cuts}: "
          f"global flops {full['flops']}, peak {full['peak']}, "
          f"collectives {full['per_kind_counts']}")


@pytest.mark.parametrize("arch,shape,ovr,multi_pod", COMPOSED)
def test_composed_record_equals_the_trace(monkeypatch, arch, shape, ovr,
                                          multi_pod):
    check_composed(monkeypatch, arch, shape, ovr, multi_pod)


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_layer_counts_and_cuts(name):
    """(b): the full config's counts; for each step kind the cuts are
    affinely independent over the kinds they vary, as many as those kinds
    and a constant, shallower than the config, and any kind they hold
    fixed has the config's own count (kimi-k2's leading dense layer)."""
    cfg = base.get_config(name)
    counts = dryrun.layer_counts(cfg)
    assert counts == FULL_COUNTS[name]
    assert sum(counts.values()) == cfg.n_layers + counts.get("shared", 0)
    for kind in KINDS:
        cuts = dryrun.cuts(cfg, kind)
        kinds = dryrun._varying(cfg, cuts)
        rows = [dryrun._row(cfg, kinds, o) for o in cuts]
        assert len(cuts) == len(kinds) + 1
        assert dryrun._eliminate(rows, len(kinds) + 1) == len(cuts)
        for o in cuts:
            c = dryrun.layer_counts(replace(cfg, **o))
            assert set(c) == set(counts)
            assert all(c[k] == counts[k] for k in counts if k not in kinds)
            assert o["n_layers"] >= dryrun._least(cfg, kind)
        assert dryrun.plan(cfg, kind) == cuts
        assert max(dryrun._depth(cfg, o) for o in cuts) < \
            dryrun._depth(cfg)


def test_named_cuts():
    """The cuts of the configs the dry-run's tests trace: qwen3 1 and 2
    layers for a train step, 2 and 3 for a prefill or decode step; gemma2
    (sliding, global) (1, 0), (1, 1), (2, 1) for a train step; zamba2
    (mamba, tail, shared) (1, 0, 1), (2, 0, 1), (2, 0, 2), (2, 1, 1);
    kimi-k2 2 and 3 layers (its dense layer in every cut); a config no
    deeper than its cuts traced as it is."""
    get = base.get_config
    assert dryrun.cuts(get("qwen3-1.7b")) == [{"n_layers": 1},
                                              {"n_layers": 2}]
    assert dryrun.cuts(get("qwen3-1.7b"), "decode") == [{"n_layers": 2},
                                                        {"n_layers": 3}]
    assert [dryrun.layer_counts(replace(get("gemma2-2b"), **o))
            for o in dryrun.cuts(get("gemma2-2b"))] == [
        {"sliding": 1, "global": 0}, {"sliding": 1, "global": 1},
        {"sliding": 2, "global": 1}]
    z = get("zamba2-1.2b")
    assert [tuple(dryrun.layer_counts(replace(z, **o)).values())
            for o in dryrun.cuts(z, "decode")] == [
        (1, 0, 1), (2, 0, 1), (2, 0, 2), (2, 1, 1)]
    assert dryrun.cuts(get("kimi-k2-1t-a32b")) == [{"n_layers": 2},
                                                   {"n_layers": 3}]
    one = replace(get("qwen3-1.7b"), n_layers=1)
    assert dryrun.plan(one) == [{"n_layers": 1}]
    two = replace(get("zamba2-1.2b"), n_layers=2, hybrid_period=1)
    assert dryrun.plan(two, "decode") == [{"n_layers": 2,
                                           "hybrid_period": 1}]


def counter_mode_flops(cfg, shape, pol, mesh):
    """The global flops of ``cfg``'s step on ``mesh`` counted by
    ``FlopCounterMode`` itself, as the dry-run counted them before it
    applied the mode's formulas in its own."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as shd
    rules = shd.rules_for(mesh, cfg, batch=shape.global_batch,
                          kind=shape.kind, fsdp=pol["fsdp"])
    with shd.axis_rules(rules):
        args, fn = dryrun._step(cfg, shape, pol, shd.ShardLayout(rules),
                                cfg.dtype)
        with dryrun._ShapeCache(), FlopCounterMode(display=False) as fc:
            fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,shape,layers", [
    ("qwen3-1.7b", "train_4k", 1), ("gemma2-2b", "prefill_32k", 2),
    ("kimi-k2-1t-a32b", "decode_32k", 2), ("zamba2-1.2b", "long_500k", 2)])
def test_flops_equal_flop_counter_mode(arch, shape, layers):
    """``trace_cut``'s flops (``flop_registry``'s formulas in its byte
    counter's mode) equal ``FlopCounterMode``'s count of the same step."""
    cfg = dryrun.cell_config(arch, overrides={"n_layers": layers})
    shape, pol, mesh = base.SHAPES[shape], dryrun.policy_for(arch), \
        mesh_of(False)
    assert dryrun.trace_cut(cfg, shape, pol, mesh)["flops"] == \
        counter_mode_flops(cfg, shape, pol, mesh)


def _fake(flops, peak=1, kinds=None):
    return {"flops": flops, "bytes": 1, "peak": peak, "argument_bytes": 1,
            "output_bytes": 1, "collective_bytes": 0,
            "per_kind_bytes": {k: 8 * v for k, v in (kinds or {}).items()},
            "per_kind_counts": dict(kinds or {}), "trace_s": 1.0}


def test_compose_is_exact_and_refuses():
    """Composition in integers: a 28-layer count from cuts of 1 and 2
    layers past float64's 2^53, a collective kind that only the second
    cut has (0 in the first); ``ValueError`` for a negative or fractional
    value and for cuts that leave the config's kinds fixed at other
    counts."""
    cfg = base.get_config("qwen3-1.7b")
    big = 3 ** 40
    one = ({"n_layers": 1}, _fake(big + 7, kinds={"all-gather": 2}))
    two = ({"n_layers": 2}, _fake(2 * big + 7, kinds={"all-gather": 3,
                                                     "all-reduce": 1}))
    out = dryrun.compose(cfg, [one, two])
    assert out["flops"] == 28 * big + 7 and out["peak"] == 1
    assert out["per_kind_counts"] == {"all-gather": 29, "all-reduce": 27}
    assert out["per_kind_bytes"] == {"all-gather": 232, "all-reduce": 216}
    assert out["trace_s"] == 2.0
    with pytest.raises(ValueError, match="composed flops is -"):
        dryrun.compose(cfg, [one, (two[0], _fake(1))])
    with pytest.raises(ValueError, match="composed flops is 3/2"):
        dryrun.compose(replace(cfg, n_layers=2), [
            ({"n_layers": 1}, _fake(1)), ({"n_layers": 3}, _fake(2))])
    with pytest.raises(ValueError, match="fix"):
        dryrun.compose(cfg, [one])


def test_full_depth_flops_against_reference_hlo(subproc, monkeypatch):
    """(c): qwen3-1.7b ``train_4k`` at its full 28 layers on (4, 4): the
    port's composed per-shard flops against the reference's per-device
    HLO flops at 28 layers, in one ``subproc`` (the reference scans its
    layers, so it compiles one body).  The bar of
    ``test_torch_dryrun.py::test_traced_flops_against_reference_hlo``:
    within 10 %."""
    out = subproc("""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=16'
from repro.compat import make_mesh
from repro.launch.dryrun import build_and_compile
mesh = make_mesh((4, 4), ('data', 'model'))
rec = build_and_compile('qwen3-1.7b', 'train_4k', mesh)
print('FLOPS', rec['cost']['flops'])
""", devices=16)
    want = float(out.split("FLOPS")[1].split()[0])
    monkeypatch.setattr(dryrun, "trace_cut", trace)
    rec = dryrun.build_and_compile("qwen3-1.7b", "train_4k", mesh_of(False))
    assert rec["cuts"] == [{"n_layers": 1}, {"n_layers": 2}]
    ratio = rec["cost"]["flops"] / want
    print(f"28 layers: port / reference per-shard flops: {ratio:.4f} "
          f"({rec['cost']['flops']:.4e} / {want:.4e})")
    assert 0.9 <= ratio <= 1.1, ratio
