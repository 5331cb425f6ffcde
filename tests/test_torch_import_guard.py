"""The PyTorch port stands on its own: no file of ``src/repro_torch/`` and
not ``chip_smoke.py`` imports JAX, the reference package ``repro`` or the
reference's ``benchmarks``.
A static AST scan, so a guarded or lazy import is caught too."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_has_files():
    files = _port_files()
    assert "chip_smoke.py" in files
    assert len(files) > 10


def test_forbidden_prefix_check():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("repro") and _forbidden("repro.core.sync")
    assert _forbidden("benchmarks.quality_tables")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.api")
    assert not _forbidden("torch") and not _forbidden("numpy")


def test_guard_covers_the_federation():
    files = _port_files()
    for rel in ("cluster/__init__.py", "cluster/cluster.py",
                "cluster/hashing.py", "cluster/health.py",
                "cluster/replication.py", "runtime/cluster_serve.py",
                "runtime/cluster_demo.py", "runtime/streaming_demo.py"):
        assert os.path.join("src", "repro_torch", rel) in files


def test_guard_covers_the_last_counterparts():
    files = _port_files()
    for rel in ("runtime/quality_tables.py", "runtime/quickstart.py",
                "runtime/adaptive_serving.py", "runtime/fleet_demo.py"):
        assert os.path.join("src", "repro_torch", rel) in files


def test_guard_covers_the_sharded_slice():
    files = _port_files()
    for rel in ("distributed/__init__.py", "distributed/sharding.py",
                "distributed/grad_sync.py", "launch/mesh.py",
                "optim/compression.py", "core/fleet.py",
                "runtime/multipod_demo.py"):
        assert os.path.join("src", "repro_torch", rel) in files


def test_guard_covers_the_lm_sharding_slice():
    files = _port_files()
    for rel in ("checkpoint/elastic.py", "distributed/sharding.py",
                "launch/mesh.py", "launch/train.py", "models/moe.py",
                "models/lm.py", "models/attention.py", "models/mlp.py",
                "models/common.py", "runtime/trainer.py",
                "optim/adafactor.py", "weights.py"):
        assert os.path.join("src", "repro_torch", rel) in files


def test_guard_covers_the_lm_mesh_slice():
    """The modules that run the SSM and hybrid families, FSDP and sharded
    prefill and decode on a mesh."""
    files = _port_files()
    for rel in ("models/ssm.py", "models/attention.py", "models/lm.py",
                "models/moe.py", "distributed/sharding.py",
                "runtime/trainer.py", "checkpoint/elastic.py",
                "weights.py"):
        assert os.path.join("src", "repro_torch", rel) in files


def test_guard_covers_the_dryrun_slice():
    """The dry-run's modules and the bf16 path's: every module of the
    reference with a counterpart has one now."""
    files = _port_files()
    for rel in ("launch/dryrun.py", "launch/roofline.py",
                "runtime/roofline_report.py", "configs/base.py",
                "kernels/flash_attention.py", "launch/mesh.py",
                "distributed/sharding.py", "models/attention.py",
                "weights.py"):
        assert os.path.join("src", "repro_torch", rel) in files


def test_guard_covers_the_multiprocess_slice():
    """The modules of the sharded fleet plane across processes."""
    files = _port_files()
    for rel in ("distributed/job.py", "distributed/sharding.py",
                "distributed/grad_sync.py", "launch/mesh.py",
                "core/fleet_backend.py"):
        assert os.path.join("src", "repro_torch", rel) in files


@pytest.mark.parametrize("rel", _port_files())
def test_no_jax_or_reference_import(rel):
    with open(os.path.join(REPO, rel)) as fh:
        tree = ast.parse(fh.read(), filename=rel)
    bad = [(line, mod) for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, f"{rel} imports {bad}"
