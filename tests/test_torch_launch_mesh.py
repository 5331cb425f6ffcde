"""``launch/mesh.py``'s production mesh and multi-process on-ramp
(mirroring ``tests/test_launch_mesh.py``), and ``launch/train.py``'s
sharded branch, driven with the production mesh and the config made
small by monkeypatching (no new flag)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh, maybe_init_distributed)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_production_mesh_shapes():
    m = make_production_mesh(devices=["cpu"] * 256)
    assert m.shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_production_mesh()


@pytest.fixture
def fresh_latch():
    saved = dict(mesh_mod._distributed)
    mesh_mod._distributed["initialized"] = False
    yield mesh_mod._distributed
    mesh_mod._distributed.clear()
    mesh_mod._distributed.update(saved)


def test_maybe_init_distributed_noop_without_coordinator(fresh_latch):
    calls = []
    assert maybe_init_distributed(env={}, initialize=calls.append) is False
    assert calls == [] and not fresh_latch["initialized"]


def test_maybe_init_distributed_reads_env_contract(fresh_latch):
    calls = []
    env = {"REPRO_COORDINATOR": "10.0.0.1:1234",
           "REPRO_NUM_PROCESSES": "4", "REPRO_PROCESS_ID": "2"}
    assert maybe_init_distributed(
        env=env, initialize=lambda **kw: calls.append(kw)) is True
    assert calls == [{"coordinator_address": "10.0.0.1:1234",
                      "num_processes": 4, "process_id": 2}]
    assert maybe_init_distributed(
        env=env, initialize=lambda **kw: calls.append(kw)) is True
    assert len(calls) == 1


def test_maybe_init_distributed_defaults_and_validation(fresh_latch):
    calls = []

    def fake_init(**kw):
        calls.append(kw)
    assert maybe_init_distributed(env={"REPRO_COORDINATOR": "head:9999"},
                                  initialize=fake_init) is True
    assert calls == [{"coordinator_address": "head:9999",
                      "num_processes": 1, "process_id": 0}]
    fresh_latch["initialized"] = False
    with pytest.raises(ValueError, match="REPRO_PROCESS_ID"):
        maybe_init_distributed(
            env={"REPRO_COORDINATOR": "head:9999",
                 "REPRO_NUM_PROCESSES": "2", "REPRO_PROCESS_ID": "2"},
            initialize=fake_init)
    assert len(calls) == 1 and not fresh_latch["initialized"]


def test_default_initializer_joins_a_process_group_on_localhost():
    """The default ``initialize``: ``torch.distributed`` at an explicit
    ``tcp://`` address, world size and rank (one process, gloo, on
    localhost), in a child process."""
    code = """
import socket, torch.distributed as dist
from repro_torch.launch.mesh import maybe_init_distributed
s = socket.socket(); s.bind(('127.0.0.1', 0)); port = s.getsockname()[1]
s.close()
env = {'REPRO_COORDINATOR': f'127.0.0.1:{port}', 'REPRO_NUM_PROCESSES': '1',
       'REPRO_PROCESS_ID': '0'}
assert maybe_init_distributed(env=env)
assert dist.is_initialized() and dist.get_world_size() == 1
assert dist.get_rank() == 0 and dist.get_backend() == 'gloo'
dist.destroy_process_group()
print('joined')
"""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "joined" in r.stdout, r.stderr[-2000:]


def test_launcher_trains_sharded_on_several_devices(monkeypatch, capsys):
    """Without --smoke on more than one device the launcher builds the
    production mesh, installs ``rules_for`` and trains ``Trainer`` on it
    (here: the mesh a (2, 2) of CPU shards, the config the smoke one, the
    shape 4 x 32)."""
    from repro_torch.configs import base
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import trainer as tr
    real = base.get_config
    monkeypatch.setattr(base, "get_config",
                        lambda name: base.smoke_config(real(name)))
    monkeypatch.setitem(base.SHAPES, "train_4k",
                        base.ShapeCfg("train_4k", 32, 4, "train"))
    monkeypatch.setattr(launch_train, "device_count", lambda device: 4)
    asked = []

    def small_mesh(*, multi_pod=False):
        asked.append(multi_pod)
        return make_test_mesh((2, 2), devices=["cpu"] * 4)
    monkeypatch.setattr(mesh_mod, "make_production_mesh", small_mesh)
    seen = []
    init = tr.Trainer.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        seen.append((self.layout, shd.current_rules()))
    monkeypatch.setattr(tr.Trainer, "__init__", spy)
    hist = launch_train.main(["--arch", "qwen1.5-0.5b", "--steps", "2",
                              "--hybrid", "--device", "cpu"])
    assert asked == [False]
    (layout, rules), = seen
    assert layout is not None and layout.n == 4
    assert rules.act_rules["batch"] == "data"
    assert len(hist) == 2 and np.all(np.isfinite([h["loss"] for h in hist]))
    assert "final loss" in capsys.readouterr().out
    assert shd.current_rules() is None
    # --smoke keeps one device whatever the count
    seen.clear()
    launch_train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert seen[0][0] is None and asked == [False]
