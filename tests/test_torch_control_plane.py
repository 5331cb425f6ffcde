"""The port's control plane (``runtime/control_plane.py``) and the
paper's system tables (``runtime/system_tables.py``) against the
reference's ``benchmarks/common.py`` and ``benchmarks/system_tables.py``.

Both packages' ``get_policy`` are replaced by the same params (the
reference's ``init_policy`` with its policy head scaled up, one seed a
platform; the port's through ``ppo_from_jax``), so every summary and
every table row must be equal to the last bit.  The port's greedy
decisions are recorded and held behind the margin guard of
``tests/test_torch_ppo.py``.  The cache round trip writes and reads the
reference's ``.npz`` keys in a temporary directory.
"""
import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import system_tables as jtables  # noqa: E402
from repro.core import ppo as jppo  # noqa: E402
from repro_torch.core import controller as ctrl  # noqa: E402
from repro_torch.core import ppo  # noqa: E402
from repro_torch.runtime import control_plane as cp  # noqa: E402
from repro_torch.runtime import system_tables as tables  # noqa: E402
from repro_torch.weights import ppo_from_jax  # noqa: E402

L = 8
MARGIN = 1e-5


def _jparams(seed):
    jp = jax.tree.map(np.asarray, jppo.init_policy(
        jax.random.PRNGKey(seed), 3, L + 1))
    jp["wp"] = jp["wp"] * 100.0
    jp["bp"] = np.linspace(-0.1, 0.1, L + 1).astype(np.float32)
    return jp


JP = {"pi4": _jparams(10), "m2": _jparams(11)}


@pytest.fixture
def same_policies(monkeypatch):
    """Both ``get_policy``s return the same params; the port's greedy
    decisions' top-two logit gaps are recorded."""
    def jget(platform="pi4", **kw):
        return JP[platform]

    def tget(platform="pi4", **kw):
        return ppo_from_jax(JP[platform])

    monkeypatch.setattr(jcommon, "get_policy", jget)
    monkeypatch.setattr(jtables, "get_policy", jget)
    monkeypatch.setattr(cp, "get_policy", tget)
    seen = []

    def guarded(params, obs):
        with torch.no_grad():
            logits, _ = ppo.policy_apply(params, torch.from_numpy(
                np.asarray(obs, np.float32)))
        top2 = np.sort(logits.numpy())[-2:]
        seen.append(float(top2[1] - top2[0]))
        return ppo.greedy_action(params, obs)

    monkeypatch.setattr(ctrl, "greedy_action", guarded)
    return seen


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k


def test_methods_and_map_match_reference():
    assert cp.METHODS == jcommon.METHODS
    assert cp.METHOD_MAP == jcommon._METHOD_MAP


@pytest.mark.parametrize("method", jcommon.METHODS)
def test_method_summaries_match_reference(method, same_policies):
    for kw in ({}, {"net": "congested", "platform": "m2", "seed": 3,
                    "horizon": 200}):
        _equal(cp.method_summary(method, **kw),
               jcommon.method_summary(method, **kw))
    _equal(cp.method_summary_mixed(method, horizon=150),
           jcommon.method_summary_mixed(method, horizon=150))
    if method == "StreamSplit":
        assert len(same_policies) > 0 and min(same_policies) > MARGIN


@pytest.mark.parametrize("kind", ["rl", "rule", "static", "edge", "server"])
def test_episode_summary_matches_reference(kind, same_policies):
    kw = dict(platform="m2", net="dropout", horizon=180, seed=4,
              static_k=5, extra_kb=17.5, env_overrides={"q_min": 0.2})
    rl = JP["m2"] if kind == "rl" else None
    _equal(cp.episode_summary(kind, rl_params=None if rl is None
                              else ppo_from_jax(rl), **kw),
           jcommon.episode_summary(kind, rl_params=rl, **kw))


def test_system_tables_rows_match_reference(same_policies, capsys):
    """Every row of ``run_all()`` (name, value, derived) equal to the
    reference's, captured from ``benchmarks.common.ROWS``."""
    del jcommon.ROWS[:]
    jtables.run_all()
    want = list(jcommon.ROWS)
    del jcommon.ROWS[:]
    got = tables.run_all()
    assert len(got) == len(want) == 57     # 7 + 8 + 12 + 7 + 11 + 8 + 4
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2], (g, w)
        assert type(g[1]) is type(w[1]) and g[1] == w[1], (g, w)
    assert min(same_policies) > MARGIN
    assert all(np.isfinite(v) for _, v, _ in got)


def test_adaptation_time_matches_reference(same_policies):
    for kind in ("rule", "rl", "server"):
        for seed in (3, 8):
            rl = JP["pi4"] if kind == "rl" else None
            got = tables._adaptation_time(
                kind, None if rl is None else ppo_from_jax(rl), seed=seed)
            assert got == jtables._adaptation_time(kind, rl, seed=seed)
    assert min(same_policies) > MARGIN


def test_policy_cache_round_trip(tmp_path, monkeypatch):
    """A port-trained policy is cached with the reference's keys and
    loads in both packages; a file in the reference's layout loads in the
    port."""
    monkeypatch.setattr(cp, "ART", str(tmp_path / "port"))
    monkeypatch.setattr(jcommon, "ART", str(tmp_path / "ref"))
    assert cp.policy_path("pi4").endswith(os.path.join("port", "ppo_pi4.npz"))
    trained = cp.get_policy("pi4", iters=1, device="cpu")
    with np.load(cp.policy_path("pi4", 1)) as data:
        assert sorted(data.files) == sorted(JP["pi4"])
        assert all(data[k].dtype == np.float32 for k in data.files)
    again = cp.get_policy("pi4", iters=1, device="cpu")   # from the cache
    assert all(torch.equal(again[k], trained[k]) for k in trained)
    os.makedirs(jcommon.ART)
    os.replace(cp.policy_path("pi4", 1), jcommon.policy_path("pi4"))
    ref = jcommon.get_policy("pi4")
    for k in trained:
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      trained[k].numpy())
    # the reference's own file (its keys, its dtypes) in the port
    np.savez(jcommon.policy_path("m2"), **JP["m2"])
    os.makedirs(cp.ART, exist_ok=True)
    os.replace(jcommon.policy_path("m2"), cp.policy_path("m2"))
    got = cp.get_policy("m2")
    for k in JP["m2"]:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), JP["m2"][k])


def test_short_run_never_stands_in_for_the_full_policy(tmp_path,
                                                       monkeypatch):
    """A policy trained for fewer than the tables' 40 iterations is cached
    under a name of its own: a later call at the default trains anew
    instead of loading it, and each count then loads its own file."""
    monkeypatch.setattr(cp, "ART", str(tmp_path))
    calls = []

    def fake_train(factory, n_actions, cfg, **kw):
        calls.append(cfg.iters)
        g = torch.Generator().manual_seed(cfg.iters)
        return ppo.init_policy(g, 3, n_actions), []

    monkeypatch.setattr(cp, "train_ppo", fake_train)
    short = cp.get_policy("pi4", iters=1, device="cpu")
    assert calls == [1]
    assert os.path.exists(cp.policy_path("pi4", 1))
    assert not os.path.exists(cp.policy_path("pi4"))
    full = cp.get_policy("pi4", device="cpu")
    assert calls == [1, cp.ITERS] and cp.ITERS == 40
    assert not all(torch.equal(full[k], short[k]) for k in full)
    for iters, want in ((cp.ITERS, full), (1, short)):
        got = cp.get_policy("pi4", iters=iters, device="cpu")
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert calls == [1, cp.ITERS]
    assert cp.policy_path("pi4", 1) != cp.policy_path("pi4")


def test_default_cache_lives_under_build():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cp.policy_path("pi4") == os.path.join(
        root, "build", "repro_torch", "artifacts", "ppo_pi4.npz")


def test_get_policy_defaults_to_cuda_and_refuses_without_it(tmp_path,
                                                            monkeypatch):
    """With nothing cached, ``get_policy`` trains on the card by default
    and raises without one; it never trains on the CPU unasked."""
    import inspect
    assert inspect.signature(cp.get_policy).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(cp, "ART", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cp.get_policy("pi4", iters=1)
    assert not os.path.exists(cp.policy_path("pi4", 1))
