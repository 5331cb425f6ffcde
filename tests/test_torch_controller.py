"""The port's deployed Control Plane (``repro_torch.core.controller``)
against the reference's: every kind's ``run_episode`` summary and its
``transitions`` equal to the last bit, over network profiles, platforms
and ``quantize``.  The ``rl`` kind takes the reference's params through
``ppo_from_jax``; its greedy decisions are compared behind the margin
guard of ``tests/test_torch_ppo.py`` (every decision's top two logits
more than 1e-5 apart), since a last-bit difference may flip a nearer
tie and a flip changes the rest of the episode."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import controller as jctrl  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core import ppo as jppo  # noqa: E402
from repro_torch.core import controller as ctrl  # noqa: E402
from repro_torch.core import env as tenv  # noqa: E402
from repro_torch.core import ppo  # noqa: E402
from repro_torch.weights import ppo_from_jax  # noqa: E402

L = 8
MARGIN = 1e-5
KINDS = ("rl", "rule", "static", "edge", "server")


def rl_params(seed):
    """The reference's ``init_policy`` with its policy head scaled up, so
    the logits spread and the greedy action moves with the state."""
    jp = jax.tree.map(np.asarray, jppo.init_policy(
        jax.random.PRNGKey(seed), 3, L + 1))
    jp["wp"] = jp["wp"] * 100.0
    jp["bp"] = np.linspace(-0.1, 0.1, L + 1).astype(np.float32)
    return jp


@pytest.fixture
def margins(monkeypatch):
    """Record the top-two logit gap of every greedy decision the port's
    controller takes."""
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


def _pair(kind, seed, **kw):
    jp = rl_params(seed) if kind == "rl" else None
    return (ctrl.Controller(kind, L, rl_params=None if jp is None
                            else ppo_from_jax(jp), **kw),
            jctrl.Controller(kind, L, rl_params=jp, **kw))


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("net,platform", [("stable", "pi4"),
                                          ("variable", "pi4"),
                                          ("congested", "m2"),
                                          ("dropout", "m2")])
@pytest.mark.parametrize("kind", KINDS)
def test_run_episode_matches_reference(kind, net, platform, quantize,
                                       margins):
    got_c, want_c = _pair(kind, 0)
    got = ctrl.run_episode(tenv.EdgeCloudEnv(tenv.EnvCfg(
        platform=platform, net=net, horizon=150)), got_c,
        quantize=quantize, seed=9)
    want = jctrl.run_episode(jenv.EdgeCloudEnv(jenv.EnvCfg(
        platform=platform, net=net, horizon=150)), want_c,
        quantize=quantize, seed=9)
    if kind == "rl":
        assert len(margins) == 150 and min(margins) > MARGIN
    assert got.keys() == want.keys()
    for k in want:
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k
    assert got_c.transitions == want_c.transitions
    assert got_c.current_k == want_c.current_k


def test_decisions_and_rule_ema_step_by_step(margins):
    """Every decision and the rule's bandwidth EMA (a float32 under
    NumPy's promotion, as the reference's) equal along an episode, with
    ``t_step`` and ``static_k`` passed through."""
    got_e = tenv.EdgeCloudEnv(tenv.EnvCfg(net="variable", horizon=120))
    want_e = jenv.EdgeCloudEnv(jenv.EnvCfg(net="variable", horizon=120))
    pairs = {k: _pair(k, 1, static_k=5, t_step=4) for k in KINDS}
    obs_g, obs_w = got_e.reset(seed=2), want_e.reset(seed=2)
    for _ in range(120):
        ks = {}
        for k, (g, w) in pairs.items():
            ks[k] = (g.decide(obs_g), w.decide(obs_w))
            assert ks[k][0] == ks[k][1] and type(ks[k][0]) is int, k
        g_r, w_r = pairs["rule"]
        assert type(g_r.rule.ema) is type(w_r.rule.ema)
        assert g_r.rule.ema == w_r.rule.ema
        obs_g, *_ = got_e.step(ks["rl"][0])
        obs_w, *_ = want_e.step(ks["rl"][1])
    assert min(margins) > MARGIN
    assert pairs["static"][0].current_k == 5
    assert all(g.t_step == 4 for g, _ in pairs.values())
    for k, (g, w) in pairs.items():
        assert g.transitions == w.transitions, k
    # on the variable link both adaptive policies move k
    assert pairs["rl"][0].transitions > 0 and pairs["rule"][0].transitions > 0


def test_rl_controller_keeps_a_host_float32_copy():
    jp = rl_params(2)
    params = ppo_from_jax(jp)
    c = ctrl.Controller("rl", L, rl_params=params)
    assert c.rl_params is params
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in c._host.values())
    assert all(v is not params[k] for k, v in c._host.items())


def test_unknown_kind_raises_as_reference():
    with pytest.raises(ValueError):
        jctrl.Controller("bogus", L).decide(np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        ctrl.Controller("bogus", L).decide(np.zeros(3, np.float32))
