"""The port's PPO actor-critic (forward half) and ``RLPolicy`` against
the reference.

Same params (the reference's ``init_policy`` draws, converted with
``ppo_from_jax``), same observations: logits and values agree within
1e-6 (three small float32 products, summed in another order).  Actions
are compared where the top two logits differ by more than 1e-5, since a
last-bit difference may flip a nearer tie; ties break to the first
index in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import make_policy as jmake_policy  # noqa: E402
from repro.core import ppo as jppo  # noqa: E402
from repro_torch.api import RLPolicy, make_policy  # noqa: E402
from repro_torch.core import ppo  # noqa: E402
from repro_torch.weights import ppo_from_jax, ppo_to_jax  # noqa: E402

L = 8
TOL = 1e-6
MARGIN = 1e-5


def _obs(n, seed):
    """Control-plane observations [U_t, R_cpu, B_net] in [0, 1]."""
    return np.random.default_rng(seed).random((n, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=[0, 1])
def params(request):
    jp = jax.tree.map(np.asarray, jppo.init_policy(
        jax.random.PRNGKey(request.param), 3, L + 1))
    # the reference's policy head starts at 0.01 x; scale it up so the
    # logits spread and most rows have a clear argmax
    jp["wp"] = jp["wp"] * 100.0
    jp["bp"] = np.linspace(-0.1, 0.1, L + 1).astype(np.float32)
    return jp, ppo_from_jax(jp)


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_policy_apply_matches_reference(params):
    jp, tp = params
    obs = _obs(256, 2)
    j_logits, j_value = jppo.policy_apply(jp, jnp.asarray(obs))
    t_logits, t_value = ppo.policy_apply(tp, torch.from_numpy(obs))
    assert t_logits.dtype == torch.float32 and t_logits.shape == (256, L + 1)
    assert t_value.shape == (256,)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(t_value.numpy(), np.asarray(j_value),
                               rtol=0, atol=TOL)


def test_rl_policy_decide_matches_reference(params):
    jp, tp = params
    obs = _obs(512, 3)
    want = np.asarray(jmake_policy("rl", L, rl_params=jp).decide(obs))
    got = make_policy("rl", L, rl_params=tp).decide(obs)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    assert got.shape == (512,) and got.min() >= 0 and got.max() <= L
    logits = np.asarray(jppo.policy_apply(jp, jnp.asarray(obs))[0])
    clear = _margin(logits) > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    assert len(set(got.tolist())) > 1        # the policy spreads over k
    for i in np.flatnonzero(clear)[:8]:
        assert ppo.greedy_action(tp, obs[i]) == \
            jppo.greedy_action(jp, obs[i]) == got[i]


def test_argmax_ties_break_to_the_first_index():
    """Equal policy columns give equal logits: both frameworks pick 0."""
    jp = jax.tree.map(np.asarray, jppo.init_policy(
        jax.random.PRNGKey(4), 3, L + 1))
    jp["wp"] = np.repeat(jp["wp"][:, :1], L + 1, axis=1)
    obs = _obs(16, 5)
    got = RLPolicy(L, ppo_from_jax(jp)).decide(obs)
    np.testing.assert_array_equal(got, 0)
    np.testing.assert_array_equal(
        np.asarray(jmake_policy("rl", L, rl_params=jp).decide(obs)), got)


def test_make_policy_rl_without_params_raises_as_reference():
    with pytest.raises(ValueError, match="rl_params"):
        jmake_policy("rl", L)
    with pytest.raises(ValueError, match="rl_params"):
        make_policy("rl", L)


def test_init_policy_from_generator():
    """Shapes and scales of the reference's initialiser; the same seed
    gives the same params; ``ppo_to_jax`` round-trips them."""
    a = ppo.init_policy(torch.Generator().manual_seed(0), 3, L + 1)
    b = ppo.init_policy(torch.Generator().manual_seed(0), 3, L + 1)
    shapes = {"w1": (3, 64), "b1": (64,), "wp": (64, L + 1), "bp": (L + 1,),
              "wv": (64, 1), "bv": (1,)}
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.dtype == torch.float32 for v in a.values())
    assert not a["b1"].any() and not a["bp"].any() and not a["bv"].any()
    assert a["wp"].abs().max() < 0.1 * a["w1"].abs().max()
    back = ppo_from_jax(ppo_to_jax(a))
    assert all(torch.equal(a[k], back[k]) for k in a)
    # tensors from a generator on any device are copied to the CPU once
    pol = RLPolicy(L, a)
    assert all(v.device.type == "cpu" for v in pol.params.values())
    assert ppo.PPOCfg().hidden == jppo.PPOCfg().hidden == 64
