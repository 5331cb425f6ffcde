"""The port's PPO (``core/ppo.py``) and ``RLPolicy`` against the
reference.

Same params (the reference's ``init_policy`` draws, converted with
``ppo_from_jax``), same observations: logits and values agree within
1e-6 (three small float32 products, summed in another order).  Actions
are compared where the top two logits differ by more than 1e-5, since a
last-bit difference may flip a nearer tie; ties break to the first
index in both.

The training half: ``PPOCfg``, ``gae`` bitwise, one update against the
jitted ``_update`` (1e-6 of each leaf's max), the ddof-0 normalisation of
the advantage, and a tiny ``train_ppo`` from the reference's initial
params and Gumbel draws (actions equal behind the margin guard, history
and params within 1e-5).
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


# --- the training half --------------------------------------------------

import dataclasses  # noqa: E402
import inspect  # noqa: E402
import itertools  # noqa: E402

from repro.core import env as jenv  # noqa: E402
from repro_torch.core import env as tenv  # noqa: E402

UPDATE_TOL = 1e-6        # one update, of each leaf's max |p|
TRAIN_TOL = 1e-5         # the tiny train_ppo run, of each leaf's max |p|
TINY = dict(iters=2, steps_per_iter=128, minibatch=32, epochs=2)
TINY_HORIZON = 50        # episodes end inside an iteration: resets happen


def _leaf_errs(got, want):
    return {k: float(np.abs(got[k].detach().cpu().numpy()
                            - np.asarray(want[k])).max()
                     / np.abs(np.asarray(want[k])).max()) for k in want}


def test_ppo_cfg_fields_match_reference():
    assert [f.name for f in dataclasses.fields(ppo.PPOCfg)] == \
        [f.name for f in dataclasses.fields(jppo.PPOCfg)]
    assert dataclasses.astuple(ppo.PPOCfg()) == \
        dataclasses.astuple(jppo.PPOCfg())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_bitwise(seed):
    rng = np.random.default_rng(seed)
    T = 300
    rewards = rng.standard_normal(T).astype(np.float32) * 3
    values = rng.standard_normal(T).astype(np.float32)
    dones = (rng.random(T) < 0.05).astype(np.float32)
    last_v = float(rng.standard_normal())
    got = ppo.gae(rewards, values, dones, last_v, 0.99, 0.95)
    want = jppo.gae(rewards, values, dones, last_v, 0.99, 0.95)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def _batch(n, seed, n_actions=L + 1):
    rng = np.random.default_rng(seed)
    return {"obs": rng.random((n, 3)).astype(np.float32),
            "act": rng.integers(0, n_actions, n).astype(np.int32),
            "logp": np.log(rng.uniform(0.05, 0.3, n)).astype(np.float32),
            "adv": (rng.standard_normal(n) * 2 + 0.5).astype(np.float32),
            "ret": rng.standard_normal(n).astype(np.float32)}


def _tbatch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["act"] = out["act"].to(torch.int64)
    return out


def _state(jp, seed, step):
    """A mid-run Adam state: random moments (v > 0) and a step count."""
    rng = np.random.default_rng(seed)
    m = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
         for k, v in jp.items()}
    v = {k: (rng.random(v.shape) * 1e-4).astype(np.float32)
         for k, v in jp.items()}
    return m, v, step


@pytest.mark.parametrize("step", [0, 7])
def test_one_update_matches_reference(params, step):
    jp, tp = params
    m, v, _ = _state(jp, 3, step)
    b = _batch(256, 4)
    kw = dict(clip=0.2, ent_coef=0.01, vf_coef=0.5, lr=3e-4)
    jnew, (jm, jv, jstep), jloss = jppo._update(
        jp, (m, v, jnp.int32(step)), {k: jnp.asarray(x) for k, x in
                                      b.items()}, **kw)
    tstate = ({k: torch.from_numpy(x) for k, x in m.items()},
              {k: torch.from_numpy(x) for k, x in v.items()},
              torch.tensor(step, dtype=torch.int32))
    tnew, (tm, tv, tstep), tloss = ppo.ppo_update(tp, tstate, _tbatch(b),
                                                  **kw)
    assert int(tstep) == int(jstep) == step + 1
    assert tstep.dtype == torch.int32
    assert abs(float(tloss) - float(jloss)) <= UPDATE_TOL * abs(float(jloss))
    for name, got, want in (("params", tnew, jnew), ("m", tm, jm),
                            ("v", tv, jv)):
        errs = _leaf_errs(got, want)
        assert max(errs.values()) <= UPDATE_TOL, (name, errs)
    assert all(not p.requires_grad for p in tnew.values())


def _loss_ddof1(params, batch, *, clip, ent_coef, vf_coef):
    """``ppo.ppo_loss`` with ``torch.std``'s default (ddof 1): the trap."""
    logits, value = ppo.policy_apply(params, batch["obs"])
    logp_all = torch.log_softmax(logits, -1)
    logp = torch.gather(logp_all, 1, batch["act"][:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = (batch["adv"] - batch["adv"].mean()) / (batch["adv"].std() + 1e-8)
    pg = -torch.mean(torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv))
    vf = torch.mean(torch.square(value - batch["ret"]))
    ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
    return pg + vf_coef * vf - ent_coef * ent


def test_advantage_std_is_population_std(params):
    """A minibatch of 4 with large advantages: the normalisation by
    ddof 0 (``jnp.std``) and by ddof 1 differ by sqrt(4/3), which the
    loss shows far above the tolerance.  The port's matches the
    reference's; the ddof-1 form would miss it."""
    jp, tp = params
    b = _batch(4, 5)
    b["adv"] = np.array([40.0, -25.0, 10.0, -3.0], np.float32)
    b["logp"] = np.log(np.full(4, 0.5, np.float32))   # ratios off 1
    kw = dict(clip=0.2, ent_coef=0.01, vf_coef=0.5)

    def jloss_fn(p, batch):
        logits, value = jppo.policy_apply(p, batch["obs"])
        logp_all = jax.nn.log_softmax(logits)
        logp = jnp.take_along_axis(logp_all, batch["act"][:, None], 1)[:, 0]
        ratio = jnp.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg = -jnp.mean(jnp.minimum(
            ratio * adv, jnp.clip(ratio, 1 - kw["clip"], 1 + kw["clip"])
            * adv))
        vf = jnp.mean(jnp.square(value - batch["ret"]))
        ent = -jnp.mean(jnp.sum(jnp.exp(logp_all) * logp_all, -1))
        return pg + kw["vf_coef"] * vf - kw["ent_coef"] * ent

    want = float(jloss_fn(jp, {k: jnp.asarray(x) for k, x in b.items()}))
    got, _ = ppo.ppo_loss(tp, _tbatch(b), **kw)
    trap = float(_loss_ddof1(tp, _tbatch(b), **kw))
    tol = UPDATE_TOL * abs(want)
    assert abs(float(got) - want) <= tol
    assert abs(trap - want) > 1e3 * tol
    # and through the update: the reference's jitted step agrees
    state = ({k: np.zeros_like(v) for k, v in jp.items()},
             {k: np.zeros_like(v) for k, v in jp.items()})
    _, _, jl = jppo._update(jp, (*state, jnp.int32(0)),
                            {k: jnp.asarray(x) for k, x in b.items()},
                            lr=3e-4, **kw)
    _, _, tl = ppo.ppo_update(
        tp, ppo.adam_init(tp), _tbatch(b), lr=3e-4, **kw)
    assert abs(float(tl) - float(jl)) <= tol


def _factory(mod):
    """Episodes cycle over three profiles, each env seeded by its index
    (``get_policy``'s pattern at a short horizon)."""
    counter = itertools.count()
    profiles = ("stable", "variable", "congested")

    def factory():
        i = next(counter)
        return mod.EdgeCloudEnv(mod.EnvCfg(net=profiles[i % 3],
                                           horizon=TINY_HORIZON, seed=i))

    return factory


def _reference_keys(seed, n):
    """The step keys of the reference's ``train_ppo``: ``k0`` for the
    initial params, then one ``ka`` a step."""
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    kas = []
    for _ in range(n):
        key, ka = jax.random.split(key)
        kas.append(ka)
    return k0, kas


@pytest.fixture(scope="module")
def tiny_runs():
    """The reference's ``train_ppo`` and the port's on the CPU, from the
    reference's initial params and its Gumbel draws, with every action
    and the port's top-two gap of ``gumbel + logits`` recorded."""
    n_act = L + 1
    cfg_kw = dict(TINY, seed=0)
    k0, kas = _reference_keys(0, TINY["iters"] * TINY["steps_per_iter"])
    jp0 = jax.tree.map(np.asarray, jppo.init_policy(k0, 3, n_act, 64))
    draws = [np.array(jax.random.gumbel(ka, (n_act,), jnp.float32))
             for ka in kas]

    jacts, tacts, margins = [], [], []
    mp = pytest.MonkeyPatch()
    orig_j, orig_t = jppo._act, ppo.act

    def jrec(p, obs, ka):
        out = orig_j(p, obs, ka)
        jacts.append(int(out[0]))
        return out

    def trec(p, obs, gumbel):
        with torch.no_grad():
            logits, _ = ppo.policy_apply(p, torch.from_numpy(obs))
        margins.append(float(_margin(
            (torch.from_numpy(gumbel) + logits).numpy()[None])[0]))
        out = orig_t(p, obs, gumbel)
        tacts.append(out[0])
        return out

    try:
        mp.setattr(jppo, "_act", jrec)
        mp.setattr(ppo, "act", trec)
        jparams, jhist = jppo.train_ppo(_factory(jenv), n_act,
                                        jppo.PPOCfg(**cfg_kw))
        tparams, thist = ppo.train_ppo(
            _factory(tenv), n_act, ppo.PPOCfg(**cfg_kw), device="cpu",
            params=ppo_from_jax(jp0), noise=lambda t: draws[t])
    finally:
        mp.undo()
    return dict(kas=kas, jacts=jacts, tacts=tacts, margins=margins,
                jparams=jparams, jhist=jhist, tparams=tparams, thist=thist)


def test_tiny_train_ppo_tracks_reference(tiny_runs):
    r = tiny_runs
    n = TINY["iters"] * TINY["steps_per_iter"]
    assert len(r["jacts"]) == len(r["tacts"]) == n
    # a last-bit difference in the logits may flip a nearer tie, and a
    # flip changes the whole trajectory: the guard first
    assert min(r["margins"]) > MARGIN
    assert r["tacts"] == r["jacts"]
    assert len(set(r["tacts"])) > 3
    assert len(r["thist"]) == len(r["jhist"]) == TINY["iters"]
    np.testing.assert_allclose(r["thist"], r["jhist"], rtol=TRAIN_TOL)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in r["tparams"].values())
    errs = _leaf_errs(r["tparams"], r["jparams"])
    assert max(errs.values()) <= TRAIN_TOL, errs
    # the params moved: the updates ran
    k0, _ = _reference_keys(0, 0)
    jp0 = jppo.init_policy(k0, 3, L + 1, 64)
    moved = _leaf_errs(r["tparams"], {k: jp0[k] for k in ("w1", "wp", "wv")})
    assert min(moved.values()) > 1e-4, moved


def test_categorical_is_argmax_of_gumbel_plus_logits(tiny_runs):
    """The port's actor rests on ``jax.random.categorical(ka, l) ==
    argmax(gumbel(ka, l.shape) + l)``; held for every key of the tiny run,
    eager and jitted, at logits of two spreads."""
    rng = np.random.default_rng(6)
    cat = jax.jit(jax.random.categorical)
    for i, ka in enumerate(tiny_runs["kas"]):
        scale = 0.01 if i % 2 else 1.0
        logits = jnp.asarray((rng.standard_normal(L + 1) * scale)
                             .astype(np.float32))
        want = int(jnp.argmax(jax.random.gumbel(ka, logits.shape,
                                                logits.dtype) + logits))
        assert int(jax.random.categorical(ka, logits)) == want
        assert int(cat(ka, logits)) == want


def test_train_ppo_reports_each_iteration():
    """``on_iter`` sees each iteration's rollout and timings; the default
    draws (one CPU generator from ``cfg.seed``) make a run repeatable."""
    seen = []
    cfg = ppo.PPOCfg(iters=2, steps_per_iter=64, minibatch=32, epochs=1,
                     seed=3)
    runs = [ppo.train_ppo(_factory(tenv), L + 1, cfg, device="cpu",
                          on_iter=lambda it, info: seen.append((it, info)))
            for _ in range(2)]
    assert [it for it, _ in seen] == [0, 1, 0, 1]
    info = seen[0][1]
    assert info["act"].shape == (64,) and info["obs"].shape == (64, 3)
    assert info["rollout_ms"] > 0 and info["update_ms"] > 0
    assert info["mean_reward"] == runs[0][1][0]
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
    np.testing.assert_array_equal(seen[0][1]["act"], seen[2][1]["act"])


def test_train_ppo_defaults_to_cuda_and_refuses_without_it():
    assert inspect.signature(ppo.train_ppo).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppo.train_ppo(_factory(tenv), L + 1,
                      ppo.PPOCfg(iters=1, steps_per_iter=8, minibatch=8))
