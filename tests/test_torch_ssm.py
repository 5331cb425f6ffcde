"""The port's Mamba-2 block (``models/ssm.py``) against the reference's
``repro.models.ssm``, and the chunked SSD against its own recurrence.

Inputs come from numpy seeds; parameters are the reference's
``init_mamba`` (its all-zero ``norm_scale`` drawn from a seed too)
converted with ``lm_from_jax``.  Tolerance rtol 1e-5 / atol 1e-5 (float32
sums in another order), as in ``test_torch_lm.py``.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SSMCfg as JSSMCfg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import SSMCfg  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.weights import lm_from_jax, lm_to_jax  # noqa: E402

RTOL = ATOL = 1e-5
D_MODEL = 32
# the smoke configs' SSM (4 heads of 8, state 8, chunk 16, conv 4), and
# two groups of B/C heads
CFGS = {"g1": dict(n_heads=4, head_dim=8, d_state=8, chunk=16),
        "g2": dict(n_heads=4, head_dim=8, d_state=8, chunk=16, n_groups=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _params(kind, seed=0):
    """The reference's init_mamba, norm_scale drawn -> (numpy tree, port
    params, port cfg, reference cfg)."""
    jc, c = JSSMCfg(**CFGS[kind]), SSMCfg(**CFGS[kind])
    jp = jax.tree.map(np.asarray, jssm.init_mamba(
        jax.random.PRNGKey(seed), jc, D_MODEL)[0])
    jp["norm_scale"] = (0.1 * np.random.default_rng(seed).normal(
        size=jp["norm_scale"].shape)).astype(np.float32)
    return jp, lm_from_jax(jp), c, jc


def _u(B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, D_MODEL)).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_init_mamba_shapes(kind):
    jp, _, c, _ = _params(kind)
    for g in (torch.Generator().manual_seed(0), None):
        mine = ssm.init_mamba(g, c, D_MODEL)
        assert {k: tuple(v.shape) for k, v in _flat(mine)} == {
            k: v.shape for k, v in _flat(jp)}
    mine = ssm.init_mamba(torch.Generator().manual_seed(0), c, D_MODEL)
    assert jax.tree.structure(lm_to_jax(mine)) == jax.tree.structure(jp)
    # the per-head dynamics as the reference sets them
    assert torch.equal(mine["A_log"], _t(jp["A_log"]))
    assert torch.equal(mine["D"], _t(jp["D"]))
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_causal_depthwise_conv():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 5)).astype(np.float32)
    w = rng.normal(size=(4, 3, 5)).astype(np.float32)
    _close(ssm._causal_depthwise_conv(_t(x), _t(w)),
           jssm._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w)))


def test_segsum_keeps_minus_inf():
    """-inf above the diagonal, exactly where the reference has it, so exp
    gives exact zeros there."""
    x = np.random.default_rng(2).normal(size=(2, 3, 16)).astype(np.float32)
    got = ssm._segsum(_t(x)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2 * 3 * 16 * 15 // 2
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    e = torch.exp(torch.from_numpy(got)).numpy()
    assert np.array_equal(e[~fin], np.zeros((~fin).sum(), np.float32))


def test_gated_rmsnorm():
    rng = np.random.default_rng(3)
    y, z = (rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
            for _ in range(2))
    scale = (0.1 * rng.normal(size=(4, 8))).astype(np.float32)
    _close(ssm._gated_rmsnorm(_t(y), _t(z), _t(scale)),
           jssm._gated_rmsnorm(jnp.asarray(y), jnp.asarray(z),
                               jnp.asarray(scale)))


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_project(kind):
    jp, p, c, jc = _params(kind, 4)
    u = _u(2, 7, 4)
    for got, want in zip(ssm._project(p, c, _t(u)),
                         jssm._project(jp, jc, jnp.asarray(u))):
        _close(got, want)


@pytest.mark.parametrize("kind", sorted(CFGS))
@pytest.mark.parametrize("S", [32, 21, 2])   # chunk multiple, ragged, < W-1
def test_mamba_forward_and_state(kind, S):
    jp, p, c, jc = _params(kind, S)
    u = _u(2, S, S)
    want, jst = jssm.mamba_forward(jp, jc, jnp.asarray(u), return_state=True)
    got, st = ssm.mamba_forward(p, c, _t(u), return_state=True)
    _close(got, want)
    _close(st.ssm, jst.ssm)
    # the conv state is the pre-conv x, as the reference's second wx GEMM
    # gives it (zero-padded on the left when S < W-1)
    _close(st.conv, jst.conv, rtol=1e-6, atol=1e-6)
    assert st.conv.shape == (2, c.conv_width - 1, c.n_heads, c.head_dim)
    assert torch.equal(ssm.mamba_forward(p, c, _t(u)), got)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_mamba_decode(kind):
    """Three steps from a random state, the state updated in place."""
    jp, p, c, jc = _params(kind, 5)
    rng = np.random.default_rng(5)
    s0 = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    c0 = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    jst = jssm.SSMState(jnp.asarray(s0), jnp.asarray(c0))
    st = ssm.SSMState(_t(s0), _t(c0))
    ptrs = (st.ssm.data_ptr(), st.conv.data_ptr())
    for t in range(3):
        u = _u(2, 1, 10 + t)
        want, jst = jssm.mamba_decode(jp, jc, jnp.asarray(u), jst)
        got, st2 = ssm.mamba_decode(p, c, _t(u), st)
        assert st2 is st
        _close(got, want)
        _close(st.ssm, jst.ssm)
        _close(st.conv, jst.conv, rtol=1e-6, atol=1e-6)
    assert (st.ssm.data_ptr(), st.conv.data_ptr()) == ptrs


def test_init_ssm_state():
    c = SSMCfg(**CFGS["g1"])
    st = ssm.init_ssm_state(c, 3)
    jst = jssm.init_ssm_state(JSSMCfg(**CFGS["g1"]), 3)
    assert st.ssm.shape == jst.ssm.shape and st.conv.shape == jst.conv.shape
    assert not st.ssm.any() and not st.conv.any()


@pytest.mark.parametrize("kind", sorted(CFGS))
@pytest.mark.parametrize("S", [37, 3])
def test_chunked_forward_equals_recurrence(kind, S):
    """Within the port: the chunked SSD over S tokens equals S steps of
    ``mamba_decode`` from a zero state, output and final state, and a
    smaller chunk gives the same."""
    _, p, c, _ = _params(kind, 6)
    u = _t(_u(2, S, 6))
    out, st = ssm.mamba_forward(p, c, u, return_state=True)
    rec = ssm.init_ssm_state(c, 2)
    steps = [ssm.mamba_decode(p, c, u[:, t:t + 1], rec)[0] for t in range(S)]
    _close(torch.cat(steps, 1), out.numpy())
    _close(rec.ssm, st.ssm.numpy())
    _close(rec.conv, st.conv.numpy(), rtol=0, atol=0)
    out8 = ssm.mamba_forward(p, replace(c, chunk=8), u)
    _close(out8, out.numpy())
