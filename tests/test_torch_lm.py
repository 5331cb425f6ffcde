"""The port's LM stack (configs, models/common.py, mlp.py, attention.py,
lm.py, weights.lm_from_jax) against the reference.

Inputs come from a numpy seed; weights are the reference's ``init_lm``
converted with ``lm_from_jax`` (torch generators cannot replay
``jax.random``).  Tolerances: elementwise functions rtol 1e-6; products,
attention and the forward rtol 1e-5 / atol 1e-5 (float32 sums in another
order).  On the CPU ``attention`` takes the reference's dense (S <=
``attn_chunk``) or chunked path; the flash kernel is the card's
(``chip_smoke.py`` phases 9-10).
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa
from repro_torch.models import attention, common, lm, mlp  # noqa: E402
from repro_torch.weights import lm_from_jax, lm_to_jax  # noqa: E402

RTOL = ATOL = 1e-5
TIERS = ("qwen1.5-0.5b", "qwen3-1.7b")
FULL_PARAMS = {"qwen1.5-0.5b": 463_987_712, "qwen3-1.7b": 1_720_574_976}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _rng_tree(tree, seed):
    """The tree with its all-zero leaves (norm scales, QKV biases) drawn
    from 0.1 x a standard normal, so they are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
        if not np.any(x) else np.asarray(x), tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TIERS)
def test_full_configs_equal_reference(name):
    assert dataclasses.asdict(base.get_config(name)) == dataclasses.asdict(
        jbase.get_config(name))


@pytest.mark.parametrize("name", TIERS)
def test_smoke_configs_equal_reference(name):
    got = base.smoke_config(base.get_config(name))
    want = jbase.smoke_config(jbase.get_config(name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_registry_and_dtypes():
    assert base.list_configs() == sorted(TIERS)
    cfg = base.get_config("qwen3-1.7b")
    assert cfg.xdtype == torch.float32 and cfg.pdtype == torch.float32
    assert replace(cfg, dtype="bfloat16").xdtype == torch.bfloat16
    wins = cfg.layer_windows()
    assert wins == [int(w) for w in np.asarray(
        jbase.get_config("qwen3-1.7b").layer_windows())]
    assert wins == [1 << 30] * 28
    slid = replace(cfg, window=16, attn_pattern=("sliding", "global"))
    assert slid.layer_windows()[:4] == [16, 1 << 30, 16, 1 << 30]


# ---------------------------------------------------------------------------
# models/common.py and mlp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("contract,shape,wshape", [
    (1, (2, 5, 8), (8, 6)), (1, (2, 5, 8), (8, 3, 4)),
    (2, (2, 5, 3, 4), (3, 4, 8))])
@pytest.mark.parametrize("bias", [False, True])
def test_apply_dense(contract, shape, wshape, bias):
    rng = np.random.default_rng(contract + len(wshape))
    x = rng.normal(size=shape).astype(np.float32)
    p = {"w": rng.normal(size=wshape).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=wshape[contract:]).astype(np.float32)
    want = jcommon.apply_dense(p, jnp.asarray(x), contract=contract)
    got = common.apply_dense({k: _t(v) for k, v in p.items()}, _t(x),
                             contract=contract)
    _close(got, want)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(2, 7, 16)) + 1).astype(np.float32)
    p = _rng_tree(jcommon.init_norm(kind, 16)[0], 2)
    want = jcommon.apply_norm(kind, p, jnp.asarray(x))
    got = common.apply_norm(kind, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, atol=1e-6)
    init = common.init_norm(kind, 16)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: v.shape for k, v in jcommon.init_norm(kind, 16)[0].items()}


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_freqs_bitwise(hd, theta):
    assert np.array_equal(common.rope_freqs(hd, theta).numpy(),
                          np.asarray(jcommon.rope_freqs(hd, theta)))


def test_apply_rope():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = common.apply_rope(_t(x), _t(pos), 1e6)
    _close(got, want, rtol=1e-6, atol=1e-6)


def test_embeddings_and_softcap():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 5)).astype(np.int32)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    assert np.array_equal(
        common.embed_lookup({"table": _t(table)}, _t(toks)).numpy(),
        np.asarray(jcommon.embed_lookup({"table": table}, toks)))
    _close(common.embed_logits({"table": _t(table)}, _t(x)),
           jcommon.embed_logits({"table": table}, jnp.asarray(x)))
    _close(common.softcap(_t(20 * x), 30.0),
           jcommon.softcap(jnp.asarray(20 * x), 30.0), rtol=1e-6, atol=1e-6)
    assert torch.equal(common.softcap(_t(x), None), _t(x))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2", "relu"])
def test_activations(act):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    _close(common.activation(act)(_t(x)),
           jcommon.activation(act)(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "relu2")])
def test_mlp(gated, act):
    jp, _ = jmlp.init_mlp(jax.random.PRNGKey(0), 16, 40, gated=gated)
    jp = _np(jp)
    x = np.random.default_rng(5).normal(size=(2, 6, 16)).astype(np.float32)
    want = jmlp.apply_mlp(jp, jnp.asarray(x), act=act)
    got = mlp.apply_mlp(lm_from_jax(jp), _t(x), act=act)
    _close(got, want)
    mine = mlp.init_mlp(torch.Generator().manual_seed(0), 16, 40, gated=gated)
    assert jax.tree.map(np.shape, lm_to_jax(mine)) == jax.tree.map(
        np.shape, jp)


def test_truncated_normal_draws():
    w = common.truncated_normal(torch.Generator().manual_seed(0),
                                (200, 300), 0.5, torch.float32)
    assert w.abs().max() <= 1.0 and abs(w.mean().item()) < 0.01
    # the std of a unit normal truncated to +-2 is 0.8796
    assert abs(w.std().item() / 0.5 - 0.8796) < 0.01
    meta = common.truncated_normal(None, (3, 4), 1.0, torch.float32)
    assert meta.is_meta and tuple(meta.shape) == (3, 4)


# ---------------------------------------------------------------------------
# attention.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TIERS)
@pytest.mark.parametrize("S", [16, 64])        # dense; chunked (> 32)
@pytest.mark.parametrize("window", [None, 1 << 30])
def test_attention_matches_reference(name, S, window):
    jc = jbase.smoke_config(jbase.get_config(name))
    c = base.smoke_config(base.get_config(name))
    jp = _rng_tree(_np(jattn.init_attention(jax.random.PRNGKey(1), jc)[0]),
                   S)
    x = np.random.default_rng(S).normal(size=(2, S, c.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jattn.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                           window=window)
    got = attention.attention(lm_from_jax(jp), c, _t(x), _t(pos),
                              window=window)
    _close(got, want)
    assert flash_attention_fwd.launches == 0


@pytest.mark.parametrize("window", [5, 40])
def test_attention_sliding_window_matches_reference(window):
    """A window that masks keys (the plain path on every device)."""
    jc = jbase.smoke_config(jbase.get_config("qwen3-1.7b"))
    c = base.smoke_config(base.get_config("qwen3-1.7b"))
    jp = _rng_tree(_np(jattn.init_attention(jax.random.PRNGKey(2), jc)[0]),
                   7)
    x = np.random.default_rng(9).normal(size=(1, 64, 64)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)
    want = jattn.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                           window=window)
    got = attention.attention(lm_from_jax(jp), c, _t(x), _t(pos),
                              window=window)
    _close(got, want)


def test_init_attention_shapes():
    for name in TIERS:
        jc = jbase.smoke_config(jbase.get_config(name))
        c = base.smoke_config(base.get_config(name))
        jp = _np(jattn.init_attention(jax.random.PRNGKey(0), jc)[0])
        mine = attention.init_attention(torch.Generator().manual_seed(0), c)
        assert jax.tree.map(np.shape, lm_to_jax(mine)) == jax.tree.map(
            np.shape, jp)


def test_kernel_rule():
    """Every layer of both full tiers goes to the kernel at S = 1,024 with
    the 'global' sentinel window; a soft-cap, a window shorter than S, an
    unsupported head dim or bf16 activations keep the plain path."""
    for name in TIERS:
        cfg = base.get_config(name)
        for w in cfg.layer_windows():
            assert attention.uses_kernel(cfg, w, 1024)
        assert attention.uses_kernel(cfg, None, 1024)
        assert not attention.uses_kernel(
            replace(cfg, attn_softcap=50.0), None, 1024)
        assert not attention.uses_kernel(cfg, 512, 1024)
        assert attention.uses_kernel(cfg, 1024, 1024)
        assert not attention.uses_kernel(replace(cfg, head_dim=80), None, 8)
        assert not attention.uses_kernel(replace(cfg, dtype="bfloat16"),
                                         None, 8)


# ---------------------------------------------------------------------------
# lm.py and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TIERS)
def test_forward_and_logits_match_reference(name):
    jc = jbase.smoke_config(jbase.get_config(name))
    c = base.smoke_config(base.get_config(name))
    jp = _np(jlm.init_lm(jc, jax.random.PRNGKey(0))[0])
    p = lm_from_jax(jp)
    for S in (16, 48):
        toks = np.random.default_rng(S).integers(0, jc.vocab, (3, S)).astype(
            np.int32)
        jh, _ = jlm.forward(jc, jp, tokens=jnp.asarray(toks))
        jl = jlm.logits_from_hidden(jc, jp, jh[:, -4:])
        h, aux = lm.forward(c, p, tokens=_t(toks))
        _close(h, jh)
        _close(lm.logits_from_hidden(c, p, h[:, -4:]), jl)
        assert aux == 0.0


def test_untied_head_and_embeds_input():
    """An untied ``lm_head`` and a forward from embeddings."""
    jc = replace(jbase.smoke_config(jbase.get_config("qwen3-1.7b")),
                 tie_embeddings=False)
    c = replace(base.smoke_config(base.get_config("qwen3-1.7b")),
                tie_embeddings=False)
    jp = _np(jlm.init_lm(jc, jax.random.PRNGKey(3))[0])
    x = np.random.default_rng(3).normal(size=(2, 12, 64)).astype(np.float32)
    jh, _ = jlm.forward(jc, jp, embeds=jnp.asarray(x))
    h, _ = lm.forward(c, lm_from_jax(jp), embeds=_t(x))
    _close(h, jh)
    _close(lm.logits_from_hidden(c, lm_from_jax(jp), h),
           jlm.logits_from_hidden(jc, jp, jh))


@pytest.mark.parametrize("name", TIERS)
def test_lm_weights_round_trip_bitwise(name):
    jp = _np(jlm.init_lm(jbase.smoke_config(jbase.get_config(name)),
                         jax.random.PRNGKey(4))[0])
    back = lm_to_jax(lm_from_jax(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mine = lm.init_lm(base.smoke_config(base.get_config(name)),
                      torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, lm_to_jax(mine)) == jax.tree.map(
        np.shape, jp)


@pytest.mark.parametrize("name", TIERS)
def test_param_count_at_full_width(name):
    cfg = base.get_config(name)
    meta = lm.init_lm(cfg, None)                   # shapes only
    shapes = jax.eval_shape(lambda k: jlm.init_lm(jbase.get_config(name),
                                                  k)[0],
                            jax.random.PRNGKey(0))
    ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert lm.param_count(meta) == ref == FULL_PARAMS[name]


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_other_families_wait(family):
    cfg = replace(base.smoke_config(base.get_config("qwen3-1.7b")),
                  family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_lm(cfg, torch.Generator())


# ---------------------------------------------------------------------------
# positions and the kernel route
# ---------------------------------------------------------------------------

def _packed_positions(B, S, restart):
    """Two packed sequences a row: positions 0..restart-1, then 0.. again."""
    row = np.concatenate([np.arange(restart), np.arange(S - restart)])
    return np.broadcast_to(row.astype(np.int32), (B, S))


@pytest.mark.parametrize("name", TIERS)
@pytest.mark.parametrize("S,restart", [(16, 9), (48, 20)])
def test_forward_with_packed_positions_matches_reference(name, S, restart):
    """Positions that restart mid-row (packed sequences): the reference
    masks by position, and so must the port."""
    jc = jbase.smoke_config(jbase.get_config(name))
    c = base.smoke_config(base.get_config(name))
    jp = _np(jlm.init_lm(jc, jax.random.PRNGKey(5))[0])
    toks = np.random.default_rng(S).integers(0, jc.vocab, (2, S)).astype(
        np.int32)
    pos = _packed_positions(2, S, restart)
    jh, _ = jlm.forward(jc, jp, tokens=jnp.asarray(toks),
                        positions=jnp.asarray(pos))
    h, _ = lm.forward(c, lm_from_jax(jp), tokens=_t(toks), positions=_t(pos))
    _close(h, jh)
    # and they differ from the index positions' output: the mask matters
    h_index, _ = lm.forward(c, lm_from_jax(jp), tokens=_t(toks))
    assert not torch.allclose(h, h_index, atol=1e-3)


def test_forward_vouches_only_for_its_own_positions(monkeypatch):
    """``forward`` tells ``attention`` the positions are the index only
    when it built them: passed-in positions never reach the kernel, whose
    causal mask is by index."""
    c = base.smoke_config(base.get_config("qwen1.5-0.5b"))
    p = lm.init_lm(c, torch.Generator().manual_seed(0))
    seen = []
    real = attention.attention

    def spy(*args, **kw):
        seen.append(kw["index_positions"])
        return real(*args, **kw)
    monkeypatch.setattr(attention, "attention", spy)
    toks = torch.zeros(2, 8, dtype=torch.int32)
    lm.forward(c, p, tokens=toks)
    assert seen == [True] * c.n_layers
    seen.clear()
    lm.forward(c, p, tokens=toks, positions=torch.arange(8).expand(2, 8))
    assert seen == [False] * c.n_layers


@pytest.mark.parametrize("name", TIERS)
def test_kernel_route_matches_dense_path_with_gradients(name):
    """``_attend_kernel`` (the differentiable flash entry on (B, H, S, hd)
    copies; its plain versions on the CPU) gives the dense path's output
    and gradients for index positions, GQA and qk-norm included."""
    c = base.smoke_config(base.get_config(name))
    rng = np.random.default_rng(11)
    S = 24
    q, k, v = (torch.from_numpy(rng.normal(size=(2, S, h, c.head_dim))
                                .astype(np.float32)).requires_grad_()
               for h in (c.n_heads, c.n_kv_heads, c.n_kv_heads))
    pos = torch.arange(S)
    got = attention._attend_kernel(c, q, k, v)
    want = attention._attend_dense(c, q, k, v, pos, pos, None)
    _close(got, want.detach())
    g = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    for a, b in zip(torch.autograd.grad(got, (q, k, v), g),
                    torch.autograd.grad(want, (q, k, v), g)):
        _close(a, b.detach())
