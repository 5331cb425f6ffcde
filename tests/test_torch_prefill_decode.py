"""The port's prefill and decode (``models/attention.py``'s
``attention_prefill`` / ``attention_decode``, ``models/lm.py``'s
``init_decode_state`` / ``prefill`` / ``decode_step``) against the
reference, for every family, and against the port's own forward.

Inputs come from numpy seeds; weights are the reference's ``init_lm``
converted with ``lm_from_jax``, decode states cross with
``decode_state_from_jax``.  The reference's prefill and decode step are
jitted once per config.  Tolerance rtol 1e-5 / atol 1e-5, as in
``test_torch_lm.py``.
"""
from dataclasses import replace
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.weights import (decode_state_from_jax,  # noqa: E402
                                 decode_state_to_jax, lm_from_jax)

RTOL = ATOL = 1e-5
LM_CONFIGS = [n for n in base.list_configs()
              if base.get_config(n).family != "audio_enc"]
# one config of each family for the port's own checks (kimi-k2: a MoE
# with a leading dense layer and a shared expert)
FAMILIES = {"dense": "qwen3-1.7b", "moe": "kimi-k2-1t-a32b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _jinit(jc, seed):
    """The reference's ``init_lm`` params, jitted (its eager vmapped init
    of a mamba stack takes seconds)."""
    return _np(jax.jit(lambda k: jlm.init_lm(jc, k)[0])(
        jax.random.PRNGKey(seed)))


@lru_cache(maxsize=None)
def _jref(name):
    """The reference's prefill and decode step for a smoke config, each
    jitted once for the module (its tests share their shapes)."""
    jc = jbase.smoke_config(jbase.get_config(name))
    return (jax.jit(partial(jlm.prefill, jc), static_argnames="max_len"),
            jax.jit(partial(jlm.decode_step, jc)))


def _smoke(name, **kw):
    return (replace(jbase.smoke_config(jbase.get_config(name)), **kw),
            replace(base.smoke_config(base.get_config(name)), **kw))


# ---------------------------------------------------------------------------
# attention_prefill / attention_decode
# ---------------------------------------------------------------------------

# GQA (4 query heads over 2 KV heads) with qwen3's qk-norm; and with
# gemma2's soft-cap, attention scale and sliding window (16 in the smoke)
ATTN_CASES = {"gqa": ("qwen3-1.7b", None), "softcap": ("gemma2-2b", 16)}


def _attn_setup(case, seed):
    name, window = ATTN_CASES[case]
    jc, c = _smoke(name, n_kv_heads=2)
    jp = _rng_tree(_np(jattn.init_attention(jax.random.PRNGKey(seed),
                                            jc)[0]), seed)
    return jc, c, jp, lm_from_jax(jp), window


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("S", [24, 40])          # dense; chunked (> 32)
def test_attention_prefill_matches_reference(case, S):
    jc, c, jp, p, window = _attn_setup(case, S)
    max_len = S + 5
    x = np.random.default_rng(S).normal(size=(2, S, c.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want, jcache = jattn.attention_prefill(jp, jc, jnp.asarray(x),
                                           jnp.asarray(pos), max_len,
                                           window=window)
    cache = attention.init_kv_cache(c, 2, max_len, torch.float32)
    got, back = attention.attention_prefill(p, c, _t(x), cache,
                                            window=window)
    assert back is cache
    _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("index,window", [
    (5, None), (17, 1 << 30), (17, 4),   # a window the decode passes
    (23, None),                          # the last slot
    (24, None)])                         # index == max_len: clamped write
def test_attention_decode_matches_reference(case, index, window):
    jc, c, jp, p, _ = _attn_setup(case, index)
    max_len = 24
    rng = np.random.default_rng(index)
    k0, v0 = (rng.normal(size=(2, 2, max_len, c.head_dim)).astype(
        np.float32) for _ in range(2))
    x = rng.normal(size=(2, 1, c.d_model)).astype(np.float32)
    want, jcache = jattn.attention_decode(
        jp, jc, jnp.asarray(x), jattn.KVCache(jnp.asarray(k0),
                                              jnp.asarray(v0)),
        jnp.int32(index), window=window)
    cache = attention.KVCache(_t(k0), _t(v0))
    got, back = attention.attention_decode(
        p, c, _t(x), cache, torch.tensor(index, dtype=torch.int32),
        window=window)
    assert back is cache
    _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    # only the slot at the (clamped) index changed
    at = min(index, max_len - 1)
    keep = np.arange(max_len) != at
    assert np.array_equal(cache.k.numpy()[:, :, keep], k0[:, :, keep])


def test_prefill_longer_than_max_len_raises():
    _, c = _smoke("qwen1.5-0.5b")
    p = lm.init_lm(c, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_len"):
        lm.prefill(c, p, tokens=torch.zeros(1, 9, dtype=torch.int32),
                   max_len=8)
    with pytest.raises(ValueError, match="does not fit"):
        attention.attention_prefill(
            lm._layers(p["blocks"]["layers"], c.n_layers)[0]["attn"], c,
            torch.zeros(1, 9, c.d_model),
            attention.init_kv_cache(c, 1, 8, torch.float32))


# ---------------------------------------------------------------------------
# lm.prefill + decode_step against the reference, every config
# ---------------------------------------------------------------------------

def _prompt(jc, B, S, seed):
    """(reference kwargs, port kwargs) of a prompt: tokens, or for the vlm
    family patch embeddings."""
    rng = np.random.default_rng(seed)
    if jc.family == "vlm":
        e = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": _t(e)}
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}


def _check_state(st, jst):
    got = decode_state_to_jax(st)
    assert sorted(got) == sorted(jst)
    assert got["index"] == np.asarray(jst["index"])
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(jst[k]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_prefill_and_decode_match_reference(name):
    """A prompt of 21 tokens (ragged against the smoke chunks of 16 and
    32) into a state for 29, then 4 greedy decode steps, each step's
    logits and the state against the reference's."""
    jc, c = _smoke(name)
    jp = _jinit(jc, 0)
    p = lm_from_jax(jp)
    jkw, kw = _prompt(jc, 2, 21, 1)
    jpre, jdec = _jref(name)
    jst, jlog = jpre(jp, max_len=29, **jkw)
    with torch.no_grad():
        st, logits = lm.prefill(c, p, max_len=29, **kw)
    _close(logits, jlog)
    _check_state(st, jst)
    for _ in range(4):
        toks = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        jlog, jst = jdec(jp, jst, jnp.asarray(toks))
        with torch.no_grad():
            logits, st = lm.decode_step(c, p, st, _t(toks))
        _close(logits, jlog)
    _check_state(st, jst)
    assert int(st["index"]) == 25


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_state_crosses_bitwise(family):
    """The reference's state after prefill crosses to the port and back
    bitwise, and the port's decode step continues from it as the
    reference's does."""
    jc, c = _smoke(FAMILIES[family])
    jp = _jinit(jc, 2)
    jkw, _ = _prompt(jc, 2, 21, 2)
    jpre, jdec = _jref(FAMILIES[family])
    jst, jlog = jpre(jp, max_len=29, **jkw)
    st = decode_state_from_jax(_np(jst))
    assert st["index"].dtype == torch.int32 and st["index"].dim() == 0
    back = decode_state_to_jax(st)
    assert sorted(back) == sorted(jst)
    for k in back:
        assert back[k].dtype == np.asarray(jst[k]).dtype
        assert np.array_equal(back[k], np.asarray(jst[k]))
    toks = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jlog, jst = jdec(jp, jst, jnp.asarray(toks))
    with torch.no_grad():
        logits, st = lm.decode_step(c, lm_from_jax(jp), st, _t(toks))
    _close(logits, jlog)
    _check_state(st, _np(jst))


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_equals_teacher_forced_forward(family):
    """Within the port: prefill of S tokens then n greedy steps give the
    logits that one forward over the prompt and the decoded tokens gives
    at those positions; every step updates the state in place (the same
    dict, the same storage, ``index`` on the device)."""
    _, c = _smoke(FAMILIES[family])
    p = lm.init_lm(c, torch.Generator().manual_seed(3))
    S, n = 19, 6
    toks = torch.randint(0, c.vocab, (2, S),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        st, logits = lm.prefill(c, p, tokens=toks, max_len=S + n)
        ptrs = {k: v.data_ptr() for k, v in st.items()}
        got, fed = [logits], []
        for _ in range(n):
            fed.append(got[-1].argmax(-1))
            logits, st2 = lm.decode_step(c, p, st, fed[-1])
            assert st2 is st
            got.append(logits)
        assert {k: v.data_ptr() for k, v in st.items()} == ptrs
        assert int(st["index"]) == S + n
        h, _ = lm.forward(c, p, tokens=torch.cat([toks, torch.stack(
            fed, 1)], 1))
        want = lm.logits_from_hidden(c, p, h[:, S - 1:])
    _close(torch.stack(got, 1), want.numpy())


def test_prefill_vouches_index_positions_and_decode_takes_no_kernel(
        monkeypatch):
    """Prefill's attention goes through the route that may take the flash
    kernel, with the positions vouched for as the index; decode never
    reaches the kernel (its causal mask is top-left aligned)."""
    _, c = _smoke("zamba2-1.2b")
    p = lm.init_lm(c, torch.Generator().manual_seed(4))
    seen = []
    real = attention._attend

    def spy(*args):
        seen.append(args[-1])
        return real(*args)
    monkeypatch.setattr(attention, "_attend", spy)
    toks = torch.zeros(2, 7, dtype=torch.int32)
    with torch.no_grad():
        st, logits = lm.prefill(c, p, tokens=toks, max_len=10)
        G = lm._hybrid_layout(c)[0]
        assert seen == [True] * G
        monkeypatch.setattr(attention, "_attend", None)
        monkeypatch.setattr(fa, "flash_attention", None)
        lm.decode_step(c, p, st, logits.argmax(-1))


def test_kernel_route_saves_nothing_without_grad():
    """Under ``no_grad`` / ``inference_mode`` the kernel route's autograd
    Function records no graph (so it keeps no q, k, v, o or lse)."""
    _, c = _smoke("qwen1.5-0.5b")
    q, k, v = (torch.randn(1, 5, 4, 16, requires_grad=True)
               for _ in range(3))
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            o = attention._attend_kernel(c, q, k, v)
        assert o.grad_fn is None and not o.requires_grad
