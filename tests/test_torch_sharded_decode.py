"""The port's prefill and decode on a mesh (``lm.prefill`` /
``lm.decode_step`` under ``axis_rules``: ``attention_prefill_sharded``,
``attention_decode_sharded``, ``mamba_decode_sharded``, MoE through
``moe_ep``) against the reference's unsharded jitted ``prefill`` and
``decode_step``, on logical shards of the CPU.

The cache's three layouts under ``rules_for``: kv heads over 'model'
(qwen3-1.7b on (data 2, model 2)); positions (``kv_seq``) over 'model'
where the kv heads do not divide it (2 kv heads on (1, 4); gemma2-2b on
(1, 8), whose sliding window of 16 and soft-caps cross the blocks'
edges); positions over 'data' at batch 1 (zamba2-1.2b and mamba2-780m
under ``kind="decode"``, their SSM heads over 'model').  Plus arctic-480b
on (1, 4) (``moe_ep``: a prompt of 21 tokens does not divide 'model', so
the replicated path, which drops no copy), a decode step whose index
sits on a block's first position, one with whole blocks masked, and a
state the reference made carried onto a mesh.  Prompt, then 4 greedy
steps; logits and the gathered state at rtol = atol = 1e-5, as
``test_torch_prefill_decode.py``."""
from dataclasses import replace
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import (decode_state_from_jax,  # noqa: E402
                                 decode_state_from_mesh,
                                 decode_state_to_jax, decode_state_to_mesh,
                                 lm_from_jax, lm_to_mesh)

RTOL = ATOL = 1e-5
STEPS = 4
# name: (config, overrides, mesh, batch, prompt, max_len, rules kind,
#        where the cache's positions split)
CASES = {
    "kvheads-2x2": ("qwen3-1.7b", {}, (2, 2), 4, 21, 32, "decode", None),
    "kvseq-model-1x4": ("qwen3-1.7b", dict(n_kv_heads=2), (1, 4), 2, 21, 32,
                        "decode", "model"),
    "gemma2-window-1x8": ("gemma2-2b", {}, (1, 8), 2, 37, 64, "decode",
                          "model"),
    "zamba2-batch1-2x2": ("zamba2-1.2b", {}, (2, 2), 1, 21, 32, "decode",
                          "data"),
    "mamba2-batch1-2x2": ("mamba2-780m", {}, (2, 2), 1, 21, 32, "decode",
                          None),
    "arctic-1x4": ("arctic-480b", {}, (1, 4), 2, 21, 32, "decode", None),
    # the first step writes at 16, the first position of block 2 of 4
    "block-edge-1x4": ("qwen3-1.7b", dict(n_kv_heads=2), (1, 4), 2, 16, 32,
                       "decode", "model"),
    # prompt 3: blocks 1-3 of (1, 4) wholly masked for every step
    "masked-blocks-1x4": ("qwen3-1.7b", dict(n_kv_heads=2), (1, 4), 2, 3,
                          32, "decode", "model"),
}


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


def _cfgs(name, kw):
    return (replace(jbase.smoke_config(jbase.get_config(name)), **kw),
            replace(base.smoke_config(base.get_config(name)), **kw))


@lru_cache(maxsize=None)
def _jref(name, kw):
    """The reference's params, prefill and decode step for a smoke config
    (jitted once for the module)."""
    jc, _ = _cfgs(name, dict(kw))
    jp = _np(jax.jit(lambda k: jlm.init_lm(jc, k)[0])(jax.random.PRNGKey(0)))
    return (jp, jax.jit(partial(jlm.prefill, jc), static_argnames="max_len"),
            jax.jit(partial(jlm.decode_step, jc)))


def _rules(c, shape, B, kind):
    mesh = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    return shd.rules_for(mesh, c, batch=B, kind=kind)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _check_state(st, jst):
    got = decode_state_to_jax(decode_state_from_mesh(st))
    assert sorted(got) == sorted(jst)
    assert got["index"] == np.asarray(jst["index"])
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(jst[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_prefill_and_decode_match_reference(case):
    """Prefill on the mesh, then greedy steps: each step's logits and the
    state (gathered) against the reference's unsharded ones; the state's
    blocks stay where prefill put them (fixed ``data_ptr``s), each
    shard's ``index`` on its device."""
    name, kw, shape, B, S, max_len, kind, seq = CASES[case]
    jc, c = _cfgs(name, kw)
    jp, jpre, jdec = _jref(name, tuple(sorted(kw.items())))
    toks = np.random.default_rng(len(case)).integers(
        0, c.vocab, (B, S)).astype(np.int32)
    jst, jlog = jpre(jp, tokens=jnp.asarray(toks), max_len=max_len)
    rules = _rules(c, shape, B, kind)
    assert rules.act_rules["kv_seq"] == seq or "k" not in jst
    p = lm_to_mesh(lm_from_jax(jp), c, rules)
    with torch.no_grad(), shd.axis_rules(rules):
        st, logits = lm.prefill(c, p, tokens=_t(toks), max_len=max_len)
        _close(logits, jlog)
        _check_state(st, jst)
        ptrs = [b.data_ptr() for t in st.values() for b in t.blocks]
        for _ in range(STEPS):
            nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
            jlog, jst = jdec(jp, jst, jnp.asarray(nxt))
            logits, st2 = lm.decode_step(c, p, st, _t(nxt))
            assert st2 is st
            _close(logits, jlog)
    _check_state(st, jst)
    assert [b.data_ptr() for t in st.values() for b in t.blocks] == ptrs
    assert all(int(i) == S + STEPS for i in st["index"].blocks)
    if seq is not None:
        k = st["k"]
        blocks = {sl[3].start for sl in k.sharding.slices(k.shape)}
        assert len(blocks) == shape[0 if seq == "data" else 1]


def test_reference_state_decodes_on_a_mesh():
    """The reference's state after its prefill crosses to the port
    (``decode_state_from_jax``), onto the mesh (``decode_state_to_mesh``)
    and back bitwise, and a step on the mesh continues it as the
    reference's step does."""
    name, kw = "zamba2-1.2b", {}
    jc, c = _cfgs(name, kw)
    jp, jpre, jdec = _jref(name, ())
    toks = np.random.default_rng(5).integers(0, c.vocab, (1, 21)).astype(
        np.int32)
    jst, jlog = jpre(jp, tokens=jnp.asarray(toks), max_len=32)
    rules = _rules(c, (2, 2), 1, "decode")
    st = decode_state_to_mesh(decode_state_from_jax(_np(jst)), c, rules)
    assert tuple(st["k"].sharding.spec) == (None, None, "model", "data",
                                            None)
    assert tuple(st["ssm"].sharding.spec) == (None, None, "model", None,
                                              None)
    back = decode_state_to_jax(decode_state_from_mesh(st))
    assert all(np.array_equal(back[k], np.asarray(jst[k])) for k in back)
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jlog, jst = jdec(jp, jst, jnp.asarray(nxt))
    with torch.no_grad(), shd.axis_rules(rules):
        logits, st = lm.decode_step(c, lm_from_jax(jp), st, _t(nxt))
    _close(logits, jlog)
    _check_state(st, jst)


def test_whole_state_under_mesh_rules_raises():
    _, c = _cfgs("qwen3-1.7b", {})
    p = lm.init_lm(c, torch.Generator().manual_seed(0))
    st = lm.init_decode_state(c, 4, 8)
    with shd.axis_rules(_rules(c, (2, 2), 4, "decode")):
        with pytest.raises(TypeError, match="decode_state_to_mesh"):
            lm.decode_step(c, p, st, torch.zeros(4, dtype=torch.int32))
