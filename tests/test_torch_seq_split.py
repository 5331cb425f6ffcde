"""The batch-1 prompt split over 'data' (context-parallel prefill) on
logical shards of the CPU, against the reference.

Under ``rules_for(mesh, cfg, batch=1, kind="decode")`` the activations'
``seq`` maps to 'data', and where the data shards divide the prompt each
holds and computes only its block of positions: ``lm.prefill_sharded``
embeds its block, ``attention_prefill_sharded`` meets k and v gathered
over 'data' from its q block's offset (the flash forward's ``q_offset``
on the card, the reference's ``_attend_dense`` / ``_attend_chunked``
with ``q_pos = off + arange`` here), ``mamba_forward_sharded`` passes
the SSM state from block to block, an MoE layer takes the gathered
prompt.  Each case: prefill, then 4 greedy decode steps; the logits and
the gathered decode state against the reference's unsharded jitted
``prefill`` / ``decode_step`` at rtol = atol = 1e-5 (as
``test_torch_sharded_decode.py``), float32 throughout (no case needed
float64).  Plus the plain kernel version's ``q_offset`` against the
reference's ``_attend_dense`` / ``_attend_chunked``, and the structure:
each data shard's rows hold S / D positions; the SSM state and the
returned logits are bitwise equal across the data shards.
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
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mlp as mlp_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.weights import (decode_state_from_mesh,  # noqa: E402
                                 decode_state_to_jax, lm_from_jax,
                                 lm_to_mesh)

RTOL = ATOL = 1e-5
STEPS = 4
# name: (config, overrides, mesh (data, model), prompt, max_len); batch 1
# under rules_for(kind="decode") throughout
CASES = {
    # blocks of 12: the edge falls inside the SSM's first chunk of 16
    "zamba2-2x2": ("zamba2-1.2b", {}, (2, 2), 24, 32),
    "mamba2-2x2": ("mamba2-780m", {}, (2, 2), 24, 32),
    # blocks of 2, shorter than the conv's W-1 = 3: the halo spans blocks
    "mamba2-4x1-short-blocks": ("mamba2-780m", {}, (4, 1), 8, 16),
    # blocks of 20 over chunks of 16: edges inside the second and third
    "mamba2-2x1-chunk-edge": ("mamba2-780m", {}, (2, 1), 40, 48),
    # a prompt over attn_chunk (32): the chunked plain path, q at 20
    "qwen3-2x1": ("qwen3-1.7b", {}, (2, 1), 40, 48),
    # the window of 16 and the soft-caps cross the block edge at 19
    "gemma2-2x1-window": ("gemma2-2b", {}, (2, 1), 38, 48),
    # moe_ep over 'model' on the prompt gathered over 'data'
    "arctic-2x2": ("arctic-480b", {}, (2, 2), 24, 32),
    # 21 does not split 2 ways: the whole prompt on every data shard
    "zamba2-2x2-odd": ("zamba2-1.2b", {}, (2, 2), 21, 32),
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
def _jref(name):
    """The reference's params, prefill and decode step for a smoke config
    (jitted once for the module)."""
    jc, _ = _cfgs(name, {})
    jp = _np(jax.jit(lambda k: jlm.init_lm(jc, k)[0])(jax.random.PRNGKey(0)))
    return (jp, jax.jit(partial(jlm.prefill, jc), static_argnames="max_len"),
            jax.jit(partial(jlm.decode_step, jc)))


def _rules(c, shape):
    mesh = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    return shd.rules_for(mesh, c, batch=1, kind="decode")


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _check_state(st, jst):
    got = decode_state_to_jax(decode_state_from_mesh(st))
    assert sorted(got) == sorted(jst)
    assert got["index"] == np.asarray(jst["index"])
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(jst[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


class _Rows:
    """Records the rows (their sequence length) each sharded layer of the
    prefill is handed, by layer kind."""

    def __init__(self, monkeypatch):
        self.seen = {}
        # each layer's function and the place of its rows among its args
        for mod, name, at in ((attn_mod, "attention_prefill_sharded", 3),
                              (ssm_mod, "mamba_forward_sharded", 3),
                              (mlp_mod, "apply_mlp_sharded", 2),
                              (lm.moe_mod, "apply_moe_sharded", 3)):
            monkeypatch.setattr(mod, name, self._wrap(
                name, getattr(mod, name), at))

    def _wrap(self, name, fn, at):
        def recorded(*a, **kw):
            self.seen.setdefault(name, set()).update(
                x.shape[1] for x in a[at])
            return fn(*a, **kw)
        return recorded


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_prefill_and_decode_match_reference(case, monkeypatch):
    """Batch-1 prefill with the prompt's positions split over 'data',
    then greedy steps: each step's logits and the gathered state against
    the reference's unsharded ones.  Each data shard's sharded layers see
    S / D rows (the MoE layer the gathered S): an attention family, ssm,
    hybrid and moe; each shard's prefill logits and its block of the SSM
    state are bitwise the other data shards'."""
    name, kw, shape, S, max_len = CASES[case]
    jc, c = _cfgs(name, kw)
    jp, jpre, jdec = _jref(name)
    toks = np.random.default_rng(len(case)).integers(
        0, c.vocab, (1, S)).astype(np.int32)
    jst, jlog = jpre(jp, tokens=jnp.asarray(toks), max_len=max_len)
    rules = _rules(c, shape)
    assert rules.act_rules["seq"] == "data"
    lay = shd.ShardLayout(rules)
    D = shape[0]
    split = S % D == 0
    assert lay.seq_starts(S) == (
        [i // shape[1] * (S // D) for i in range(lay.n)] if split else None)
    p = lm_to_mesh(lm_from_jax(jp), c, rules)
    rows = _Rows(monkeypatch)
    with torch.no_grad(), shd.axis_rules(rules):
        st = lm.init_decode_state_sharded(lay, c, 1, max_len)
        blocks = lm.prefill_sharded(lay, c, lm._laid_out(c, p, lay), st,
                                    tokens=lay.batch_blocks(_t(toks)))
        monkeypatch.undo()
        logits = lm._gather_logits(lay, c, blocks)
        _close(logits, jlog, "prefill")
        _check_state(st, jst)
        for _ in range(STEPS):
            nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
            jlog, jst = jdec(jp, jst, jnp.asarray(nxt))
            logits, _ = lm.decode_step(c, p, st, _t(nxt))
            _close(logits, jlog, "decode")
    _check_state(st, jst)
    n = S // D if split else S
    for layer, seen in rows.seen.items():
        want = S if layer == "apply_moe_sharded" else n
        assert seen == {want}, (layer, seen)
    fam = c.family
    assert ("attention_prefill_sharded" in rows.seen) == (fam != "ssm")
    assert ("mamba_forward_sharded" in rows.seen) == (fam in ("ssm",
                                                              "hybrid"))
    assert ("apply_moe_sharded" in rows.seen) == (fam == "moe")
    # the data shards of each model rank: bitwise the same logits and
    # SSM state
    by_rank = {}
    for i, r in enumerate(lay.rank):
        by_rank.setdefault(r, []).append(i)
    for members in by_rank.values():
        first = members[0]
        for i in members[1:]:
            assert torch.equal(blocks[i], blocks[first])
            for k in ("ssm", "conv"):
                if k in st:
                    assert torch.equal(st[k].blocks[i], st[k].blocks[first])


# (B, H, KV, Sq, Sk, q_offset): offsets 0, 37 and Sk - Sq, a block whose
# last row sees short of Sk, GQA
REF_CASES = [(1, 4, 4, 20, 60, 0), (2, 4, 2, 23, 60, 37),
             (1, 4, 1, 25, 60, 35), (1, 6, 2, 16, 64, 10),
             (1, 2, 2, 40, 40, 0)]


@pytest.mark.parametrize("shape", REF_CASES)
@pytest.mark.parametrize("chunked", [False, True])
def test_ref_q_offset_matches_reference_attend(shape, chunked):
    """``flash_attention_ref`` with ``q_offset`` (the plain version of the
    forward kernel, and what a CPU tensor gets from
    ``flash_attention_fwd``) against the reference's ``_attend_dense`` /
    ``_attend_chunked`` with ``q_pos = off + arange(Sq)`` over ``k_pos =
    arange(Sk)``, at 1e-5."""
    B, H, KV, Sq, Sk, off = shape
    hd = 16
    rng = np.random.default_rng(sum(shape))
    q = rng.normal(size=(B, H, Sq, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, Sk, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, Sk, hd)).astype(np.float32)
    jc = replace(jbase.smoke_config(jbase.get_config("qwen3-1.7b")),
                 n_heads=H, n_kv_heads=KV, head_dim=hd)
    args = (jc, jnp.asarray(q).transpose(0, 2, 1, 3),
            jnp.asarray(k).transpose(0, 2, 1, 3),
            jnp.asarray(v).transpose(0, 2, 1, 3),
            off + jnp.arange(Sq), jnp.arange(Sk), None)
    want = (jattn._attend_chunked(*args, 16) if chunked
            else jattn._attend_dense(*args))
    got, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True,
                                      q_offset=off)
    assert fa.flash_attention_fwd.launches == 0
    _close(got.transpose(1, 2), want)
    o2, lse2 = fa.flash_attention_ref(_t(q), _t(k), _t(v), True, None, off)
    assert torch.equal(o2, got) and torch.equal(lse2, lse)
    # row i's lse is the logsumexp of its first off + i + 1 scores
    s = torch.einsum("bhqd,bhkd->bhqk", _t(q), _t(k).repeat_interleave(
        H // KV, 1)) / hd ** 0.5
    i = Sq - 1
    np.testing.assert_allclose(
        lse[..., i].numpy(),
        torch.logsumexp(s[..., i, :off + i + 1], -1).numpy(), rtol=1e-6)


def test_q_offset_refused_without_mask_or_below_zero():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_fwd(q, q, q, causal=False, q_offset=2)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_fwd(q, q, q, q_offset=-1)


def test_offset_route_refuses_a_gradient():
    """The kernel route with an offset calls the forward alone: asked for
    a gradient it raises rather than drop the offset."""
    _, c = _cfgs("qwen3-1.7b", {})
    q = torch.zeros(1, 4, 4, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="offset"):
        attn_mod._attend_kernel(c, q, q, q, 4)
