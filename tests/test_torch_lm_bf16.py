"""The bf16 LM (``dtype`` and ``param_dtype`` bf16, as the dry-run sets
them) against the reference's, on the CPU, and the bf16 carry-across.

2-layer smoke configs of qwen3-1.7b (qk-norm, GQA) and kimi-k2 (its
leading dense layer and one MoE layer with a shared expert), the
reference's weights carried across bit for bit (``weights.lm_from_jax``
keeps bf16 leaves bf16, through their ``uint16`` view).  Both packages
round every product and activation to bf16, in orders of their own (XLA's
dots against torch's matmuls on the CPU), so the bf16 bars are set from a
bf16 ulp, 2^-7 of a value's magnitude at most: the hidden states, logits
and gradients within 4 ulps of their max |x| (measured: 4.9e-3 to 9.2e-3,
about one ulp, after two layers), the loss within 2e-3 (measured: 1.4e-4
to 4.5e-4; a float32 mean of log-sums of bf16 logits, whose roundings
average out).  The same runs in float32 hold the existing 1e-4 (and
``test_torch_trainer.py``'s 1e-5 for gradients).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import get_optimizer as get_joptimizer  # noqa: E402
from repro.runtime import trainer as jtr  # noqa: E402
from repro_torch.checkpoint.serial import _paths  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.sgd import value_and_grad  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402
from repro_torch.weights import (decode_state_from_jax,  # noqa: E402
                                 decode_state_to_jax, lm_from_jax, lm_to_jax,
                                 train_state_from_jax, train_state_to_jax)

NAMES = ("qwen3-1.7b", "kimi-k2-1t-a32b")
DTYPES = ("bfloat16", "float32")
BF16_ULP = 2.0 ** -7     # of a value's magnitude, at most
BF16_RTOL = 4 * BF16_ULP
BF16_LOSS_RTOL = 2e-3
F32_RTOL = 1e-4
# a leaf's gradient against jax.grad's, of the leaf's max |g|: float32 as
# test_torch_trainer.py holds it; bf16 a few ulps (every product of the
# backward rounds to bf16, in each framework's own order)
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 4 * BF16_ULP}
# the update is held where |g| is above this share of its leaf's max (8
# times the bf16 gradient bar: the sign of g is certain there), and at
# least this many such elements a leaf, on average, must have moved
UPD_GFRAC = 8 * GRAD_RTOL["bfloat16"]
UPD_MOVED = 4
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, dtype):
    kw = dict(n_layers=2, dtype=dtype, param_dtype=dtype)
    return (replace(jbase.smoke_config(jbase.get_config(name)), **kw),
            replace(base.smoke_config(base.get_config(name)), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jinit(jc, seed):
    return _np(jax.jit(lambda k: jlm.init_lm(jc, k)[0])(
        jax.random.PRNGKey(seed)))


def _jstate(jc, optimizer, seed):
    """The reference's ``init_train_state`` (its params, the optimizer's
    initial state, step 0), each part jitted (its eager init is slow)."""
    params = _jinit(jc, seed)
    opt_init, _ = get_joptimizer(optimizer)
    return {"params": params, "opt": _np(jax.jit(opt_init)(params)),
            "step": np.zeros((), np.int32)}


def _batch(vocab, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _bar(dtype):
    return BF16_RTOL if dtype == "bfloat16" else F32_RTOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_and_loss_match_reference(name, dtype):
    jc, c = _cfgs(name, dtype)
    jp = _jinit(jc, 1)
    p = lm_from_jax(jp)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(jp)):
        assert str(a.dtype) == f"torch.{b.dtype}"
    batch = _batch(c.vocab, 1)
    toks = jnp.asarray(batch["tokens"])
    jh, _ = jlm.forward(jc, jp, tokens=toks)
    with torch.no_grad():
        h, _ = lm.forward(c, p, tokens=torch.from_numpy(batch["tokens"]))
        logits = lm.logits_from_hidden(c, p, h)
    assert h.dtype == c.xdtype
    assert _rel(h, jh) <= _bar(dtype)
    assert _rel(logits, jlm.logits_from_hidden(jc, jp, jh)) <= _bar(dtype)
    jloss, _ = jlm.lm_loss(jc, jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        loss, _ = lm.lm_loss(c, p, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= (
        BF16_LOSS_RTOL if dtype == "bfloat16" else F32_RTOL) * abs(
            float(jloss))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_one_adamw_step_matches_reference(name, dtype):
    """One step of both ``make_train_step``s (AdamW, remat, hybrid off, as
    the dry-run's ``TrainCfg``) from the same state and batch.

    - The gradients (``jax.grad`` against ``value_and_grad``) within
      ``GRAD_RTOL`` of each leaf's max; the loss and the gradient's norm
      as the forward's loss.
    - The moments: m = (1 - b1) g s and v = (1 - b2) (g s)^2, with s the
      clip scale 1 / ||g||, so m within ``GRAD_RTOL`` plus the norm's bar
      of the leaf's max m, and v within twice that of its max v.
    - The update p - p0, element by element, where the reference's
      gradient is above ``UPD_GFRAC`` of its leaf's max (there the sign
      of g, which is all that Adam's first step reads, is certain: the
      gradients' error is under ``GRAD_RTOL`` of the max).  Both compute
      p0 - lr g / (|g| + eps) in float32 and round it to the parameter's
      dtype, so they agree to one ulp of the parameter: bf16 2^-7 |p|,
      float32 2^-23 |p| (two of each, for the rounding of both sides).
      A skipped update (off by lr), a flipped sign (2 lr) or a wrong lr is
      many ulps wherever |p| is under 2^7 lr (bf16), which the
      ``UPD_MOVED`` elements of every leaf are required to be."""
    jc, c = _cfgs(name, dtype)
    lr = 1e-3
    kw = dict(optimizer="adamw", lr=lr, warmup=0, total_steps=10)
    jt, tt = jtr.TrainCfg(**kw), tr.TrainCfg(**kw)
    jstate = _jstate(jc, "adamw", 2)
    p0 = [_f32(x) for x in jax.tree.leaves(jstate["params"])]
    state = train_state_from_jax(jstate, "adamw")
    batch = _batch(c.vocab, 2)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jg = _np(jax.jit(jax.grad(lambda q: jlm.lm_loss(jc, q, jax.tree.map(
        jnp.asarray, batch))[0]))(jstate["params"]))
    _, g = value_and_grad(tr.make_loss_fn(c, tt), state["params"],
                          tbatch, None)
    for (k, want), got in zip(_paths(jg), g):
        assert _rel(got, want) <= GRAD_RTOL[dtype], k
    jp, jo, jm = jax.jit(jtr.make_train_step(jc, jt))(
        jstate["params"], jstate["opt"], batch, jnp.int32(0),
        jax.random.PRNGKey(3))
    p, o, m = tr.make_train_step(c, tt)(state["params"], state["opt"],
                                        tbatch, 0, None)
    loss_bar = BF16_LOSS_RTOL if dtype == "bfloat16" else F32_RTOL
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= loss_bar * abs(
            float(jm[key])), key
    assert int(o["step"]) == int(jo["step"]) == 1
    m_bar = GRAD_RTOL[dtype] + loss_bar
    for mom, bar in (("m", m_bar), ("v", 2 * m_bar)):
        for (k, got), want in zip(_paths(o[mom]), jax.tree.leaves(
                _np(jo[mom]))):
            assert got.dtype == torch.float32 and want.dtype == np.float32
            assert _rel(got, want) <= bar, (mom, k)
    ulps = 2 * (BF16_ULP if dtype == "bfloat16" else 2.0 ** -23)
    moved = 0
    for (k, got), want, g0, jgk in zip(
            _paths(p), jax.tree.leaves(_np(jp)), p0, jax.tree.leaves(jg)):
        assert str(got.dtype) == f"torch.{want.dtype}"
        got, want, jgk = _f32(got), _f32(want), _f32(jgk)
        sure = np.abs(jgk) > UPD_GFRAC * np.abs(jgk).max()
        assert sure.any(), k
        d = np.abs((got - g0) - (want - g0))[sure]
        scale = np.maximum(np.abs(want), np.abs(g0))[sure]
        assert (d <= ulps * scale).all(), (k, float(d.max()))
        moved += int(((want - g0)[sure] != 0).sum())
    assert moved >= UPD_MOVED * len(p0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference(name, dtype):
    """A prompt of 21 tokens into a state for 26, then 3 greedy steps fed
    the reference's tokens: each step's logits against the reference's
    (the bf16 KV cache written by both)."""
    jc, c = _cfgs(name, dtype)
    jp = _jinit(jc, 4)
    p = lm_from_jax(jp)
    toks = np.random.default_rng(4).integers(0, c.vocab, (B, 21)).astype(
        np.int32)
    jst, jlog = jax.jit(lambda q, t: jlm.prefill(jc, q, tokens=t,
                                                 max_len=26))(jp, toks)
    with torch.no_grad():
        st, logits = lm.prefill(c, p, tokens=torch.from_numpy(toks),
                                max_len=26)
    assert st["k"].dtype == c.xdtype
    assert _rel(logits, jlog) <= _bar(dtype)
    jdec = jax.jit(lambda q, s, t: jlm.decode_step(jc, q, s, t))
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        jlog, jst = jdec(jp, jst, nxt)
        with torch.no_grad():
            logits, st = lm.decode_step(c, p, st, torch.from_numpy(nxt))
        assert _rel(logits, jlog) <= _bar(dtype)
    assert int(st["index"]) == 24


@pytest.mark.parametrize("name", NAMES)
def test_bf16_carry_across_is_bitwise(name):
    """bf16 params, an AdamW and an Adafactor train state and a bf16
    decode state cross to the port and back bit for bit, in their
    dtypes."""
    jc, c = _cfgs(name, "bfloat16")
    jp = _jinit(jc, 5)
    back = lm_to_jax(lm_from_jax(jp))
    assert any(b.dtype == jnp.bfloat16 for b in jax.tree.leaves(jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for opt in ("adamw", "adafactor"):
        js = _jstate(jc, opt, 6)
        if opt == "adafactor":          # statistics that are not all zero
            js["opt"] = _np(jax.jit(lambda p, o: jadafactor.adafactor_update(
                p, p, o, lr=1e-3)[1])(js["params"], js["opt"]))
        got = train_state_to_jax(train_state_from_jax(js, opt), opt)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    jst = _np(jlm.init_decode_state(jc, B, 16))
    jst["k"] = np.asarray(jnp.asarray(
        np.random.default_rng(7).normal(size=jst["k"].shape),
        jnp.bfloat16))
    st = decode_state_from_jax(jst)
    assert st["k"].dtype == torch.bfloat16
    got = decode_state_to_jax(st)
    assert got["k"].tobytes() == jst["k"].tobytes()
