"""The port's audio encoder against the reference, on weights converted
with ``params_from_jax``.

Tolerance: atol 1e-5.  Both run float32 on the CPU, but torch's
convolutions and reductions sum in another order than XLA's, so bitwise
equality across the frameworks is not a contract; a layout or padding
error shows up as O(1).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import audio_encoder as jenc  # noqa: E402
from repro_torch.configs.streamsplit_audio import CFG as FULL  # noqa: E402
from repro_torch.models import audio_encoder as enc  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2), n_mels=32,
             frames=40, d_embed=32, groups=4)
CFG, JCFG = enc.AudioEncCfg(**SMALL), jenc.AudioEncCfg(**SMALL)
L = CFG.n_blocks
ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: jenc.init_audio_encoder(
        JCFG, k))(jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp)


def _mel(B, cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.frames, cfg.n_mels)).astype(np.float32)


def _reference_chain(jp, mel):
    """The reference's activation after the stem and each of blocks
    1..L, and its embedding: the reference's encode(start, end) takes
    the raw mel at start=0 and chain[start] otherwise, and gives
    chain[end], or the embedding when end == L."""
    x = jenc.apply_stem(JCFG, jp, mel)
    chain = [np.array(x)]
    for i in range(L):
        x = jenc.apply_block(JCFG, jp["blocks"][i], x, JCFG.strides[i])
        chain.append(np.array(x))
    return chain, np.asarray(jenc.apply_head(JCFG, jp, x))


@pytest.mark.parametrize("start", range(L + 1))
def test_encode_every_split_matches_reference(params, start):
    jp, tp = params
    mel = _mel(3, CFG, seed=start)
    chain, z = _reference_chain(jp, mel)
    x = torch.from_numpy(mel if start == 0 else chain[start])
    for end in range(start, L + 1):
        ref = z if end == L else chain[end]
        out = enc.encode(CFG, tp, x,
                         start=start, end=end).numpy()
        assert out.shape == ref.shape, (start, end)
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL,
                                   err_msg=f"start={start} end={end}")


def test_full_width_forward_matches_reference():
    """The paper's AudioEncCfg() at B=2 (weights drawn by the port and
    handed to the reference, which is quicker than the reference's own
    per-tensor init at this width)."""
    assert FULL == enc.AudioEncCfg() and FULL.n_blocks == 8
    tp = enc.init_audio_encoder(FULL, torch.Generator().manual_seed(3))
    mel = _mel(2, FULL, seed=3)
    ref = np.asarray(jax.jit(lambda p, a: jenc.encode(
        jenc.AudioEncCfg(), p, a))(params_to_jax(tp), mel))
    out = enc.encode(FULL, tp, torch.from_numpy(mel))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("T,K,s,pad", [(100, 3, 2, (0, 1)), (50, 3, 2, (0, 1)),
                                       (25, 3, 2, (1, 1)), (100, 7, 1, (3, 3)),
                                       (100, 1, 2, (0, 0)), (40, 3, 1, (1, 1))])
def test_same_padding_is_xla_asymmetric(T, K, s, pad):
    assert enc._same_pad(T, K, s) == pad
    x = np.random.default_rng(T).normal(size=(1, T, 4)).astype(np.float32)
    w = np.random.default_rng(K).normal(size=(K, 4, 5)).astype(np.float32)
    ref = np.asarray(jenc._conv1d(x, w, s))
    out = enc._conv1d(torch.from_numpy(x).transpose(1, 2),
                      torch.from_numpy(w.transpose(2, 1, 0).copy()), s)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, atol=1e-5)


def test_weight_conversion_round_trips(params):
    jp, tp = params
    back = params_to_jax(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert tp["stem"]["w"].shape == (16, 32, 7)      # (Cout, Cin, K)
    assert tp["head"]["w"].shape == (32, 32)         # (Cin, d)


def test_init_matches_reference_shapes_and_scale():
    tp = enc.init_audio_encoder(FULL, torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda k: jenc.init_audio_encoder(
        jenc.AudioEncCfg(), k), jax.random.PRNGKey(0))
    assert [np.shape(a) for a in jax.tree.leaves(params_to_jax(tp))] \
        == [a.shape for a in jax.tree.leaves(ref)]
    w = tp["blocks"][7]["conv2"]["w"]
    bound = 2.0 / np.sqrt(3 * 512)                    # ±2σ, σ = 1/√(k·cin)
    assert float(w.abs().max()) <= bound + 1e-7
    assert abs(float(w.std()) * np.sqrt(3 * 512) - 0.88) < 0.02


def test_cost_models_match_reference():
    for t, j in ((CFG, JCFG), (FULL, jenc.AudioEncCfg())):
        assert enc.block_flops(t) == jenc.block_flops(j)
        for db in (1, 4):
            assert enc.boundary_bytes(t, dtype_bytes=db) == \
                jenc.boundary_bytes(j, dtype_bytes=db)
