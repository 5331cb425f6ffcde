"""The port's ``SplitEngine`` against the reference's, stage by stage.

Across frameworks the edge activation agrees in all but its last bits
(torch and XLA sum convolutions in different orders).  Such a shift can
move one element across a .5 rounding tie of the INT8 wire and change
it by one quantization level (scale ≈ range/255), so the wire stage is
held BITWISE given the SAME input, and each float stage at atol 1e-5
given the same input.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.splitter import SplitEngine as JaxEngine  # noqa: E402
from repro.models import audio_encoder as jenc  # noqa: E402
from repro_torch.core.splitter import SplitEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import audio_encoder as enc  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402


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
def setup():
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: jenc.init_audio_encoder(
        JCFG, k))(jax.random.PRNGKey(0)))
    mel = np.random.default_rng(1).normal(
        size=(4, CFG.frames, CFG.n_mels)).astype(np.float32)
    return jp, params_from_jax(jp), mel, JaxEngine(JCFG)


@pytest.mark.parametrize("k", range(L + 1))
def test_split_equals_monolithic(setup, k):
    """Without the wire, edge(k) then server(k) IS the full encoder."""
    _, tp, mel, _ = setup
    eng = SplitEngine(CFG, quantize_wire=False, device="cpu")
    z, _ = eng.run_batch(tp, mel, k)
    full = enc.encode(CFG, tp, torch.from_numpy(mel))
    np.testing.assert_allclose(z.numpy(), full.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(eng.full(tp, mel).numpy(), full.numpy())


@pytest.mark.parametrize("quantize", [True, False])
def test_wire_bytes_match_reference_every_k(setup, quantize):
    jp, tp, mel, _ = setup
    jeng = JaxEngine(JCFG, quantize_wire=quantize)
    eng = SplitEngine(CFG, quantize_wire=quantize, device="cpu")
    for k in range(L + 1):
        assert eng.run_batch(tp, mel, k)[1] == jeng.run_batch(jp, mel, k)[1]
        assert eng.run_batch_async(tp, torch.from_numpy(mel), k)[1] == \
            jeng.run_batch(jp, mel, k)[1]
        assert eng.run(tp, mel, k)[1] == jeng.run(jp, mel, k)[1]


@pytest.mark.parametrize("k", range(L))
def test_stagewise_parity_with_reference(setup, k):
    jp, tp, mel, jeng = setup
    eng = SplitEngine(CFG, device="cpu")
    # edge stage: same mel in
    j_act = np.array(jeng._edge_exec(k)(jp, mel))
    t_act = eng._edge_fn(k, tp, torch.from_numpy(mel))
    np.testing.assert_allclose(t_act.numpy(), j_act, rtol=0, atol=ATOL)
    # wire stage: the reference's activation handed across -> bitwise
    j_rx = np.array(jeng._qdq_sample(j_act))
    t_rx = ops.wire_roundtrip(torch.from_numpy(j_act))
    np.testing.assert_array_equal(t_rx.numpy(), j_rx)
    # server stage: the same received activation in
    j_z = np.asarray(jeng._server_exec(k)(jp, j_rx))
    t_z = eng._server_fn(k, tp, torch.from_numpy(j_rx))
    np.testing.assert_allclose(t_z.numpy(), j_z, rtol=0, atol=ATOL)


def test_run_batch_async_equals_run_batch_bitwise(setup):
    """Kernel wrapper (plain version on the CPU) vs plain round trip."""
    _, tp, mel, _ = setup
    eng = SplitEngine(CFG, device="cpu")
    for k in range(L + 1):
        a, _ = eng.run_batch(tp, mel, k)
        b, _ = eng.run_batch_async(tp, torch.from_numpy(mel), k)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_run_b1_equals_run_batch_b1(setup):
    """Per-tensor and per-sample wire formats agree at B=1."""
    _, tp, mel, _ = setup
    eng = SplitEngine(CFG, device="cpu")
    for k in range(L + 1):
        np.testing.assert_array_equal(eng.run(tp, mel[:1], k)[0].numpy(),
                                      eng.run_batch(tp, mel[:1], k)[0].numpy())


def test_engine_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        assert SplitEngine(CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SplitEngine(CFG)
