"""The port's edge loop (``runtime/edge_loop.py::serve_stream``) against
the reference's ``examples/streamsplit_edge_train.py::serve_stream``,
loaded by path: one gateway session serving a stream a frame a tick
while the calibrated simulator prices each placement, at the edge
trainer's small encoder on the CPU.

The same encoder params (the reference's ``init_audio_encoder``,
converted with ``params_from_jax``) and the same mels; ``rule`` and
``server``, and ``rl`` built through the reference's ``make_policy`` with
the same actor-critic (the port's decisions behind the margin guard of
``tests/test_torch_ppo.py``).  The k sequences, env summaries, drops,
the gateway's counters and the session's transitions are equal;
embeddings agree within the gateway tests' atol 1e-4.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "_ref_streamsplit_edge_train",
    os.path.join(REPO, "examples", "streamsplit_edge_train.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

from repro.core import ppo as jppo  # noqa: E402
from repro.data.audio_stream import AudioStream, StreamCfg  # noqa: E402
from repro.models import audio_encoder as jenc  # noqa: E402
from repro_torch.api import policies  # noqa: E402
from repro_torch.runtime import edge_loop  # noqa: E402
from repro_torch.runtime.edge_train import ENC  # noqa: E402
from repro_torch.weights import params_from_jax, ppo_from_jax  # noqa: E402

FRAMES = 60
Z_ATOL = 1e-4
MARGIN = 1e-5
COUNTERS = ("ticks", "frames", "dispatches", "wire_bytes", "sync_bytes",
            "sync_events", "routed", "sessions_opened", "sessions_closed",
            "device_syncs_per_tick", "d2h_copies_per_tick",
            "staged_h2d_bytes")


@pytest.fixture(scope="module")
def setup():
    assert (ENC.widths, ENC.strides, ENC.d_embed, ENC.groups, ENC.frames) \
        == (ref.ENC.widths, ref.ENC.strides, ref.ENC.d_embed,
            ref.ENC.groups, ref.ENC.frames)
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: jenc.init_audio_encoder(
        ref.ENC, k))(jax.random.PRNGKey(3)))
    mels, ys, _ = AudioStream(StreamCfg(seed=1)).batch(FRAMES)
    mels = np.asarray(mels[:, :ENC.frames], np.float32)
    L = ENC.n_blocks
    rl = jax.tree.map(np.asarray, jppo.init_policy(
        jax.random.PRNGKey(5), 3, L + 1))
    rl["wp"] = rl["wp"] * 100.0
    rl["bp"] = np.linspace(-0.1, 0.1, L + 1).astype(np.float32)
    return jp, params_from_jax(jp), mels, np.asarray(ys), rl


def _ref_serve(kind, jp, mels, ys, rl, monkeypatch, **kw):
    """The reference's serve_stream, its k sequence and embeddings."""
    ks = []

    class Env(ref.EdgeCloudEnv):
        def step(self, k, **skw):
            ks.append(int(k))
            return super().step(k, **skw)

    monkeypatch.setattr(ref, "EdgeCloudEnv", Env)
    make = ref.make_policy
    monkeypatch.setattr(ref, "make_policy",
                        lambda k, L: make(k, L, rl_params=rl))
    zs = []
    tick = ref.StreamSplitGateway.tick

    def rec_tick(self, *a, **k):
        out = tick(self, *a, **k)
        zs.append(out[0].z)
        return out

    monkeypatch.setattr(ref.StreamSplitGateway, "tick", rec_tick)
    out = ref.serve_stream(kind, jp, mels, ys, **kw)
    monkeypatch.undo()
    return out, ks, zs


@pytest.mark.parametrize("net,seed", [("variable", 0), ("dropout", 4)])
@pytest.mark.parametrize("kind", ["rule", "server", "rl"])
def test_serve_stream_matches_reference(kind, net, seed, setup,
                                        monkeypatch):
    jp, tp, mels, ys, rl = setup
    margins = []
    decide = policies.RLPolicy.decide

    def guarded(self, obs_batch):
        with torch.no_grad():
            logits, _ = policies.policy_apply(self.params, torch.from_numpy(
                np.asarray(obs_batch, np.float32)))
        top2 = np.sort(logits.numpy(), axis=-1)[:, -2:]
        margins.extend((top2[:, 1] - top2[:, 0]).tolist())
        return decide(self, obs_batch)

    (js, jst, jinfo, jdrops), jks, jzs = _ref_serve(
        kind, jp, mels, ys, rl, monkeypatch, net=net, seed=seed)
    monkeypatch.setattr(policies.RLPolicy, "decide", guarded)
    results = []
    s, st, info, drops = edge_loop.serve_stream(
        kind, tp, mels, ys, net=net, seed=seed, device="cpu",
        rl_params=ppo_from_jax(rl), on_tick=lambda t, r, gw: results.append(r))
    if kind == "rl":
        assert len(margins) == FRAMES and min(margins) > MARGIN
    ks = [r.k for r in results]
    assert ks == jks and len(ks) == FRAMES
    if kind != "server":
        assert len(set(ks)) > 1                  # the placement moves
    assert [r.t for r in results] == list(range(FRAMES))
    assert s.keys() == js.keys()
    for k in js:
        assert type(s[k]) is type(js[k]) and s[k] == js[k], k
    assert drops == jdrops
    for name in COUNTERS:
        assert getattr(st, name) == getattr(jst, name), name
    assert (info.frames, info.wire_bytes, info.sync_bytes,
            info.transitions, info.last_k) == \
        (jinfo.frames, jinfo.wire_bytes, jinfo.sync_bytes,
         jinfo.transitions, jinfo.last_k)
    z = np.stack([r.z for r in results])
    assert z.dtype == np.float32 and z.shape == (FRAMES, ENC.d_embed)
    np.testing.assert_allclose(z, np.stack(jzs), rtol=0, atol=Z_ATOL)


def test_serve_stream_defaults_to_cuda_and_refuses_without_it(setup):
    import inspect
    assert inspect.signature(edge_loop.serve_stream).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tp, mels, ys, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        edge_loop.serve_stream("rule", tp, mels[:2], ys[:2])


def test_part3_line_is_the_reference_formula():
    s = {"kb_per_batch": 10.0, "energy_mj": 60.0, "utility": 0.9}
    s2 = {"kb_per_batch": 250.0, "energy_mj": 187.2, "utility": 0.95}
    assert edge_loop.part3_line(s, s2) == (
        "bandwidth 96.0% lower   energy 67.9% lower   accuracy 72.1% vs "
        "72.8%")
