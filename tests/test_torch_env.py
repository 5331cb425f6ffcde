"""The port's edge–cloud simulator (``repro_torch.core.env``) against the
reference's, bitwise: every platform x network profile x ``quantize``,
seeded random actions over a horizon with a ``reset(seed=)`` in the
middle; obs, reward, done, info and ``summary()`` equal to the last bit;
the constants field by field; ``utility_to_accuracy`` and
``battery_hours``."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import env as jenv  # noqa: E402
from repro.models import audio_encoder as jae  # noqa: E402
from repro_torch.core import env  # noqa: E402
from repro_torch.models.audio_encoder import AudioEncCfg  # noqa: E402

HORIZON = 60
RESET_AT = 15       # the second episode runs past its horizon
SMALL = dict(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2), d_embed=32,
             groups=4, frames=97)


def _same(a, b, what):
    """Equal to the last bit (numpy arrays, floats, bools, dicts)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k}]")
        return
    assert type(a) is type(b), (what, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, a, b)
    else:
        assert a == b, (what, a, b)


def _pair(**cfg):
    small = cfg.pop("small", False)
    enc_kw = SMALL if small else {}
    return (env.EdgeCloudEnv(env.EnvCfg(enc=AudioEncCfg(**enc_kw), **cfg)),
            jenv.EdgeCloudEnv(jenv.EnvCfg(enc=jae.AudioEncCfg(**enc_kw),
                                          **cfg)))


def _roll(e, actions, quantize, reset_at, reset_seed):
    out = [e.reset(seed=3)]
    for t, a in enumerate(actions):
        if t == reset_at:
            out.append(e.summary())
            out.append(e.reset(seed=reset_seed))
        out.append(e.step(a, quantize=quantize))
    out.append(e.summary())
    out.append((e.bw, e.cpu, e.cpu_loaded, e.u, e.offload_ema, e.t))
    return out


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("net", sorted(jenv.NET_PROFILES))
@pytest.mark.parametrize("platform", sorted(jenv.PLATFORMS))
def test_env_bitwise_against_reference(platform, net, quantize):
    got_env, want_env = _pair(platform=platform, net=net, horizon=HORIZON,
                              seed=11)
    rng = np.random.default_rng(zlib.crc32(f"{platform}/{net}/{quantize}"
                                           .encode()))
    # every k, and out-of-range ones (the env clips them)
    actions = rng.integers(-1, got_env.L + 2, size=HORIZON + 20)
    got = _roll(got_env, actions, quantize, RESET_AT, 1234)
    want = _roll(want_env, actions, quantize, RESET_AT, 1234)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, tuple):
            assert len(g) == len(w)
            for j, (a, b) in enumerate(zip(g, w)):
                _same(a, b, f"item {i}.{j}")
        else:
            _same(g, w, f"item {i}")
    # the episode ended inside the horizon and the done flags agree
    dones = [x[2] for x in got if isinstance(x, tuple) and len(x) == 4]
    assert any(dones)


def test_small_encoder_env_and_step_costs():
    """The edge trainer's small encoder (``EnvCfg(enc=ENC)`` of the edge
    loop): the same wire table, flops and costs for every k."""
    got, want = _pair(small=True, net="variable", horizon=20, seed=5)
    assert got.L == want.L == 4
    _same(got.flops, want.flops, "flops")
    _same(got.wire_int8, want.wire_int8, "wire_int8")
    _same(got.wire_fp32, want.wire_fp32, "wire_fp32")
    for k in range(got.L + 1):
        for q in (True, False):
            _same(got.step_costs(k, quantize=q),
                  want.step_costs(k, quantize=q), f"costs k={k}")
            _same(got.utility(k, False, quantize=q),
                  want.utility(k, False, quantize=q), f"utility k={k}")
    _same(got.utility(3, True), want.utility(3, True), "dropped utility")


def test_constants_field_by_field():
    for name in ("TRAIN_FLOP_MULT", "SERVER_FLOPS", "SERVER_BASE_MS",
                 "RAW_PCM_BYTES", "EMBED_BYTES", "ACC_EDGE_ONLY",
                 "ACC_SERVER"):
        _same(getattr(env, name), getattr(jenv, name), name)
    assert env.PLATFORMS.keys() == jenv.PLATFORMS.keys()
    for k in jenv.PLATFORMS:
        assert dataclasses.astuple(env.PLATFORMS[k]) == \
            dataclasses.astuple(jenv.PLATFORMS[k])
    assert dataclasses.astuple(env.PI4) == dataclasses.astuple(jenv.PI4)
    assert dataclasses.astuple(env.M2) == dataclasses.astuple(jenv.M2)
    assert list(env.NET_PROFILES) == list(jenv.NET_PROFILES)
    for k in jenv.NET_PROFILES:
        assert dataclasses.astuple(env.NET_PROFILES[k]) == \
            dataclasses.astuple(jenv.NET_PROFILES[k])
    # positional order of NetProfile's fields (``_adaptation_time`` builds
    # one positionally)
    assert [f.name for f in dataclasses.fields(env.NetProfile)] == \
        [f.name for f in dataclasses.fields(jenv.NetProfile)]
    assert [f.name for f in dataclasses.fields(env.Platform)] == \
        [f.name for f in dataclasses.fields(jenv.Platform)]
    got, want = env.EnvCfg(), jenv.EnvCfg()
    for f in dataclasses.fields(jenv.EnvCfg):
        if f.name == "enc":
            assert dataclasses.astuple(got.enc) == dataclasses.astuple(
                want.enc)
        else:
            _same(getattr(got, f.name), getattr(want, f.name), f.name)
    assert [f.name for f in dataclasses.fields(env.EnvCfg)] == \
        [f.name for f in dataclasses.fields(jenv.EnvCfg)]
    assert env.EdgeCloudEnv.BW_NORM == jenv.EdgeCloudEnv.BW_NORM


def test_accuracy_and_battery_maps():
    for u in np.linspace(-0.5, 1.5, 41):
        _same(env.utility_to_accuracy(float(u)),
              jenv.utility_to_accuracy(float(u)), f"acc({u})")
    for e in (0.0, 1e-12, 12.4, 67.4, 89.3, 187.2, 1e4):
        _same(env.battery_hours(e), jenv.battery_hours(e), f"bat({e})")
        _same(env.battery_hours(e, wh=10.0, fps=5.0),
              jenv.battery_hours(e, wh=10.0, fps=5.0), f"bat({e}, kw)")


def test_gateway_normalises_bandwidth_as_the_env():
    """The gateway's observation divides the bandwidth by the env's
    ``BW_NORM`` (one definition), and clips at 1 as the env does."""
    from repro_torch.api import FrameRequest, StreamSplitGateway
    from repro_torch.api import gateway as gw_mod
    from repro_torch.models.audio_encoder import init_audio_encoder
    assert gw_mod.EdgeCloudEnv is env.EdgeCloudEnv

    seen = []

    class Spy:
        L = 4

        def decide(self, obs):
            seen.append(obs.copy())
            return np.zeros(len(obs), np.int64)

    cfg = AudioEncCfg(**SMALL)
    gw = StreamSplitGateway(cfg, init_audio_encoder(
        cfg, torch.Generator().manual_seed(0)), policy=Spy(), capacity=4,
        window=8, qos_reserve=0, device="cpu")
    e = env.EdgeCloudEnv(env.EnvCfg(enc=cfg, net="wifi"))
    sid = gw.open_session().sid
    mel = np.zeros((cfg.frames, cfg.n_mels), np.float32)
    for bw in (e.bw, 12.5, 49.9, 50.0, 75.0):
        e.bw = bw
        gw.submit(sid, FrameRequest(t=len(seen), mel=mel, u=0.3, cpu=0.5,
                                    bandwidth_mbps=bw))
        gw.tick()
        want = np.array([0.3, 0.5, min(bw / env.EdgeCloudEnv.BW_NORM, 1.0)],
                        np.float32)
        np.testing.assert_array_equal(seen[-1][0], want)
        assert seen[-1][0][2] == e._obs()[2]
