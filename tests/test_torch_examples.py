"""The port's three gateway examples against the reference's.

``runtime/quickstart.py``, ``runtime/adaptive_serving.py`` and
``runtime/fleet_demo.py`` run beside ``examples/quickstart.py``,
``examples/adaptive_serving.py`` and ``examples/fleet_demo.py`` (loaded by
path and run as they are, their gateway's ``tick`` recorded), from the
reference's encoder weights (``params_from_jax``) and, where the example
refines, its head (``head_from_jax``) and refine draws
(``HostFleetBackend(draws=...)``: round r's directions and prior from
``split(fold_in(PRNGKey(seed), r))``, as the reference gateway draws
them).

- Each frame's ``(sid, t, k, route, wire_bytes, bucket_size)`` equal
  exactly, and each tick's device syncs and D2H copies;
- every ``GatewayStats`` counter equal exactly (the wall-clock ones
  aside);
- embeddings of frames that cross no wire at atol 1e-6 (measured: at
  most 2.7e-7); of frames that cross the INT8 wire, at atol 5e-4, and at
  most one in 20 of them beyond 1e-6 (measured: 1 of 38 in adaptive
  serving, up to 2.85e-4; 4 of 893 in the fleet demo's two rounds, up to
  3.09e-4; none of the quickstart's 4).  A last-bit difference of an
  edge activation (convolutions summed in another order) can move one
  element across a .5 tie of the wire; these examples' unit-variance mels
  give a wider range, so one INT8 level (range/255) reaches the embedding
  above ``test_torch_gateway.py``'s atol 1e-4;
- the refine losses at rtol 1e-4 and the head at rtol 1e-4 / atol 1e-6,
  as ``test_torch_gateway.py::test_refine_matches_reference_gateway``;
- the printed lines equal once every decimal number is masked (the
  numbers are checked above, or are host clocks).

The fleet demo runs 2 of its 6 rounds here (``ROUNDS`` set on both
modules alike), the other two demos at their own size.
"""
import importlib.util
import os
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import StreamSplitGateway as JaxGateway  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro.models import audio_encoder as jenc  # noqa: E402
from repro_torch.api import HostFleetBackend  # noqa: E402
from repro_torch.runtime import adaptive_serving, fleet_demo  # noqa: E402
from repro_torch.runtime import quickstart  # noqa: E402
from repro_torch.weights import head_from_jax, params_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z_ATOL, WIRE_ATOL, TIE_ATOL = 1e-6, 5e-4, 1e-6   # measured bounds
LOSS_RTOL = 1e-4
COUNTERS = ("ticks", "frames", "sessions_open", "sessions_opened",
            "sessions_closed", "admission_refusals", "dispatches",
            "wire_bytes", "sync_bytes", "sync_events", "refine_rounds",
            "routed", "backend", "shards", "shard_frames", "dispatch_shards",
            "dispatch_shard_frames", "snapshot_h2d_bytes",
            "ingest_h2d_bytes", "device_syncs_per_tick",
            "d2h_copies_per_tick", "staged_h2d_bytes", "sessions_exported",
            "sessions_imported")
FLEET_ROUNDS = 2
# the examples' encoder (the same in all three)
SMALL = dict(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2), n_mels=32,
             frames=40, d_embed=32, groups=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_example(name):
    """``examples/<name>.py`` as a fresh module (its top level runs)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tick_of(record):
    """A ``tick`` that records each tick's results, syncs and D2H."""
    def record_tick(self, *args, **kw):
        out = orig(self, *args, **kw)
        s = self.stats()
        record.append((self, out, s.device_syncs_per_tick,
                       s.d2h_copies_per_tick))
        return out
    orig = JaxGateway.tick
    return record_tick


def on_tick_of(record):
    def on_tick(gw, out):
        s = gw.stats()
        record.append((gw, out, s.device_syncs_per_tick,
                       s.d2h_copies_per_tick))
    return on_tick


def ref_params():
    """The examples' encoder weights, ``init_audio_encoder(CFG,
    PRNGKey(0))``, in the port's layout."""
    jp = jax.tree.map(np.asarray, jenc.init_audio_encoder(
        jenc.AudioEncCfg(**SMALL), jax.random.PRNGKey(0)))
    return params_from_jax(jp)


def ref_backend(mod, ref_mod, *, capacity, window, lr, seed=0):
    """The reference gateway's refine state for the port: its head
    (``head_init(PRNGKey(seed))``) and round r's SW draws."""
    head = head_from_jax(jax.tree.map(
        np.asarray, ref_mod.head_init(jax.random.PRNGKey(seed))))
    d = mod.CFG.d_embed

    def draws(r):
        kd, kp = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), r))
        return (np.array(jswd.random_directions(kd, 50, d)),
                np.array(jswd.sphere_prior_samples(kp, window, d)))
    return HostFleetBackend(capacity=capacity, window=window, dim=d,
                            head_init=lambda generator: head,
                            head_apply=mod.head_apply, lr=lr, seed=seed,
                            draws=draws, device="cpu")


def skeleton(text):
    """Printed text with every decimal number masked and spacing
    normalised (numpy pads arrays by their signs)."""
    s = re.sub(r"-?\d+\.\d*", "#", text)
    s = re.sub(r"\s+", " ", s)
    return re.sub(r"\[ ", "[", s)


def assert_ticks_match(got, want):
    assert len(got) == len(want)
    wire, ties = 0, 0
    for (_, out, syncs, d2h), (_, jout, jsyncs, jd2h) in zip(got, want):
        assert (syncs, d2h) == (jsyncs, jd2h)
        assert [(r.sid, r.t, r.k, r.route, r.wire_bytes, r.bucket_size)
                for r in out] == \
            [(r.sid, r.t, r.k, r.route, r.wire_bytes, r.bucket_size)
             for r in jout]
        for r, jr in zip(out, jout):
            dz = float(np.abs(r.z - np.asarray(jr.z)).max())
            if r.wire_bytes:
                wire += 1
                ties += dz > TIE_ATOL
                assert dz <= WIRE_ATOL, (r.sid, r.t, r.k, dz)
            else:
                assert dz <= Z_ATOL, (r.sid, r.t, r.k, dz)
    assert ties * 20 <= wire, (ties, wire)


def assert_stats_match(s, js):
    for c in COUNTERS:
        assert getattr(s, c) == getattr(js, c), c
    np.testing.assert_allclose(s.last_refine_loss, js.last_refine_loss,
                               rtol=LOSS_RTOL)


def test_quickstart_matches_reference(monkeypatch, capsys):
    jrec = []
    monkeypatch.setattr(JaxGateway, "tick", tick_of(jrec))
    ref_mod = load_example("quickstart")        # runs at import
    jout = capsys.readouterr().out
    rec = []
    got = quickstart.main(
        device="cpu", params=ref_params(), on_tick=on_tick_of(rec),
        backend=ref_backend(quickstart, ref_mod, capacity=8, window=32,
                            lr=1e-2))
    out = capsys.readouterr().out
    assert_ticks_match(rec, jrec)
    assert len(rec) == quickstart.N_FRAMES
    jgw = jrec[-1][0]
    assert_stats_match(rec[-1][0].stats(), jgw.stats())
    assert got["stats"].refine_rounds == 3
    assert (got["final"].frames, got["final"].transitions) == \
        (ref_mod.final.frames, ref_mod.final.transitions)
    np.testing.assert_allclose(
        rec[-1][0].backend.refiner.state.params["w"].numpy(),
        np.asarray(jgw.backend.refiner.state.params["w"]), rtol=LOSS_RTOL,
        atol=1e-6)
    assert skeleton(out) == skeleton(jout)


def test_adaptive_serving_matches_reference(monkeypatch, capsys):
    jrec = []
    monkeypatch.setattr(JaxGateway, "tick", tick_of(jrec))
    load_example("adaptive_serving").main()
    jout = capsys.readouterr().out
    rec = []
    got = adaptive_serving.main(device="cpu", params=ref_params(),
                                on_tick=on_tick_of(rec))
    out = capsys.readouterr().out
    assert_ticks_match(rec, jrec)
    assert len(rec) == adaptive_serving.N_TICKS
    # profile=True: one sync a bucket and one for the tick's copy
    for _, res, syncs, d2h in rec:
        assert syncs == len({r.k for r in res}) + 1 and d2h == 1
    s = got["stats"]
    assert_stats_match(rec[-1][0].stats(), jrec[-1][0].stats())
    assert got["escalation_rate"] == s.routed["split"] / s.frames
    assert [r.sid for r in got["results"]] == \
        [r.sid for _, res, _, _ in rec for r in res]
    assert skeleton(out) == skeleton(jout)


def test_fleet_demo_matches_reference(monkeypatch, capsys):
    jrec = []
    monkeypatch.setattr(JaxGateway, "tick", tick_of(jrec))
    ref_mod = load_example("fleet_demo")
    monkeypatch.setattr(ref_mod, "ROUNDS", FLEET_ROUNDS)
    monkeypatch.setattr(fleet_demo, "ROUNDS", FLEET_ROUNDS)
    ref_mod.main()
    jout = capsys.readouterr().out
    rec = []
    got = fleet_demo.main(
        device="cpu", params=ref_params(), on_tick=on_tick_of(rec),
        backend=ref_backend(fleet_demo, ref_mod,
                            capacity=fleet_demo.N_CLIENTS,
                            window=fleet_demo.WINDOW,
                            lr=fleet_demo.REFINE_LR))
    out = capsys.readouterr().out
    assert_ticks_match(rec, jrec)
    assert len(rec) == FLEET_ROUNDS * fleet_demo.FRAMES_PER_ROUND
    assert all((syncs, d2h) == (1, 1) for _, _, syncs, d2h in rec)
    jgw = jrec[-1][0]
    assert_stats_match(rec[-1][0].stats(), jgw.stats())
    assert got["stats"].refine_rounds == FLEET_ROUNDS
    assert got["dropped"] > 0 and got["simulated"] == \
        fleet_demo.N_CLIENTS * FLEET_ROUNDS * fleet_demo.FRAMES_PER_ROUND
    # each round's loss, as the reference prints it (4 decimals)
    jlosses = [float(m) for m in re.findall(r"refine loss=(-?\d+\.\d+)",
                                            jout)]
    np.testing.assert_allclose(got["round_losses"], jlosses, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(
        rec[-1][0].backend.refiner.state.params["w"].numpy(),
        np.asarray(jgw.backend.refiner.state.params["w"]), rtol=LOSS_RTOL,
        atol=1e-6)
    assert skeleton(out) == skeleton(jout)


def test_demos_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (quickstart.main, adaptive_serving.main, fleet_demo.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
