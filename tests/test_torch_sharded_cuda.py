"""The sharded fleet over two or more distinct CUDA devices.

The port's sessions mesh may name distinct cards; these tests hold that
layout where the machine has the cards and skip themselves otherwise
(the H100 machine of ``chip_smoke.py`` has one card, where phase 17
runs several shards as logical shards of it).  This file imports no
JAX: on the card the port is held against itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (FrameRequest, ShardedFleetBackend,  # noqa: E402
                             StreamSplitGateway)
from repro_torch.launch.mesh import make_sessions_mesh  # noqa: E402
from repro_torch.models.audio_encoder import (AudioEncCfg,  # noqa: E402
                                              init_audio_encoder)

CFG = AudioEncCfg(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2), n_mels=32,
                  frames=40, d_embed=32, groups=4)


def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more distinct CUDA devices")
    return make_sessions_mesh(2)


class SpreadPolicy:
    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.arange(len(obs_batch), dtype=np.int64) % (self.L + 1)


@pytest.mark.cuda
def test_two_card_mesh_rings_live_on_their_cards():
    mesh = two_cards()
    b = ShardedFleetBackend(capacity=4, window=4, dim=8, mesh=mesh)
    assert [blk.z.device for blk in b._blocks] == list(mesh.devices.flat)


@pytest.mark.cuda
def test_sharded_dispatch_over_two_cards():
    """Two cards: each shard's chains run on its own card, one sync and
    one D2H a card a tick, and the embeddings match one card's plane
    within 1e-4."""
    mesh = two_cards()
    params = init_audio_encoder(CFG, torch.Generator().manual_seed(0))
    L = CFG.n_blocks

    def gw_on(backend):
        return StreamSplitGateway(CFG, params, policy=SpreadPolicy(L),
                                  backend=backend, capacity=8, window=8,
                                  qos_reserve=0, device="cuda:0")
    two = gw_on(ShardedFleetBackend(capacity=8, window=8, dim=CFG.d_embed,
                                    mesh=mesh))
    one = gw_on(None)
    rng = np.random.default_rng(0)
    pairs = [(gw, [gw.open_session().sid for _ in range(6)])
             for gw in (two, one)]
    mels = [rng.normal(size=(CFG.frames, CFG.n_mels)).astype(np.float32)
            for _ in range(6)]
    outs = []
    for gw, sids in pairs:
        for sid, mel in zip(sids, mels):
            gw.submit(sid, FrameRequest(t=0, mel=mel))
        outs.append(gw.tick())
    for a, b in zip(*outs):
        assert (a.k, a.wire_bytes) == (b.k, b.wire_bytes)
        assert np.abs(a.z - b.z).max() <= 1e-4
    st = two.stats()
    assert st.device_syncs_per_tick == 2 and st.d2h_copies_per_tick == 2
