"""The port's streaming serving runtime (``repro_torch.serving``) on
the CPU: the oracles of the reference's ``tests/test_serving.py`` at its
tiny encoder — bounded QoS queues, the deadline-aware preempting
TickScheduler (every decision pinned with a fake clock), cross-tick
pipelined StreamServer bit-parity against the sequential port gateway,
QoS behaviour under synthetic overload, threaded ingest-vs-close stress
with a sequential-replay oracle — plus the RL policy behind the server, the
migration seams, tracing and the flight recorder, and one workload
through both packages' servers: the same schedule and counts,
embeddings within 1e-5.

Every thread join, close and stop has a finite timeout.
"""
import sys
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import QoSClass as JaxQoSClass  # noqa: E402
from repro.api import StreamSplitGateway as JaxGateway  # noqa: E402
from repro.models import audio_encoder as jenc  # noqa: E402
from repro.serving import SchedulerCfg as JaxSchedulerCfg  # noqa: E402
from repro.serving import StreamServer as JaxStreamServer  # noqa: E402
from repro_torch.api import (FrameRequest, QoSClass,  # noqa: E402
                             StreamSplitGateway, make_policy)
from repro_torch.core.ppo import init_policy  # noqa: E402
from repro_torch.models.audio_encoder import (AudioEncCfg,  # noqa: E402
                                              init_audio_encoder)
from repro_torch.obs import FlightRecorder, Tracer  # noqa: E402
from repro_torch.serving import (DEADLINE_MS, MAX_WAIT_MS,  # noqa: E402
                                 QoSQueues, QueueFullError, RateLimitError,
                                 SchedulerCfg, StreamServer, TickScheduler,
                                 TokenBucket)
from repro_torch.weights import params_from_jax  # noqa: E402

JOIN_S = 120.0          # every thread join waits at most this long

# tiny deep-ish encoder: 2 split points -> up to 3 buckets per tick,
# cheap enough that threaded tests stay fast
CFG = AudioEncCfg(widths=(8, 8), strides=(1, 1), n_mels=8, frames=8,
                  d_embed=16, groups=2)
L = CFG.n_blocks
I, S, B = QoSClass.INTERACTIVE, QoSClass.STANDARD, QoSClass.BULK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_audio_encoder(CFG, torch.Generator().manual_seed(0))


def _join(threads):
    for th in threads:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads), "a thread hung"


class FakeClock:
    """Manual clock: tests advance ``t`` explicitly, so every queue
    wait, deadline decision and SyncEvent timestamp is exact."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class QuantilePolicy:
    """Deterministic frame-content policy: u quantile -> split index.
    Position-independent, so a replayed schedule reproduces every k."""

    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.clip((obs_batch[:, 0] * (self.L + 1)).astype(np.int64),
                       0, self.L)


def _mel(rng):
    return rng.normal(size=(CFG.frames, CFG.n_mels)).astype(np.float32)


def _req(rng, t, u=None):
    return FrameRequest(t=t, mel=_mel(rng),
                        u=float(rng.random() if u is None else u))


def _gw(params, *, capacity=8, clock=None, policy=None, **kw):
    return StreamSplitGateway(
        CFG, params, policy=policy or QuantilePolicy(L), capacity=capacity,
        window=8, qos_reserve=0, device="cpu",
        **({"clock": clock} if clock is not None else {}), **kw)


# ---------------------------------------------------------------------------
# Queues: bounded, typed backpressure, conservation counters
# ---------------------------------------------------------------------------

def test_queue_bounded_rejects_with_typed_error():
    qs = QoSQueues(maxlen=2)
    f = FrameRequest(t=0, mel=np.zeros((2, 2), np.float32))
    qs.submit(0, f, B, now=0.0, deadline_s=1.0)
    qs.submit(0, f, B, now=0.0, deadline_s=1.0)
    with pytest.raises(QueueFullError) as ei:
        qs.submit(0, f, B, now=0.0, deadline_s=1.0)
    assert ei.value.qos is B and ei.value.maxlen == 2
    # the refusal is counted; the accepted count is untouched
    c = qs.counters()
    assert c["rejected"]["bulk"] == 1 and c["submitted"]["bulk"] == 2
    # other classes unaffected by a full bulk queue
    qs.submit(0, f, I, now=0.0, deadline_s=1.0)
    assert qs.depths() == {"interactive": 1, "standard": 0, "bulk": 2}


def test_queue_per_class_maxlen_override():
    qs = QoSQueues(maxlen=1, maxlens={B: 3})
    f = FrameRequest(t=0, mel=np.zeros((2, 2), np.float32))
    for _ in range(3):
        qs.submit(0, f, B, now=0.0, deadline_s=1.0)
    qs.submit(0, f, I, now=0.0, deadline_s=1.0)
    with pytest.raises(QueueFullError):
        qs.submit(0, f, I, now=0.0, deadline_s=1.0)


def test_requeue_front_preserves_identity_and_counts():
    qs = QoSQueues(maxlen=4)
    f = FrameRequest(t=0, mel=np.zeros((2, 2), np.float32))
    a = qs.submit(0, f, B, now=1.0, deadline_s=3.0)
    qs.submit(1, f, B, now=2.0, deadline_s=4.0)
    with qs.cond:
        got = qs.pop_locked(B)
        assert got is a                      # FIFO
        qs.requeue_front_locked(got)
        again = qs.pop_locked(B)
    assert again is a and again.preemptions == 1
    assert again.enq_s == 1.0 and again.deadline_s == 3.0   # untouched
    c = qs.counters()
    assert c["preempted"]["bulk"] == c["requeued"]["bulk"] == 1


# ---------------------------------------------------------------------------
# TickScheduler: priority, deadline monotonicity, preemption conservation
# (pure-Python deterministic — seeded sweeps in the repo's property style)
# ---------------------------------------------------------------------------

def _rand_submits(qs, cfg, rng, now, n, p=None):
    classes = [I, S, B]
    out = []
    for _ in range(n):
        qos = classes[rng.choice(3, p=p)]
        try:
            out.append(qs.submit(int(rng.integers(8)),
                                 FrameRequest(t=0, mel=np.zeros((1, 1),
                                                               np.float32)),
                                 qos, now=now,
                                 deadline_s=now + cfg.deadline_s(qos)))
        except QueueFullError:
            pass
    return out


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_priority_and_deadline_monotonicity(seed):
    """No admitted BULK frame while a higher-class frame still waits
    (absent aging — waits here never reach ``max_wait_ms``); within a
    class, admission follows nondecreasing deadlines inside a batch
    (the final sort is by arrival), and EDF holds across ticks globally
    for INTERACTIVE/BULK (plain FIFO) but per *session* for STANDARD —
    DRR may serve tenant B's older frame after tenant A's newer one,
    that is exactly the fairness trade."""
    rng = np.random.default_rng(seed)
    cfg = SchedulerCfg(max_batch=4)
    qs, sched = QoSQueues(maxlen=64), TickScheduler(cfg)
    now = 0.0
    last_deadline = {I: -np.inf, B: -np.inf}
    last_std = {}                            # sid -> last deadline
    for _ in range(12):
        _rand_submits(qs, cfg, rng, now, int(rng.integers(0, 9)))
        if rng.random() < 0.5:              # sometimes stage early
            sched.stage(qs)
            now += 0.01
            _rand_submits(qs, cfg, rng, now, int(rng.integers(0, 5)))
        batch = sched.admit(qs, now)
        assert len(batch) <= cfg.max_batch
        assert not any(f.promoted for f in batch), "no aging at these waits"
        if any(f.qos is B for f in batch):
            # the preemption pass emptied every higher-class queue first
            assert qs.depths()["interactive"] == 0
            assert qs.depths()["standard"] == 0
        seen = {q: -np.inf for q in QoSClass}
        for f in batch:
            assert f.deadline_s >= seen[f.qos], "EDF order inside a tick"
            seen[f.qos] = f.deadline_s
            if f.qos is S:
                assert f.deadline_s >= last_std.get(f.sid, -np.inf), \
                    "per-session EDF order across ticks (STANDARD)"
                last_std[f.sid] = f.deadline_s
        for q in (I, B):
            if seen[q] > -np.inf:
                assert seen[q] >= last_deadline[q], "EDF order across ticks"
                last_deadline[q] = seen[q]
        now += 0.02


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_preemption_conserves_frames(seed):
    """Under random overload every accepted frame is admitted exactly
    once or still queued/staged: re-queued frames are re-served, never
    dropped, and ``preempted == requeued`` throughout."""
    rng = np.random.default_rng(100 + seed)
    cfg = SchedulerCfg(max_batch=3)
    qs, sched = QoSQueues(maxlen=64), TickScheduler(cfg)
    admitted, accepted, now = [], 0, 0.0
    for _ in range(20):
        # arrivals before staging skew BULK; arrivals in the
        # stage->admit window skew INTERACTIVE — the preempting mix
        accepted += len(_rand_submits(qs, cfg, rng, now,
                                      int(rng.integers(0, 7)),
                                      p=[0.15, 0.15, 0.7]))
        sched.stage(qs)
        accepted += len(_rand_submits(qs, cfg, rng, now + 0.01,
                                      int(rng.integers(0, 4)),
                                      p=[0.7, 0.15, 0.15]))
        admitted.extend(sched.admit(qs, now + 0.02))
        c = qs.counters()
        assert c["preempted"] == c["requeued"]
        with qs.cond:
            waiting = qs.pending_locked()
        assert len(admitted) + waiting + len(sched.staged) == accepted
        now += 0.05
    # drain completely: conservation must close the books
    for _ in range(64):
        admitted.extend(sched.admit(qs, now))
    assert len(admitted) == accepted
    assert len({id(f) for f in admitted}) == accepted   # no double-serve
    c = qs.counters()
    assert sum(c["preempted"].values()) > 0, "overload must preempt"
    assert all(v == 0 for v in c["preempted"].values()
               if v != c["preempted"]["bulk"]), "only BULK is preemptible"


def test_scheduler_preempts_staged_bulk_for_interactive():
    """The pipelining window, explicitly: BULK frames staged under the
    in-flight tick get bumped (to the FRONT of their queue, deadlines
    intact) when INTERACTIVE frames arrive before launch."""
    cfg = SchedulerCfg(max_batch=2)
    qs, sched = QoSQueues(maxlen=8), TickScheduler(cfg)
    f = FrameRequest(t=0, mel=np.zeros((1, 1), np.float32))
    b1 = qs.submit(0, f, B, now=0.0, deadline_s=2.0)
    b2 = qs.submit(1, f, B, now=0.0, deadline_s=2.0)
    assert sched.stage(qs) == 2        # tick t in flight, both staged
    i1 = qs.submit(2, f, I, now=0.1, deadline_s=0.15)
    batch = sched.admit(qs, 0.2)
    assert batch == [i1, b1]                # newest-staged BULK was bumped
    assert b2.preemptions == 1
    c = qs.counters()
    assert c["preempted"]["bulk"] == 1 and c["requeued"]["bulk"] == 1
    assert sched.admit(qs, 0.3) == [b2]     # ... and served next tick
    misses = sched.deadline_misses
    assert misses["interactive"] == 1       # 0.2 > 0.15: counted at admit
    assert misses["bulk"] == 0


def test_scheduler_no_preemption_when_disabled():
    cfg = SchedulerCfg(max_batch=1, preempt_bulk=False)
    qs, sched = QoSQueues(maxlen=8), TickScheduler(cfg)
    f = FrameRequest(t=0, mel=np.zeros((1, 1), np.float32))
    b = qs.submit(0, f, B, now=0.0, deadline_s=9.0)
    sched.stage(qs)
    qs.submit(1, f, I, now=0.0, deadline_s=1.0)
    assert sched.admit(qs, 0.0) == [b]
    assert qs.counters()["preempted"]["bulk"] == 0


# ---------------------------------------------------------------------------
# SchedulerCfg: partial overrides merge with defaults (regression)
# ---------------------------------------------------------------------------

def test_scheduler_cfg_partial_override_merges_defaults():
    """``SchedulerCfg(deadline_ms={BULK: ...})`` used to lose the other
    classes' budgets and KeyError on their first submit."""
    cfg = SchedulerCfg(deadline_ms={B: 5000.0})
    assert cfg.deadline_s(B) == 5.0
    assert cfg.deadline_s(I) == DEADLINE_MS[I] * 1e-3   # no KeyError
    assert cfg.deadline_s(S) == DEADLINE_MS[S] * 1e-3
    cfg2 = SchedulerCfg(max_wait_ms={B: 100.0})
    assert cfg2.max_wait_s(B) == 0.1
    assert cfg2.max_wait_s(S) == MAX_WAIT_MS[S] * 1e-3
    assert cfg2.max_wait_s(I) is None                   # default: no aging
    # merged dicts are per-instance: mutations must not leak across cfgs
    cfg.deadline_ms[I] = 1.0
    assert SchedulerCfg().deadline_ms[I] == DEADLINE_MS[I]
    with pytest.raises(ValueError):
        SchedulerCfg(promote_quota=0.0)
    with pytest.raises(ValueError):
        SchedulerCfg(drr_quantum=0.0)


def test_server_partial_deadline_override_serves_other_classes(params):
    """End-to-end regression: a server configured with only a BULK
    deadline budget must still accept INTERACTIVE/STANDARD submits."""
    srv = _server(params, max_batch=2, deadline_ms={B: 5000.0})
    rng = np.random.default_rng(20)
    sid_i = srv.open_session(qos=I).sid
    sid_b = srv.open_session(qos=B).sid
    srv.submit(sid_i, _req(rng, 0))          # KeyError before the fix
    srv.submit(sid_b, _req(rng, 0))
    while srv.served_total < 2:
        srv.step()


# ---------------------------------------------------------------------------
# Aging/promotion: bounded BULK wait under sustained higher-class load
# ---------------------------------------------------------------------------

def _zf():
    return FrameRequest(t=0, mel=np.zeros((1, 1), np.float32))


def test_scheduler_bulk_aging_bounds_max_wait_under_flood():
    """Sustained INTERACTIVE load saturates every tick; without aging
    the BULK frame starves forever, with aging it is admitted within
    ``max_wait_ms`` + one tick period, promotion-immune to preemption."""
    # (a) aging ON: bounded
    cfg = SchedulerCfg(max_batch=2, max_wait_ms={B: 500.0})
    qs, sched = QoSQueues(maxlen=64), TickScheduler(cfg)
    bulk = qs.submit(0, _zf(), B, now=0.0, deadline_s=2.0)
    now, admitted_at = 0.0, None
    for _ in range(20):
        for _ in range(2):                   # flood: 2 fresh I per tick
            qs.submit(1, _zf(), I, now=now, deadline_s=now + 0.05)
        if bulk in sched.admit(qs, now):
            admitted_at = now
            break
        now += 0.1
    assert admitted_at is not None, "BULK starved despite aging"
    assert admitted_at <= 0.5 + 0.1 + 1e-9, "bound: max_wait + 1 tick"
    assert bulk.promoted and sched.promoted["bulk"] == 1
    assert qs.counters()["preempted"]["bulk"] == 0  # promotion stuck
    # (b) aging OFF (the old scheduler): starved outright
    cfg = SchedulerCfg(max_batch=2, max_wait_ms={B: None})
    qs, sched = QoSQueues(maxlen=64), TickScheduler(cfg)
    bulk = qs.submit(0, _zf(), B, now=0.0, deadline_s=2.0)
    now = 0.0
    for _ in range(20):
        for _ in range(2):
            qs.submit(1, _zf(), I, now=now, deadline_s=now + 0.05)
        assert bulk not in sched.admit(qs, now)
        now += 0.1
    assert sched.promoted["bulk"] == 0


def test_scheduler_promotion_quota_caps_aged_share():
    """The aging lane cannot invert the starvation: promoted frames
    take at most ``promote_quota`` of a batch, fresh INTERACTIVE
    traffic keeps the rest."""
    cfg = SchedulerCfg(max_batch=4, max_wait_ms={B: 100.0},
                       promote_quota=0.5)
    qs, sched = QoSQueues(maxlen=64), TickScheduler(cfg)
    for i in range(8):                       # deep, long-aged BULK backlog
        qs.submit(i, _zf(), B, now=0.0, deadline_s=10.0)
    for _ in range(4):                       # fresh INTERACTIVE burst
        qs.submit(9, _zf(), I, now=1.0, deadline_s=1.05)
    batch = sched.admit(qs, 1.0)
    assert len(batch) == 4
    assert sum(1 for x in batch if x.promoted) == 2   # quota = 0.5 * 4
    assert sum(1 for x in batch if x.qos is I) == 2
    # the promoted frames are the OLDEST aged ones (FIFO drain -> bound)
    assert sorted(x.seq for x in batch if x.promoted) == [0, 1]


def test_scheduler_promote_slots_is_at_least_one():
    assert SchedulerCfg(max_batch=1, promote_quota=0.5).promote_slots == 1
    assert SchedulerCfg(max_batch=8, promote_quota=0.5).promote_slots == 4


# ---------------------------------------------------------------------------
# DRR: weighted fair sharing between STANDARD tenants
# ---------------------------------------------------------------------------

def test_scheduler_drr_fair_share_between_standard_tenants():
    """A chatty tenant's deep backlog (submitted FIRST — plain FIFO
    would drain it before touching anyone else) cannot monopolize the
    STANDARD slots: while every tenant stays backlogged, service is
    near-equal."""
    cfg = SchedulerCfg(max_batch=4)
    qs, sched = QoSQueues(maxlen=128), TickScheduler(cfg)
    for _ in range(40):                      # chatty tenant 0 floods first
        qs.submit(0, _zf(), S, now=0.0, deadline_s=0.25)
    for _ in range(10):
        qs.submit(1, _zf(), S, now=0.0, deadline_s=0.25)
        qs.submit(2, _zf(), S, now=0.0, deadline_s=0.25)
    served = {0: 0, 1: 0, 2: 0}
    for _ in range(5):                       # 20 slots, all 3 backlogged
        for qf in sched.admit(qs, 0.1):
            served[qf.sid] += 1
    assert sum(served.values()) == 20
    assert served[1] >= 6 and served[2] >= 6, served
    assert served[0] <= 8, f"chatty tenant monopolized: {served}"
    # once the modest tenants drain, the chatty backlog gets every slot
    for _ in range(20):
        for qf in sched.admit(qs, 0.2):
            served[qf.sid] += 1
    assert served == {0: 40, 1: 10, 2: 10}   # conservation: all served


def test_scheduler_drr_weight_biases_share_2_to_1():
    """``QueuedFrame.weight`` is a real weight: a weight-2 tenant gets
    exactly twice the slots of a weight-1 tenant while both are
    backlogged (quantum accounting, not probabilistic)."""
    cfg = SchedulerCfg(max_batch=3)
    qs, sched = QoSQueues(maxlen=128), TickScheduler(cfg)
    for _ in range(30):
        qs.submit(0, _zf(), S, now=0.0, deadline_s=0.25, weight=2.0)
        qs.submit(1, _zf(), S, now=0.0, deadline_s=0.25, weight=1.0)
    served = {0: 0, 1: 0}
    for _ in range(6):                       # 18 slots, both backlogged
        for qf in sched.admit(qs, 0.1):
            served[qf.sid] += 1
    assert served[0] == 2 * served[1], served


# ---------------------------------------------------------------------------
# Shedding: expired frames dropped visibly, bit-reproducibly
# ---------------------------------------------------------------------------

def test_scheduler_shed_expired_visible_and_deterministic():
    """Frames whose deadline expired past the horizon are dropped AND
    counted (shed counter, deadline miss, terminal wait sample); the
    whole decision replayed under the same fake clock is identical."""
    cfg = SchedulerCfg(max_batch=2, deadline_ms={B: 100.0},
                       shed_horizon_ms=200.0)
    runs = []
    for _ in range(2):
        qs, sched = QoSQueues(maxlen=64), TickScheduler(cfg)
        for i in range(6):
            t = i * 0.05
            qs.submit(i, _zf(), B, now=t, deadline_s=t + 0.1)
        batch = sched.admit(qs, 0.45)
        shed = sched.pop_shed()
        runs.append(([f.seq for f in batch], [f.seq for f in shed],
                     dict(sched.deadline_misses), qs.counters(),
                     sched.wait_percentiles()))
    assert runs[0] == runs[1], "shed decisions must be bit-reproducible"
    batch_seqs, shed_seqs, misses, counters, _ = runs[0]
    # deadlines .10/.15/.20/.25/.30/.35; shed iff now > deadline + .2
    assert shed_seqs == [0, 1, 2]
    assert batch_seqs == [3, 4]              # admitted (late: misses)
    assert counters["shed_expired"]["bulk"] == 3
    assert misses["bulk"] == 5               # 3 starved-in-queue + 2 late
    assert sched.pop_shed() == []            # consumed
    # conservation: 6 submitted == 2 admitted + 3 shed + 1 still queued
    assert qs.depths()["bulk"] == 1


def test_scheduler_no_shed_when_horizon_none():
    cfg = SchedulerCfg(max_batch=1, deadline_ms={B: 100.0})
    qs, sched = QoSQueues(maxlen=8), TickScheduler(cfg)
    qs.submit(0, _zf(), B, now=0.0, deadline_s=0.1)
    batch = sched.admit(qs, 1e9)             # absurdly late: still served
    assert len(batch) == 1 and sched.pop_shed() == []
    assert qs.counters()["shed_expired"]["bulk"] == 0


# ---------------------------------------------------------------------------
# TokenBucket: deterministic admission control
# ---------------------------------------------------------------------------

def test_token_bucket_deterministic_refill():
    tb = TokenBucket(10.0, 2, now=0.0)       # 10 tokens/s, burst 2
    assert tb.try_take(0.0) and tb.try_take(0.0)
    assert not tb.try_take(0.0)
    assert tb.retry_after_s(0.0) == pytest.approx(0.1)
    assert tb.try_take(0.1)                  # exactly one token refilled
    assert not tb.try_take(0.1)
    tb.give_back()                           # refund (queue refused it)
    assert tb.try_take(0.1)
    assert tb.try_take(10.0) and tb.try_take(10.0)   # capped at burst
    assert not tb.try_take(10.0)
    with pytest.raises(ValueError):
        TokenBucket(0.0, 2)
    with pytest.raises(ValueError):
        TokenBucket(1.0, 0)


# ---------------------------------------------------------------------------
# StreamServer (stepped, fake clock): parity, pipelining, QoS overload
# ---------------------------------------------------------------------------

def _server(params, *, capacity=8, max_batch=8, clock=None, refine=0,
            deadline_ms=None, queue_maxlen=256, queue_maxlens=None,
            head=None, rate_limit=None, sched_kw=None, **gw_kw):
    kw = dict(refine_every=refine, **gw_kw)
    if head:
        kw.update(head_init=head[0], head_apply=head[1])
    gw = _gw(params, capacity=capacity, clock=clock, **kw)
    cfg = SchedulerCfg(max_batch=max_batch,
                       **({"deadline_ms": deadline_ms} if deadline_ms
                          else {}),
                       **(sched_kw or {}))
    return StreamServer(gw, cfg=cfg, queue_maxlen=queue_maxlen,
                        queue_maxlens=queue_maxlens, rate_limit=rate_limit)


@pytest.mark.parametrize("pipeline", [True, False])
def test_server_serving_bit_matches_sequential_gateway(params, pipeline):
    """THE parity contract: replaying the server's admitted schedule
    through a plain sequential ``submit``/``tick`` gateway reproduces
    every embedding bit-for-bit — and the pipelined server really did
    overlap ticks (``pipelined_ticks`` > 0, one device sync per tick).
    ``pipeline=False`` (the measured baseline knob) collects tick t
    before launching t+1: the same results, zero pipelined ticks."""
    rng = np.random.default_rng(0)
    srv = StreamServer(_gw(params), cfg=SchedulerCfg(max_batch=6),
                       pipeline=pipeline)
    sids = [srv.open_session(qos=q).sid for q in (I, S, B, S)]
    frames = {}
    for t in range(5):
        for sid in sids:
            frames[(sid, t)] = _req(rng, t)
            srv.submit(sid, frames[(sid, t)])
        srv.step()
    while srv.stats().frames_served != srv.stats().frames_submitted:
        srv.step()
    results = {(r.sid, r.t): r for r in srv.drain_results()}
    st = srv.stats()
    assert st.ticks >= 5 and (st.pipelined_ticks > 0) == pipeline
    assert st.gateway.device_syncs_per_tick == 1
    assert st.gateway.d2h_copies_per_tick == 1
    # replay the EXACT admitted schedule sequentially
    gw = _gw(params)
    replay_sids = [gw.open_session(qos=q).sid for q in (I, S, B, S)]
    assert replay_sids == sids
    for tick in srv.schedule():
        for sid, t in tick:
            gw.submit(sid, frames[(sid, t)])
        for r in gw.tick():
            ref = results[(r.sid, r.t)]
            np.testing.assert_array_equal(r.z, ref.z)
            assert r.k == ref.k and r.wire_bytes == ref.wire_bytes


def test_server_refine_order_matches_sequential_gateway(params):
    """Pipelining must not reorder learning: with ``refine_every`` set
    the server drains its pipeline before a refine tick, so refine
    rounds and losses are bitwise those of the sequential gateway."""
    def head_init(generator):
        return {"w": 0.01 * torch.randn(CFG.d_embed, 4, generator=generator)}

    def head_apply(p, z):
        return z @ p["w"]

    rng = np.random.default_rng(1)
    srv = _server(params, capacity=2, max_batch=4, refine=2,
                  head=(head_init, head_apply))
    gw = _gw(params, capacity=2, refine_every=2, head_init=head_init,
             head_apply=head_apply)
    ssid = srv.open_session(qos=S).sid
    gsid = gw.open_session(qos=S).sid
    assert ssid == gsid
    for t in range(6):
        f = _req(rng, t)
        f = FrameRequest(t=t, mel=f.mel, u=f.u, label=t % 4)
        srv.submit(ssid, f)
        srv.step()
        gw.submit(gsid, f)
        gw.tick()
    while srv.stats().ticks < 6:
        srv.step()
    ss, gs = srv.stats().gateway, gw.stats()
    assert ss.refine_rounds == gs.refine_rounds == 3
    assert ss.last_refine_loss == gs.last_refine_loss   # bitwise


def test_server_overload_qos_isolation_and_conservation(params):
    """Synthetic 2x overload under a fake clock: INTERACTIVE p95 queue
    wait stays below BULK p50, BULK frames get preempted but conserved
    (requeued == preempted; submitted == served + depth at quiescence),
    and BULK deadline misses are counted while INTERACTIVE never
    misses."""
    clock = FakeClock()
    rng = np.random.default_rng(2)
    srv = _server(params, capacity=8, max_batch=4, clock=clock,
                  deadline_ms={I: 500.0, S: 500.0, B: 150.0})
    sids = {I: [srv.open_session(qos=I).sid],
            S: [srv.open_session(qos=S).sid],
            B: [srv.open_session(qos=B).sid for _ in range(6)]}
    # offered load 8 frames/round vs capacity 4/tick = 2x
    for t in range(10):
        srv.submit(sids[I][0], _req(rng, t))
        srv.submit(sids[S][0], _req(rng, t))
        for sid in sids[B]:
            srv.submit(sid, _req(rng, t))
        clock.t += 0.1
        srv.step()
    st = srv.stats()
    assert sum(st.preempted.values()) == st.preempted["bulk"] > 0
    assert st.requeued == st.preempted
    # backlog is all BULK: the latency classes never queued up
    assert st.queue_depth["interactive"] == st.queue_depth["standard"] == 0
    assert st.queue_depth["bulk"] > 0
    assert st.deadline_misses["bulk"] > 0
    assert st.deadline_misses["interactive"] == 0
    w = st.queue_wait_ms
    assert w["interactive"]["p95"] < w["bulk"]["p50"]
    # drain: conservation closes the books per class
    while True:
        st = srv.stats()
        if st.frames_served == st.frames_submitted:
            break
        clock.t += 0.1
        srv.step()
    assert all(st.queue_depth[c] == 0 for c in st.queue_depth)
    assert st.frames_served["bulk"] == st.frames_submitted["bulk"] == 60


def test_server_bounded_queue_backpressure(params):
    srv = _server(params, capacity=2, max_batch=2, queue_maxlen=3)
    sid = srv.open_session(qos=B).sid
    rng = np.random.default_rng(3)
    for t in range(3):
        srv.submit(sid, _req(rng, t))
    with pytest.raises(QueueFullError):
        srv.submit(sid, _req(rng, 3))
    st = srv.stats()
    assert st.rejected_full["bulk"] == 1
    assert st.frames_submitted["bulk"] == 3   # the rejected frame never counted
    while srv.stats().frames_served["bulk"] < 3:
        srv.step()


def test_server_close_session_drains_then_evicts(params):
    srv = _server(params, capacity=4, max_batch=2)
    rng = np.random.default_rng(4)
    a = srv.open_session(qos=S).sid
    b = srv.open_session(qos=S).sid
    for t in range(3):
        srv.submit(a, _req(rng, t))
    srv.submit(b, _req(rng, 0))
    srv.close_session(a)                    # stepped mode: drains inline
    with pytest.raises(KeyError):
        srv.submit(a, _req(rng, 9))
    st = srv.stats()
    assert st.frames_served["standard"] >= 3   # a's frames all served
    assert srv.gateway.stats().sessions_closed == 1
    # b still serves
    srv.submit(b, _req(rng, 1))
    while srv.stats().frames_served["standard"] < 5:
        srv.step()


def test_server_requires_overlapped_gateway(params):
    with pytest.raises(ValueError):
        StreamServer(_gw(params, overlap=False))


def test_server_step_counts_refine_drain_frames(params):
    """step()'s return includes frames delivered by a refine-forced
    pipeline drain, not just the trailing collect."""
    def head_init(generator):
        return {"w": 0.01 * torch.randn(CFG.d_embed, 4, generator=generator)}

    def head_apply(p, z):
        return z @ p["w"]

    rng = np.random.default_rng(7)
    srv = _server(params, capacity=2, max_batch=2, refine=2,
                  head=(head_init, head_apply))
    sid = srv.open_session(qos=S).sid
    delivered = 0
    for t in range(6):
        srv.submit(sid, FrameRequest(t=t, mel=_mel(rng), label=0))
        delivered += srv.step()
    while srv.stats().ticks < 6:
        delivered += srv.step()
    assert delivered == 6 == srv.served_total


def test_serving_loop_fault_fails_fast_at_callers(params):
    """If the serving loop dies on an internal error, producers and
    progress pollers raise the stored fault instead of hanging."""
    import time as _time
    srv = _server(params, capacity=2, max_batch=2)
    sid = srv.open_session(qos=S).sid
    boom = RuntimeError("injected tick failure")

    def bad_launch(*a, **k):
        raise boom

    srv.gateway.tick_launch = bad_launch
    rng = np.random.default_rng(10)
    with pytest.raises(RuntimeError):
        with srv:
            srv.submit(sid, _req(rng, 0))
            deadline = _time.time() + 30
            while True:
                assert _time.time() < deadline, "fault never surfaced"
                try:
                    srv.served_total
                except RuntimeError as e:
                    assert e.__cause__ is boom
                    break
                _time.sleep(0.01)
            with pytest.raises(RuntimeError):
                srv.submit(sid, _req(rng, 1))
        # __exit__ -> stop() re-raises the fault (the outer pytest.raises)


def test_gateway_rejects_out_of_order_collect(params):
    gw = _gw(params, capacity=2)
    sid = gw.open_session().sid
    rng = np.random.default_rng(11)
    gw.submit(sid, _req(rng, 0))
    p0 = gw.tick_launch()
    gw.submit(sid, _req(rng, 1))
    p1 = gw.tick_launch()
    with pytest.raises(RuntimeError):
        gw.tick_collect(p1)                  # out of launch order
    gw.tick_collect(p0)
    gw.tick_collect(p1)                      # in order: fine
    with pytest.raises(RuntimeError):
        gw.tick_collect(p1)                  # double collect


def test_on_result_exception_does_not_kill_serving(params):
    """A raising user callback is isolated: serving continues, every
    frame is still delivered to the (faulty) callback."""
    seen = []

    def bad_cb(r):
        seen.append(r.t)
        raise RuntimeError("user bug")

    srv = StreamServer(_gw(params, capacity=2),
                       cfg=SchedulerCfg(max_batch=2), on_result=bad_cb)
    rng = np.random.default_rng(9)
    sid = srv.open_session(qos=S).sid
    for t in range(3):
        srv.submit(sid, _req(rng, t))
        srv.step()
    while srv.served_total < 3:
        srv.step()
    assert sorted(seen) == [0, 1, 2]
    assert srv.drain_results() == []    # callback mode: no buffering


def test_close_session_from_on_result_callback_does_not_deadlock(params):
    """close_session on the serving thread (e.g. closing a session from
    its own result callback) must defer to _process_closes instead of
    waiting on an event only that thread can set."""
    holder = {}

    def on_result(r):
        holder["srv"].close_session(r.sid)   # runs ON the serving thread

    gw = _gw(params, capacity=2)
    srv = StreamServer(gw, cfg=SchedulerCfg(max_batch=2),
                       on_result=on_result)
    holder["srv"] = srv
    rng = np.random.default_rng(8)
    sid = srv.open_session(qos=S).sid
    with srv:
        srv.submit(sid, _req(rng, 0))
        deadline = __import__("time").time() + 30
        while srv.gateway.stats().sessions_closed < 1:
            assert __import__("time").time() < deadline, "close never ran"
            __import__("time").sleep(0.01)
    assert srv.served_total == 1


def test_server_fake_clock_queue_waits_are_exact(params):
    """The whole stack on one fake clock: queue waits and SyncEvent
    timestamps come out exact, covering the async tick path (the clock
    threading satellite)."""
    clock = FakeClock()
    srv = _server(params, capacity=2, max_batch=2, clock=clock)
    rng = np.random.default_rng(5)
    sid = srv.open_session(qos=S).sid
    # charging -> the lazy-sync weights push fires on frame 0
    srv.submit(sid, FrameRequest(t=0, mel=_mel(rng), charging=True))
    clock.t = 0.25
    srv.step()                              # admitted + launched at t=0.25
    srv.step()
    w = srv.stats().queue_wait_ms["standard"]
    assert w["p50"] == w["max"] == 250.0
    assert srv.stats().gateway.last_tick_ms == 0.0   # no clock advance in tick
    # the async tick stamped the SyncEvent off the injected clock
    events = srv.gateway._sessions[sid].sync.events
    assert [e.kind for e in events] == ["weights"]
    assert events[0].at_s == 0.25


# ---------------------------------------------------------------------------
# Server: aging bound, shedding, rate limits (all on the fake clock)
# ---------------------------------------------------------------------------

def _conservation(st):
    """The extended invariant, per class, at THIS snapshot."""
    for c in st.frames_submitted:
        assert st.frames_submitted[c] == (
            st.frames_served[c] + st.queue_depth[c]
            + st.in_flight[c] + st.shed_expired[c]), (c, st)
    assert st.preempted == st.requeued


def test_server_bulk_bounded_wait_under_sustained_flood(params):
    """The whole starvation fix end-to-end: sustained INTERACTIVE load
    saturates every tick, yet the BULK frame is served with its queue
    wait exactly ``max_wait_ms`` on the fake clock."""
    clock = FakeClock()
    srv = _server(params, capacity=4, max_batch=2, clock=clock,
                  deadline_ms={B: 10_000.0},
                  sched_kw={"max_wait_ms": {B: 300.0}})
    rng = np.random.default_rng(21)
    sid_i = srv.open_session(qos=I).sid
    sid_b = srv.open_session(qos=B).sid
    srv.submit(sid_b, _req(rng, 0))
    for t in range(8):
        srv.submit(sid_i, _req(rng, 2 * t))
        srv.submit(sid_i, _req(rng, 2 * t + 1))
        srv.step()
        clock.t += 0.1
        _conservation(srv.stats())
    st = srv.stats()
    assert st.frames_served["bulk"] == 1, "BULK starved despite aging"
    assert st.promoted["bulk"] == 1
    # promoted at the first stage() after aging past 300 ms (t=0.3),
    # admitted at the next tick (t=0.4): the documented bound is
    # max_wait + one stage->admit window, and on the fake clock it is
    # EXACT — preempted on ticks 1-3, promotion-immune afterwards
    assert st.queue_wait_ms["bulk"]["max"] == 400.0
    assert st.preempted["bulk"] == st.requeued["bulk"] == 3


def test_server_shed_visible_conservation_and_close(params):
    """Expired frames are dropped VISIBLY: counted in ``shed_expired``
    and ``deadline_misses`` (starved-in-queue misses used to be
    invisible), the extended conservation invariant holds at every
    snapshot, and a draining close completes once every accepted frame
    is served or shed."""
    clock = FakeClock()
    srv = _server(params, capacity=2, max_batch=2, clock=clock,
                  deadline_ms={B: 100.0},
                  sched_kw={"shed_horizon_ms": 200.0,
                            "max_wait_ms": {B: None}})
    rng = np.random.default_rng(22)
    sid = srv.open_session(qos=B).sid
    for t in range(6):
        srv.submit(sid, _req(rng, t))
    srv.step()                # admits 2, stages 2, 2 still queued
    _conservation(srv.stats())
    clock.t = 10.0            # everything queued is long past deadline
    srv.step()                # shed pass drops the 2 QUEUED frames
    _conservation(srv.stats())
    while srv.stats().in_flight != {c: 0 for c in ("interactive",
                                                   "standard", "bulk")}:
        srv.step()
    st = srv.stats()
    assert st.shed_expired["bulk"] == 2
    assert st.frames_served["bulk"] == 4      # 2 early + 2 staged (late)
    assert st.deadline_misses["bulk"] >= 4    # 2 shed + 2 admitted late
    _conservation(st)
    srv.close_session(sid)                    # completes: served + shed
    assert srv.gateway.stats().sessions_closed == 1


def test_server_rate_limit_token_bucket(params):
    """Per-session admission control on the fake clock: refusals are
    typed, counted per class, never enter ``frames_submitted``, and a
    queue-refused frame refunds its token."""
    clock = FakeClock()
    srv = _server(params, capacity=4, max_batch=2, clock=clock,
                  queue_maxlen=2)
    rng = np.random.default_rng(23)
    sid = srv.open_session(qos=S, rate_limit=(10.0, 2)).sid
    free = srv.open_session(qos=S).sid       # inherits server default: none
    srv.submit(sid, _req(rng, 0))
    srv.submit(sid, _req(rng, 1))            # burst of 2 OK
    with pytest.raises(RateLimitError) as ei:
        srv.submit(sid, _req(rng, 2))
    assert ei.value.retry_after_s == pytest.approx(0.1)
    st = srv.stats()
    assert st.rejected_rate_limited["standard"] == 1
    assert st.frames_submitted["standard"] == 2
    _conservation(st)
    for t in range(5):                       # unlimited session unaffected
        try:
            srv.submit(free, _req(rng, t))
        except QueueFullError:
            break
    clock.t = 0.1                            # exactly one token refills
    # the bounded queue is FULL (maxlen 2): the refusal must refund the
    # token so the retry after serving succeeds without waiting again
    with pytest.raises(QueueFullError):
        srv.submit(sid, _req(rng, 2))
    while srv.stats().queue_depth["standard"] > 0 or \
            sum(srv.stats().in_flight.values()):
        srv.step()
    srv.submit(sid, _req(rng, 2))            # refunded token spends here
    with pytest.raises(RateLimitError):
        srv.submit(sid, _req(rng, 3))
    st = srv.stats()
    assert st.rejected_rate_limited["standard"] == 2
    assert st.rejected_full["standard"] == 2   # free's probe + the refund
    _conservation(st)


def test_server_rate_limit_default_applies_to_all_sessions(params):
    clock = FakeClock()
    srv = _server(params, capacity=2, max_batch=2, clock=clock,
                  rate_limit=(1.0, 1))
    rng = np.random.default_rng(24)
    sid = srv.open_session(qos=S).sid        # inherits (1.0, 1)
    off = srv.open_session(qos=S, rate_limit=None).sid   # opted out
    srv.submit(sid, _req(rng, 0))
    with pytest.raises(RateLimitError):
        srv.submit(sid, _req(rng, 1))
    for t in range(3):
        srv.submit(off, _req(rng, t))        # no bucket, no refusal
    assert srv.stats().rejected_rate_limited["standard"] == 1
    while srv.served_total < 4:
        srv.step()


def test_server_start_stop_race_single_serving_thread(params):
    """start() used to be check-then-act: two racing callers could both
    see a dead thread and spawn two serving loops."""
    srv = _server(params, capacity=2, max_batch=2)
    n = 8
    barrier = threading.Barrier(n)

    def go():
        barrier.wait()
        srv.start()

    threads = [threading.Thread(target=go) for _ in range(n)]
    for th in threads:
        th.start()
    _join(threads)
    alive = [t for t in threading.enumerate()
             if t.name == "streamsplit-serve" and t.is_alive()]
    assert len(alive) == 1, f"{len(alive)} serving loops spawned"
    srv.stop()
    assert not any(t.is_alive() for t in alive)


# ---------------------------------------------------------------------------
# Property-style stress: extended conservation across concurrent snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_stats_conservation_under_concurrent_stress(params, seed):
    """Producers, the serving thread, a closing/reopening tenant and a
    stats() poller all race, with shedding, rate limits, preemption and
    tight deadlines live.  The extended invariant (``submitted ==
    served + queue_depth + in_flight + shed_expired`` per class,
    ``preempted == requeued``) must hold at EVERY concurrent snapshot,
    and the books must close exactly at quiescence."""
    srv = _server(params, capacity=8, max_batch=4, queue_maxlen=16,
                  deadline_ms={I: 50.0, S: 50.0, B: 20.0},
                  sched_kw={"shed_horizon_ms": 30.0,
                            "max_wait_ms": {B: 40.0}},
                  rate_limit=(2000.0, 8))
    errors: list = []
    stop_polling = threading.Event()

    def poller():
        while not stop_polling.is_set():
            try:
                _conservation(srv.stats())
            except BaseException as e:       # surface in the main thread
                errors.append(e)
                return

    def producer(worker):
        rng = np.random.default_rng(3000 + 10 * seed + worker)
        for round_ in range(2):              # churn: open -> stream -> close
            sid = srv.open_session(qos=[I, S, B][worker % 3]).sid
            for t in range(40):
                try:
                    srv.submit(sid, _req(rng, round_ * 100 + t))
                except (QueueFullError, RateLimitError):
                    pass                     # typed refusals: fine, counted
                if rng.random() < 0.2:
                    time.sleep(1e-3)
            srv.close_session(sid, timeout=60.0)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the threads finely
    try:
        with srv:
            threads = [threading.Thread(target=producer, args=(w,))
                       for w in range(3)]
            poll = threading.Thread(target=poller)
            poll.start()
            for th in threads:
                th.start()
            _join(threads)
            stop_polling.set()
            _join([poll])
    finally:
        sys.setswitchinterval(switch)
    if errors:
        raise errors[0]
    st = srv.stats()
    _conservation(st)
    # quiescence: the books close exactly — nothing queued or in flight,
    # every accepted frame either served or visibly shed
    assert sum(st.queue_depth.values()) == 0
    assert sum(st.in_flight.values()) == 0
    for c in st.frames_submitted:
        assert st.frames_submitted[c] == (st.frames_served[c]
                                          + st.shed_expired[c]), (c, st)
    assert srv.gateway.stats().sessions_closed == 6


# ---------------------------------------------------------------------------
# Threaded: ingest racing close_session, oracle = sequential replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_threaded_ingest_races_close_without_losing_frames(params, seed):
    """Producers hammer the queues from their own threads while sessions
    close and reopen mid-stream.  No frame is lost or double-served:
    per-session served == accepted, and replaying the recorded schedule
    through a sequential gateway reproduces every embedding bitwise."""
    srv = _server(params, capacity=8, max_batch=8, queue_maxlen=64)
    frames, flock = {}, threading.Lock()
    accepted = {"n": 0}

    def producer(worker):
        rng = np.random.default_rng(1000 + 10 * seed + worker)
        for round_ in range(3):             # churn: open -> stream -> close
            sid = srv.open_session(qos=[I, S, B][worker % 3]).sid
            # frame indices globally unique per (worker, round): rows are
            # reused across close/reopen, so (sid, t) must still key one
            # frame for the replay oracle below
            base = (worker * 3 + round_) * 100
            for i in range(12):
                t = base + i
                f = _req(rng, t)
                with flock:
                    frames[(sid, t)] = f
                while True:
                    try:
                        srv.submit(sid, f)
                        break
                    except QueueFullError:  # backpressure: retry
                        pass
                with flock:
                    accepted["n"] += 1
            srv.close_session(sid, timeout=60.0)

    with srv:
        threads = [threading.Thread(target=producer, args=(w,))
                   for w in range(3)]
        for th in threads:
            th.start()
        _join(threads)
    st = srv.stats()
    assert sum(st.frames_served.values()) == accepted["n"] == 3 * 3 * 12
    assert sum(st.queue_depth.values()) == 0
    assert st.gateway.sessions_closed == 9
    results = srv.drain_results()
    assert len(results) == accepted["n"]    # no loss ...
    by_key = {(r.sid, r.t): r for r in results}
    assert len(by_key) == accepted["n"]     # ... and no double-serve
    # sequential replay oracle: same admitted schedule, same embeddings.
    # Rows are reused across close/reopen, so the replay gateway opens
    # rows on demand (its free-list hands out ascending rows) and keys
    # every comparison purely by the globally unique (sid, t)
    gw = _gw(params, capacity=8)
    open_rows = set()
    served = 0
    for tick in srv.schedule():
        for sid, t in tick:
            if sid not in open_rows:
                # force-admit the specific row the server used
                while True:
                    got = gw.open_session().sid
                    open_rows.add(got)
                    if got == sid:
                        break
            gw.submit(sid, frames[(sid, t)])
        for r in gw.tick():
            ref = by_key[(r.sid, r.t)]
            np.testing.assert_array_equal(
                r.z, ref.z, err_msg=f"{(r.sid, r.t)} diverged from replay")
            assert r.k == ref.k
            served += 1
    assert served == accepted["n"]


# ---------------------------------------------------------------------------
# The RL split policy behind the server
# ---------------------------------------------------------------------------

def test_server_with_rl_policy_replays_bitwise(params):
    """``make_policy("rl")`` on ``init_policy`` from a seed decides on the
    host; the served schedule replays through a sequential gateway with
    the same policy bit for bit, and the policy spreads over several k."""
    pol = make_policy("rl", L, rl_params=init_policy(
        torch.Generator().manual_seed(5), 3, L + 1))
    rng = np.random.default_rng(41)
    srv = StreamServer(_gw(params, policy=pol),
                       cfg=SchedulerCfg(max_batch=4))
    sids = [srv.open_session(qos=q).sid for q in (I, S, B, B)]
    frames = {}
    for t in range(6):
        for sid in sids:
            frames[(sid, t)] = FrameRequest(
                t=t, mel=_mel(rng), u=float(rng.random()),
                cpu=float(rng.random()),
                bandwidth_mbps=float(60.0 * rng.random()))
            srv.submit(sid, frames[(sid, t)])
        srv.step()
    while srv.busy():
        srv.step()
    results = {(r.sid, r.t): r for r in srv.drain_results()}
    assert len(results) == 24 and len({r.k for r in results.values()}) > 1
    gw = _gw(params, policy=pol)
    assert [gw.open_session(qos=q).sid for q in (I, S, B, B)] == sids
    for tick in srv.schedule():
        for key in tick:
            gw.submit(key[0], frames[key])
        for r in gw.tick():
            ref = results[(r.sid, r.t)]
            assert r.k == ref.k
            np.testing.assert_array_equal(r.z, ref.z)


# ---------------------------------------------------------------------------
# Live migration seams: export / import / checkpoint / quiesce
# ---------------------------------------------------------------------------

def test_server_export_import_moves_waiting_frames(params):
    """A session leaves with its books and every waiting frame (staged
    or queued, original deadlines), through its wire form; the target
    serves exactly those frames and both servers conserve."""
    from repro_torch.api import SessionSnapshot
    clock = FakeClock()
    a = _server(params, capacity=4, max_batch=2, clock=clock)
    b = _server(params, capacity=4, max_batch=2, clock=clock)
    rng = np.random.default_rng(42)
    sid = a.open_session(qos=S).sid
    stay = a.open_session(qos=S).sid
    for t in range(6):
        a.submit(sid, _req(rng, t))
    a.step()                  # launches 2, stages 2, 2 still queued
    with pytest.raises(RuntimeError, match="quiesce"):
        a.export_session(sid)
    assert a.quiesce() == 2
    snap = SessionSnapshot.from_bytes(a.export_session(sid).to_bytes())
    assert (snap.server.submitted, snap.server.served, snap.server.shed) \
        == (6, 2, 0)
    assert [q.frame.t for q in snap.server.queued] == [2, 3, 4, 5]
    deadlines = [q.deadline_s for q in snap.server.queued]
    a.submit(stay, _req(rng, 0))
    new = b.import_session(snap).sid
    with b.queues.cond:
        assert [qf.deadline_s for qf in b.queues.by_class[S].q] == deadlines
    while b.busy():
        b.step()
    assert sorted(r.t for r in b.drain_results()) == [2, 3, 4, 5]
    _conservation(b.stats())
    b.close_session(new)
    while a.busy():
        a.step()
    _conservation(a.stats())
    assert a.served_total == 3 and a.gateway.stats().sessions_exported == 1
    with pytest.raises(KeyError):
        a.submit(sid, _req(rng, 9))


def test_server_checkpoint_is_settled_and_keeps_serving(params):
    rng = np.random.default_rng(43)
    srv = _server(params, capacity=2, max_batch=2)
    sid = srv.open_session(qos=B).sid
    for t in range(3):
        srv.submit(sid, _req(rng, t))
    srv.step()
    srv.quiesce()
    snap = srv.checkpoint_session(sid)
    assert snap.server.queued == ()
    assert snap.server.submitted == snap.server.served + snap.server.shed
    assert snap.frames == snap.server.served == 2
    while srv.busy():
        srv.step()
    assert srv.served_total == 3          # the session kept serving
    srv.close_session(sid)
    assert srv.gateway.stats().sessions_closed == 1


# ---------------------------------------------------------------------------
# Tracing, the flight recorder, metrics and resource signals
# ---------------------------------------------------------------------------

_ORDER = ("submit", "enqueue", "stage", "admit", "dispatch", "collect",
          "serve")


def _assert_span_order(trace):
    names = [n for n in trace.names() if n in _ORDER]
    assert names == [n for n in _ORDER if n in names]
    stamps = [e[1] for e in trace.events]
    assert stamps == sorted(stamps)          # clock-monotone


def _traced(params, clock, sample, **kw):
    return StreamServer(_gw(params, clock=clock, capacity=8),
                        cfg=SchedulerCfg(**kw), trace_sample=sample)


def test_trace_spans_ordered_across_pipelined_ticks(params):
    clock = FakeClock()
    srv = _traced(params, clock, 1.0, max_batch=4)
    rng = np.random.default_rng(44)
    sids = [srv.open_session(qos=q).sid for q in (I, S, B)]
    n = 0
    for t in range(4):
        for sid in sids:
            srv.submit(sid, _req(rng, t))
            n += 1
        clock.t += 0.01
        srv.step()
    while srv.busy():
        clock.t += 0.01
        srv.step()
    assert srv.stats().pipelined_ticks > 0
    traces = srv.recorder.traces()
    assert len(traces) == n
    assert srv.tracer.started == srv.tracer.finished == n
    for tr in traces:
        _assert_span_order(tr)
        assert tr.find("submit") is not None and tr.find("serve") is not None
        d = tr.find("dispatch")
        assert d is not None and "k" in d[2] and "shard" in d[2]
    ms = traces[0].span_ms("submit", "serve")
    assert ms == pytest.approx(round(ms / 10) * 10, abs=1e-6)
    dump = srv.dump_trace(reason="test")
    assert dump["reason"] == "test" and len(dump["traces"]) == n


def test_trace_sampling_matches_reference_hash(params):
    """The copy samples the same frames as the reference's tracer: the
    deterministic hash of ``(sid, t)``."""
    from repro.obs import sampled as jsampled
    from repro_torch.obs import sampled
    for sid in range(4):
        for t in range(64):
            for p in (0.1, 0.5, 0.9):
                assert sampled(sid, t, p) == jsampled(sid, t, p)
    clock = FakeClock()
    srv = _traced(params, clock, 0.5, max_batch=8)
    rng = np.random.default_rng(45)
    sid = srv.open_session(qos=S).sid
    want = {t for t in range(20) if sampled(sid, t, 0.5)}
    for t in range(20):
        srv.submit(sid, _req(rng, t))
        clock.t += 0.01
        srv.step()
    while srv.busy():
        srv.step()
    got = {tr.t for tr in srv.recorder.traces()}
    assert got == want and 0 < len(got) < 20


def test_tracing_off_is_the_zero_allocation_path(params):
    clock = FakeClock()
    srv = _traced(params, clock, 0.0, max_batch=4)
    rng = np.random.default_rng(46)
    sid = srv.open_session(qos=S).sid
    for t in range(3):
        srv.submit(sid, _req(rng, t))
        clock.t += 0.01
        srv.step()
    while srv.busy():
        srv.step()
    assert srv.tracer.started == 0 and srv.recorder.traces() == []
    assert srv.served_total == 3


def test_trace_shed_terminates_span_into_recorder(params):
    clock = FakeClock()
    srv = StreamServer(
        _gw(params, clock=clock, capacity=2),
        cfg=SchedulerCfg(max_batch=2, deadline_ms={B: 100.0},
                         shed_horizon_ms=200.0, max_wait_ms={B: None}),
        trace_sample=1.0)
    rng = np.random.default_rng(47)
    sid = srv.open_session(qos=B).sid
    for t in range(6):
        srv.submit(sid, _req(rng, t))
    srv.step()
    clock.t = 10.0
    srv.step()
    while srv.busy():
        srv.step()
    shed = [tr for tr in srv.recorder.traces() if tr.find("shed")]
    assert len(shed) == 2
    assert all(tr.find("serve") is None and tr.events[-1][0] == "shed"
               for tr in shed)
    assert srv.recorder.counts()["shed"] == srv.stats().shed_expired["bulk"]
    ev = srv.recorder.events("shed")[0]
    assert ev["sid"] == sid and "waited_ms" in ev


def test_trace_survives_live_migration_with_original_submit(params):
    clock = FakeClock(t=1.0)
    src = _traced(params, clock, 1.0, max_batch=4)
    dst = _traced(params, clock, 1.0, max_batch=4)
    rng = np.random.default_rng(48)
    sid = src.open_session(qos=S).sid
    for t in range(3):
        src.submit(sid, _req(rng, t))
    clock.t += 0.5
    snap = src.export_session(sid)
    assert all(q.trace is not None for q in snap.server.queued)
    info = dst.import_session(snap)
    while dst.busy():
        clock.t += 0.01
        dst.step()
    traces = dst.recorder.traces()
    assert len(traces) == 3
    for tr in traces:
        names = tr.names()
        assert names.index("migrate_out") < names.index("migrate_in")
        assert "serve" in names
        assert tr.find("submit")[1] == 1.0
        assert tr.find("migrate_out")[1] == 1.5
        assert tr.find("migrate_in")[2]["sid"] == info.sid
    assert src.recorder.traces() == []


def test_server_metrics_export_and_resource_signals(params):
    from repro_torch.obs import validate_prometheus
    clock = FakeClock()
    srv = _server(params, capacity=4, max_batch=2, clock=clock)
    rng = np.random.default_rng(49)
    sids = [srv.open_session(qos=q).sid for q in (I, S, B)]
    for t in range(3):
        for sid in sids:
            srv.submit(sid, _req(rng, t))
        clock.t += 0.05
        srv.step()
    while srv.busy():
        clock.t += 0.05
        srv.step()
    text = srv.metrics()
    validate_prometheus(text)
    assert "stream_frames_served" in text and "gateway_" in text
    sig = srv.resource_signals()
    assert sig.queue_depth == 0 and sig.in_flight == 0
    obs = sig.as_observation()
    assert obs.shape == (5,) and obs.dtype == np.float32
    assert np.all(obs >= 0.0) and np.all(obs <= 1.0)
    assert sig.throughput_fps > 0.0
    st = srv.stats()
    assert sig.wait_p95_ms == max(w["p95"] for w in st.queue_wait_ms.values())
    assert isinstance(srv.recorder, FlightRecorder)
    assert isinstance(srv.tracer, Tracer)


# ---------------------------------------------------------------------------
# One workload through both packages' servers
# ---------------------------------------------------------------------------

JCFG = jenc.AudioEncCfg(widths=(8, 8), strides=(1, 1), n_mels=8, frames=8,
                        d_embed=16, groups=2)
Z_ATOL = 1e-5


def _overload(server, clock, sids, n_rounds=12):
    """A seeded 2x overload on the fake clock, with deadlines, a shed
    horizon, BULK aging and rate limits live -> the refusals' kinds."""
    rng = np.random.default_rng(50)
    refused = []
    for t in range(n_rounds):
        for sid in sids:
            f = FrameRequest(t=t, mel=_mel(rng), u=float(rng.random()))
            try:
                server.submit(sid, f)
            except Exception as e:       # each package's own typed errors
                if type(e).__name__ not in ("QueueFullError",
                                            "RateLimitError"):
                    raise
                refused.append((sid, t, type(e).__name__))
        clock.t += 0.05
        server.step()
    while server.busy():
        clock.t += 0.05
        server.step()
    return refused


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True                       # nan == nan here
    return a == b


def test_server_matches_reference_server():
    """The same fake-clock workload through the JAX ``StreamServer`` and
    the port's: the same refusals, the identical admitted ``schedule()``
    and every ``StreamStats`` count (gateway counters included) equal;
    embeddings within 1e-5 (the same weights, converted)."""
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: jenc.init_audio_encoder(
        JCFG, k))(jax.random.PRNGKey(0)))
    kw = dict(capacity=8, window=8, qos_reserve=0)
    servers = []
    for gw_cls, srv_cls, cfg_cls, cfg, p, extra in (
            (JaxGateway, JaxStreamServer, JaxSchedulerCfg, JCFG, jp, {}),
            (StreamSplitGateway, StreamServer, SchedulerCfg, CFG,
             params_from_jax(jp), {"device": "cpu"})):
        qos = QoSClass if srv_cls is StreamServer else JaxQoSClass
        i, s, b = (qos(q.value) for q in (I, S, B))   # each package's own
        clock = FakeClock()
        gw = gw_cls(cfg, p, policy=QuantilePolicy(L), clock=clock, **kw,
                    **extra)
        srv = srv_cls(gw, cfg=cfg_cls(
            max_batch=4, deadline_ms={i: 150.0, s: 300.0, b: 150.0},
            shed_horizon_ms=200.0, max_wait_ms={b: 400.0}),
            queue_maxlen=12, rate_limit=(25.0, 4))
        sids = [srv.open_session(qos=q).sid for q in (i, s, s, b, b, b)]
        refused = _overload(srv, clock, sids)
        servers.append((srv, refused))
    (js, j_refused), (ts, t_refused) = servers
    assert t_refused == j_refused and len(t_refused) > 0
    assert ts.schedule() == js.schedule()
    jst, tst = js.stats(), ts.stats()
    assert tst.preempted["bulk"] > 0 and sum(tst.shed_expired.values()) > 0
    for field in ("ticks", "pipelined_ticks", "frames_submitted",
                  "frames_served", "queue_depth", "in_flight",
                  "rejected_full", "rejected_rate_limited", "preempted",
                  "requeued", "shed_expired", "promoted", "deadline_misses",
                  "queue_wait_ms"):
        assert getattr(tst, field) == getattr(jst, field), field
    for field in tst.gateway.__dataclass_fields__:
        assert _same(getattr(tst.gateway, field),
                     getattr(jst.gateway, field)), field
    j_res = {(r.sid, r.t): r for r in js.drain_results()}
    t_res = {(r.sid, r.t): r for r in ts.drain_results()}
    assert t_res.keys() == j_res.keys()
    for key, r in t_res.items():
        assert (r.k, r.route, r.wire_bytes, r.bucket_size) == (
            j_res[key].k, j_res[key].route, j_res[key].wire_bytes,
            j_res[key].bucket_size)
        np.testing.assert_allclose(r.z, np.asarray(j_res[key].z), rtol=0,
                                   atol=Z_ATOL)
