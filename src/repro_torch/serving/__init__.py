"""Streaming serving runtime of the port: continuous audio in, ticked
batches out (port of ``repro.serving``).

    from repro_torch.serving import StreamServer, SchedulerCfg

    server = StreamServer(gateway, cfg=SchedulerCfg(max_batch=64))
    with server:                         # starts the serving thread
        info = server.open_session(qos=QoSClass.INTERACTIVE)
        server.submit(info.sid, FrameRequest(t=0, mel=mel))
        ...
        server.close_session(info.sid)   # drains, then evicts

Bounded per-QoS-class ingest queues (``queues``), a deadline-aware
preempting tick scheduler (``scheduler``), and the always-on
``StreamServer`` (``server``) that pipelines tick t+1's staging and
launch under tick t's in-flight device chains via the gateway's
``tick_launch``/``tick_collect`` seam.
"""
from repro_torch.api.types import StreamStats
from repro_torch.runtime.fault import (FailureInjector, StragglerEvent,
                                       StragglerMonitor)
from repro_torch.serving.queues import (ClassQueue, QoSQueues, QueuedFrame,
                                        QueueFullError, RateLimitError,
                                        TokenBucket)
from repro_torch.serving.scheduler import (DEADLINE_MS, MAX_WAIT_MS,
                                           PRIORITY, SchedulerCfg,
                                           TickScheduler, clamp_weight)
from repro_torch.serving.server import StreamServer

__all__ = [
    "StreamServer",
    "TickScheduler", "SchedulerCfg", "DEADLINE_MS", "MAX_WAIT_MS",
    "PRIORITY", "clamp_weight",
    "QoSQueues", "ClassQueue", "QueuedFrame", "QueueFullError",
    "RateLimitError", "TokenBucket",
    "StreamStats",
    "FailureInjector", "StragglerEvent", "StragglerMonitor",
]
