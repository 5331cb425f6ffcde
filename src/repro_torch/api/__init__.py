"""Public typed API of the port's serving pipeline.

    from repro_torch.api import (StreamSplitGateway, FrameRequest,
                                 QoSClass, make_policy)
"""
from repro_torch.api.gateway import StreamSplitGateway, TickPlan
from repro_torch.api.policies import (EntropyThresholdPolicy, FixedKPolicy,
                                      RLPolicy, RulePolicy, SplitPolicy,
                                      make_policy)
from repro_torch.api.types import (AdmissionError, ClusterDegradedError,
                                   ClusterDrainTimeout, ClusterStats,
                                   FrameRequest, FrameResult, GatewayStats,
                                   QoSClass, QueuedFrameSnapshot,
                                   ResourceSignals, ServerSessionSnapshot,
                                   SessionInfo, SessionSnapshot, StreamStats)
from repro_torch.core.fleet_backend import (FleetBackend, HostFleetBackend,
                                            ShardedFleetBackend, make_backend)

__all__ = [
    "StreamSplitGateway", "TickPlan",
    "FleetBackend", "HostFleetBackend", "ShardedFleetBackend",
    "make_backend",
    "SplitPolicy", "make_policy", "FixedKPolicy", "RulePolicy",
    "RLPolicy", "EntropyThresholdPolicy",
    "FrameRequest", "FrameResult", "SessionInfo", "GatewayStats",
    "QoSClass", "AdmissionError", "SessionSnapshot", "StreamStats",
    "ResourceSignals", "ServerSessionSnapshot", "QueuedFrameSnapshot",
    "ClusterStats", "ClusterDegradedError", "ClusterDrainTimeout",
]
