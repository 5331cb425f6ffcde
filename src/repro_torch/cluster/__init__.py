"""Multi-gateway federation of the port: consistent-hash routing, live
session migration, frame journaling + buddy replication, heartbeat
failure detection, and chaos-tested drain/rebalance (port of
``repro.cluster``).

Public surface::

    from repro_torch.cluster import GatewayCluster, HashRing
    from repro_torch.cluster import FailureInjector, StragglerMonitor
    from repro_torch.cluster import FrameJournal, ReplicationLog
    from repro_torch.cluster import HeartbeatMonitor, MemberHungError
    from repro_torch.cluster import RetryPolicy, TransientFault
"""
from repro_torch.api.types import (ClusterDegradedError, ClusterDrainTimeout,
                                   ClusterStats, ServerSessionSnapshot,
                                   SessionSnapshot)
from repro_torch.cluster.cluster import GatewayCluster
from repro_torch.cluster.hashing import HashRing
from repro_torch.cluster.health import HeartbeatMonitor, MemberHungError
from repro_torch.cluster.replication import (FrameJournal, JournalEntry,
                                             ReplicationLog)
from repro_torch.runtime.fault import (FailureInjector, RetryPolicy,
                                       StragglerEvent, StragglerMonitor,
                                       TransientFault)

__all__ = [
    "ClusterDegradedError",
    "ClusterDrainTimeout",
    "ClusterStats",
    "FailureInjector",
    "FrameJournal",
    "GatewayCluster",
    "HashRing",
    "HeartbeatMonitor",
    "JournalEntry",
    "MemberHungError",
    "ReplicationLog",
    "RetryPolicy",
    "ServerSessionSnapshot",
    "SessionSnapshot",
    "StragglerEvent",
    "StragglerMonitor",
    "TransientFault",
]
