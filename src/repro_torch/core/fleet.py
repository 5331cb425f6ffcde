"""The fleet data plane under one import (port of ``repro.core.fleet``):

- ``core/fleet_buffer.py``  — the host ``FleetBuffer`` session rings;
- ``core/fleet_refiner.py`` — ``FleetRefiner`` and ``make_fleet_loss``
  (with the cross-shard ``axis_name`` form);
- ``core/fleet_backend.py`` — the ``FleetBackend`` seam:
  ``HostFleetBackend`` and ``ShardedFleetBackend`` (device-resident
  rings over a sessions mesh).
"""
from repro_torch.core.fleet_backend import (FleetBackend, HostFleetBackend,
                                            ShardedFleetBackend,
                                            T_SENTINEL_DEV, make_backend)
from repro_torch.core.fleet_buffer import (FleetBuffer, FleetFullError,
                                           T_SENTINEL, as_host, pad_pow2)
from repro_torch.core.fleet_refiner import (FleetRefiner, FleetRefinerState,
                                            make_fleet_loss)

__all__ = [
    "FleetBuffer", "FleetFullError", "T_SENTINEL", "as_host", "pad_pow2",
    "FleetRefiner", "FleetRefinerState", "make_fleet_loss",
    "FleetBackend", "HostFleetBackend", "ShardedFleetBackend",
    "T_SENTINEL_DEV", "make_backend",
]
