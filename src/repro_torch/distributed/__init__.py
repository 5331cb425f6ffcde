"""Sharding over a mesh of devices in one process: the sessions mesh,
its collectives and gradient synchronization (port of
``repro.distributed``'s fleet half)."""
from repro_torch.distributed.sharding import (SESSIONS_AXIS, Mesh, PerShard,
                                              pmax, pmean, ppermute, psum,
                                              row_blocks, sessions_sharding)

__all__ = ["SESSIONS_AXIS", "Mesh", "PerShard", "row_blocks",
           "sessions_sharding", "psum", "pmax", "pmean", "ppermute"]
