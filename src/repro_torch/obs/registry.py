"""Stat-counter slots of ``DexState.stats``.

The column order is load-bearing: column ``i`` of the ``[Dev, N_STATS]``
counter plane is ``STAT_*`` slot ``i``.  The order is the mesh-slot order of
the metric registry in ``repro/obs/registry.py``; the parity tests hold the
two equal.
"""

from __future__ import annotations

STAT_OPS = 0  # operations admitted to the engine on this device
STAT_HITS = 1  # descents resolved from the local cache
STAT_FETCHES = 2  # coalesced remote row fetches
STAT_OFFLOADS = 3  # ops shipped to the owning memory column
STAT_DROPS = 4  # ops shed to the retry lane
STAT_SPLITS = 5  # leaf splits requested, pending settlement
STAT_WRITES = 6  # write-through row updates
STAT_SMO_SPLITS = 7  # leaf splits settled on the mesh
STAT_DRAINS = 8  # shed ops drained host-side
STAT_OFFLOAD_GROUPS = 9  # column groups that chose offload this batch
STAT_FETCH_GROUPS = 10  # column groups that chose fetch this batch
STAT_PIPE_STALLS = 11  # pipelined overlap-window stalls
STAT_PEER_HITS = 12  # peer peeks answered from a sibling's cache
STAT_PEER_MISSES = 13  # peer peeks resolved by the owner's block walk
STAT_RT_SKIPS = 14  # inner fetch rounds skipped by the route table
STAT_RT_MISPREDICTS = 15  # route-table guesses the fence rejected

N_STATS = 16


def stat_constants() -> dict:
    """``{"STAT_OPS": 0, ...}`` in slot order."""
    return {
        name: value
        for name, value in globals().items()
        if name.startswith("STAT_") and isinstance(value, int)
    }
