"""Per-lane latency ledger: the bucket schema and the pricing constants.

The engine prices each lane's trip through a batch with these constants (the
simulator's ``SimConfig`` defaults) and bins the modelled cost into a
``[Dev, N_CLASSES, N_PATHS, N_BUCKETS]`` int64 histogram.  Buckets are
base-2 log-scale from ``T0``: bucket ``i`` covers about
``[T0 * 2**i, T0 * 2**(i + 1))`` seconds, bucket 0 also catches anything below
``T0`` and the last bucket catches overflow.
"""

from __future__ import annotations

import numpy as np
import torch

#: number of log-scale buckets per (op class, path) cell
N_BUCKETS = 16
#: left edge of bucket 0 in seconds (also the underflow catch-all)
T0 = 200e-9

#: op classes, indexed by engine opcode
OP_CLASSES = ("lookup", "update", "insert", "scan")
#: outcome paths, mutually exclusive per lane; later entries win
PATHS = (
    "cache_hit",
    "remote_fetch",
    "peer_peek",
    "offload",
    "stale_forced",
    "shed",
)
N_CLASSES = len(OP_CLASSES)
N_PATHS = len(PATHS)

T_CACHED = 400e-9  # 1KB cached page access
T_READ = 2e-6  # one-sided remote node fetch
T_WRITE = 2e-6  # write-through leaf write
T_RPC = 4e-6  # two-sided round-trip floor
T_MEM = 600e-9  # per-node memory-side search
T_LOCAL = 150e-9  # compute-side leaf search

#: First float32 cost of buckets 1..N_BUCKETS-1, as float32 bit patterns.
#: The reference bins with ``floor(log2(max(x, T0) / T0))`` in float32 under
#: XLA, whose log2 rounds a few ulps away from the exact edge ``T0 * 2**i``
#: (-6 to +1 ulps).  Costs are sums of the constants above and often land
#: exactly on an edge, so the port compares against the reference's own
#: edges: the same bucket on any device, with no division or log2 to round.
BUCKET_FLOOR_BITS = (
    0x34D6BF95, 0x3556BF95, 0x35D6BF94, 0x3656BF94, 0x36D6BF94,
    0x3756BF92, 0x37D6BF92, 0x3856BF92, 0x38D6BF92, 0x3956BF92,
    0x39D6BF92, 0x3A56BF8F, 0x3AD6BF96, 0x3B56BF8F, 0x3BD6BF96,
)
BUCKET_FLOORS = np.array(BUCKET_FLOOR_BITS, np.uint32).view(np.float32)


def bucket_index(x: torch.Tensor) -> torch.Tensor:
    """int64 bucket index of float32 cost(s) ``x`` in seconds."""
    floors = torch.from_numpy(BUCKET_FLOORS.copy()).to(x.device)
    return (x.unsqueeze(-1) >= floors).sum(-1)
