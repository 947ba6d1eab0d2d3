"""Batched range scans on the virtual mesh: the paper's §7 range query.

DEX keeps no leaf links on the memory servers; a scan that spans leaves
follows fence keys.  In the blocked pool that becomes a read of the next
leaf's gid from the replicated successor table (``DexState.succ``, set up by
``pool.initial_succ`` and re-linked by on-mesh splits in ``core/smo.py``):
one remote leaf read per hop, without walking the upper levels again.  A
lane reads hop ``h`` only while the records it has collected fall short of
its count.

The dataflow (route round, cached descent to the start leaf, successor
hops, the ``leaf_scan`` kernel) is in ``core/engine.py``; this module is the
thin single-opcode wrapper.  Scans never offload and leave the offload miss
EMA alone.
"""

from __future__ import annotations

import torch

from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import DEFAULT_MAX_COUNT
from repro_torch.core.pool import PoolMeta


def make_dex_scan(
    meta: PoolMeta, cfg, *, max_count: int = DEFAULT_MAX_COUNT, device=None
):
    """Build the range scan: ``(state, start_keys, counts) -> (state, keys,
    values, taken)``.

    A thin wrapper over the engine with ``ops=("scan",)``; a scan lane
    carries its record count in the engine's value plane.  ``start_keys`` /
    ``counts`` [B] are split evenly over the devices; results come back in
    the caller's lane order as ``keys``/``values`` [B, max_count] (KEY_MAX /
    0 padded) and ``taken`` [B] int32.  Counts above ``max_count`` are
    clipped; a start key need not exist (the scan begins at the smallest key
    >= it).  A lane that a routing or fetch bucket shed returns ``taken ==
    -1`` and empty rows, never a truncated answer, and counts in
    ``STAT_DROPS``: retry it."""
    eng = engine_mod.make_dex_engine(
        meta, cfg, ops=("scan",), max_count=max_count, device=device
    )

    def scan(state, start_keys, counts):
        start_keys = torch.as_tensor(start_keys, dtype=torch.int64)
        opcodes = torch.full(start_keys.shape, engine_mod.OP_SCAN, dtype=torch.int32)
        new_state, r = eng(state, opcodes, start_keys, torch.as_tensor(counts))
        return new_state, r.scan_keys, r.scan_values, r.taken

    return scan
