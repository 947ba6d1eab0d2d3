"""Per-lane latency ledger: the bucket schema and the pricing constants.

The engine prices each lane's trip through a batch with these constants (the
simulator's ``SimConfig`` defaults) and bins the modelled cost into a
``[Dev, N_CLASSES, N_PATHS, N_BUCKETS]`` int64 histogram.  Buckets are
base-2 log-scale from ``T0``: bucket ``i`` covers about
``[T0 * 2**i, T0 * 2**(i + 1))`` seconds, bucket 0 also catches anything below
``T0`` and the last bucket catches overflow.

The simulator (``core/sim.py``) bins its per-op latencies into the same
schema on the host, so the two planes' histograms can be compared; the
percentile, ledger and audit helpers below read either.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

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


#: one copy of ``BUCKET_FLOORS`` a device, made on first use (a copy from
#: pageable host memory on every batch would wait for the card's stream)
_FLOORS_ON: Dict[torch.device, torch.Tensor] = {}


def bucket_edges() -> np.ndarray:
    """``[N_BUCKETS + 1]`` bucket edges in seconds (monotone, base-2)."""
    return T0 * np.exp2(np.arange(N_BUCKETS + 1, dtype=np.float64))


def bucket_index(x):
    """Bucket index of cost(s) ``x`` in seconds.

    A tensor (the engine's float32 costs) is binned against the reference
    engine's own edges, ``BUCKET_FLOORS``.  A Python or numpy number (the
    simulator's float64 latencies) is binned by the reference's own host
    formula, ``floor(log2(max(x, T0) / T0))`` in float64, so both planes'
    histograms equal the reference's bit for bit.  int64 either way."""
    if isinstance(x, torch.Tensor):
        floors = _FLOORS_ON.get(x.device)
        if floors is None:
            floors = torch.from_numpy(BUCKET_FLOORS.copy()).to(x.device)
            _FLOORS_ON[x.device] = floors
        return (x.unsqueeze(-1) >= floors).sum(-1)
    safe = np.maximum(x, T0)
    idx = np.floor(np.log2(safe / T0))
    return np.clip(idx, 0, N_BUCKETS - 1).astype(np.int64)


# --------------------------------------------------------------------------
# percentile estimation from bucket CDFs
# --------------------------------------------------------------------------


def percentile(hist_1d: np.ndarray, q: float) -> float:
    """Estimate the ``q``-th percentile (0..100) from a 1-D bucket count
    vector: the geometric midpoint of the bucket where the CDF crosses the
    rank.  Returns 0.0 for an empty histogram."""
    h = np.asarray(hist_1d, dtype=np.float64)
    total = h.sum()
    if total <= 0:
        return 0.0
    rank = total * (q / 100.0)
    cdf = np.cumsum(h)
    i = int(np.searchsorted(cdf, rank, side="left"))
    i = min(i, N_BUCKETS - 1)
    return float(T0 * (2.0**i) * math.sqrt(2.0))


def class_percentiles(
    hist: np.ndarray, qs: Sequence[float] = (50.0, 95.0, 99.0)
) -> Dict[str, Dict[str, float]]:
    """Per-op-class percentiles from a ``[classes, paths, buckets]`` (or
    already path-summed ``[classes, buckets]``) histogram."""
    h = np.asarray(hist)
    if h.ndim == 3:
        h = h.sum(axis=1)
    out: Dict[str, Dict[str, float]] = {}
    for c, name in enumerate(OP_CLASSES):
        out[name] = {f"p{q:g}": percentile(h[c], q) for q in qs}
    return out


def ledger(hist: np.ndarray) -> Dict[str, Dict[str, object]]:
    """Per-(class, path) view of a ``[classes, paths, buckets]`` histogram:
    lane counts, path share within the class, and p50/p99 of each cell."""
    h = np.asarray(hist, dtype=np.int64)
    out: Dict[str, Dict[str, object]] = {}
    for c, cname in enumerate(OP_CLASSES):
        cls_total = int(h[c].sum())
        paths: Dict[str, object] = {}
        for p, pname in enumerate(PATHS):
            n = int(h[c, p].sum())
            paths[pname] = {
                "count": n,
                "share": (n / cls_total) if cls_total else 0.0,
                "p50_s": percentile(h[c, p], 50.0),
                "p99_s": percentile(h[c, p], 99.0),
            }
        out[cname] = {"count": cls_total, "paths": paths}
    return out


def latency_section(hist: np.ndarray) -> Dict[str, object]:
    """JSON-ready export of a fleet-summed ``[classes, paths, buckets]``
    histogram: schema + raw counts + percentiles + per-path ledger.  This is
    the shape ``BatchTimeline.summary()["latency"]`` carries and
    the reference's benchmarks/check_telemetry.py validates."""
    h = np.asarray(hist, dtype=np.int64)
    return {
        "bucket_edges_s": [float(e) for e in bucket_edges()],
        "op_classes": list(OP_CLASSES),
        "paths": list(PATHS),
        "hist": h.tolist(),
        "total": int(h.sum()),
        "percentiles": class_percentiles(h),
        "ledger": ledger(h),
    }


# --------------------------------------------------------------------------
# offload cost-model audit
# --------------------------------------------------------------------------


def audit_report(predicted: np.ndarray, realized: np.ndarray) -> Dict[str, object]:
    """Compare the offload rule's predicted fetch bytes against realized
    fetch bytes, both ``[n_memory, levels]`` accumulated over a run.

    ``mispricing_ratio`` is total predicted / total realized over the cells
    where the model made a fetch-side decision (realized > 0) — >1 means the
    EMA rule over-prices fetching (biasing toward offload), <1 under-prices
    it.  Cells with zero realized bytes (fully cached levels) are reported
    but excluded from the ratio."""
    pred = np.asarray(predicted, dtype=np.float64)
    real = np.asarray(realized, dtype=np.float64)
    active = real > 0
    tot_pred = float(pred[active].sum())
    tot_real = float(real[active].sum())
    ratio = (tot_pred / tot_real) if tot_real > 0 else 0.0
    cells = []
    n_mem, levels = pred.shape
    for col in range(n_mem):
        for lvl in range(levels):
            if pred[col, lvl] == 0 and real[col, lvl] == 0:
                continue
            cells.append({
                "column": col,
                "level": lvl,
                "predicted_bytes": float(pred[col, lvl]),
                "realized_bytes": float(real[col, lvl]),
                "ratio": (
                    float(pred[col, lvl] / real[col, lvl])
                    if real[col, lvl] > 0 else 0.0
                ),
            })
    return {
        "predicted_bytes": tot_pred,
        "realized_bytes": tot_real,
        "mispricing_ratio": ratio,
        "cells": cells,
    }


# --------------------------------------------------------------------------
# drift-gauge plumbing
# --------------------------------------------------------------------------


def percentile_gauges(hist: np.ndarray, classes: Sequence[str] = OP_CLASSES):
    """Flat ``{"lat_p50_lookup": ..., "lat_p99_lookup": ...}`` mapping for
    :func:`repro_torch.obs.drift.assert_plane_agreement`; only classes with at
    least one sample are emitted (a gauge at 0.0 would force the drift band
    to special-case empties)."""
    h = np.asarray(hist)
    if h.ndim == 3:
        h = h.sum(axis=1)
    out: Dict[str, float] = {}
    for c, name in enumerate(OP_CLASSES):
        if name not in classes or h[c].sum() <= 0:
            continue
        out[f"lat_p50_{name}"] = percentile(h[c], 50.0)
        out[f"lat_p99_{name}"] = percentile(h[c], 99.0)
    return out
