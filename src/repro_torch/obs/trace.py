"""Chrome trace-event export for :class:`repro_torch.obs.timeline.BatchTimeline`.

Emits the JSON-object flavour of the Trace Event Format (``{"traceEvents":
[...]}``) viewable in Perfetto (ui.perfetto.dev) or chrome://tracing:

* pid 0, one tid per phase name — "X" (complete) events for every fenced
  host phase, batch-level "X" events on tid 0.
* one pid per mesh device — "C" (counter) tracks for per-batch hit rate,
  drops and ops, sampled at each batch's start time.
* fleet-level "C" tracks (hit_rate, drops_per_op, offload_fraction) on the
  host process.
* when the timeline captured the latency ledger (DESIGN.md §12), one
  run-level "C" sample per percentile gauge (``lat_p50_lookup`` ...)
  plus ``offload_mispricing``, stamped at the end of the last batch (ts 0
  on an empty timeline).
* "M" metadata events naming every process/thread.

Timestamps are microseconds from the timeline epoch, as the format requires.

Also provides :func:`profiler_annotations`, the optional ``torch.profiler``
hook: a context manager that opens a ``record_function`` range so the
engine's own ranges land under ``label`` in a profiler trace alongside the
host-side batches.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import mesh
from repro_torch.obs import latency
from repro_torch.obs.timeline import BatchTimeline

_US = 1e6  # trace-event timestamps are microseconds

#: per-device counter tracks emitted for each batch
_DEVICE_COUNTERS = ("ops", "hits", "drops")
#: fleet-level derived counter tracks
_FLEET_COUNTERS = ("hit_rate", "drops_per_op", "offload_fraction")

_HOST_PID = 0
_BATCH_TID = 0


def to_trace_events(timeline: BatchTimeline) -> Dict[str, Any]:
    """Render a timeline as a Chrome trace-event JSON object.  On the rank
    backend every rank must call it, and every rank renders the same
    events: the fleet's times (``timeline.records()``) and counters."""
    events: List[Dict[str, Any]] = []
    records = timeline.records()

    def meta(pid: int, tid: int, name: str, what: str = "thread_name") -> None:
        events.append(
            {
                "ph": "M",
                "name": what,
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )

    meta(_HOST_PID, 0, f"host:{timeline.name}", "process_name")
    meta(_HOST_PID, _BATCH_TID, "batches")

    # one tid per distinct phase name, stable order of first appearance
    phase_tids: Dict[str, int] = {}
    for rec in records:
        for span in rec.phases:
            if span.name not in phase_tids:
                tid = len(phase_tids) + 1
                phase_tids[span.name] = tid
                meta(_HOST_PID, tid, f"phase:{span.name}")

    n_dev = 0
    for rec in records:
        if rec.counters is not None:
            n_dev = max(n_dev, rec.counters.n_devices)
    for d in range(n_dev):
        meta(d + 1, 0, f"device {d}", "process_name")
        meta(d + 1, 0, "counters")

    for rec in records:
        ts = rec.t0 * _US
        events.append(
            {
                "ph": "X",
                "name": f"batch[{rec.index}] {rec.label}",
                "cat": "batch",
                "pid": _HOST_PID,
                "tid": _BATCH_TID,
                "ts": ts,
                "dur": rec.dur * _US,
                "args": {
                    "label": rec.label,
                    **({"retries": rec.retries} if rec.retries else {}),
                },
            }
        )
        for span in rec.phases:
            events.append(
                {
                    "ph": "X",
                    "name": span.name,
                    "cat": "phase",
                    "pid": _HOST_PID,
                    "tid": phase_tids[span.name],
                    "ts": span.t0 * _US,
                    "dur": span.dur * _US,
                    "args": {"batch": rec.index},
                }
            )
        if rec.counters is None:
            continue
        for name in _FLEET_COUNTERS:
            events.append(
                {
                    "ph": "C",
                    "name": name,
                    "cat": "fleet",
                    "pid": _HOST_PID,
                    "tid": 0,
                    "ts": ts,
                    "args": {name: float(rec.counters.derived[name])},
                }
            )
        for d in range(rec.counters.n_devices):
            for name in _DEVICE_COUNTERS:
                events.append(
                    {
                        "ph": "C",
                        "name": name,
                        "cat": "device",
                        "pid": d + 1,
                        "tid": 0,
                        "ts": ts,
                        "args": {name: int(rec.counters.per_device[name][d])},
                    }
                )

    lat = timeline.latency_arrays() if hasattr(timeline, "latency_arrays") else None
    if lat is not None:
        hist, audit = lat
        ts_end = max((r.t0 + r.dur for r in records), default=0.0) * _US
        gauges: Dict[str, float] = dict(latency.percentile_gauges(hist))
        if audit is not None:
            rep = latency.audit_report(audit[0], audit[1])
            gauges["offload_mispricing"] = float(rep["mispricing_ratio"])
        for name, val in gauges.items():
            events.append(
                {
                    "ph": "C",
                    "name": name,
                    "cat": "latency",
                    "pid": _HOST_PID,
                    "tid": 0,
                    "ts": ts_end,
                    "args": {name: float(val)},
                }
            )

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "timeline": timeline.name,
            **{str(k): str(v) for k, v in timeline.meta.items()},
        },
    }


def write_trace(timeline: BatchTimeline, path: str) -> str:
    """Write the Perfetto-viewable trace JSON to ``path`` (its directory is
    made if missing; the repo ignores ``traces/``); returns ``path``.  On
    the rank backend every rank renders the trace and rank 0 alone writes
    it."""
    events = to_trace_events(timeline)
    rm = mesh.current()
    if rm is not None and rm.rank != 0:
        return path
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(path, "w") as f:
        json.dump(events, f)
    return path


@contextlib.contextmanager
def profiler_annotations(label: str, enabled: bool = True):
    """Optional ``torch.profiler`` hook: a ``record_function`` range named
    ``label`` around the enclosed dispatches, so the engine's own ranges
    show up under it in a profiler trace.  No-op when disabled; the range is
    metadata and costs nothing when no profiler is recording.
    """
    if not enabled:
        yield
        return
    with torch.profiler.record_function(label):
        yield
