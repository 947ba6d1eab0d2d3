"""Per-batch phase-segmented wall-time instrumentation for the mesh plane.

The engine runs each batch as one call of tensor programs on the card; its
internal phases (route, descent, fused exchange, apply) are not fenced
apart, since a host wait between them would serialise what the card
overlaps.  So the timeline works at two resolutions:

* **Host phases** — whole dispatches the caller already separates (engine
  call, shed-lane retry rounds, SMO settlement rounds, repartition install,
  scan probes).  Each is fenced with :func:`fence` on the FULL result tree,
  which waits for the card, so queued work cannot leak past the timer.
* **Device counters** — after each batch's fence we copy the ``[Dev,
  N_STATS]`` stats plane to the host and diff it against the previous batch
  (:func:`repro_torch.obs.registry.delta`).  The counters are maintained by
  the engine's existing sums; reading them adds a host transfer, never a
  collective.

Inside the engine, ``torch.profiler.record_function`` ranges (in
``core/engine.py``) label the phases for ``torch.profiler`` traces, with the
reference's names; they are metadata only and change no state, result or
count.

Shed-lane retry latency is tracked per op class as *batches to completion*:
``record_retry("insert", rounds)`` after a retry loop.

The modeled-latency ledger rides the same measure fences:
``prime_latency(state)`` after warmup snapshots the device histogram plane
(``DexState.lat_hist`` / ``lat_audit``, or a simulator's ``lat_hist``), and
``capture_latency(state)`` at the end of the measured window stores the
delta — ``summary()`` then carries a ``"latency"`` section (bucket schema,
counts, percentiles, per-path ledger) and, when the audit plane is present,
a ``"cost_audit"`` section (obs/latency.audit_report).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mesh
from repro_torch.obs import latency, registry


def _host(x: Any) -> np.ndarray:
    """A numpy copy of a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fleet(plane: Any) -> np.ndarray:
    """A per-device plane ``[Dev, ...]`` of the whole mesh on the host: on
    the rank backend every rank's block, gathered in device order
    (``mesh.gather_devices``; every rank must call it), so the sums over
    the device axis run in the virtual mesh's order."""
    if mesh.current() is not None:
        plane = mesh.gather_devices(torch.as_tensor(plane))
    return _host(plane)


def _latency_arrays(state_or_hist: Any) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Fleet-summed ``[classes, paths, buckets]`` histogram plus the optional
    ``[2, n_memory, levels]`` audit plane, from a ``DexState`` (mesh: sums the
    device axis, over every rank's devices on ranks), a ``Simulator``
    (already fleet-shaped), or a raw array."""
    hist = getattr(state_or_hist, "lat_hist", state_or_hist)
    hist = _fleet(hist) if np.ndim(hist) == 4 else _host(hist)
    if hist.ndim == 4:
        hist = hist.sum(axis=0)
    audit = getattr(state_or_hist, "lat_audit", None)
    if audit is not None:
        audit = _fleet(audit).astype(np.float64).sum(axis=0)
    return hist.astype(np.int64), audit


def _cuda_devices(tree: Any, out: set) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)


def fence(tree: Any) -> Any:
    """Wait until the work that produced ``tree`` is done; returns ``tree``.

    ``torch.cuda.synchronize`` on every CUDA device that holds a tensor of
    ``tree`` (tuples, lists, NamedTuples and dicts are walked).  This is a
    real wait on the card and is never skipped there; a tree of CPU tensors
    has nothing queued, so it returns at once."""
    devices: set = set()
    _cuda_devices(tree, devices)
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


def timed_call(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """Run ``fn`` and fence its FULL result tree; returns ``(result, secs)``."""
    t0 = time.perf_counter()
    out = fence(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


@dataclasses.dataclass
class PhaseSpan:
    name: str
    t0: float  # seconds since the timeline epoch
    dur: float  # seconds


@dataclasses.dataclass
class BatchRecord:
    index: int
    label: str  # op class / workload label for this batch
    t0: float
    dur: float
    phases: List[PhaseSpan] = dataclasses.field(default_factory=list)
    #: per-batch counter increments (named; per-device + fleet)
    counters: Optional[registry.Snapshot] = None
    #: op class -> shed-lane rounds-to-completion observed this batch
    retries: Dict[str, int] = dataclasses.field(default_factory=dict)

    def phase_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p in self.phases:
            out[p.name] = out.get(p.name, 0.0) + p.dur
        return out


class _Phase:
    """Context manager for one fenced phase inside a batch."""

    def __init__(self, batch: "_Batch", name: str):
        self._batch = batch
        self._name = name
        self._pending: Any = None

    def fence(self, tree: Any) -> Any:
        """Register ``tree`` to be fenced when the phase closes (and fence it
        now if the phase is being timed eagerly).  Returns ``tree``."""
        self._pending = tree
        return tree

    def __enter__(self) -> "_Phase":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and self._pending is not None:
            fence(self._pending)
        dur = time.perf_counter() - self._t0
        if exc_type is None:
            self._batch.record.phases.append(
                PhaseSpan(self._name, self._t0 - self._batch.timeline.epoch, dur)
            )


class _Batch:
    """Context manager for one batch; hands out phases and counter capture."""

    def __init__(self, timeline: "BatchTimeline", label: str):
        self.timeline = timeline
        self.record = BatchRecord(
            index=len(timeline.batches), label=label, t0=0.0, dur=0.0
        )

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def counters(self, state_or_stats: Any) -> registry.Snapshot:
        """Capture this batch's counter delta from a fenced ``DexState`` (or
        raw stats array).  Uses the timeline's running snapshot so repeated
        captures across batches yield per-batch increments.
        """
        snap = registry.snapshot(state_or_stats)
        prev = self.timeline._last_snap
        self.record.counters = registry.delta(snap, prev) if prev else snap
        self.timeline._last_snap = snap
        return self.record.counters

    def retry(self, op_class: str, rounds: int) -> None:
        self.record.retries[op_class] = int(rounds)

    # -- pipelined (cross-step) recording ---------------------------------
    # A pipelined batch's lifetime spans two engine steps (front half in
    # step s, back half in step s+1), so it cannot be a ``with`` block
    # around one dispatch: open it at push time, attach externally measured
    # spans, close it when its result lands.

    def open(self) -> "_Batch":
        """Begin the batch without a ``with`` block (see ``close``)."""
        self._t0 = time.perf_counter()
        self.record.t0 = self._t0 - self.timeline.epoch
        return self

    def add_span(self, name: str, t0: float, dur: float) -> None:
        """Attach a phase span measured externally — ``t0`` is an absolute
        ``time.perf_counter()`` stamp (it may predate ``open``; overlap
        windows legitimately interleave batches)."""
        self.record.phases.append(
            PhaseSpan(name, t0 - self.timeline.epoch, dur)
        )

    def close(self) -> BatchRecord:
        """Finalize an ``open``\\ ed batch and append it to the timeline."""
        self.record.dur = time.perf_counter() - self._t0
        self.timeline.batches.append(self.record)
        return self.record

    def __enter__(self) -> "_Batch":
        return self.open()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.record.dur = time.perf_counter() - self._t0
        if exc_type is None:
            self.timeline.batches.append(self.record)


class BatchTimeline:
    """Accumulates per-batch :class:`BatchRecord`\\ s for one benchmark run."""

    def __init__(self, name: str, meta: Optional[Mapping[str, Any]] = None):
        self.name = name
        self.meta: Dict[str, Any] = dict(meta or {})
        self.epoch = time.perf_counter()
        self.batches: List[BatchRecord] = []
        self._last_snap: Optional[registry.Snapshot] = None
        self._lat_base: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None
        self._lat: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None

    # -- recording --------------------------------------------------------

    def batch(self, label: str = "batch") -> _Batch:
        return _Batch(self, label)

    def open_batch(self, label: str = "batch") -> _Batch:
        """A batch whose lifetime the caller manages explicitly (pipelined
        execution: front and back halves land in different engine steps).
        Call ``close()`` on the returned batch to record it."""
        return _Batch(self, label).open()

    def prime(self, state_or_stats: Any) -> None:
        """Set the counter baseline (e.g. after warmup) so the first measured
        batch reports increments, not lifetime totals."""
        self._last_snap = registry.snapshot(state_or_stats)

    def prime_latency(self, state_or_hist: Any) -> None:
        """Latency-ledger analogue of :meth:`prime`: snapshot the histogram
        (and audit) plane at the measure fence so :meth:`capture_latency`
        reports the measured window only."""
        self._lat_base = _latency_arrays(state_or_hist)

    def capture_latency(self, state_or_hist: Any) -> np.ndarray:
        """Store the histogram/audit delta since :meth:`prime_latency` (or
        lifetime totals when never primed); returns the fleet-summed
        ``[classes, paths, buckets]`` histogram it recorded."""
        hist, audit = _latency_arrays(state_or_hist)
        if self._lat_base is not None:
            base_h, base_a = self._lat_base
            hist = hist - base_h
            if audit is not None and base_a is not None:
                audit = audit - base_a
        self._lat = (hist, audit)
        return hist

    def latency_arrays(self) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """The captured ``(hist, audit)`` pair, or None before
        :meth:`capture_latency` ran (used by obs/trace.py counter tracks)."""
        return self._lat

    def instrument(
        self, engine: Callable, *, label: str = "engine"
    ) -> Callable:
        """Wrap a mesh engine (or any dispatch whose first result is a
        ``DexState``): every call becomes one recorded batch with a single
        fenced phase plus a counter-delta capture.  The wrapper is a plain
        host-side shim around the engine — it adds no collective and
        changes no state, so lanes, stats and collective counts equal those
        of a bare call.
        """

        def wrapped(*args, **kwargs):
            with self.batch(label) as b:
                with b.phase(label) as ph:
                    out = engine(*args, **kwargs)
                    ph.fence(out)
                head = out[0] if isinstance(out, tuple) else out
                if hasattr(head, "stats"):
                    b.counters(head)
            return out

        if hasattr(engine, "plan"):
            wrapped.plan = engine.plan  # type: ignore[attr-defined]
        return wrapped

    # -- aggregation ------------------------------------------------------

    def records(self) -> List[BatchRecord]:
        """The recorded batches.  On the rank backend their times are the
        fleet's: each batch's and span's start and length the maximum over
        the ranks (the slowest rank's), so every rank returns the same
        records.  Every rank must call it, with the same batches and spans
        recorded (two ``all_reduce`` of host numbers, counting nothing)."""
        if mesh.current() is None:
            return self.batches
        flat = []
        for r in self.batches:
            flat += [r.t0, r.dur]
            for p in r.phases:
                flat += [p.t0, p.dur]
        n = len(flat)
        hi, neg_lo = mesh.host_max([n, -n])
        if hi != n or -neg_lo != n:
            raise ValueError(
                "the ranks recorded different batches or spans; a timeline "
                "over ranks records the same on every rank"
            )
        if n == 0:
            return self.batches
        it = iter(mesh.host_max(flat).tolist())
        out = []
        for r in self.batches:
            t0, dur = next(it), next(it)
            phases = [PhaseSpan(p.name, next(it), next(it)) for p in r.phases]
            out.append(dataclasses.replace(r, t0=t0, dur=dur, phases=phases))
        return out

    def phase_totals(self) -> Dict[str, Dict[str, float]]:
        return _phase_totals(self.records())

    def counter_totals(self) -> Dict[str, float]:
        fleet: Dict[str, int] = {}
        for rec in self.batches:
            if rec.counters is None:
                continue
            for name, val in rec.counters.fleet.items():
                fleet[name] = fleet.get(name, 0) + val
        named: Dict[str, float] = dict(fleet)
        for m in registry.METRICS:
            if m.kind == "derived":
                named[m.name] = float(m.compute(fleet))
        return named

    def retry_latency(self) -> Dict[str, Dict[str, float]]:
        """Shed-lane batches-to-completion per op class."""
        acc: Dict[str, List[int]] = {}
        for rec in self.batches:
            for opc, rounds in rec.retries.items():
                acc.setdefault(opc, []).append(rounds)
        return {
            opc: {
                "count": len(vals),
                "mean_rounds": sum(vals) / len(vals),
                "max_rounds": max(vals),
            }
            for opc, vals in acc.items()
        }

    def summary(self) -> Dict[str, Any]:
        """The run's totals; on the rank backend the same on every rank
        (:meth:`records`), which must all call it."""
        return self._summary(self.records())

    def _summary(self, recs: List[BatchRecord]) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "meta": self.meta,
            "n_batches": len(recs),
            "wall_s": sum(r.dur for r in recs),
            "phases": _phase_totals(recs),
            "counters": self.counter_totals(),
            "retry_latency": self.retry_latency(),
        }
        if self._lat is not None:
            hist, audit = self._lat
            out["latency"] = latency.latency_section(hist)
            if audit is not None:
                out["cost_audit"] = latency.audit_report(audit[0], audit[1])
        return out

    def to_json(self) -> Dict[str, Any]:
        """JSON-serialisable dump (``metrics_timeline.json`` payload); on
        the rank backend the same on every rank, which must all call it."""
        recs = self.records()
        return {
            **self._summary(recs),
            "batches": [
                {
                    "index": r.index,
                    "label": r.label,
                    "t0_s": r.t0,
                    "dur_s": r.dur,
                    "phases": [
                        {"name": p.name, "t0_s": p.t0, "dur_s": p.dur}
                        for p in r.phases
                    ],
                    "counters": (
                        r.counters.as_dict() if r.counters is not None else None
                    ),
                    "retries": r.retries,
                }
                for r in recs
            ],
        }


def _phase_totals(records: List[BatchRecord]) -> Dict[str, Dict[str, float]]:
    acc: Dict[str, List[float]] = {}
    for rec in records:
        for name, secs in rec.phase_seconds().items():
            acc.setdefault(name, []).append(secs)
    return {
        name: {
            "count": len(vals),
            "total_s": sum(vals),
            "mean_s": sum(vals) / len(vals),
            "max_s": max(vals),
        }
        for name, vals in acc.items()
    }


def obs_phase(obs: Optional[Any], name: str):
    """Phase hook used by core/smo.py and core/repartition.py: ``obs`` is a
    :class:`_Batch` (or anything with ``.phase``), or None for a no-op."""
    if obs is None:
        return contextlib.nullcontext()
    return obs.phase(name)
