"""Declarative metric registry — the single source of truth for counters.

Every mesh ``STAT_*`` slot of ``DexState.stats``, every simulator
``Counters`` field in :mod:`repro_torch.core.sim`, and every derived
figure-level metric is declared here exactly once as a :class:`Metric`.  The
``STAT_*`` constants below name the columns of the ``[Dev, N_STATS]`` counter
plane; the module checks them against :data:`MESH_SLOTS` at import, so a
counter can never silently alias another slot.  The column order is the
reference's (``repro/obs/registry.py``); the parity tests hold the two equal.

The registry imports numpy only; helpers that need the engine defer the
import to function scope, so any module may import it.

Cross-plane mapping
-------------------
A metric with both ``slot`` (mesh) and ``sim_field`` (simulator) set is
*paired*: the mesh counter and the simulator counter measure the same
physical event under the paper's cost model and may be compared by
``repro_torch.obs.drift``.  Mesh-only metrics (``sim_field=None``) are artifacts
of the SPMD execution strategy (drops, splits-pending, drains); sim-only
metrics (``slot=None``) are costs the mesh plane absorbs into its
collectives (bytes, CAS, coherence) and cannot observe per-event.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

#: kinds: "counter" = monotone int64 event count; "derived" = computed from
#: counters at snapshot time (float); "gauge" = a figure-level quantity both
#: planes report directly (not a stats slot), registered so drift checks
#: share the counter namespace.
KINDS = ("counter", "derived", "gauge")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One named metric.

    Attributes
    ----------
    name:        registry key, e.g. ``"fetches"``.
    unit:        human unit: "events", "ops", "rows", "bytes", "ratio", ...
    kind:        "counter" or "derived".
    slot:        mesh ``DexState.stats`` column index, or None if the mesh
                 plane does not track it.
    stat_const:  name of the ``STAT_*`` constant this module exports for the
                 slot (None for sim-only / derived metrics).
    sim_field:   field name on ``repro_torch.core.sim.Counters``, or None if the
                 simulator does not track it.
    provenance:  which paper figure / table this metric reproduces.
    doc:         one-line description (also feeds the DESIGN.md table).
    compute:     for derived metrics: ``f(named_counters) -> float`` where
                 ``named_counters`` maps counter names to scalars.
    """

    name: str
    unit: str
    kind: str
    slot: Optional[int] = None
    stat_const: Optional[str] = None
    sim_field: Optional[str] = None
    provenance: str = ""
    doc: str = ""
    compute: Optional[Callable[[Mapping[str, float]], float]] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"metric {self.name!r}: bad kind {self.kind!r}")
        if self.kind == "derived" and self.compute is None:
            raise ValueError(f"derived metric {self.name!r} needs compute=")
        if self.kind == "counter" and self.slot is None and self.sim_field is None:
            raise ValueError(f"counter {self.name!r} maps to neither plane")


def _ratio(num: str, den: str) -> Callable[[Mapping[str, float]], float]:
    def f(c: Mapping[str, float]) -> float:
        d = float(c.get(den, 0.0))
        return float(c.get(num, 0.0)) / d if d else 0.0

    return f


# ---------------------------------------------------------------------------
# The registry proper.
#
# MESH order is load-bearing: the tuple index IS the ``DexState.stats``
# column.  Append only; never reorder (checkpointed states index by slot).
# ---------------------------------------------------------------------------

_MESH = (
    Metric("ops", "ops", "counter", slot=0, stat_const="STAT_OPS",
           sim_field="ops", provenance="Fig. 8/13 (throughput denominators)",
           doc="operations admitted to the engine on this device"),
    Metric("hits", "events", "counter", slot=1, stat_const="STAT_HITS",
           sim_field="local_accesses", provenance="Fig. 11 (cache hit rate)",
           doc="descents resolved from the local cache, no remote read"),
    Metric("fetches", "events", "counter", slot=2, stat_const="STAT_FETCHES",
           sim_field="rdma_read", provenance="Table 2 / Fig. 8 (RDMA READ)",
           doc="remote row fetches (one-sided READ equivalent)"),
    Metric("offloads", "events", "counter", slot=3, stat_const="STAT_OFFLOADS",
           sim_field="two_sided", provenance="Fig. 12 (offload ratio)",
           doc="ops shipped to the owning memory column (two-sided RPC)"),
    Metric("drops", "events", "counter", slot=4, stat_const="STAT_DROPS",
           sim_field=None, provenance="shed-lane admission (mesh-only)",
           doc="ops shed to the retry lane this batch (re-admitted later)"),
    Metric("splits", "events", "counter", slot=5, stat_const="STAT_SPLITS",
           sim_field=None, provenance="§5 SMO (mesh-only)",
           doc="leaf splits requested and still pending settlement"),
    Metric("writes", "events", "counter", slot=6, stat_const="STAT_WRITES",
           sim_field="rdma_write", provenance="Table 2 (RDMA WRITE)",
           doc="write-through row updates (one-sided WRITE equivalent)"),
    Metric("smo_splits", "events", "counter", slot=7, stat_const="STAT_SMO_SPLITS",
           sim_field="smo_inserts", provenance="Fig. 10 (SMO volume)",
           doc="leaf splits settled by the on-mesh SMO engine"),
    Metric("drains", "events", "counter", slot=8, stat_const="STAT_DRAINS",
           sim_field=None, provenance="§5 SMO drain path (mesh-only)",
           doc="shed ops drained host-side instead of split on-mesh"),
    Metric("offload_groups", "groups", "counter", slot=9,
           stat_const="STAT_OFFLOAD_GROUPS", sim_field="offload_groups",
           provenance="Fig. 12 (grouped offload)",
           doc="contiguous same-leaf op groups coalesced into one offload"),
    Metric("fetch_groups", "groups", "counter", slot=10,
           stat_const="STAT_FETCH_GROUPS", sim_field="fetch_groups",
           provenance="Fig. 12 (grouped fetch)",
           doc="contiguous same-leaf op groups coalesced into one fetch"),
    Metric("pipeline_stalls", "events", "counter", slot=11,
           stat_const="STAT_PIPE_STALLS", sim_field="pipeline_stalls",
           provenance="§7 coherence under the pipelined overlap window",
           doc="lanes whose leaf version moved inside the overlap window: "
               "lookups/updates stale-forced two-sided, scans stall-shed "
               "(always 0 in batch-synchronous mode)"),
    Metric("peer_hits", "events", "counter", slot=12,
           stat_const="STAT_PEER_HITS", sim_field="peer_hits",
           provenance="§5.4 cooperative fleet caching (extend-dist, FlexKV)",
           doc="peer peeks answered from a sibling chip's version-fresh "
               "cached row (no memory-column walk needed)"),
    Metric("peer_misses", "events", "counter", slot=13,
           stat_const="STAT_PEER_MISSES", sim_field="peer_misses",
           provenance="§5.4 cooperative fleet caching (extend-dist, FlexKV)",
           doc="peer peeks the sibling could not serve from cache (stale or "
               "absent row); resolved by the owning column's block walk"),
    Metric("rt_skips", "events", "counter", slot=14,
           stat_const="STAT_RT_SKIPS", sim_field="rt_skips",
           provenance="§1 / Outback compute-side location resolution "
               "(leaf-direct route table, DESIGN.md §13)",
           doc="inner-level fetch rounds skipped by lanes whose leaf-direct "
               "route-table guess the version fence accepted"),
    Metric("rt_mispredicts", "events", "counter", slot=15,
           stat_const="STAT_RT_MISPREDICTS", sim_field="rt_mispredicts",
           provenance="§1 / Outback compute-side location resolution "
               "(leaf-direct route table, DESIGN.md §13)",
           doc="route-table guesses rejected by the fence-key bounds or the "
               "leaf version fence; the lane fell back to full cached descent"),
)

_SIM_ONLY = (
    Metric("rdma_small_read", "events", "counter", sim_field="rdma_small_read",
           provenance="Table 2 (small READ)",
           doc="sub-row one-sided reads (version probes, fence words)"),
    Metric("rdma_cas", "events", "counter", sim_field="rdma_cas",
           provenance="Table 2 (RDMA CAS)",
           doc="compare-and-swap ops (lock/version acquisition)"),
    Metric("bytes", "bytes", "counter", sim_field="bytes",
           provenance="Fig. 9 (network volume)",
           doc="total bytes moved over the fabric under the cost model"),
    Metric("offload_fallbacks", "events", "counter",
           sim_field="offload_fallbacks", provenance="Fig. 12",
           doc="offloads that fell back to one-sided reads (queue full)"),
    Metric("coherence_invalidations", "events", "counter",
           sim_field="coherence_invalidations", provenance="§4.3 coherence",
           doc="cache entries invalidated by remote writers"),
    Metric("refresh_from_root", "events", "counter",
           sim_field="refresh_from_root", provenance="§4.3 coherence",
           doc="full descents forced by a stale root after an SMO"),
)

_DERIVED = (
    Metric("hit_rate", "ratio", "derived", provenance="Fig. 11",
           doc="hits / ops — fraction of descents served from cache",
           compute=_ratio("hits", "ops")),
    Metric("drops_per_op", "ratio", "derived", provenance="shed-lane health",
           doc="drops / ops — shed-lane pressure per admitted op",
           compute=_ratio("drops", "ops")),
    Metric("offload_fraction", "ratio", "derived", provenance="Fig. 12",
           doc="offloads / ops — fraction of ops shipped to memory columns",
           compute=_ratio("offloads", "ops")),
    Metric("bytes_per_op", "bytes/op", "derived", provenance="Fig. 9",
           doc="bytes / ops — fabric volume per operation (sim plane)",
           compute=_ratio("bytes", "ops")),
    Metric("remote_reads_per_op", "reads/op", "derived",
           provenance="§1 (fewer remote accesses win) / Table 2",
           doc="fetches / ops — coalesced remote row reads per admitted op; "
               "paired cross-plane (mesh fetches vs sim rdma_read), gated by "
               "obs/drift in benchmarks/fig20_leaf_direct.py",
           compute=_ratio("fetches", "ops")),
)


def _latency_gauges() -> Tuple[Metric, ...]:
    """Per-op-class latency percentile gauges (DESIGN.md §12).  Both planes
    estimate them from the shared bucket schema in ``repro_torch.obs.latency``
    (mesh: ``DexState.lat_hist``; sim: ``Simulator.lat_hist``), so drift
    checks can gate p50/p99 per op class like any paired counter."""
    out = []
    for cls in ("lookup", "update", "insert", "scan"):
        for q in (50, 99):
            out.append(Metric(
                f"lat_p{q}_{cls}", "seconds", "gauge",
                provenance="§6 latency breakdown / Outback per-op rounds",
                doc=f"modeled p{q} {cls} latency from the shared log-bucket "
                    "histogram (geometric bucket midpoint)",
            ))
    return tuple(out)


_GAUGES = (
    Metric("moved_fraction", "fraction", "gauge",
           provenance="Fig. 10 / §4 (live repartition)",
           doc="fraction of dataset keys whose owner a boundary install "
               "moved (both planes compute it from their own tables)"),
) + _latency_gauges() + (
    Metric("offload_mispricing", "ratio", "gauge",
           provenance="§6.1 offload cost rule (audited)",
           doc="predicted / realized fetch bytes over the offload decision's "
               "fetch-side cells (obs/latency.py audit_report)"),
)

METRICS: Tuple[Metric, ...] = _MESH + _SIM_ONLY + _DERIVED + _GAUGES

BY_NAME: Dict[str, Metric] = {m.name: m for m in METRICS}
if len(BY_NAME) != len(METRICS):  # pragma: no cover - registry authoring bug
    raise RuntimeError("duplicate metric name in registry")

#: Mesh counter slots in DexState.stats column order.
MESH_SLOTS: Tuple[Metric, ...] = tuple(sorted(_MESH, key=lambda m: m.slot))
for _i, _m in enumerate(MESH_SLOTS):  # pragma: no cover - authoring bug
    if _m.slot != _i:
        raise RuntimeError(f"mesh slots not dense at {_m.name!r}")

#: Width of the DexState.stats counter row.
N_STATS: int = len(MESH_SLOTS)

#: name -> slot for the mesh plane.
SLOT_OF: Dict[str, int] = {m.name: m.slot for m in MESH_SLOTS}

#: Counter metrics tracked by the simulator, in Counters field order terms.
SIM_FIELDS: Dict[str, Metric] = {
    m.sim_field: m for m in METRICS if m.sim_field is not None
}

#: Paired metrics — present on both planes, comparable by obs.drift.
PAIRED: Tuple[Metric, ...] = tuple(
    m for m in MESH_SLOTS if m.sim_field is not None
)


def stat_constants() -> Dict[str, int]:
    """``{"STAT_OPS": 0, ...}`` in slot order."""
    return {m.stat_const: m.slot for m in MESH_SLOTS}


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

for _name, _slot in stat_constants().items():  # pragma: no cover - authoring bug
    if globals().get(_name) != _slot:
        raise RuntimeError(f"{_name} is not mesh slot {_slot}")


# ---------------------------------------------------------------------------
# Named views over raw counter arrays
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A named view over one ``DexState.stats`` array ``[Dev, N_STATS]``.

    ``per_device[name]`` is an int64 ``[Dev]`` vector; ``fleet[name]`` the
    cross-device sum; ``derived[name]`` the fleet-level derived metrics.
    """

    per_device: Dict[str, np.ndarray]
    fleet: Dict[str, int]
    derived: Dict[str, float]

    @property
    def n_devices(self) -> int:
        vec = next(iter(self.per_device.values()))
        return int(vec.shape[0])

    def __getitem__(self, name: str) -> float:
        if name in self.fleet:
            return self.fleet[name]
        return self.derived[name]

    def as_dict(self) -> Dict[str, float]:
        """Flat fleet view (counters + derived) for JSON emission."""
        out: Dict[str, float] = {k: int(v) for k, v in self.fleet.items()}
        out.update({k: float(v) for k, v in self.derived.items()})
        return out


def _to_host(stats) -> np.ndarray:
    if hasattr(stats, "detach"):  # a tensor, maybe on the card
        # a copy: a CPU tensor's numpy view would follow later writes
        stats = stats.detach().cpu().numpy().copy()
    arr = np.asarray(stats)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2 or arr.shape[1] != N_STATS:
        raise ValueError(
            f"stats array has shape {arr.shape}, want [Dev, {N_STATS}]"
        )
    return arr


def snapshot(state_or_stats) -> Snapshot:
    """Named snapshot of mesh counters.

    Accepts a ``DexState`` (anything with a ``.stats`` attribute) or the raw
    ``[Dev, N_STATS]`` array or tensor.  Device transfer happens here — call
    once per batch, after the fence.

    On the rank backend (``core/mesh.py``) the input is the rank's block,
    ``[Dl, N_STATS]``: every rank's block is gathered (``mesh.
    gather_devices``, a collective that counts nothing), so ``per_device``,
    ``fleet`` and ``derived`` are the whole mesh's, the virtual mesh's, on
    every rank.  Every rank must call it.
    """
    import torch

    from repro_torch.core import mesh

    stats = getattr(state_or_stats, "stats", state_or_stats)
    if mesh.current() is not None:
        t = torch.as_tensor(stats)
        stats = mesh.gather_devices(t[None, :] if t.dim() == 1 else t)
    arr = _to_host(stats)
    per_device = {m.name: arr[:, m.slot] for m in MESH_SLOTS}
    fleet = {name: int(vec.sum()) for name, vec in per_device.items()}
    derived = {m.name: float(m.compute(fleet)) for m in _DERIVED}
    return Snapshot(per_device=per_device, fleet=fleet, derived=derived)


def delta(after: Snapshot, before: Snapshot) -> Snapshot:
    """Per-batch counter increments: ``after - before`` (derived recomputed)."""
    per_device = {
        name: after.per_device[name] - before.per_device[name]
        for name in after.per_device
    }
    fleet = {name: int(vec.sum()) for name, vec in per_device.items()}
    derived = {m.name: float(m.compute(fleet)) for m in _DERIVED}
    return Snapshot(per_device=per_device, fleet=fleet, derived=derived)


def sim_view(counters) -> Dict[str, float]:
    """Named view over a ``repro_torch.core.sim.Counters`` (or any object carrying
    the registered sim fields).  Unrecognised fields are ignored; missing
    ones read as 0 so partial fakes work in tests.
    """
    named: Dict[str, float] = {}
    for field, metric in SIM_FIELDS.items():
        named[metric.name] = float(getattr(counters, field, 0) or 0)
    for m in _DERIVED:
        named[m.name] = float(m.compute(named))
    return named


def collectives_per_batch(fn, state, *args, by_phase: bool = False) -> Dict[str, int]:
    """Collective counts of one engine dispatch ``fn(state, *args)``.

    The reference traces the program and executes nothing.  The port counts
    its collectives as they run, and its engine writes the state in place,
    so this runs ``fn`` on a copy of ``state`` (every tensor cloned) and
    leaves the caller's state untouched.  ``by_phase`` adds the counts of
    each ``mesh.phase`` label, as ``mesh.collective_counts`` does.  The
    module counters are restored afterwards.  On the rank backend the
    dispatch runs collectives, so every rank must call it, with its own
    share of the state and its own lanes; each gets the virtual mesh's
    counts.
    """
    from repro_torch.core import mesh

    saved = (dict(mesh.COUNTS), {k: dict(v) for k, v in mesh.PHASE_COUNTS.items()})
    mesh.reset_counts()
    try:
        fn(_clone_tree(state), *args)
        return mesh.collective_counts(by_phase=by_phase)
    finally:
        mesh.COUNTS.update(saved[0])
        mesh.PHASE_COUNTS.clear()
        mesh.PHASE_COUNTS.update(saved[1])


def _clone_tree(x):
    """A copy of a (nested) NamedTuple of tensors with every tensor cloned."""
    if hasattr(x, "_fields"):
        return type(x)(*(_clone_tree(v) for v in x))
    if hasattr(x, "clone"):
        return x.clone()
    return x


# ---------------------------------------------------------------------------
# Docs generation — DESIGN.md §7.1 is rendered from here so it can't rot.
# ---------------------------------------------------------------------------


def markdown_table() -> str:
    """The counter table for DESIGN.md, generated from the registry."""
    lines = [
        "| name | unit | mesh slot | sim field | paper provenance | meaning |",
        "|---|---|---|---|---|---|",
    ]
    for m in MESH_SLOTS + _SIM_ONLY + _DERIVED + _GAUGES:
        slot = str(m.slot) if m.slot is not None else "—"
        sim = f"`{m.sim_field}`" if m.sim_field else "—"
        if m.kind != "counter":
            slot = m.kind
        lines.append(
            f"| `{m.name}` | {m.unit} | {slot} | {sim} | {m.provenance} | {m.doc} |"
        )
    return "\n".join(lines)
