"""Cross-plane drift checks: mesh (Plane B) counters vs simulator (Plane A).

Four mesh benchmarks used to hand-roll this comparison with four different
idioms (relative per-op error, raw ratio bands, absolute fraction gaps).
:func:`assert_plane_agreement` is the one shared helper: you hand it
anything counter-shaped from each plane plus per-metric tolerances, and it
returns a :class:`DriftReport` (raising :class:`PlaneDriftError` with the
readable report if any metric is out of tolerance).

Accepted "counter-shaped" inputs, resolved through the registry's names:

* a :class:`repro_torch.obs.timeline.BatchTimeline` (summed per-batch deltas),
* a :class:`repro_torch.obs.registry.Snapshot`,
* a ``repro_torch.core.sim.Counters`` (any object carrying registered sim fields),
* a plain mapping of metric name -> value.

Tolerances (see the factory helpers):

* ``rel(limit, per_op=True)`` — relative error, optionally after dividing
  both sides by their own ``ops`` (fig6mesh's per-op read/write checks),
* ``ratio(lo, hi)`` — the raw mesh/sim ratio band (fig13engine's grouped
  offload check, fig14meshload's split-volume check),
* ``absolute(limit)`` — absolute difference (fig10meshrep's moved-fraction
  check).

``min_count`` on any tolerance skips the check when both planes saw fewer
events than that — quick-mode runs are too noisy for ratios on tiny counts,
and a skipped check is reported as skipped, never silently dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.obs import registry

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Tolerance:
    kind: str  # "rel" | "ratio" | "abs"
    limit: float = 0.0  # for rel/abs
    lo: float = 0.0  # for ratio
    hi: float = 0.0  # for ratio
    per_op: bool = False  # normalise both sides by their own "ops" first
    min_count: float = 0.0  # skip when both planes are below this

    def describe(self) -> str:
        if self.kind == "rel":
            return f"rel<={self.limit:g}" + ("/op" if self.per_op else "")
        if self.kind == "ratio":
            return f"ratio in [{self.lo:g}, {self.hi:g}]"
        return f"abs<={self.limit:g}"


def rel(limit: float, *, per_op: bool = False, min_count: float = 0.0) -> Tolerance:
    return Tolerance("rel", limit=limit, per_op=per_op, min_count=min_count)


def ratio(lo: float, hi: float, *, min_count: float = 0.0) -> Tolerance:
    return Tolerance("ratio", lo=lo, hi=hi, min_count=min_count)


def absolute(limit: float, *, min_count: float = 0.0) -> Tolerance:
    return Tolerance("abs", limit=limit, min_count=min_count)


@dataclasses.dataclass(frozen=True)
class DriftEntry:
    name: str
    mesh: float
    sim: float
    tolerance: Tolerance
    measured: float  # the quantity the tolerance bounds (rel err / ratio / gap)
    ok: bool
    skipped: bool = False

    def format(self) -> str:
        status = "SKIP" if self.skipped else ("ok  " if self.ok else "DRIFT")
        return (
            f"  [{status}] {self.name:<24} mesh={self.mesh:>14.6g} "
            f"sim={self.sim:>14.6g}  {self.tolerance.describe():<20} "
            f"measured={self.measured:.4g}"
        )


@dataclasses.dataclass(frozen=True)
class DriftReport:
    label: str
    entries: List[DriftEntry]

    @property
    def ok(self) -> bool:
        return all(e.ok or e.skipped for e in self.entries)

    @property
    def failures(self) -> List[DriftEntry]:
        return [e for e in self.entries if not e.ok and not e.skipped]

    def format(self) -> str:
        head = f"plane agreement [{self.label}]: " + (
            "OK" if self.ok else f"{len(self.failures)} metric(s) out of tolerance"
        )
        return "\n".join([head] + [e.format() for e in self.entries])


class PlaneDriftError(AssertionError):
    def __init__(self, report: DriftReport):
        super().__init__(report.format())
        self.report = report


def _named(values: Any) -> Mapping[str, float]:
    """Coerce any supported counter carrier into a name -> value mapping."""
    if values is None:
        return {}
    if hasattr(values, "counter_totals"):  # BatchTimeline
        return values.counter_totals()
    if isinstance(values, registry.Snapshot):
        return values.as_dict()
    if isinstance(values, Mapping):
        return values
    if hasattr(values, "stats"):  # a DexState — snapshot it
        return registry.snapshot(values).as_dict()
    if any(hasattr(values, f) for f in registry.SIM_FIELDS):  # sim Counters
        return registry.sim_view(values)
    raise TypeError(f"cannot read counters from {type(values).__name__}")


def compare(
    mesh: Any,
    sim: Any,
    tolerances: Mapping[str, Tolerance],
    *,
    label: str = "",
) -> DriftReport:
    """Build the drift report without raising; see module docstring."""
    mesh_named = _named(mesh)
    sim_named = _named(sim)
    mesh_ops = float(mesh_named.get("ops", 0.0))
    sim_ops = float(sim_named.get("ops", 0.0))

    entries: List[DriftEntry] = []
    for name, tol in tolerances.items():
        if name not in registry.BY_NAME:
            raise KeyError(f"unregistered metric {name!r} in tolerances")
        m = float(mesh_named.get(name, 0.0))
        s = float(sim_named.get(name, 0.0))
        if max(abs(m), abs(s)) < tol.min_count:
            entries.append(DriftEntry(name, m, s, tol, 0.0, ok=True, skipped=True))
            continue
        mv, sv = m, s
        if tol.per_op:
            mv = m / mesh_ops if mesh_ops else 0.0
            sv = s / sim_ops if sim_ops else 0.0
        if tol.kind == "rel":
            measured = abs(mv - sv) / max(abs(sv), _EPS)
            ok = measured <= tol.limit
        elif tol.kind == "ratio":
            measured = mv / max(sv, _EPS)
            ok = tol.lo <= measured <= tol.hi
        else:  # abs
            measured = abs(mv - sv)
            ok = measured <= tol.limit
        entries.append(DriftEntry(name, m, s, tol, measured, ok=ok))
    return DriftReport(label=label, entries=entries)


def assert_plane_agreement(
    mesh: Any,
    sim: Any,
    tolerances: Mapping[str, Tolerance],
    *,
    label: str = "",
    verbose: bool = True,
) -> DriftReport:
    """Compare mesh vs sim counters; print the report, raise on drift."""
    report = compare(mesh, sim, tolerances, label=label)
    if verbose:
        print(report.format())
    if not report.ok:
        raise PlaneDriftError(report)
    return report
