"""Compute-side logical partitioning (paper §4).

Each compute server (a route row of the mesh) logically owns a disjoint key
range, while the memory servers present one global address space.  The
partitioning is *logical*: a table of boundaries, not a placement of data,
so repartitioning is a metadata update plus a cache invalidation.

:class:`LogicalPartitions` is the same numpy table as
``repro.core.partition.LogicalPartitions`` (its methods run on the host,
between batches); :meth:`LogicalPartitions.owner_of_device` is the one query
that runs on a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.nodes import KEY_MAX, KEY_MIN


def _distinct_inner(candidates, num_partitions: int) -> np.ndarray:
    """Force ``num_partitions - 1`` strictly increasing int64 boundaries in
    the open interval ``(KEY_MIN, KEY_MAX)``.

    A mesh has a fixed server count, so colliding candidates are perturbed
    (a forward pass pushes collisions up, a backward pass resolves clamps at
    the top); it raises only when the key space cannot hold the count.  The
    arithmetic is in Python ints: candidates can sit next to the int64
    sentinels, where ``+ 1`` would overflow int64."""
    n_inner = num_partitions - 1
    inner = sorted(int(c) for c in candidates)
    if len(inner) != n_inner:
        raise ValueError(f"expected {n_inner} boundary candidates, got {len(inner)}")
    if n_inner == 0:
        return np.zeros((0,), np.int64)
    if KEY_MAX - KEY_MIN - 1 < n_inner:
        raise ValueError(f"key space cannot hold {n_inner} distinct inner boundaries")
    prev = KEY_MIN
    for i in range(n_inner):
        inner[i] = min(max(inner[i], prev + 1), KEY_MAX - 1)
        prev = inner[i]
    nxt = KEY_MAX
    for i in range(n_inner - 1, -1, -1):
        inner[i] = min(inner[i], nxt - 1)
        nxt = inner[i]
    if inner[0] <= KEY_MIN:
        raise ValueError(
            f"cannot fit {n_inner} distinct inner boundaries above KEY_MIN"
        )
    return np.asarray(inner, dtype=np.int64)


def _table(inner: np.ndarray) -> "LogicalPartitions":
    b = np.concatenate([[KEY_MIN], inner, [KEY_MAX]]).astype(np.int64)
    return LogicalPartitions(b)


@dataclasses.dataclass(frozen=True)
class LogicalPartitions:
    """Key-range ownership table: ``boundaries`` has ``num_partitions + 1``
    int64 entries, partition ``p`` owns ``[boundaries[p], boundaries[p+1])``,
    ``boundaries[0] == KEY_MIN`` and ``boundaries[-1] == KEY_MAX``."""

    boundaries: np.ndarray  # [P+1] int64

    def __post_init__(self):
        b = np.asarray(self.boundaries, dtype=np.int64)
        assert b.ndim == 1 and b.size >= 2
        assert b[0] == KEY_MIN and b[-1] == KEY_MAX
        assert np.all(np.diff(b.astype(object)) > 0), "boundaries must increase"
        object.__setattr__(self, "boundaries", b)

    # -- construction -------------------------------------------------------

    @staticmethod
    def equal_width(num_partitions: int, lo: int, hi: int) -> "LogicalPartitions":
        """Equal key-range widths over ``[lo, hi)``; always
        ``num_partitions`` partitions (a range too narrow for distinct
        boundaries has them perturbed upward)."""
        inner = np.linspace(lo, hi, num_partitions + 1).astype(np.int64)[1:-1]
        return _table(_distinct_inner(inner, num_partitions))

    @staticmethod
    def from_samples(keys: np.ndarray, num_partitions: int) -> "LogicalPartitions":
        """Equal-frequency boundaries from sampled keys; few distinct
        samples perturb duplicate quantiles instead of collapsing the
        partition count."""
        keys = np.sort(np.asarray(keys, dtype=np.int64))
        qs = np.quantile(keys, np.linspace(0, 1, num_partitions + 1)[1:-1])
        return _table(_distinct_inner(qs.astype(np.int64), num_partitions))

    # -- queries -------------------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return self.boundaries.size - 1

    def owner_of(self, keys) -> np.ndarray:
        """Owning partition of each key (int32)."""
        keys = np.asarray(keys, dtype=np.int64)
        return (np.searchsorted(self.boundaries, keys, side="right") - 1).astype(
            np.int32
        )

    def owner_of_device(self, keys: torch.Tensor) -> torch.Tensor:
        """:meth:`owner_of` on an int64 tensor, on the tensor's device."""
        b = torch.as_tensor(self.boundaries).to(keys.device)
        return (torch.searchsorted(b, keys, right=True) - 1).to(torch.int32)

    def is_shared_range(self, lo, hi) -> np.ndarray:
        """True where a ``[lo, hi)`` fence range crosses a partition
        boundary: such nodes (the root, say) are reached by several compute
        servers (paper §4)."""
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        po = self.owner_of(lo)
        # hi is exclusive: probe the last key strictly inside the range
        ph = (
            np.searchsorted(self.boundaries, hi.astype(object) - 1, side="right") - 1
        ).astype(np.int32)
        return po != ph

    # -- elasticity and rebalancing (paper §4, Fig. 10) ----------------------

    def split_partition(self, p: int, at_key: int) -> "LogicalPartitions":
        """Scale-out: split partition ``p`` at ``at_key``."""
        lo, hi = self.boundaries[p], self.boundaries[p + 1]
        if not (lo < at_key < hi):
            raise ValueError("split key outside partition range")
        return LogicalPartitions(np.insert(self.boundaries, p + 1, at_key))

    def merge_partitions(self, p: int) -> "LogicalPartitions":
        """Scale-in: merge partition ``p`` with ``p + 1``."""
        if not (0 <= p < self.num_partitions - 1):
            raise ValueError("no right neighbour to merge with")
        return LogicalPartitions(np.delete(self.boundaries, p + 1))

    def rebalance(
        self,
        loads: Sequence[float],
        *,
        key_range: "tuple[int, int] | None" = None,
    ) -> "LogicalPartitions":
        """Move the boundaries toward equal load, taking the load as uniform
        within each partition; no data moves.

        The walk stays inside the data hull: ``key_range = (min_key,
        max_key)`` bounds the edge partitions exactly; without it their
        extents are taken as the mean inner width (with two partitions the
        hull then collapses around the one boundary, which barely moves).
        The partition count is kept: zero total load returns the table
        unchanged and colliding boundaries are perturbed, not merged."""
        loads = np.maximum(np.asarray(loads, dtype=np.float64), 0.0)
        assert loads.size == self.num_partitions
        n_parts = self.num_partitions
        total = float(loads.sum())
        if n_parts == 1 or total <= 0.0:
            return self
        inner_b = [int(x) for x in self.boundaries[1:-1]]
        if key_range is not None:
            hull_lo, hull_hi = int(key_range[0]), int(key_range[1])
            if hull_lo > hull_hi:
                hull_lo, hull_hi = hull_hi, hull_lo
        else:
            mean_w = (
                max(1, (inner_b[-1] - inner_b[0]) // (n_parts - 2))
                if n_parts > 2
                else 1
            )
            hull_lo = inner_b[0] - mean_w
            hull_hi = inner_b[-1] + mean_w
        # the hull encloses the inner boundaries and stays off the sentinels
        hull_lo = max(min(hull_lo, inner_b[0]), KEY_MIN + 1)
        hull_hi = min(max(hull_hi, inner_b[-1]), KEY_MAX - 1)
        edges = np.asarray([hull_lo] + inner_b + [hull_hi], dtype=np.float64)
        # inverse CDF of a piecewise-constant density; the epsilon keeps the
        # CDF strictly increasing through zero-load partitions
        eps = total * 1e-9 + 1e-12
        cum = np.concatenate([[0.0], np.cumsum(loads + eps)])
        targets = cum[-1] * np.arange(1, n_parts) / n_parts
        cand = np.floor(np.interp(targets, cum, edges))
        return _table(_distinct_inner(cand, n_parts))

    def assignment_diff(self, other: "LogicalPartitions") -> float:
        """Fraction of a sample of the key space whose owner changes, a
        proxy for the cache re-warm volume after repartitioning."""
        lo = max(int(self.boundaries[1]) - 1, -(2**62))
        hi = min(int(self.boundaries[-2]) + 1, 2**62)
        if hi <= lo:
            lo, hi = -(2**32), 2**32
        sample = np.linspace(lo, hi, 4097).astype(np.int64)
        return float(np.mean(self.owner_of(sample) != other.owner_of(sample)))
