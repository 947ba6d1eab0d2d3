"""Live logical repartitioning of the mesh plane (paper §4, Fig. 10).

The engine routes every lane to the compute partition (route row) that owns
its key and sheds what overflows a routing bucket.  Under sustained skew the
shed lanes retry into the same overloaded partition; the paper's answer is
to move the boundaries toward the load, which costs a table update and a
cache invalidation, never a data move.

:class:`RepartitionController` closes that loop between batches, as
``repro.core.repartition.RepartitionController`` does:

1. accumulate per-partition load from ``DexState.route_demand`` (routed
   requests counted at the source before bucketing, so shed lanes count
   too; without it the served ``STAT_OPS``), the drops, and the observed
   key hull;
2. decide: when the max/mean load crosses ``imbalance_threshold`` (or the
   drops exceed ``drop_frac`` of the ops) after ``min_ops``, call
   :meth:`LogicalPartitions.rebalance`;
3. install (:func:`install_boundaries`): swap the boundary table and bump
   the version of every pool node whose key range changed owner, so every
   device's cached copy fails its version check; retrain the route table
   when one is active.

The pool, occupancy and successor table never move.  Node ranges come from
the children graph on the state's device (:func:`node_key_ranges`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fleet_cache, mesh
from repro_torch.core.dex import DexState
from repro_torch.core.nodes import KEY_MAX, KEY_MIN
from repro_torch.core.partition import LogicalPartitions
from repro_torch.core.pool import PoolMeta, _level_offsets
from repro_torch.obs.registry import N_STATS, STAT_DROPS, STAT_OPS


@dataclasses.dataclass(frozen=True)
class RepartitionConfig:
    """Trigger policy of the controller."""

    imbalance_threshold: float = 1.25  # max/mean demand ratio
    drop_frac: float = 0.01  # drops / ops that force a trigger
    min_ops: int = 1024  # accumulate at least this many ops
    cooldown_batches: int = 1  # decisions skipped after an install


@dataclasses.dataclass
class RepartitionReport:
    """What one boundary install did."""

    old_boundaries: np.ndarray
    new_boundaries: np.ndarray
    loads: np.ndarray  # per-partition load of the window
    drops: int  # routing-bucket drops of the window
    imbalance: float  # max/mean of ``loads``
    fraction_keyspace_moved: float  # LogicalPartitions.assignment_diff
    nodes_invalidated: int  # pool nodes whose version was bumped
    shared_nodes_before: int  # boundary-crossing nodes, old table
    shared_nodes_after: int  # boundary-crossing nodes, new table


def node_key_ranges(
    pool_keys: torch.Tensor,
    meta: PoolMeta,
    pool_children: Optional[torch.Tensor] = None,
    *,
    with_levels: bool = False,
):
    """Fence ranges ``(gids, lo, hi)`` (int64 tensors on the pool's device)
    of every real pool node, level by level from the block roots down.

    A node's range runs from its first key to the next node's first key at
    its level; the leftmost node of a level starts at ``KEY_MIN`` and the
    rightmost ends at ``KEY_MAX``.  Levels come from walking the children
    graph from each block's root (on-mesh splits put siblings in free-list
    rows, so a node's level is not a function of its slot); without
    ``pool_children`` the bulk layout is assumed.  A child id is taken as
    the reference takes it: any id in ``[0, subtree_cap)``, so the 0-padded
    children of a merged parent row mark the block root a level lower, as
    they do there.  ``with_levels`` adds each node's level (int32, 0 =
    leaf).  Sorts are stable, as the reference's."""
    pk0 = pool_keys[:, :, 0]
    n_sub, cap = pk0.shape
    dev = pk0.device
    lvl_of = torch.full((n_sub, cap), -1, dtype=torch.int32, device=dev)
    lvl_of[:, 0] = meta.level_m
    if pool_children is not None:
        for lvl in range(meta.level_m, 0, -1):
            s_idx, c_idx = torch.nonzero(lvl_of == lvl, as_tuple=True)
            if s_idx.numel() == 0:
                break
            ch = pool_children[s_idx, c_idx]
            valid = (ch >= 0) & (ch < cap)
            s_rep = s_idx[:, None].expand_as(ch)[valid]
            lvl_of[s_rep, ch[valid].long()] = lvl - 1
    else:
        offs = _level_offsets(meta.per_node, meta.level_m, meta.leaves_per_subtree)
        for lvl in range(meta.level_m + 1):
            lvl_of[:, int(offs[lvl]) : int(offs[lvl + 1])] = meta.level_m - lvl
    base = torch.arange(n_sub, dtype=torch.int64, device=dev) * meta.subtree_cap
    gid_grid = base[:, None] + torch.arange(cap, dtype=torch.int64, device=dev)
    gids, los, his, lvls = [], [], [], []
    for lvl in range(meta.level_m, -1, -1):
        real = (lvl_of == lvl) & (pk0 != KEY_MAX)
        # subtrees are key-ordered and a level's ranges are disjoint, so
        # first-key order is the level's key order
        lo_r, order = torch.sort(pk0[real], stable=True)
        gids.append(gid_grid[real][order])
        hi_r = torch.full_like(lo_r, KEY_MAX)
        hi_r[:-1] = lo_r[1:]
        lo_r[:1] = KEY_MIN
        los.append(lo_r)
        his.append(hi_r)
        lvls.append(torch.full_like(lo_r, lvl, dtype=torch.int32))
    out = (torch.cat(gids), torch.cat(los), torch.cat(his))
    if with_levels:
        return out + (torch.cat(lvls),)
    return out


def moved_intervals(
    old: LogicalPartitions, new: LogicalPartitions
) -> List[Tuple[int, int]]:
    """Key intervals ``[a, b)`` whose owning partition differs between the
    two tables, adjacent ones coalesced."""
    pts = np.unique(np.concatenate([old.boundaries, new.boundaries]).astype(np.int64))
    starts = pts[:-1]
    changed = old.owner_of(starts) != new.owner_of(starts)
    out: List[Tuple[int, int]] = []
    for i in np.where(changed)[0]:
        a, b = int(pts[i]), int(pts[i + 1])
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _n_shared(parts: LogicalPartitions, lo: torch.Tensor, hi: torch.Tensor) -> int:
    """How many ``[lo, hi)`` ranges cross a boundary of ``parts``
    (``LogicalPartitions.is_shared_range`` on the device)."""
    b = torch.as_tensor(parts.boundaries).to(lo.device)
    po = torch.searchsorted(b, lo, right=True) - 1
    ph = torch.searchsorted(b, hi - 1, right=True) - 1
    # hi - 1 wraps at KEY_MIN, where the exact answer is partition -1
    ph = torch.where(hi == KEY_MIN, -1, ph)
    return int((po != ph).sum())


def install_boundaries(
    state: DexState,
    meta: PoolMeta,
    old: LogicalPartitions,
    new: LogicalPartitions,
) -> Tuple[DexState, int, int, int]:
    """Install ``new`` boundaries: swap the boundary table and bump
    ``versions`` on every device for each pool node whose fence range meets
    a moved key interval, so every cached copy of it is refetched.  Returns
    ``(new_state, nodes_invalidated, shared_before, shared_after)``; the
    new state's ``boundaries`` and ``versions`` are new tensors."""
    mesh.refuse_on_ranks("install_boundaries, the boundary install", 3)
    gids, lo, hi = node_key_ranges(
        state.pool.pool_keys, meta, state.pool.pool_children
    )
    affected = torch.zeros_like(lo, dtype=torch.bool)
    for a, b in moved_intervals(old, new):
        affected |= (lo < b) & (hi > a)
    new_state = state._replace(
        boundaries=torch.as_tensor(new.boundaries).to(state.boundaries.device),
        versions=fleet_cache.invalidate_nodes(state.versions, gids[affected]),
    )
    return (
        new_state,
        int(affected.sum()),
        _n_shared(old, lo, hi),
        _n_shared(new, lo, hi),
    )


def _host(x) -> Optional[np.ndarray]:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


class RepartitionController:
    """Between-batch control loop that turns load shedding into
    repartitioning::

        ctl = RepartitionController(parts, n_memory=cfg.n_memory)
        for batch in trace:
            state, result = engine(state, ...)
            ctl.observe(state.stats, keys, demand=state.route_demand)
            state, report = ctl.maybe_repartition(state, meta)

    It touches the state only through :func:`install_boundaries` (and the
    route-table retrain after an install)."""

    def __init__(
        self,
        parts: LogicalPartitions,
        *,
        n_memory: int,
        cfg: Optional[RepartitionConfig] = None,
    ):
        self.parts = parts
        self.n_memory = int(n_memory)
        self.cfg = cfg or RepartitionConfig()
        self._last_stats: Optional[np.ndarray] = None
        self._last_demand: Optional[np.ndarray] = None
        self._loads = np.zeros((parts.num_partitions,), np.float64)
        self._drops = 0
        self._ops = 0
        self._cooldown = 0
        self._key_lo: Optional[int] = None
        self._key_hi: Optional[int] = None
        self.reports: List[RepartitionReport] = []

    def observe(self, stats, keys=None, demand=None):
        """Fold one batch's cumulative counters into the window: ``stats``
        is ``DexState.stats`` [Dev, N_STATS], ``demand`` the preferred load
        signal ``DexState.route_demand`` [Dev, n_route], ``keys`` the batch's
        keys (their hull bounds the rebalance walk).  Tensors or arrays."""
        stats = np.asarray(_host(stats), dtype=np.int64)
        assert stats.ndim == 2 and stats.shape[1] == N_STATS
        delta = stats if self._last_stats is None else stats - self._last_stats
        self._last_stats = stats.copy()
        per_dev = delta.reshape(self.parts.num_partitions, self.n_memory, N_STATS)
        if demand is not None:
            demand = np.asarray(_host(demand), dtype=np.int64)
            prev = (
                self._last_demand
                if self._last_demand is not None
                else np.zeros_like(demand)
            )
            d_delta = demand - prev
            self._last_demand = demand.copy()
            self._loads += d_delta.sum(axis=0).astype(np.float64)
            # the window counts demand, not served ops: the served count
            # loses exactly the dropped lanes whose load is the signal
            self._ops += int(d_delta.sum())
        else:
            self._loads += per_dev[:, :, STAT_OPS].sum(axis=1).astype(np.float64)
            self._ops += int(per_dev[:, :, STAT_OPS].sum())
        self._drops += int(per_dev[:, :, STAT_DROPS].sum())
        if keys is not None:
            keys = np.asarray(_host(keys), dtype=np.int64)
            keys = keys[keys != KEY_MAX]  # inactive lanes
            if keys.size:
                lo, hi = int(keys.min()), int(keys.max())
                self._key_lo = lo if self._key_lo is None else min(self._key_lo, lo)
                self._key_hi = hi if self._key_hi is None else max(self._key_hi, hi)

    @property
    def imbalance(self) -> float:
        """Max/mean load of the current window."""
        if self._loads.sum() <= 0:
            return 1.0
        return float(self._loads.max() / self._loads.mean())

    def should_repartition(self) -> bool:
        if self._cooldown > 0 or self._ops < self.cfg.min_ops:
            return False
        if self.imbalance >= self.cfg.imbalance_threshold:
            return True
        return self._drops > self.cfg.drop_frac * max(self._ops, 1)

    def propose(self) -> LogicalPartitions:
        """A new boundary table for the window's loads."""
        key_range = (
            (self._key_lo, self._key_hi)
            if self._key_lo is not None and self._key_lo < self._key_hi
            else None
        )
        return self.parts.rebalance(self._loads, key_range=key_range)

    def maybe_repartition(
        self, state: DexState, meta: PoolMeta, *, obs=None
    ) -> Tuple[DexState, Optional[RepartitionReport]]:
        """Repartition if the trigger fires.  Returns the (possibly new)
        state and a report when the boundaries moved.  The first
        ``cooldown_batches`` calls after an install are skipped.  ``obs``
        is an optional telemetry batch (``obs/timeline.py``): the boundary
        install becomes its fenced phase ``repartition/install``."""
        mesh.refuse_on_ranks("maybe_repartition, the boundary install", 3)
        if self._cooldown > 0:
            self._cooldown -= 1
            return state, None
        if not self.should_repartition():
            return state, None
        new_parts = self.propose()
        if np.array_equal(new_parts.boundaries, self.parts.boundaries):
            self._reset_window()
            return state, None
        from repro_torch.core import route_table  # route_table imports us
        from repro_torch.obs.timeline import obs_phase

        with obs_phase(obs, "repartition/install") as ph:
            new_state, n_inval, sh_before, sh_after = install_boundaries(
                state, meta, self.parts, new_parts
            )
            # the version bumps already fence the table's moved entries off;
            # retraining brings the leaf-direct path back under the new owners
            if route_table.route_table_active(new_state):
                new_state = route_table.train_route_table(new_state, meta)
            if ph is not None:
                ph.fence(new_state.boundaries)
        report = RepartitionReport(
            old_boundaries=self.parts.boundaries.copy(),
            new_boundaries=new_parts.boundaries.copy(),
            loads=self._loads.copy(),
            drops=self._drops,
            imbalance=self.imbalance,
            fraction_keyspace_moved=self.parts.assignment_diff(new_parts),
            nodes_invalidated=n_inval,
            shared_nodes_before=sh_before,
            shared_nodes_after=sh_after,
        )
        self.reports.append(report)
        self.parts = new_parts
        self._reset_window()
        self._cooldown = self.cfg.cooldown_batches
        return new_state, report

    def _reset_window(self) -> None:
        self._loads = np.zeros_like(self._loads)
        self._drops = 0
        self._ops = 0
