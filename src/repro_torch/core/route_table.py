"""Leaf-direct route table of the mesh plane.

Every engine lane otherwise pays the whole cached inner descent before it
reaches its leaf.  The route table maps a key straight to a predicted leaf:
its entries are the leaves' fence ranges, sorted, held in five replicated
arrays of ``DexState`` (``rt_keys`` / ``rt_hi`` / ``rt_sub`` / ``rt_local``
/ ``rt_ver``), and a prediction is one ``searchsorted``
(``routing.rt_predict``).

Correctness never rests on the table: the engine acts on a guess only when
``fleet_cache.rt_accept`` finds the key inside the entry's fence range, the
subtree equal to the top walk's and the leaf's version equal to the stamp
taken here.  Any write, split or repartition move bumps a leaf's version,
so a stale entry is rejected and its lanes take the full descent until the
next training.  When the pool holds more leaves than slots, the leaves of
the demand-hottest route partitions are kept first.

Training runs between batches on the state's device, from the children
graph (``repartition.node_key_ranges``), as the reference's runs on the host
(``repro.core.route_table``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mesh
from repro_torch.core.dex import DexState
from repro_torch.core.nodes import KEY_MAX
from repro_torch.core.pool import PoolMeta
from repro_torch.core.repartition import node_key_ranges


def route_table_active(state: DexState) -> bool:
    """Does the state carry a live (trained) entry?"""
    return bool((state.rt_ver >= 0).any())


def leaf_ranges(state: DexState, meta: PoolMeta):
    """Fence ranges ``(gids, lo, hi)`` of every leaf, sorted by ``lo``
    (stable), from the children graph."""
    gids, lo, hi, lvl = node_key_ranges(
        state.pool.pool_keys, meta, state.pool.pool_children, with_levels=True
    )
    keep = lvl == 0
    lo, order = torch.sort(lo[keep], stable=True)
    return gids[keep][order], lo, hi[keep][order]


def train_route_table(
    state: DexState, meta: PoolMeta, *, slots: Optional[int] = None
) -> DexState:
    """(Re)train the table from the current pool: one entry per leaf fence
    range, stamped with the leaf's current version on device 0.  With more
    leaves than ``slots`` (default: the table's size), the leaves of the
    demand-hottest route partitions are kept (a stable sort, so key order
    breaks ties and the kept set stays a union of key ranges).  Returns a
    new state with new table arrays of ``slots`` entries."""
    mesh.refuse_on_ranks("train_route_table, the leaf-direct route table", 3)
    r = int(state.rt_keys.shape[0]) if slots is None else int(slots)
    gids, lo, hi = leaf_ranges(state, meta)
    if gids.numel() > r:
        boundaries = state.boundaries
        n_route = boundaries.shape[0] - 1
        demand = state.route_demand.sum(0)
        owner = torch.searchsorted(boundaries, lo, right=True) - 1
        owner = owner.clamp(0, n_route - 1)
        hot = torch.sort(-demand[owner], stable=True).indices[:r]
        keep = torch.sort(hot).values
        gids, lo, hi = gids[keep], lo[keep], hi[keep]
    n = gids.numel()
    dev = lo.device
    rt_keys = torch.full((r,), KEY_MAX, dtype=torch.int64, device=dev)
    rt_hi = torch.full_like(rt_keys, KEY_MAX)
    rt_sub = torch.zeros((r,), dtype=torch.int32, device=dev)
    rt_local = torch.zeros_like(rt_sub)
    rt_ver = torch.full_like(rt_sub, -1)
    rt_keys[:n] = lo
    rt_hi[:n] = hi
    rt_sub[:n] = (gids // meta.subtree_cap).to(torch.int32)
    rt_local[:n] = (gids % meta.subtree_cap).to(torch.int32)
    rt_ver[:n] = state.versions[0, gids]
    return state._replace(
        rt_keys=rt_keys, rt_hi=rt_hi, rt_sub=rt_sub, rt_local=rt_local, rt_ver=rt_ver
    )


def poison_route_table(state: DexState) -> DexState:
    """Bump every live entry's stamp by ``1 << 20`` so the version fence
    rejects every guess: a fully poisoned table must give exactly the
    descent-only answers, every guess a mispredict.  The bump is large so
    that later writes cannot re-arm an entry (a ``+1`` bump would alias one
    write's version bump).  Returns a new state."""
    ver = state.rt_ver.clone()
    ver[ver >= 0] += 1 << 20
    return state._replace(rt_ver=ver)
