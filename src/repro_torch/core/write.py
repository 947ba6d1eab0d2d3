"""Batched writes on the virtual mesh: the paper's update and insert
protocols (§7).

Updates and inserts share the engine's dataflow (``core/engine.py``: one
route round, one version-checked cached descent, one fused tagged request/
response exchange over the memory axis).  This module holds the owner-side
apply, :func:`_apply_leaf_writes`, and the thin single-opcode wrappers:

* :func:`make_dex_update` overwrites the value of an existing key in place.
  The owning memory column re-searches the authoritative leaf row at apply
  time and writes at the key's current slot; conflicting writers of one key
  are resolved by batch priority (updates before inserts, the last lane of a
  phase wins), as a sequential replay of the batch would.
* :func:`make_dex_insert` appends fresh keys into their leaf's slack slots
  with the ``leaf_write`` kernel and bumps the leaf's occupancy; a key that
  already exists becomes a value update.  **A leaf that would overflow is
  shed**: none of its staged inserts apply, and their lanes come back with
  ``STATUS_SPLIT``, counted in ``STAT_SPLITS``, for the structural path
  (the on-mesh SMO, ``core/smo.py``) to replay.

Cache coherence is write-through-and-invalidate with per-leaf versions: the
writing device refreshes (update) or drops (insert) its own cached row and
bumps the leaf's version, so other devices' copies fail the version check.

Result status codes, per lane: ``STATUS_OK`` applied; ``STATUS_MISS`` no-op
(update of an absent key, inactive lane); ``STATUS_SHED`` shed by a routing
bucket (retry it; ``STAT_DROPS``); ``STATUS_SPLIT`` insert shed to the
structural path.

The bottom rung of that path is on the host: :func:`drain_splits` replays
the inserts the on-mesh SMO could not place through a
:class:`repro_torch.core.sim.HostBTree` mirror and rebuilds the pool from
its contents (:func:`host_items`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dex import init_state
from repro_torch.core.nodes import FANOUT, KEY_MAX
from repro_torch.core.pool import PoolMeta, build_pool
from repro_torch.kernels import ops as kops
from repro_torch.obs.registry import STAT_DRAINS

STATUS_MISS = 0  # update of an absent key / inactive lane: no-op
STATUS_OK = 1  # write applied by the owning memory column
STATUS_SPLIT = 2  # insert shed to the structural path
STATUS_SHED = -1  # routing-bucket load shed; retry (STAT_DROPS)


def _seg_positions(mask: torch.Tensor, new_seg: torch.Tensor) -> torch.Tensor:
    """Rank of each ``mask`` lane within its segment (segments are runs
    delimited by ``new_seg`` over a sorted lane order).  The reference takes
    a running maximum of the exclusive count at segment starts; the count
    never falls, so each segment's start value is that maximum."""
    inc = mask.long()
    excl = torch.cumsum(inc, 0) - inc
    seg_id = torch.cumsum(new_seg, 0) - 1
    return excl - excl[new_seg][seg_id]


def _lexsort(*keys: torch.Tensor):
    """The order of ``jnp.lexsort(keys)``: by the last key, ties by the one
    before it, and so on, by one stable sort per key from the first up."""
    order = torch.sort(keys[0], stable=True).indices
    for k in keys[1:]:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _run_sums(x: torch.Tensor, new_run: torch.Tensor) -> torch.Tensor:
    """Per-lane sum of ``x`` over the lane's run (runs delimited by
    ``new_run``), from a cumulative sum: no scatter, so no contention on the
    one long run of inactive lanes."""
    c = torch.cumsum(x.long(), 0)
    starts = new_run.nonzero()[:, 0]
    ends = torch.cat([starts[1:] - 1, starts.new_full((1,), x.numel() - 1)])
    run_id = torch.cumsum(new_run, 0) - 1
    return (c[ends] - c[starts] + x[starts].long())[run_id]


def _apply_leaf_writes(
    pool_keys: torch.Tensor,  # [S, C, F] the whole pool
    pool_values: torch.Tensor,  # [S, C, F]
    occupancy: torch.Tensor,  # [S, C] int32
    meta: PoolMeta,
    gid: torch.Tensor,  # [N] int64 leaf gids from pool_keys' first row (KEY_MAX = inactive)
    key: torch.Tensor,  # [N] int64
    value: torch.Tensor,  # [N] int64
    prio: torch.Tensor,  # [N] int64, unique among live lanes
    allow_insert: torch.Tensor,  # [N] bool: absent keys may claim a slack slot
):
    """Apply one flat mixed batch of leaf-write requests to the pool.

    A lane whose key sits in its leaf becomes an in-place value write (the
    authoritative row is re-searched here); an absent key claims a slack
    slot when ``allow_insert`` and is a ``STATUS_MISS`` no-op otherwise.
    This is ``repro.core.write._apply_leaf_writes`` over the whole pool with
    global gids: the reference applies each memory column's gathered batch
    to its shard, and since a gid names one column, one call over all the
    columns' batches gives each lane the same fate.  A rank of the rank
    backend passes its own columns' rows and gids counted from their first
    row.

    ``pool_keys``, ``pool_values`` and ``occupancy`` are written **in
    place**, only at the leaves that took a write.  Returns ``(pool_keys,
    pool_values, occupancy, status [N] int32, rows_v_out [N, F] post-batch
    value rows, ins_in_leaf [N] bool)``; ``ins_in_leaf`` marks lanes whose
    leaf took a fresh insert this batch (its keys shifted, so a cached copy
    must not be refreshed in place)."""
    n = gid.shape[0]
    dev = gid.device
    cap = meta.subtree_cap
    valid = gid != KEY_MAX
    st = torch.where(valid, gid // cap, 0)
    lo = torch.where(valid, gid % cap, 0)
    row_k0 = pool_keys[st, lo]  # [N, F] pre-batch rows

    eqk = row_k0 == key[:, None]
    exists = eqk.any(-1) & valid
    slot32 = eqk.to(torch.uint8).argmax(-1).to(torch.int32)
    del row_k0, eqk
    live = valid & (exists | allow_insert)

    # conflict resolution: sort by (gid, key, prio); the last writer of each
    # (gid, key) run wins, the rest are superseded (and still applied, as a
    # sequential replay would have applied and then overwritten them)
    route_gid = torch.where(live, gid, KEY_MAX)
    order = _lexsort(prio, key, route_gid)
    g_s = route_gid[order]
    k_s = key[order]
    live_s = live[order]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    diff = (g_s[1:] != g_s[:-1]) | (k_s[1:] != k_s[:-1])
    new_run = torch.cat([one, diff])
    last_of_run = torch.cat([diff, one])
    winner = last_of_run & live_s

    # segments: one per distinct target leaf.  A segment's lanes share one
    # gid, so its (st, lo) is any lane's, and 0 for the inactive lanes' run
    new_seg = torch.cat([one, g_s[1:] != g_s[:-1]])
    seg_id = torch.cumsum(new_seg, 0) - 1
    st_s = st[order]
    lo_s = lo[order]
    seg_st = torch.zeros_like(st_s)
    seg_lo = torch.zeros_like(lo_s)
    n_seg = int(seg_id[-1]) + 1
    seg_st[:n_seg] = torch.where(live_s, st_s, 0)[new_seg]
    seg_lo[:n_seg] = torch.where(live_s, lo_s, 0)[new_seg]

    upd_w = winner & exists[order]
    ins_w = winner & live_s & ~exists[order]
    # overflow check: leaves whose fresh keys exceed the slack are shed
    occ_lane = occupancy[st_s, lo_s]
    over_lane = (occ_lane + _run_sums(ins_w, new_seg)) > FANOUT
    ins_apply = ins_w & ~over_lane
    upd_apply = upd_w  # in-place updates apply even when the leaf overflows

    # staged write planes, one row per segment
    pos_u = _seg_positions(upd_apply, new_seg)
    pos_i = _seg_positions(ins_apply, new_seg)
    v_s = value[order]
    upd_slot = torch.full((n, FANOUT), -1, dtype=torch.int32, device=dev)
    upd_val = torch.zeros((n, FANOUT), dtype=torch.int64, device=dev)
    u = upd_apply.nonzero()[:, 0]
    upd_slot[seg_id[u], pos_u[u]] = slot32[order[u]]
    upd_val[seg_id[u], pos_u[u]] = v_s[u]
    ins_key = torch.full((n, FANOUT), KEY_MAX, dtype=torch.int64, device=dev)
    ins_val = torch.zeros((n, FANOUT), dtype=torch.int64, device=dev)
    i = ins_apply.nonzero()[:, 0]
    ins_key[seg_id[i], pos_i[i]] = k_s[i]
    ins_val[seg_id[i], pos_i[i]] = v_s[i]

    # the masked scatter and merge itself (the leaf_write kernel)
    new_k, new_v, new_occ = kops.leaf_write(
        pool_keys[seg_st, seg_lo],
        pool_values[seg_st, seg_lo],
        upd_slot,
        upd_val,
        ins_key,
        ins_val,
    )
    del upd_slot, upd_val, ins_key, ins_val
    seg_active = torch.zeros((n,), dtype=torch.bool, device=dev)
    seg_active[:n_seg] = (_run_sums(upd_apply | ins_apply, new_seg) > 0)[new_seg]
    a = seg_active.nonzero()[:, 0]
    pool_keys[seg_st[a], seg_lo[a]] = new_k[a]
    pool_values[seg_st[a], seg_lo[a]] = new_v[a]
    occupancy[seg_st[a], seg_lo[a]] = new_occ[a]
    del new_k, new_v

    # per-lane status: every lane inherits its (gid, key) winner's fate
    outcome_w = torch.where(
        upd_apply | ins_apply,
        STATUS_OK,
        torch.where(ins_w & over_lane, STATUS_SPLIT, STATUS_MISS),
    ).to(torch.int32)
    # a live run's one winner is its last lane
    run_id = torch.cumsum(new_run, 0) - 1
    run_out = torch.where(winner, outcome_w, 0)[last_of_run]
    status_s = torch.where(live_s, run_out[run_id], STATUS_MISS)
    status = torch.empty_like(status_s).scatter_(0, order, status_s)

    rows_v_out = pool_values[st, lo]  # post-batch rows
    ins_lane_s = live_s & (_run_sums(ins_apply, new_seg) > 0)
    ins_in_leaf = torch.empty_like(ins_lane_s).scatter_(0, order, ins_lane_s)
    return pool_keys, pool_values, occupancy, status, rows_v_out, ins_in_leaf


def _single_op(meta, cfg, op: str, device):
    from repro_torch.core import engine as engine_mod  # engine imports us

    eng = engine_mod.make_dex_engine(meta, cfg, ops=(op,), device=device)
    code = {"update": engine_mod.OP_UPDATE, "insert": engine_mod.OP_INSERT}[op]

    def run(state, keys, values):
        keys = torch.as_tensor(keys, dtype=torch.int64)
        opcodes = torch.full(keys.shape, code, dtype=torch.int32)
        new_state, r = eng(state, opcodes, keys, torch.as_tensor(values))
        return new_state, r.status

    return run


def make_dex_update(meta: PoolMeta, cfg, *, device=None):
    """Build the in-place update: ``(state, keys, values) -> (state,
    status)``.

    A thin wrapper over the engine with ``ops=("update",)``: the write
    records ride its fused round (offloaded where the key's column offloads).
    ``keys``/``values`` [B] lanes are split evenly over the devices;
    ``status`` (``STATUS_OK`` / ``STATUS_MISS`` / ``STATUS_SHED``) comes back
    in the caller's lane order; ``KEY_MAX`` lanes are inactive."""
    return _single_op(meta, cfg, "update", device)


def make_dex_insert(meta: PoolMeta, cfg, *, device=None):
    """Build the insert: ``(state, keys, values) -> (state, status)``.

    A thin wrapper over the engine with ``ops=("insert",)``.  Fresh keys
    append into their leaf's slack slots; keys that already exist become
    value updates; a leaf that would overflow sheds its inserts with
    ``STATUS_SPLIT`` (``STAT_SPLITS``).  ``KEY_MAX`` lanes are inactive."""
    return _single_op(meta, cfg, "insert", device)


# ---------------------------------------------------------------------------
# host-side split replay (the bottom rung of the SMO path)
# ---------------------------------------------------------------------------


def host_items(host) -> "tuple[np.ndarray, np.ndarray]":
    """All (key, value) pairs of a :class:`repro_torch.core.sim.HostBTree`
    in sorted key order.

    The reference concatenates the leaves in id order and sorts the keys;
    leaves hold disjoint key ranges, so taking them in fence order and
    their live slots in row order gives the same arrays without a sort of
    every key (4.5M leaves at 200M keys)."""
    leaves = np.nonzero(host.LV == 0)[0]
    leaves = leaves[np.argsort(host.FLO[leaves], kind="stable")]
    live = np.arange(FANOUT)[None, :] < host.NK[leaves][:, None]
    return host.K[leaves][live], host.V[leaves][live]


def _release(state) -> None:
    """Give the card back the memory of a spent state's per-node planes (the
    pool, the cache, versions, occupancy, successors, the free lists).  A
    CPU state is left alone: its memory goes when the caller drops it."""
    planes = list(state.pool) + list(state.cache) + [
        state.versions, state.occupancy, state.succ, state.n_alloc
    ]
    for t in planes:
        if t.is_cuda:
            t.untyped_storage().resize_(0)


def drain_splits(state, meta: PoolMeta, cfg, host, shed_keys, shed_values, boundaries):
    """Replay shed inserts through the host tree's eager-split path and
    rebuild the mesh state from the result: the bottom rung of the SMO
    fallback ladder (``core/smo.py`` settles plain leaf splits on the
    device; this path takes a full parent, an exhausted free list, more than
    64 staged keys in a leaf and growth of the top tree).

    ``host`` is the :class:`repro_torch.core.sim.HostBTree` mirror the
    caller keeps in sync (it must already hold every write the mesh
    applied); ``shed_keys``/``shed_values`` are the lanes that came back
    ``STATUS_SPLIT``, in batch order.  Returns ``(new_state, new_meta)``: a
    pool rebuilt from the mirror at the old level M, fill, shard count,
    headroom and block size, with cold caches and versions; the stats and
    ``route_demand`` carry over, with ``STAT_DRAINS`` + 1 on device 0.  Ops
    built by ``make_dex_*`` must be rebuilt against ``new_meta``.

    On the card the old state is spent: its pool, cache, version,
    occupancy, successor and free-list planes are released before the new
    pool is allocated, so the two never coexist (tensors the caller shares
    with it, such as the pool it gave ``init_state``, go with it).  With no
    shed lanes this is a no-op that returns the same objects."""
    from repro_torch.core import mesh

    mesh.refuse_on_ranks("drain_splits, the host rebuild of the pool", 4)
    shed_keys = np.asarray(shed_keys)
    shed_values = np.asarray(shed_values)
    if shed_keys.size == 0:
        return state, meta
    for k, v in zip(shed_keys.tolist(), shed_values.tolist()):
        host.insert(int(k), int(v))
    items_k, items_v = host_items(host)
    device = state.stats.device
    stats = state.stats.clone()
    stats[0, STAT_DRAINS] += 1
    demand = state.route_demand.clone()
    _release(state)
    del state
    pool, new_meta = build_pool(
        items_k,
        items_v,
        level_m=meta.level_m,
        fill=meta.per_node / FANOUT,
        n_shards=cfg.n_memory,
        headroom=meta.headroom_frac,
        subtree_leaves=meta.leaves_per_subtree,
        device=device,
    )
    new_state = init_state(pool, new_meta, cfg, boundaries, device=device)
    return new_state._replace(stats=stats, route_demand=demand), new_meta
