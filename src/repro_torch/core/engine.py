"""The mesh plane's execution engine: point lookups, updates, inserts and
range scans.

:func:`make_dex_engine` runs a batch of mixed lookups, updates, inserts and
scans over the virtual mesh (``core/mesh.py``) the way the reference's
unified engine does, batched over the ``Dev`` axis:

  1. one route round: ``routing.route_owners``, ``pack_by_dest`` and
     ``route_exchange`` move each lane to the route row owning its key (an
     engine with writes or scans carries its value, opcode and batch
     priority along);
  2. the replicated top-tree walk (``pool.top_walk``, ``node_search``) and
     the per-column offload decision: each destination memory column's
     group of live lanes compares its predicted fetch bytes (the per-column,
     per-level miss-rate EMA) against the two-sided RPC bytes;
  3. the version-checked cached descent, one ``cached_fetch_level`` per
     level, with ``node_search`` picking the child at inner levels and
     matching the key at the leaf; inserts stop above the leaf;
  3b. scan lanes only: successor-chain hops over ``DexState.succ``, one
     ``cached_fetch_level`` per hop while a lane's count is not yet covered,
     then the ``leaf_scan`` kernel compacts each lane's window of leaf rows;
  4. one request/response exchange over the memory axis: offloaded lanes
     are walked by the owning column with the ``subtree_walk`` kernel, and
     every write is applied there in one conflict-resolved batch
     (``write._apply_leaf_writes``, the ``leaf_write`` kernel);
  5. version bumps and the write-through refresh (updates) or drop
     (inserts) of the writer's own cached row; the EMA, stat, latency-
     histogram and audit planes, and the return trip over the route axis.

``policy="fetch"`` never offloads; ``policy="offload"`` offloads every live
lane that is not a scan and runs no descent unless scans need it;
``policy="auto"`` decides per column.  Scans never offload and leave the
miss EMA alone.  With ``route_table_slots > 0`` a lane that stays one-sided
first asks the leaf-direct route table (``core/route_table.py``): an
accepted guess skips the inner levels and probes its leaf directly, a
rejected one takes the full descent.  Reads (lookups and scans) see the
pre-batch index, then updates apply, then inserts (a phase-offset batch
priority); an insert into a leaf that would overflow comes back
``STATUS_SPLIT`` for ``core/smo.py``.
The pipelined engine, divergent cache policies, peer peeks and two route
axes are not ported yet: asking for them raises.

The engine writes its state in place: the cache planes, and with writes the
pool's key and value planes, ``occupancy`` and ``versions``.  The returned
state shares these tensors with the one it was given, which saves a copy of
the pool per batch; a caller that needs the pre-batch state keeps a copy.
"""

from __future__ import annotations

from math import inf
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fleet_cache, mesh, routing
from repro_torch.core.dex import (
    NODE_ROW_BYTES,
    OFFLOAD_REQ_BYTES,
    OFFLOAD_RESP_BYTES,
    DexMeshConfig,
    DexState,
)
from repro_torch.core.fleet_cache import DexCache, cached_fetch_level
from repro_torch.core.nodes import FANOUT, KEY_MAX
from repro_torch.core.pool import PoolMeta, top_walk
from repro_torch.core.write import (
    STATUS_MISS,
    STATUS_OK,
    STATUS_SHED,
    STATUS_SPLIT,
    _apply_leaf_writes,
)
from repro_torch.kernels import ops as kops
from repro_torch.obs import latency as obs_latency
from repro_torch.obs.registry import (
    N_STATS,
    STAT_DROPS,
    STAT_FETCH_GROUPS,
    STAT_FETCHES,
    STAT_HITS,
    STAT_OFFLOAD_GROUPS,
    STAT_OFFLOADS,
    STAT_OPS,
    STAT_RT_MISPREDICTS,
    STAT_RT_SKIPS,
    STAT_SPLITS,
    STAT_WRITES,
)

OP_LOOKUP, OP_UPDATE, OP_INSERT, OP_SCAN = 0, 1, 2, 3
ALL_OPS = ("lookup", "update", "insert", "scan")
_OP_CODES = {
    "lookup": OP_LOOKUP,
    "update": OP_UPDATE,
    "insert": OP_INSERT,
    "scan": OP_SCAN,
}
DEFAULT_MAX_COUNT = 128

# fused-round message tags (field 0 of a request record)
MSG_NONE = 0  # no request from this lane (or bucket padding)
MSG_UPDATE = 1  # fetched-path update: gid known from the descent
MSG_INSERT = 2  # fetched-path slack-slot insert: gid from the descent
MSG_OFF_LOOKUP = 3  # offloaded lookup: the owner walks its block
MSG_OFF_UPDATE = 4  # offloaded update: the owner walks, then writes
MSG_OFF_INSERT = 5  # offloaded insert: the owner walks, then merges
REQ_FIELDS = 6  # (tag, gid, subtree, key, value, prio)
RESP_HEAD = 4  # (status, value, gid, leaf-took-inserts) ahead of the value row


def scan_hops(meta: PoolMeta, max_count: int) -> int:
    """Leaves a ``max_count``-record scan may read: its start leaf (which
    may contribute nothing) plus enough least-filled leaves for the rest.
    The static bound of the hop loop; each lane stops reading as soon as its
    count is covered."""
    return 1 + -(-max_count // meta.min_leaf_fill)


class EngineResult(NamedTuple):
    """Per-lane results of one batch, in the caller's lane order:
    ``found``/``values`` answer lookups, ``status`` answers writes
    (``write.STATUS_*``), ``shed`` marks lanes shed anywhere (retry them).
    ``scan_keys``/``scan_values`` [B, max_count] and ``taken`` [B] int32
    answer scans (``taken == -1`` for a shed scan) and are None for an engine
    without ``"scan"``."""

    found: torch.Tensor
    values: torch.Tensor
    status: torch.Tensor
    shed: torch.Tensor
    scan_keys: Optional[torch.Tensor] = None
    scan_values: Optional[torch.Tensor] = None
    taken: Optional[torch.Tensor] = None


class Descent(NamedTuple):
    """What the cached descent hands the rest of the batch, per lane
    ``[Dev, Q]`` or per device."""

    found: torch.Tensor  # leaf match (one-sided lookup and update lanes)
    value: torch.Tensor
    gid: torch.Tensor  # the leaf's global node id
    shed: torch.Tensor  # a fetch bucket dropped the lane
    fmiss: torch.Tensor  # some level paid a remote fetch
    cost: torch.Tensor  # modelled seconds so far
    cache: DexCache
    miss_cl: torch.Tensor  # [Dev, n_memory, levels] misses per column/level
    want_cl: torch.Tensor  # [Dev, n_memory, levels] lanes per column/level
    realized: torch.Tensor  # [Dev, n_memory, levels] distinct fetched bytes
    n_hit: torch.Tensor  # [Dev]
    n_fetch: torch.Tensor  # [Dev] coalesced remote reads
    rows_k: Optional[torch.Tensor] = None  # [Dev, Q, F] leaf rows (scans)
    rows_v: Optional[torch.Tensor] = None


class Fused(NamedTuple):
    """The fused round's answers, per lane ``[Dev, Q]``."""

    send: torch.Tensor  # the lane sent a request
    dropped: torch.Tensor  # a request bucket dropped it
    status: torch.Tensor  # int32 STATUS_* from the owner
    value: torch.Tensor  # offloaded lookups' value
    gid: torch.Tensor  # the leaf the owner wrote (KEY_MAX if none)
    ins: torch.Tensor  # the leaf took a fresh insert this batch
    row_v: torch.Tensor  # [Dev, Q, F] the leaf's post-batch value row


def fma32(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 with one rounding, as a fused multiply-add.

    XLA contracts the reference's multiply-adds into FMAs; PyTorch rounds
    each operation.  The product of two float32 values is exact in float64,
    the float64 sum's error is recovered exactly (TwoSum), and a float64 sum
    that lands on a float32 tie is resolved by the error's sign, so the
    result equals a true FMA on any device."""
    p = torch.as_tensor(a, dtype=torch.float32).double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    lo = torch.where(r.double() <= s, r, torch.nextafter(r, r.new_tensor(-inf)))
    hi = torch.nextafter(lo, lo.new_tensor(inf))
    tie = (lo.double() + hi.double()) * 0.5 == s
    return torch.where(tie & (err != 0), torch.where(err > 0, hi, lo), r)


def _dot_levels(caps: torch.Tensor, ema: torch.Tensor) -> torch.Tensor:
    """``sum(caps * ema, axis=-1)`` in XLA's order: the first product, then
    one fused multiply-add per further level."""
    acc = caps[..., 0] * ema[..., 0]
    for i in range(1, caps.shape[-1]):
        acc = fma32(caps[..., i], ema[..., i], acc)
    return acc


def make_dex_engine(
    meta: PoolMeta,
    cfg: DexMeshConfig,
    *,
    ops: Tuple[str, ...] = ("lookup",),
    max_count: int = DEFAULT_MAX_COUNT,
    cache_policy: "fleet_cache.CachePolicy | None" = None,
    pipeline: bool = False,
    device=None,
):
    """Build the engine ``(state, opcodes, keys, values) -> (state,
    EngineResult)`` on ``device`` (None = CUDA).

    ``ops`` is any non-empty subset of ``ALL_OPS``.
    ``opcodes``/``keys``/``values`` are [B] lanes, split evenly over the
    virtual devices (lanes ``dev*b .. (dev+1)*b`` start on device ``dev``);
    ``keys == KEY_MAX`` lanes and opcodes outside ``ops`` are inactive.
    Update and insert lanes carry their new value in ``values``, scan lanes
    their record count (clipped to ``max_count``); lookups ignore it.
    ``ops`` prunes statically: an engine without writes or scans routes keys
    alone and carries no write round, one without scans no hops.  The
    returned function carries the reference's ``plan`` attribute.  The state
    is updated in place (see the module's docstring)."""
    ops = tuple(ops)
    for o in ops:
        if o not in ALL_OPS:
            raise ValueError(f"unknown op {o!r}; options: {ALL_OPS}")
    if not ops:
        raise ValueError("ops must name at least one operation")
    if cfg.policy not in ("fetch", "offload", "auto"):
        raise ValueError(f"unknown policy {cfg.policy!r}")
    if pipeline:
        raise NotImplementedError("the pipelined engine is not ported yet")
    if len(cfg.route_axes) != 1:
        raise NotImplementedError("two route axes are not ported yet")
    if not fleet_cache.is_uniform(cache_policy):
        raise NotImplementedError("divergent cache policies are not ported yet")
    device = mesh.resolve_device(device)

    has_lookup = "lookup" in ops
    has_update = "update" in ops
    has_insert = "insert" in ops
    has_scan = "scan" in ops
    has_writes = has_update or has_insert
    # lanes that can offload (scans never do)
    has_offloadable = has_lookup or has_writes
    # the route round carries opcode, value and priority planes
    route_planes = has_writes or has_scan
    enabled = [_OP_CODES[o] for o in ops]
    levels = meta.levels_in_subtree
    mc = max_count
    hops = scan_hops(meta, mc) if has_scan else 0
    may_offload = has_offloadable and cfg.policy != "fetch"
    # scans need the descent to their start leaf under every policy
    do_descent = has_scan or cfg.policy != "offload" or not has_offloadable
    # the leaf level serves lookups, updates and a scan's first hop; inserts
    # stop above it
    do_leaf = has_lookup or has_update or has_scan
    audit = has_offloadable and cfg.policy == "auto"
    # the leaf-direct route table; with no slots the program is the
    # descent-only one
    use_rt = cfg.route_table_slots > 0 and do_descent
    nr, nm, n_dev = cfg.n_route, cfg.n_memory, cfg.n_devices
    s_per = meta.n_subtrees_padded // nm
    n_nodes = meta.n_nodes
    # per-level node population of one column: the fetch side of the cost
    # rule is capped by it
    level_nodes = torch.tensor(
        [
            float(s_per * min(meta.per_node**lvl, meta.leaves_per_subtree))
            for lvl in range(levels)
        ],
        dtype=torch.float32,
        device=device,
    )
    # XLA folds ``NODE_ROW_BYTES * offload_c`` into one float32 constant
    row_cost = float(np.float32(NODE_ROW_BYTES) * np.float32(cfg.offload_c))
    rpc_bytes = float(OFFLOAD_REQ_BYTES + OFFLOAD_RESP_BYTES)
    dev_index = mesh.device_linear_index(cfg, device)
    first = (dev_index == 0).long()
    my_col = mesh.memory_linear_index(cfg, device)[:, None]
    plan = {
        "route_rounds": 1,
        "fused_pairs": 1 if (may_offload or has_writes) else 0,
        "descent_levels": (levels if do_leaf else levels - 1) if do_descent else 0,
        "scan_hops": hops,
        "pipeline": False,
    }

    def offload_decision(ema, col, live):
        """Each destination column's group of live lanes offloads when its
        predicted fetch bytes beat the RPC bytes; counts are mesh-global.
        Returns ``(want_off_c, grp_live, caps)``."""
        none = torch.zeros((n_dev, nm), dtype=torch.bool, device=device)
        if not may_offload:
            return none, none, None
        n_live_c = torch.zeros((n_dev, nm), dtype=torch.int64, device=device)
        n_live_c = mesh.psum(n_live_c.scatter_add_(1, col, live.long()))
        grp_live = n_live_c > 0
        if cfg.policy == "offload":
            return torch.ones_like(grp_live), grp_live, None
        nf = n_live_c.float()
        caps = torch.minimum(nf[..., None], level_nodes)
        want_off_c = _dot_levels(caps, ema) * row_cost > nf * rpc_bytes
        return want_off_c, grp_live, caps

    def descent(
        state, q, subtree, col, want, leaf_want, cost, is_scan, acc=None, p_loc=None
    ) -> Descent:
        """The version-checked cached descent: one ``cached_fetch_level`` per
        level for the ``want`` lanes (``leaf_want`` at the leaf),
        ``node_search`` for the child at inner levels and for the match at
        the leaf.  Without a leaf level it stops at the leaf's id.  Scan
        lanes leave the miss observation and the audit's realized bytes
        alone; an engine with scans keeps the leaf rows for their window.
        Lanes of ``acc`` (route-table guesses accepted) skip the inner
        levels and land on their predicted leaf ``p_loc``."""
        nq = q.shape[1]
        flat_q = q.reshape(-1)
        cache = state.cache
        local = torch.zeros_like(q)
        fmiss = torch.zeros_like(want)
        shed = torch.zeros_like(want)
        n_fetch = torch.zeros(n_dev, dtype=torch.int64, device=device)
        n_hit = torch.zeros_like(n_fetch)
        miss_cl = torch.zeros((n_dev, nm, levels), device=device)
        want_cl = torch.zeros_like(miss_cl)
        realized = torch.zeros_like(miss_cl)
        found = torch.zeros_like(want)
        value = torch.zeros_like(q)
        leaf_k = leaf_v = None
        inner_want = want if acc is None else want & ~acc
        for lvl in range(levels if do_leaf else levels - 1):
            leaf = lvl == levels - 1
            if leaf and acc is not None:
                local = torch.where(acc, p_loc, local)
            gid = meta.node_gid(subtree, local)
            if leaf:
                want = leaf_want
                salt = state.stats[:, STAT_OPS, None] + torch.arange(
                    nq, device=device
                )
                p_ok = fleet_cache.leaf_admit(cfg, cache_policy, gid, salt)
            else:
                want = inner_want
                p_ok = torch.ones_like(want)
            rows_k, rows_c, rows_v, hit, miss, f_drop, n_msgs, cache = (
                cached_fetch_level(
                    state.pool, meta, cfg, cache, state.versions, gid, want, p_ok
                )
            )
            fetched = miss & ~f_drop
            cost = cost + (
                hit.float() * obs_latency.T_CACHED
                + fetched.float() * obs_latency.T_READ
            )
            fmiss = fmiss | fetched
            shed = shed | f_drop
            n_fetch = n_fetch + n_msgs
            n_hit = n_hit + hit.sum(1)
            zero = torch.zeros((n_dev, nm), device=device)
            obs = want & ~is_scan
            miss_cl[..., lvl] = zero.scatter_add(1, col, (miss & obs).float())
            want_cl[..., lvl] = zero.scatter_add(1, col, obs.float())
            if audit:
                # realized bytes count distinct fetched nodes per column
                nset = torch.zeros(
                    (n_dev, n_nodes + 1), dtype=torch.bool, device=device
                )
                seen = fetched & ~is_scan
                nset.scatter_(1, torch.where(seen, gid, n_nodes), True)
                cnt = nset[:, :n_nodes].view(n_dev, nm, -1).sum(-1).float()
                realized[..., lvl] = cnt * float(NODE_ROW_BYTES)
            rows_k = rows_k.view(-1, FANOUT)
            if leaf:
                _, found, value = kops.node_search(
                    rows_k, flat_q, rows_v.view(-1, FANOUT)
                )
                found = found.view(n_dev, nq) & want
                value = value.view(n_dev, nq)
                if has_scan:
                    leaf_k, leaf_v = rows_k.view(n_dev, nq, FANOUT), rows_v
            else:
                slot, _, _ = kops.node_search(rows_k, flat_q)
                local = rows_c.view(-1, FANOUT).gather(1, slot.long()[:, None])
                local = local.view(n_dev, nq).long()
        if not do_leaf and acc is not None:
            # inserts stop above the leaf: accepted lanes take the guess
            local = torch.where(acc, p_loc, local)
        return Descent(
            found=found,
            value=value,
            gid=meta.node_gid(subtree, local),
            shed=shed,
            fmiss=fmiss,
            cost=cost,
            cache=cache,
            miss_cl=miss_cl,
            want_cl=want_cl,
            realized=realized,
            n_hit=n_hit,
            n_fetch=n_fetch,
            rows_k=leaf_k,
            rows_v=leaf_v,
        )

    def scan_window(state, q, cnt, is_scan, d: Descent):
        """The scan lanes' successor-chain hops: the start leaf's row, then
        one ``cached_fetch_level`` per hop over ``DexState.succ`` for the
        lanes whose collected records fall short of their count, then the
        ``leaf_scan`` kernel over each lane's window.  Reads the pre-batch
        pool and runs before any write.  Returns the descent with its shed,
        cost, cache and counters carried forward, and ``(keys, values,
        taken)``."""
        nq = q.shape[1]
        succ = state.succ[0]
        qc = q[..., None]
        win_k = [torch.where(is_scan[..., None], d.rows_k, KEY_MAX)]
        win_v = [torch.where(is_scan[..., None], d.rows_v, 0)]
        collected = ((win_k[0] != KEY_MAX) & (win_k[0] >= qc)).sum(-1)
        in_range = is_scan
        gid_h = d.gid
        shed, cost, fmiss, cache = d.shed, d.cost, d.fmiss, d.cache
        n_hit, n_fetch = d.n_hit, d.n_fetch
        for h in range(1, hops):
            nxt = succ[torch.where(in_range, gid_h, 0)]
            in_range = in_range & (collected < cnt) & (nxt >= 0)
            gid_h = torch.where(in_range, nxt, gid_h)
            gid = torch.where(in_range, gid_h, 0)
            salt = state.stats[:, STAT_OPS, None] + h + torch.arange(
                nq, device=device
            )
            p_ok = fleet_cache.leaf_admit(cfg, cache_policy, gid, salt)
            rows_k, _, rows_v, hit, miss, f_drop, n_msgs, cache = (
                cached_fetch_level(
                    state.pool, meta, cfg, cache, state.versions, gid, in_range, p_ok
                )
            )
            shed = shed | f_drop
            n_fetch = n_fetch + n_msgs
            n_hit = n_hit + hit.sum(1)
            # each hop prices one more leaf read and its local search
            fetched = miss & ~f_drop
            cost = cost + (
                hit.float() * obs_latency.T_CACHED
                + fetched.float() * obs_latency.T_READ
                + in_range.float() * obs_latency.T_LOCAL
            )
            fmiss = fmiss | fetched
            rows_k = torch.where(in_range[..., None], rows_k, KEY_MAX)
            rows_v = torch.where(in_range[..., None], rows_v, 0)
            collected = collected + ((rows_k != KEY_MAX) & (rows_k >= qc)).sum(-1)
            win_k.append(rows_k)
            win_v.append(rows_v)
        w = hops * FANOUT
        sc_k, sc_v, taken = kops.leaf_scan(
            torch.cat(win_k, -1).view(-1, w),
            torch.cat(win_v, -1).view(-1, w),
            q.reshape(-1),
            cnt.reshape(-1),
            max_count=mc,
        )
        del win_k, win_v
        ok = (is_scan & ~shed).view(-1)
        sc_k = torch.where(ok[:, None], sc_k, KEY_MAX).view(n_dev, nq, mc)
        sc_v = torch.where(ok[:, None], sc_v, 0).view(n_dev, nq, mc)
        taken = torch.where(
            ok.view(n_dev, nq), taken.view(n_dev, nq), torch.where(is_scan & shed, -1, 0)
        ).to(torch.int32)
        d = d._replace(
            shed=shed,
            cost=cost,
            fmiss=fmiss,
            cache=cache,
            n_hit=n_hit,
            n_fetch=n_fetch,
            rows_k=None,
            rows_v=None,
        )
        return d, (sc_k, sc_v, taken)

    def no_descent(state, q, subtree, cost) -> Descent:
        zero_cl = torch.zeros((n_dev, nm, levels), device=device)
        zero_dev = torch.zeros(n_dev, dtype=torch.int64, device=device)
        none = torch.zeros_like(q, dtype=torch.bool)
        return Descent(
            found=none,
            value=torch.zeros_like(q),
            gid=meta.node_gid(subtree, torch.zeros_like(q)),
            shed=none,
            fmiss=none,
            cost=cost,
            cache=state.cache,
            miss_cl=zero_cl,
            want_cl=zero_cl,
            realized=zero_cl,
            n_hit=zero_dev,
            n_fetch=zero_dev,
        )

    def owner_walk(pool, q, subtree, send):
        """The lookup engine's fused exchange over the memory axis: the
        owning column walks its subtree block for each ``send`` lane with
        the ``subtree_walk`` kernel.  Returns ``(found, value, dropped)``."""
        nq = q.shape[1]
        dest = torch.where(send, subtree // s_per, nm)
        wcap = routing.route_capacity(nq, nm, cfg.route_capacity_factor)
        wbuf, wlane, dropped = routing.pack_by_dest(
            torch.stack([subtree, q], -1), dest, nm, wcap
        )
        req = mesh.a2a(wbuf, cfg, cfg.memory_axis).reshape(n_dev, -1, 2)
        stf, kf = req[..., 0], req[..., 1]
        walk = kf != KEY_MAX
        # a request on column m names a subtree of m's shard
        st = my_col * s_per + torch.where(walk, stf % s_per, 0)
        o_found, o_val, _ = kops.subtree_walk(
            pool.pool_keys,
            pool.pool_children,
            pool.pool_values,
            st.reshape(-1).to(torch.int32),
            kf.reshape(-1).contiguous(),
            levels=levels,
            active=walk.reshape(-1),
        )
        o_found = o_found.view(walk.shape) & walk
        o_val = torch.where(walk, o_val.view(walk.shape), 0)
        resp = torch.stack([o_found.long(), o_val], -1).view(n_dev, nm, wcap, 2)
        resp = mesh.a2a(resp, cfg, cfg.memory_axis)
        back = routing.unpack_to_lanes(resp, wlane, nq, 0)
        return back[..., 0] != 0, back[..., 1], dropped & send

    def write_round(state, q, val, opc, pr, subtree, col, offl, d: Descent):
        """The fused tagged request/response exchange of an engine with
        writes.  Each lane's request goes to its leaf's memory column; the
        columns' batches are gathered over the route replicas and applied
        to the one pool once: offloaded lanes first walk the pre-batch pool
        (``subtree_walk``), then every write applies (``leaf_write``), and
        each device takes its own route row of the response."""
        pool = state.pool
        nq = q.shape[1]
        live = q != KEY_MAX
        ok_lane = live & ~d.shed
        tag = torch.zeros_like(q)
        if has_lookup and may_offload:
            tag = torch.where(
                ok_lane & (opc == OP_LOOKUP) & offl, MSG_OFF_LOOKUP, tag
            )
        if has_update:
            is_up = ok_lane & (opc == OP_UPDATE)
            if may_offload:
                tag = torch.where(is_up & offl, MSG_OFF_UPDATE, tag)
            tag = torch.where(is_up & ~offl & d.found, MSG_UPDATE, tag)
        if has_insert:
            is_in = ok_lane & (opc == OP_INSERT)
            if may_offload:
                tag = torch.where(is_in & offl, MSG_OFF_INSERT, tag)
            tag = torch.where(is_in & ~offl, MSG_INSERT, tag)
        send = tag != MSG_NONE
        dest = torch.where(send, col, nm)
        wcap = routing.route_capacity(nq, nm, cfg.route_capacity_factor)
        fetched_w = (tag == MSG_UPDATE) | (tag == MSG_INSERT)
        payload = torch.stack(
            [tag, torch.where(fetched_w, d.gid, KEY_MAX), subtree, q, val, pr], -1
        )
        wbuf, wlane, dropped = routing.pack_by_dest(payload, dest, nm, wcap)
        dropped = dropped & send
        req = mesh.a2a(wbuf, cfg, cfg.memory_axis)  # [Dev, nm, wcap, RF]
        # [nm, nr, nm, wcap, RF]: each column's batch, gathered once
        flat = mesh.gather_route(req, cfg).reshape(-1, REQ_FIELDS)
        tagf, gidf, stf, kf, vf, prf = (c.contiguous() for c in flat.unbind(-1))
        wgid = torch.where((tagf == MSG_UPDATE) | (tagf == MSG_INSERT), gidf, KEY_MAX)
        resp_val = torch.zeros_like(kf)
        if may_offload:
            # the owner-side walk reads the pre-batch pool
            walk = (tagf >= MSG_OFF_LOOKUP) & (tagf <= MSG_OFF_INSERT)
            col_f = torch.arange(kf.numel(), device=device) // (nr * nm * wcap)
            st = col_f * s_per + torch.where(walk, stf % s_per, 0)
            o_found, o_val, o_loc = kops.subtree_walk(
                pool.pool_keys,
                pool.pool_children,
                pool.pool_values,
                st.to(torch.int32),
                kf,
                levels=levels,
                active=walk,
            )
            o_found = o_found & walk
            off_w = (tagf == MSG_OFF_UPDATE) | (tagf == MSG_OFF_INSERT)
            wgid = torch.where(off_w, meta.node_gid(stf, o_loc.long()), wgid)
            lk = tagf == MSG_OFF_LOOKUP
            resp_val = torch.where(lk, o_val, 0)
        allow_ins = (tagf == MSG_INSERT) | (tagf == MSG_OFF_INSERT)
        _, _, _, wstat, rows_v, ins_in_leaf = _apply_leaf_writes(
            pool.pool_keys,
            pool.pool_values,
            state.occupancy,
            meta,
            wgid,
            kf,
            vf,
            prf,
            allow_ins,
        )
        if may_offload:
            wstat = torch.where(
                lk, torch.where(o_found, STATUS_OK, STATUS_MISS).to(wstat.dtype), wstat
            )
        resp = torch.cat(
            [
                wstat[:, None].long(),
                resp_val[:, None],
                wgid[:, None],
                ins_in_leaf[:, None].long(),
                rows_v,
            ],
            -1,
        )
        del rows_v
        width = RESP_HEAD + FANOUT
        # each device answers its own route row
        resp = mesh.route_share(resp.view(nm, nr, nm, wcap, width), cfg)
        resp = mesh.a2a(resp, cfg, cfg.memory_axis)
        back = routing.unpack_to_lanes(resp, wlane, nq, 0)
        return Fused(
            send=send,
            dropped=dropped,
            status=back[..., 0].to(torch.int32),
            value=back[..., 1],
            gid=back[..., 2],
            ins=back[..., 3] != 0,
            row_v=back[..., RESP_HEAD:],
        )

    def write_through(state, cache: DexCache, opc, f: Fused):
        """Version bumps (mesh-wide maximum) and the writer's own cache:
        refresh an updated leaf's value row, drop an inserted leaf's row."""
        delivered = f.send & ~f.dropped
        wrote_ok = (
            delivered
            & ((opc == OP_UPDATE) | (opc == OP_INSERT))
            & (f.status == STATUS_OK)
        )
        vers = state.versions
        nv = vers.gather(1, torch.where(wrote_ok, f.gid, 0)) + 1
        bump = torch.zeros(n_nodes + 1, dtype=vers.dtype, device=device)
        at = torch.where(wrote_ok, f.gid, n_nodes).reshape(-1)
        bump.scatter_reduce_(0, at, nv.reshape(-1), "amax")
        new_vers = torch.maximum(mesh.pmax(vers), bump[:n_nodes])
        set_idx = routing.umod(routing.hash64(f.gid), cfg.cache_sets)
        dd = torch.arange(n_dev, device=device)[:, None]
        eqt = cache.tags[dd, set_idx] == f.gid[..., None]
        chit = eqt.any(-1) & wrote_ok
        way = fleet_cache._first_true(eqt)
        slot = (dd * cfg.cache_sets + set_idx) * cfg.cache_ways + way
        # lanes that hit one (set, way) carry one gid, so one row and one
        # version: duplicate writes agree
        if has_update:
            # not when the leaf also took inserts: the cached keys would be
            # stale under a current version; the old stamp forces a refetch
            u = (chit & (opc == OP_UPDATE) & ~f.ins).nonzero(as_tuple=True)
            cache.values.view(-1, FANOUT)[slot[u]] = f.row_v[u]
            cache.ver.view(-1)[slot[u]] = nv[u]
        if has_insert:
            i = (chit & (opc == OP_INSERT)).nonzero(as_tuple=True)
            cache.tags.view(-1)[slot[i]] = -1
        vers.copy_(new_vers)
        return cache

    def engine(state: DexState, opcodes, keys, values):
        keys = torch.as_tensor(keys).to(device=device, dtype=torch.int64)
        if keys.shape[0] % n_dev:
            raise ValueError(
                f"batch width {keys.shape[0]} must divide over {n_dev} devices"
            )
        if state.stats.device != device:
            raise ValueError(f"state lies on {state.stats.device}, engine on {device}")
        b = keys.shape[0] // n_dev
        if b == 0:
            none = torch.zeros((0,), dtype=torch.bool, device=device)
            i64 = dict(dtype=torch.int64, device=device)
            return state, EngineResult(
                found=none,
                values=torch.zeros((0,), **i64),
                status=torch.zeros((0,), dtype=torch.int32, device=device),
                shed=none,
                scan_keys=torch.zeros((0, mc), **i64) if has_scan else None,
                scan_values=torch.zeros((0, mc), **i64) if has_scan else None,
                taken=(
                    torch.zeros((0,), dtype=torch.int32, device=device)
                    if has_scan
                    else None
                ),
            )
        # opcodes outside ``ops`` are no-ops, masked before routing
        opcodes = torch.as_tensor(opcodes).to(device=device, dtype=torch.int32)
        allowed = opcodes == enabled[0]
        for code in enabled[1:]:
            allowed = allowed | (opcodes == code)
        keys = torch.where(allowed, keys, KEY_MAX).view(n_dev, b)

        # 1. route round: every lane to the route row owning its key
        owner, demand = routing.route_owners(state.boundaries, keys, nr)
        cap = routing.route_capacity(b, nr, cfg.route_capacity_factor)
        if route_planes:
            values = torch.as_tensor(values).to(device=device, dtype=torch.int64)
            opc_in = opcodes.view(n_dev, b).long()
            lane_prio = dev_index[:, None] * b + torch.arange(b, device=device)
            # phase-offset priority: all updates replay before all inserts
            phase = torch.where(opc_in == OP_INSERT, n_dev * b, 0)
            payload = torch.stack(
                [keys, values.view(n_dev, b), opc_in, lane_prio + phase], -1
            )
        else:
            payload = keys
        buf, lane, dropped_r = routing.pack_by_dest(payload, owner, nr, cap)
        dropped_r = dropped_r & (keys != KEY_MAX)
        routed = routing.route_exchange(buf, cfg).reshape(
            (n_dev, nr * cap) + tuple(payload.shape[2:])
        )
        if route_planes:
            q = routed[..., 0].contiguous()
            val, pr = routed[..., 1], routed[..., 3]
            opc = routed[..., 2].to(torch.int32)
        else:
            q = routed
            opc = None
        live = q != KEY_MAX
        is_scan = live & (opc == OP_SCAN) if has_scan else torch.zeros_like(live)

        # 2. top walk and the per-column offload decision
        subtree = top_walk(state.pool, meta, q.reshape(-1)).view(q.shape)
        subtree = torch.where(live, subtree, 0)
        col = subtree // s_per
        ema = state.miss_ema
        offable = live & ~is_scan
        want_off_c, grp_live, caps = offload_decision(ema, col, offable)
        offl = want_off_c.gather(1, col) & offable
        # per-lane cost ledger (obs/latency.py): the top walk prices like
        # warm cached accesses
        cost = live.float() * (obs_latency.T_CACHED * float(meta.top_height))

        # 2b. the route-table probe: an accepted guess skips the inner levels
        # (scans and offloaded lanes never ask)
        fetchable = live & ~offl
        acc = p_loc = None
        if use_rt:
            ridx, _, p_loc = routing.rt_predict(
                state.rt_keys, state.rt_sub, state.rt_local, q
            )
            guess, acc, _ = fleet_cache.rt_accept(
                meta,
                state.rt_keys,
                state.rt_hi,
                state.rt_sub,
                state.rt_local,
                state.rt_ver,
                state.versions,
                ridx,
                subtree,
                q,
                fetchable & ~is_scan,
            )
            p_loc = p_loc.long()

        # 3. cached descent of the lanes that stay one-sided
        if do_descent:
            leaf_want = fetchable if opc is None else fetchable & (opc != OP_INSERT)
            d = descent(
                state, q, subtree, col, fetchable, leaf_want, cost, is_scan, acc, p_loc
            )
        else:
            d = no_descent(state, q, subtree, cost)
        if has_scan:
            # the scan window, read before the write round touches the pool
            cnt = torch.clamp(torch.where(is_scan, val, 0), 0, mc).to(torch.int32)
            d, scan_out = scan_window(state, q, cnt, is_scan, d)
        cost = d.cost
        if has_lookup:
            # the compute-side leaf search of one-sided lookups
            searched = fetchable if opc is None else fetchable & (opc == OP_LOOKUP)
            cost = cost + searched.float() * obs_latency.T_LOCAL
        if has_scan:
            # and of a scan's first (descent) hop
            cost = cost + is_scan.float() * obs_latency.T_LOCAL

        # 4. the fused round over the memory axis
        r_found = send = dropped_w = torch.zeros_like(live)
        r_val = 0
        cache = d.cache
        status = None
        if has_writes:
            f = write_round(state, q, val, opc, pr, subtree, col, offl, d)
            send, dropped_w, r_val = f.send, f.dropped, f.value
            r_found = f.status == STATUS_OK
            cache = write_through(state, cache, opc, f)
            is_w = live & ((opc == OP_UPDATE) | (opc == OP_INSERT))
            status = torch.where(
                is_w & send & ~dropped_w & ~d.shed,
                f.status,
                torch.where(
                    is_w & (d.shed | dropped_w), STATUS_SHED, STATUS_MISS
                ).to(torch.int32),
            )
            del f
        elif may_offload:
            send = offl & ~d.shed
            r_found, r_val, dropped_w = owner_walk(state.pool, q, subtree, send)
        delivered = send & ~dropped_w
        # a lane that sent a request was offloaded or is a fetched-path write
        off_done = delivered & offl
        write_done = delivered & ~offl
        out_found = torch.where(offl, r_found & delivered, d.found & ~d.shed)
        if opc is not None:
            out_found = out_found & (opc == OP_LOOKUP)
        out_val = torch.where(out_found, torch.where(offl, r_val, d.value), 0)
        lane_shed = d.shed | (send & dropped_w)

        # 5. state planes: the EMA over mesh-global counts, stats, latency
        # histogram and cost-model audit
        g_want = mesh.psum(d.want_cl)
        rates = mesh.psum(d.miss_cl) / torch.clamp(g_want, min=1.0)
        new_ema = torch.where(
            g_want > 0, fma32(cfg.ema_decay, ema, (1 - cfg.ema_decay) * rates), ema
        )
        upd = torch.zeros((n_dev, N_STATS), dtype=torch.int64, device=device)
        upd[:, STAT_OPS] = live.sum(1)
        upd[:, STAT_HITS] = d.n_hit
        upd[:, STAT_FETCHES] = d.n_fetch
        upd[:, STAT_OFFLOADS] = off_done.sum(1)
        upd[:, STAT_DROPS] = dropped_r.sum(1) + (lane_shed & live).sum(1)
        if has_writes:
            upd[:, STAT_WRITES] = write_done.sum(1)
            upd[:, STAT_SPLITS] = (status == STATUS_SPLIT).sum(1)
        # group decisions are mesh-global: count them once, on device 0
        upd[:, STAT_OFFLOAD_GROUPS] = first * (want_off_c & grp_live).sum(1)
        upd[:, STAT_FETCH_GROUPS] = first * (~want_off_c & grp_live).sum(1)
        if use_rt:
            # an accepted lane skips every inner level of its subtree
            upd[:, STAT_RT_SKIPS] = acc.sum(1) * (levels - 1)
            upd[:, STAT_RT_MISPREDICTS] = (guess & ~acc).sum(1)
        # a two-sided trip prices one RPC plus the owner's per-level walk, a
        # fetched-path write one write-through; each live lane bins into one
        # (op class, path, bucket) cell
        cost = cost + off_done.float() * (
            obs_latency.T_RPC + float(levels) * obs_latency.T_MEM
        )
        if has_writes:
            cost = cost + write_done.float() * obs_latency.T_WRITE
        path = torch.where(d.fmiss, 1, 0)
        path = torch.where(off_done, 3, path)
        path = torch.where(lane_shed, 5, path)
        cell = path * obs_latency.N_BUCKETS + obs_latency.bucket_index(cost)
        if opc is not None:
            cls = torch.clamp(opc, 0, obs_latency.N_CLASSES - 1).long()
            cell = cell + cls * (obs_latency.N_PATHS * obs_latency.N_BUCKETS)
        hist = torch.zeros_like(state.lat_hist).view(n_dev, -1)
        hist.scatter_add_(1, cell, live.long())
        audit_upd = torch.zeros_like(state.lat_audit)
        if audit:
            # predicted bytes of the columns priced onto the fetch side, on
            # device 0 only; realized bytes on every device
            fetch_dec = (grp_live & ~want_off_c).float()
            audit_upd[:, 0] = (
                first.float()[:, None, None]
                * fetch_dec[..., None]
                * (caps * ema * row_cost)
            )
            audit_upd[:, 1] = d.realized

        # the return trip over the route axis
        fields = [out_found.long(), out_val]
        if has_writes:
            fields.append(status.long())
        fields.append(lane_shed.long())
        head = len(fields)
        fields = torch.stack(fields, -1)
        if has_scan:
            sc_k, sc_v, taken = scan_out
            fields = torch.cat([fields, taken.long()[..., None], sc_k, sc_v], -1)
            del scan_out, sc_k, sc_v
        width = fields.shape[-1]
        back = routing.route_exchange(fields.view(n_dev, nr, cap, width), cfg)
        del fields
        out = routing.unpack_to_lanes(back, lane, b, 0)
        new_state = state._replace(
            cache=cache,
            miss_ema=new_ema,
            stats=state.stats + upd,
            route_demand=state.route_demand + demand,
            lat_hist=state.lat_hist + hist.view(state.lat_hist.shape),
            lat_audit=state.lat_audit + audit_upd,
        )
        if has_writes:
            res_status = torch.where(
                dropped_r, STATUS_SHED, out[..., 2].to(torch.int32)
            )
        else:
            res_status = torch.where(dropped_r, STATUS_SHED, STATUS_MISS)
        result = EngineResult(
            found=((out[..., 0] != 0) & ~dropped_r).reshape(-1),
            values=torch.where(dropped_r, 0, out[..., 1]).reshape(-1),
            status=res_status.to(torch.int32).reshape(-1),
            shed=((out[..., head - 1] != 0) | dropped_r).reshape(-1),
        )
        if has_scan:
            dr = dropped_r[..., None]
            result = result._replace(
                scan_keys=torch.where(
                    dr, KEY_MAX, out[..., head + 1 : head + 1 + mc]
                ).reshape(-1, mc),
                scan_values=torch.where(
                    dr, 0, out[..., head + 1 + mc : head + 1 + 2 * mc]
                ).reshape(-1, mc),
                taken=torch.where(dropped_r, -1, out[..., head])
                .to(torch.int32)
                .reshape(-1),
            )
        return new_state, result

    engine.plan = plan
    return engine
