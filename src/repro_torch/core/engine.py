"""The mesh plane's execution engine, lookup slice.

:func:`make_dex_engine` with ``ops=("lookup",)`` runs a batch of point
lookups over the virtual mesh (``core/mesh.py``) the way the reference's
unified engine does, batched over the ``Dev`` axis:

  1. one route round: ``routing.route_owners``, ``pack_by_dest`` and
     ``route_exchange`` move each lane to the route row owning its key;
  2. the replicated top-tree walk (``pool.top_walk``, ``node_search``) and
     the per-column offload decision: each destination memory column's
     group of live lanes compares its predicted fetch bytes (the per-column,
     per-level miss-rate EMA) against the two-sided RPC bytes;
  3. the version-checked cached descent, one ``cached_fetch_level`` per
     level, with ``node_search`` picking the child at inner levels and
     matching the key at the leaf;
  4. for lanes whose column offloads: one request/response exchange over
     the memory axis, where the owning column walks its subtree block with
     the ``subtree_walk`` kernel;
  5. the EMA, stat, latency-histogram and audit planes, and the return trip
     over the route axis.

``policy="fetch"`` never offloads; ``policy="offload"`` offloads every live
lane and runs no descent; ``policy="auto"`` decides per column.  Writes,
scans, the pipelined engine, divergent cache policies, peer peeks and the
route table are not ported yet: asking for them raises.
"""

from __future__ import annotations

from math import inf
from typing import NamedTuple, Tuple

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
)

OP_LOOKUP, OP_UPDATE, OP_INSERT, OP_SCAN = 0, 1, 2, 3
ALL_OPS = ("lookup", "update", "insert", "scan")
PORTED_OPS = ("lookup",)

STATUS_MISS = 0
STATUS_SHED = -1


class EngineResult(NamedTuple):
    """Per-lane results of one batch, in the caller's lane order."""

    found: torch.Tensor
    values: torch.Tensor
    status: torch.Tensor
    shed: torch.Tensor


class Descent(NamedTuple):
    """What the cached descent hands the rest of the batch, per lane
    ``[Dev, Q]`` or per device."""

    found: torch.Tensor  # leaf match (one-sided lanes)
    value: torch.Tensor
    shed: torch.Tensor  # a fetch bucket dropped the lane
    fmiss: torch.Tensor  # some level paid a remote fetch
    cost: torch.Tensor  # modelled seconds so far
    cache: DexCache
    miss_cl: torch.Tensor  # [Dev, n_memory, levels] misses per column/level
    want_cl: torch.Tensor  # [Dev, n_memory, levels] lanes per column/level
    realized: torch.Tensor  # [Dev, n_memory, levels] distinct fetched bytes
    n_hit: torch.Tensor  # [Dev]
    n_fetch: torch.Tensor  # [Dev] coalesced remote reads


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
    ops: Tuple[str, ...] = PORTED_OPS,
    cache_policy: "fleet_cache.CachePolicy | None" = None,
    device=None,
):
    """Build the engine ``(state, opcodes, keys, values) -> (state,
    EngineResult)`` on ``device`` (None = CUDA).

    ``opcodes``/``keys``/``values`` are [B] lanes, split evenly over the
    virtual devices (lanes ``dev*b .. (dev+1)*b`` start on device ``dev``);
    ``keys == KEY_MAX`` lanes and opcodes outside ``ops`` are inactive, and
    lookups ignore ``values``.  The returned function carries the
    reference's ``plan`` attribute.  The cache planes of the given state are
    updated in place."""
    for o in ops:
        if o not in ALL_OPS:
            raise ValueError(f"unknown op {o!r}; options: {ALL_OPS}")
    if tuple(ops) != PORTED_OPS:
        raise NotImplementedError(f"only ops={PORTED_OPS} is ported, got {ops}")
    if cfg.policy not in ("fetch", "offload", "auto"):
        raise ValueError(f"unknown policy {cfg.policy!r}")
    if cfg.route_table_slots > 0:
        raise NotImplementedError("the route table is not ported yet")
    if len(cfg.route_axes) != 1:
        raise NotImplementedError("two route axes are not ported yet")
    if not fleet_cache.is_uniform(cache_policy):
        raise NotImplementedError("divergent cache policies are not ported yet")
    device = mesh.resolve_device(device)

    levels = meta.levels_in_subtree
    may_offload = cfg.policy != "fetch"
    do_descent = cfg.policy != "offload"
    audit = cfg.policy == "auto"
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
    first = (mesh.device_linear_index(cfg, device) == 0).long()
    my_col = mesh.memory_linear_index(cfg, device)[:, None]
    plan = {
        "route_rounds": 1,
        "fused_pairs": 1 if may_offload else 0,
        "descent_levels": levels if do_descent else 0,
        "scan_hops": 0,
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

    def descent(state, q, subtree, col, want, cost) -> Descent:
        """The version-checked cached descent of the ``want`` lanes: one
        ``cached_fetch_level`` per level, ``node_search`` for the child at
        inner levels and for the match at the leaf."""
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
        for lvl in range(levels):
            leaf = lvl == levels - 1
            gid = meta.node_gid(subtree, local)
            if leaf:
                salt = state.stats[:, STAT_OPS, None] + torch.arange(
                    nq, device=device
                )
                p_ok = fleet_cache.leaf_admit(cfg, cache_policy, gid, salt)
            else:
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
            miss_cl[..., lvl] = zero.scatter_add(1, col, miss.float())
            want_cl[..., lvl] = zero.scatter_add(1, col, want.float())
            if audit:
                # realized bytes count distinct fetched nodes per column
                nset = torch.zeros(
                    (n_dev, n_nodes + 1), dtype=torch.bool, device=device
                )
                nset.scatter_(1, torch.where(fetched, gid, n_nodes), True)
                cnt = nset[:, :n_nodes].view(n_dev, nm, -1).sum(-1).float()
                realized[..., lvl] = cnt * float(NODE_ROW_BYTES)
            rows_k = rows_k.view(-1, FANOUT)
            if not leaf:
                slot, _, _ = kops.node_search(rows_k, flat_q)
                local = rows_c.view(-1, FANOUT).gather(1, slot.long()[:, None])
                local = local.view(n_dev, nq).long()
        _, found, value = kops.node_search(rows_k, flat_q, rows_v.view(-1, FANOUT))
        return Descent(
            found=found.view(n_dev, nq) & want,
            value=value.view(n_dev, nq),
            shed=shed,
            fmiss=fmiss,
            cost=cost,
            cache=cache,
            miss_cl=miss_cl,
            want_cl=want_cl,
            realized=realized,
            n_hit=n_hit,
            n_fetch=n_fetch,
        )

    def owner_walk(pool, q, subtree, send):
        """The fused request/response exchange over the memory axis: the
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
        o_found, o_val = kops.subtree_walk(
            pool.pool_keys,
            pool.pool_children,
            pool.pool_values,
            st.reshape(-1).to(torch.int32),
            kf.reshape(-1).contiguous(),
            levels=levels,
        )
        o_found = o_found.view(walk.shape) & walk
        o_val = torch.where(walk, o_val.view(walk.shape), 0)
        resp = torch.stack([o_found.long(), o_val], -1).view(n_dev, nm, wcap, 2)
        resp = mesh.a2a(resp, cfg, cfg.memory_axis)
        back = routing.unpack_to_lanes(resp, wlane, nq, 0)
        return back[..., 0] != 0, back[..., 1], dropped & send

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
            return state, EngineResult(
                found=none,
                values=torch.zeros((0,), dtype=torch.int64, device=device),
                status=torch.zeros((0,), dtype=torch.int32, device=device),
                shed=none,
            )
        # opcodes outside the ported set are no-ops, masked before routing
        opcodes = torch.as_tensor(opcodes).to(device)
        keys = torch.where(opcodes == OP_LOOKUP, keys, KEY_MAX).view(n_dev, b)

        # 1. route round: every lane to the route row owning its key
        owner, demand = routing.route_owners(state.boundaries, keys, nr)
        cap = routing.route_capacity(b, nr, cfg.route_capacity_factor)
        buf, lane, dropped_r = routing.pack_by_dest(keys, owner, nr, cap)
        dropped_r = dropped_r & (keys != KEY_MAX)
        q = routing.route_exchange(buf, cfg).reshape(n_dev, -1)
        live = q != KEY_MAX

        # 2. top walk and the per-column offload decision
        subtree = top_walk(state.pool, meta, q.reshape(-1)).view(q.shape)
        subtree = torch.where(live, subtree, 0)
        col = subtree // s_per
        ema = state.miss_ema
        want_off_c, grp_live, caps = offload_decision(ema, col, live)
        offl = want_off_c.gather(1, col) & live
        # per-lane cost ledger (obs/latency.py): the top walk prices like
        # warm cached accesses
        cost = live.float() * (obs_latency.T_CACHED * float(meta.top_height))

        # 3. cached descent of the lanes that stay one-sided
        fetchable = live & ~offl
        if do_descent:
            d = descent(state, q, subtree, col, fetchable, cost)
        else:
            zero_cl = torch.zeros((n_dev, nm, levels), device=device)
            zero_dev = torch.zeros(n_dev, dtype=torch.int64, device=device)
            d = Descent(
                found=torch.zeros_like(live),
                value=torch.zeros_like(q),
                shed=torch.zeros_like(live),
                fmiss=torch.zeros_like(live),
                cost=cost,
                cache=state.cache,
                miss_cl=zero_cl,
                want_cl=zero_cl,
                realized=zero_cl,
                n_hit=zero_dev,
                n_fetch=zero_dev,
            )
        cost = d.cost + fetchable.float() * obs_latency.T_LOCAL

        # 4. offloaded lanes: the owner-side block walk
        send = offl & ~d.shed
        r_found = dropped_w = torch.zeros_like(live)
        r_val = 0
        if may_offload:
            r_found, r_val, dropped_w = owner_walk(state.pool, q, subtree, send)
        delivered = send & ~dropped_w
        out_found = torch.where(offl, r_found & delivered, d.found & ~d.shed)
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
        upd[:, STAT_OFFLOADS] = delivered.sum(1)
        upd[:, STAT_DROPS] = dropped_r.sum(1) + (lane_shed & live).sum(1)
        # group decisions are mesh-global: count them once, on device 0
        upd[:, STAT_OFFLOAD_GROUPS] = first * (want_off_c & grp_live).sum(1)
        upd[:, STAT_FETCH_GROUPS] = first * (~want_off_c & grp_live).sum(1)
        # a two-sided trip prices one RPC plus the owner's per-level walk;
        # each live lane bins into one (class, path, bucket) cell
        cost = cost + delivered.float() * (
            obs_latency.T_RPC + float(levels) * obs_latency.T_MEM
        )
        path = torch.where(d.fmiss, 1, 0)
        path = torch.where(delivered, 3, path)
        path = torch.where(lane_shed, 5, path)
        cell = path * obs_latency.N_BUCKETS + obs_latency.bucket_index(cost)
        hist = torch.zeros_like(state.lat_hist).view(n_dev, -1)
        hist.scatter_add_(1, cell, live.long())  # op class 0: lookups
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
        fields = torch.stack([out_found.long(), out_val, lane_shed.long()], -1)
        back = routing.route_exchange(fields.view(n_dev, nr, cap, 3), cfg)
        out = routing.unpack_to_lanes(back, lane, b, 0)
        new_state = state._replace(
            cache=d.cache,
            miss_ema=new_ema,
            stats=state.stats + upd,
            route_demand=state.route_demand + demand,
            lat_hist=state.lat_hist + hist.view(state.lat_hist.shape),
            lat_audit=state.lat_audit + audit_upd,
        )
        status = torch.where(dropped_r, STATUS_SHED, STATUS_MISS).to(torch.int32)
        result = EngineResult(
            found=((out[..., 0] != 0) & ~dropped_r).reshape(-1),
            values=torch.where(dropped_r, 0, out[..., 1]).reshape(-1),
            status=status.reshape(-1),
            shed=((out[..., 2] != 0) | dropped_r).reshape(-1),
        )
        return new_state, result

    engine.plan = plan
    return engine
