"""On-mesh structural modification (SMO): leaf splits on the device between
batches, without rebuilding the pool.

``core/write.py`` sheds an insert whose leaf would overflow
(``STATUS_SPLIT``).  :func:`make_dex_smo` builds one SMO round over the
virtual mesh, as the reference's does:

  1. the shed ``(key, value)`` lanes go to the memory column owning their
     subtree (24-byte messages, a bucket the size of the whole per-device
     batch, so the round never sheds its own repair work);
  2. the owner walks its block to each target leaf, groups the lanes by
     leaf, resolves duplicate writers by batch priority and turns keys that
     already exist into value updates;
  3. each target leaf goes through the ``leaf_split`` kernel: its staged
     inserts are rank-merged, and a leaf whose merged count exceeds 64 is
     cut into two half-full rows.  The sibling's row comes from the
     subtree's free list (``DexState.n_alloc``, headroom reserved at build
     time), the successor table is re-linked so scans walk the new leaf,
     and the separator is merged into the parent row by the ``leaf_write``
     kernel with children as the value plane;
  4. full parents are split by a dense pass over the block (one split per
     parent per sweep), at ``level_m >= 2`` only.

Only the split leaf, its sibling and the touched ancestors get version
bumps, so cached rows elsewhere stay warm.  A lane that a bounded number of
rounds cannot place (an exhausted free list, a split at the subtree root)
stays ``STATUS_SPLIT``; :func:`settle_splits` sends that residue through
the host fallback, ``write.drain_splits``, which replays it through a
``HostBTree`` mirror and rebuilds the pool.

The virtual mesh holds one pool: each memory column's gathered batch is
applied once (``mesh.gather_route``) and each device takes its own route
row of the statuses (``mesh.route_share``).  On the rank backend a rank
applies its own columns' batches to its copy of their shard, and the
successors its columns wrote and the version bumps join over the ranks
(``mesh.owner_merge``, ``mesh.pmax``); ``run_smo`` sums its progress over
the ranks so that every rank runs the same rounds, and ``settle_splits``
raises ``NotImplementedError`` there.  The round writes the pool,
``occupancy``, ``n_alloc`` and ``versions`` in place; ``succ`` comes back as
a new table.  :func:`run_smo` drives rounds until the pending set stops
shrinking, :func:`settle_splits` adds the host fallback for what they
leave; :func:`refresh_sep_planes` then recompresses the separator rows the
rounds touched.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mesh, routing
from repro_torch.core.nodes import FANOUT, KEY_MAX, NULL
from repro_torch.core.pool import PoolMeta, SepPlanes, compress_rows, top_walk
from repro_torch.core.write import (
    STATUS_MISS,
    STATUS_OK,
    STATUS_SPLIT,
    _lexsort,
    _run_sums,
    _seg_positions,
    drain_splits,
)
from repro_torch.kernels import ops as kops
from repro_torch.obs.timeline import obs_phase
from repro_torch.obs.registry import N_STATS, STAT_SMO_SPLITS

SW = FANOUT  # staged inserts per leaf per round


def _dense_parents(pool_children: torch.Tensor) -> torch.Tensor:
    """Per-node parent local id ``[S, C]`` int32 (-1 where no row names the
    node as a child), from the children planes ``[S, C, F]``.

    Where several slots name one node (a merged parent row pads its
    children with 0, so every such row names the block's root), the
    reference's scatter keeps the last in row-major order; so does this."""
    s, c, f = pool_children.shape
    dev = pool_children.device
    ch = pool_children.long()
    valid = (ch != NULL) & (ch >= 0) & (ch < c)
    row = torch.arange(s, device=dev)[:, None, None]
    target = torch.where(valid, row * c + ch, s * c).reshape(-1)
    slot = torch.arange(c * f, device=dev).expand(s, c * f).reshape(-1)
    last = torch.full((s * c + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, target, slot, "amax")
    last = last[: s * c].view(s, c)
    return torch.where(last >= 0, last // f, -1).to(torch.int32)


def _seg_starts_attr(x: torch.Tensor, live: torch.Tensor, starts: torch.Tensor, n):
    """``[n]`` per-segment attribute: ``x`` at each segment's first lane
    where that lane is live, 0 elsewhere and past the last segment (the
    reference's segment maximum, since a live segment's lanes share ``x``
    and ``x >= 0``)."""
    out = torch.zeros((n,), dtype=x.dtype, device=x.device)
    out[: starts.numel()] = torch.where(live, x, 0)[starts]
    return out


def _bump(vers: torch.Tensor, gids: torch.Tensor) -> None:
    """``vers[g] += 1`` once per distinct gid of ``gids``, in place
    (duplicates write the same value)."""
    vers[gids] = vers[gids] + 1


def make_dex_smo(meta: PoolMeta, cfg, *, device=None):
    """Build one SMO round: ``(state, keys, values) -> (state, status)``.

    ``keys``/``values`` are [B] lanes split evenly over the devices,
    normally the lanes an insert batch returned ``STATUS_SPLIT`` (``KEY_MAX``
    lanes are inactive).  Each live lane comes back ``STATUS_OK`` (its leaf
    split on the device, or had room and merged it, or the key existed and
    took the value) or ``STATUS_SPLIT`` (still pending: more than 64 staged
    keys, a full parent, an exhausted free list; retry with another round).
    The state is written in place (see the module's docstring)."""
    device = mesh.resolve_device(device)
    levels = meta.levels_in_subtree
    cap_nodes = meta.subtree_cap
    # the devices this process holds and its pool columns: rows are indexed
    # in the held shard, node ids stay global
    nr, nm, n_dev = cfg.n_route, cfg.n_memory, mesh.local_devices(cfg)
    col0, n_cols = mesh.local_columns(cfg)
    s_pad = meta.n_subtrees_padded
    s_per = s_pad // nm
    sbase = col0 * s_per
    dev_index = mesh.device_linear_index(cfg, device)
    first_row = (dev_index // nm) == 0

    def per_column(rows: torch.Tensor) -> torch.Tensor:
        """``[nm]`` count of the subtree rows ``rows`` in each column."""
        return torch.bincount(rows // s_per, minlength=nm)

    rank_mesh = mesh.current()

    def smo(state, keys, values):
        if mesh.current() is not rank_mesh:
            raise RuntimeError("the SMO round runs on the mesh it was built on")
        keys = torch.as_tensor(keys).to(device=device, dtype=torch.int64)
        values = torch.as_tensor(values).to(device=device, dtype=torch.int64)
        if keys.shape[0] % n_dev:
            raise ValueError(
                f"batch width {keys.shape[0]} must divide over {n_dev} devices"
            )
        if state.stats.device != device:
            raise ValueError(f"state lies on {state.stats.device}, SMO on {device}")
        b = keys.shape[0] // n_dev
        if b == 0:
            return state, torch.zeros((0,), dtype=torch.int32, device=device)
        pool, occupancy = state.pool, state.occupancy
        pk, pc, pv = pool.pool_keys, pool.pool_children, pool.pool_values
        one = torch.ones((1,), dtype=torch.bool, device=device)

        # 1. route to the owning memory column; each column's batch is
        # gathered over its route replicas and applied once
        keys, values = keys.view(n_dev, b), values.view(n_dev, b)
        prio = dev_index[:, None] * b + torch.arange(b, device=device)
        live0 = keys != KEY_MAX
        st0 = top_walk(pool, meta, keys.reshape(-1)).view(n_dev, b)
        owner = torch.where(live0, st0 // s_per, nm)
        payload = torch.stack([keys, values, prio], -1)
        buf, lane, dropped = routing.pack_by_dest(payload, owner, nm, b)
        req = mesh.a2a(buf, cfg, cfg.memory_axis)  # [Dev, nm, b, 3]
        flat = mesh.gather_route(req, cfg).reshape(-1, 3)
        k, v, pr = (c.contiguous() for c in flat.unbind(-1))
        n = k.numel()
        live = k != KEY_MAX

        # 2. walk the block to the leaf, recording the path (``st`` is the
        # subtree's row in the held shard)
        st = torch.where(live, top_walk(pool, meta, k) - sbase, 0)
        local = torch.zeros_like(k)
        plocals = [local]
        for _ in range(levels - 1):
            slot, _, _ = kops.node_search(pk[st, local], k)
            local = pc[st, local, slot.long()].long()
            plocals.append(local)
        leaf_lo = plocals[-1]
        gid_leaf = meta.node_gid(st + sbase, leaf_lo)

        # 3. conflict order; keys already present become value updates
        eqk = pk[st, leaf_lo] == k[:, None]
        exists = eqk.any(-1) & live
        uslot = eqk.to(torch.uint8).argmax(-1)
        del eqk
        route_gid = torch.where(live, gid_leaf, KEY_MAX)
        order = _lexsort(pr, k, route_gid)
        g_s, k_s, v_s = route_gid[order], k[order], v[order]
        live_s, st_s, lo_s = live[order], st[order], leaf_lo[order]
        diff = (g_s[1:] != g_s[:-1]) | (k_s[1:] != k_s[:-1])
        new_run = torch.cat([one, diff])
        last_of_run = torch.cat([diff, one])
        winner = last_of_run & live_s
        upd_w = winner & exists[order]
        u = upd_w.nonzero()[:, 0]
        pv[st_s[u], lo_s[u], uslot[order][u]] = v_s[u]

        # 4. per-leaf staging of fresh inserts
        new_seg = torch.cat([one, g_s[1:] != g_s[:-1]])
        seg_id = torch.cumsum(new_seg, 0) - 1
        starts = new_seg.nonzero()[:, 0]
        ins_w = winner & ~exists[order]
        pos = _seg_positions(ins_w, new_seg)
        staged = ins_w & (pos < SW)
        ins_key = torch.full((n, SW), KEY_MAX, dtype=torch.int64, device=device)
        ins_val = torch.zeros((n, SW), dtype=torch.int64, device=device)
        i = staged.nonzero()[:, 0]
        ins_key[seg_id[i], pos[i]] = k_s[i]
        ins_val[seg_id[i], pos[i]] = v_s[i]
        n_staged = _seg_starts_attr(
            _run_sums(staged, new_seg).to(torch.int32), one.expand(n), starts, n
        )
        seg_st = _seg_starts_attr(st_s, live_s, starts, n)
        seg_lo = _seg_starts_attr(lo_s, live_s, starts, n)
        par_lane = plocals[-2][order] if levels >= 2 else torch.zeros_like(k)
        seg_par = _seg_starts_attr(par_lane, live_s, starts, n)
        seg_active = n_staged > 0
        m_seg = occupancy[seg_st, seg_lo] + n_staged
        need_split = seg_active & (m_seg > FANOUT)
        merge_ok = seg_active & ~need_split

        # 5. split admission: room in the parent, slack in the free list
        if levels >= 2:
            par_flat = seg_st * cap_nodes + seg_par
            cnt_par = torch.zeros(
                (s_pad * cap_nodes,), dtype=torch.int32, device=device
            )
            ns = need_split.nonzero()[:, 0]
            cnt_par.index_add_(0, par_flat[ns], torch.ones_like(ns, dtype=torch.int32))
            parent_room = (occupancy[seg_st, seg_par] + cnt_par[par_flat]) <= FANOUT
            allowed = need_split & parent_room
        else:
            # the leaf is the subtree root: any split overflows the block
            parent_room = torch.zeros_like(need_split)
            allowed = parent_room
        new_sub = torch.cat([one, seg_st[1:] != seg_st[:-1]])
        rank_sub = _seg_positions(allowed, new_sub)
        n_alloc = state.n_alloc
        sib_lo = n_alloc[seg_st].long() + rank_sub
        can_split = allowed & (sib_lo < cap_nodes)
        apply_seg = merge_ok | can_split
        cs = can_split.nonzero()[:, 0]
        split_cols = per_column(seg_st[cs] + sbase)

        # 6. merge or split each staged leaf (the leaf_split kernel)
        lk, lv, rk, rv, occ_l, occ_r, sep, _ = kops.leaf_split(
            pk[seg_st, seg_lo], pv[seg_st, seg_lo], ins_key, ins_val
        )
        del ins_key, ins_val
        a = apply_seg.nonzero()[:, 0]
        pk[seg_st[a], seg_lo[a]] = lk[a]
        pv[seg_st[a], seg_lo[a]] = lv[a]
        occupancy[seg_st[a], seg_lo[a]] = occ_l[a]
        pk[seg_st[cs], sib_lo[cs]] = rk[cs]
        pv[seg_st[cs], sib_lo[cs]] = rv[cs]
        occupancy[seg_st[cs], sib_lo[cs]] = occ_r[cs]
        del lk, lv, rk, rv
        n_alloc.index_add_(0, seg_st[cs], torch.ones_like(cs, dtype=n_alloc.dtype))

        # the successor chain: leaf -> sibling -> the leaf's old successor
        gid_seg = meta.node_gid(seg_st + sbase, seg_lo)
        gid_sib = meta.node_gid(seg_st + sbase, sib_lo)
        succ = state.succ[0].clone()
        old_nxt = succ[gid_seg[cs]]
        succ[gid_sib[cs]] = old_nxt
        succ[gid_seg[cs]] = gid_sib[cs]

        # version bumps: updated leaves, applied leaves, siblings, parents
        vers = state.versions[0].clone()
        _bump(vers, g_s[upd_w])
        _bump(vers, gid_seg[a])
        _bump(vers, gid_sib[cs])
        gid_par = meta.node_gid(seg_st + sbase, seg_par)
        _bump(vers, gid_par[cs])

        # 7. separators into the parent rows (the leaf_write kernel, with
        # children as the value plane)
        if levels >= 2:
            pg_route = torch.where(can_split, gid_par, KEY_MAX)
            order2 = _lexsort(sep, pg_route)
            pg2 = pg_route[order2]
            act2 = can_split[order2]
            new_seg2 = torch.cat([one, pg2[1:] != pg2[:-1]])
            seg2_id = torch.cumsum(new_seg2, 0) - 1
            starts2 = new_seg2.nonzero()[:, 0]
            pos2 = _seg_positions(act2, new_seg2)
            ins_k2 = torch.full((n, SW), KEY_MAX, dtype=torch.int64, device=device)
            ins_v2 = torch.zeros((n, SW), dtype=torch.int64, device=device)
            j = (act2 & (pos2 < SW)).nonzero()[:, 0]
            ins_k2[seg2_id[j], pos2[j]] = sep[order2][j]
            ins_v2[seg2_id[j], pos2[j]] = sib_lo[order2][j]
            seg2_st = _seg_starts_attr(seg_st[order2], act2, starts2, n)
            seg2_lo = _seg_starts_attr(seg_par[order2], act2, starts2, n)
            seg2_active = _seg_starts_attr(act2, act2, starts2, n)
            nk2, nc2, nocc2 = kops.leaf_write(
                pk[seg2_st, seg2_lo],
                pc[seg2_st, seg2_lo].long(),
                torch.full((n, SW), -1, dtype=torch.int32, device=device),
                torch.zeros((n, SW), dtype=torch.int64, device=device),
                ins_k2,
                ins_v2,
            )
            del ins_k2, ins_v2
            w2 = seg2_active.nonzero()[:, 0]
            pk[seg2_st[w2], seg2_lo[w2]] = nk2[w2]
            pc[seg2_st[w2], seg2_lo[w2]] = nc2[w2].to(pc.dtype)
            occupancy[seg2_st[w2], seg2_lo[w2]] = nocc2[w2]
            del nk2, nc2

        # 8. the dense inner pass: full parents split toward the root
        inner_cols = torch.zeros_like(split_cols)
        if levels >= 3:
            # the reference's sweep sums the watermark's increments in
            # int64, so the plane leaves it as int64
            n_alloc = n_alloc.long()
            flagged = (need_split & ~parent_room & (m_seg > 0)).nonzero()[:, 0]
            inner_cols = _inner_pass(
                pk, pc, pv, occupancy, n_alloc, vers,
                seg_st[flagged], seg_par[flagged], levels - 2,
            )

        # 9. statuses back to the requesting lanes
        outcome_w = torch.where(
            upd_w | (staged & apply_seg[seg_id]), STATUS_OK, STATUS_SPLIT
        ).to(torch.int32)
        run_id = torch.cumsum(new_run, 0) - 1
        run_out = torch.where(winner, outcome_w, 0)[last_of_run]
        status_s = torch.where(live_s, run_out[run_id], STATUS_MISS).to(torch.int32)
        status = torch.empty_like(status_s).scatter_(0, order, status_s)
        own = mesh.route_share(status.long().view(n_cols, nr, nm, b), cfg)
        back = mesh.a2a(own[..., None], cfg, cfg.memory_axis)
        out = routing.unpack_to_lanes(back, lane, b, 0)[..., 0].to(torch.int32)
        out = torch.where(dropped & live0, STATUS_SPLIT, out)
        out = torch.where(live0, out, STATUS_MISS).to(torch.int32)

        # 10. the replicated tables and the split count, once per column: a
        # rank wrote the successors of its own columns' nodes only
        if rank_mesh is not None:
            node_col = torch.arange(succ.numel(), device=device) // (
                s_per * cap_nodes
            )
            succ = mesh.owner_merge(succ, (node_col >= col0) & (node_col < col0 + n_cols))
        versions = state.versions
        new_vers = mesh.pmax(torch.maximum(versions.amax(0), vers)[None])
        versions.copy_(new_vers.expand_as(versions))
        upd = torch.zeros((n_dev, N_STATS), dtype=torch.int64, device=device)
        col_splits = (split_cols + inner_cols)[dev_index % nm]
        upd[:, STAT_SMO_SPLITS] = torch.where(first_row, col_splits, 0)
        new_state = state._replace(
            n_alloc=n_alloc,
            succ=succ[None].expand(n_dev, succ.numel()),
            stats=state.stats + upd,
        )
        return new_state, out.reshape(-1)

    def _inner_pass(pk, pc, pv, occ, n_alloc, vers, f_st, f_par, sweeps):
        """The reference's dense sweep over every block: each flagged full
        parent splits (one per grandparent per sweep, the lowest flagged
        child winning) and its separator goes into its own parent.  Writes
        the planes and the int64 watermark ``n_alloc`` in place; returns the
        splits per column."""
        c, f = cap_nodes, FANOUT
        dev = pk.device
        s_rows = pk.shape[0]  # the held shard's subtree rows
        row_ix = torch.arange(s_rows, device=dev)[:, None].expand(s_rows, c)
        lo_ix = torch.arange(c, device=dev)[None, :].expand(s_rows, c)
        gid_grid = (row_ix + sbase) * c + lo_ix
        col_f = torch.arange(f, device=dev)[None, None, :]
        flag = torch.zeros((s_rows, c), dtype=torch.bool, device=dev)
        flag[f_st, f_par] = True
        splits = torch.zeros((nm,), dtype=torch.int64, device=dev)
        for _ in range(sweeps):
            par = _dense_parents(pc).long()
            par_safe = torch.where(par >= 0, par, 0)
            par_occ = occ.gather(1, par_safe)
            can = flag & (lo_ix != 0) & (par >= 0)
            room = can & (par_occ < FANOUT)
            min_lo = torch.full((s_rows, c + 1), c, dtype=torch.int64, device=dev)
            min_lo.scatter_reduce_(1, torch.where(room, par_safe, c), lo_ix, "amin")
            m_g = occ.long()
            win = room & (min_lo.gather(1, par_safe) == lo_ix) & (m_g >= 2)
            rank = torch.cumsum(win.long(), 1) - win.long()
            sib_g = n_alloc[:, None] + rank
            ok = win & (sib_g < c)
            left_n = m_g // 2
            idx = torch.clamp(col_f + left_n[..., None], 0, f - 1)
            mask_r = col_f < (m_g - left_n)[..., None]
            right_k = torch.where(mask_r, pk.gather(2, idx), KEY_MAX)
            right_c = torch.where(mask_r, pc.gather(2, idx), NULL)
            sep_g = pk.gather(2, left_n[..., None])[..., 0]
            left = (col_f < left_n[..., None]) | ~ok[..., None]
            pk.copy_(torch.where(left, pk, KEY_MAX))
            pc.copy_(torch.where(left, pc, NULL))
            occ.copy_(torch.where(ok, left_n, m_g).to(occ.dtype))
            r_i, c_i = ok.nonzero(as_tuple=True)
            sib = sib_g[r_i, c_i]
            pk[r_i, sib] = right_k[r_i, c_i]
            pc[r_i, sib] = right_c[r_i, c_i]
            occ[r_i, sib] = (m_g - left_n)[r_i, c_i].to(occ.dtype)
            pv[r_i, sib] = 0
            n_alloc.add_(ok.sum(1))
            # one separator into each winner's parent row
            at = torch.where(ok, par_safe, c)
            psep = torch.full((s_rows, c + 1), KEY_MAX, dtype=torch.int64, device=dev)
            psep.scatter_(1, at, sep_g)
            psep = psep[:, :c]
            pchild = torch.full((s_rows, c + 1), NULL, dtype=pc.dtype, device=dev)
            pchild.scatter_(1, at, sib_g.to(pc.dtype))
            pchild = pchild[:, :c]
            has = psep != KEY_MAX
            ppos = (pk < psep[..., None]).sum(2)
            shift = torch.clamp(col_f - (col_f > ppos[..., None]).long(), 0, f - 1)
            ins_here = col_f == ppos[..., None]
            new_k = torch.where(ins_here, psep[..., None], pk.gather(2, shift))
            new_c = torch.where(ins_here, pchild[..., None], pc.gather(2, shift))
            pk.copy_(torch.where(has[..., None], new_k, pk))
            pc.copy_(torch.where(has[..., None], new_c, pc))
            occ.add_(has.to(occ.dtype))
            bumped = ok | has
            bumped[r_i, sib] = True
            _bump(vers, gid_grid[bumped])
            splits += per_column(r_i + sbase)
            # parents that were full flag themselves for the next sweep;
            # losers among several flagged children retry next round
            nf_par = torch.where(can & (par_occ >= FANOUT), par_safe, c)
            flag = torch.zeros((s_rows, c + 1), dtype=torch.bool, device=dev)
            flag.scatter_(1, nf_par, True)
            flag = flag[:, :c]
        return splits

    return smo


def run_smo(smo, state, keys, values, *, max_rounds=None, levels: int = 2, obs=None):
    """Drive SMO rounds until every live lane settles or the pending set
    stops shrinking (an exhausted free list, a split at the subtree root).

    ``keys``/``values`` keep the originating batch's lane layout, with the
    lanes that are not pending set to ``KEY_MAX`` (as an insert batch hands
    back its ``STATUS_SPLIT`` lanes); the width must divide over the
    devices.  Returns ``(state, status [B] int32 numpy, rounds)``; lanes
    still ``STATUS_SPLIT`` need the host fallback (:func:`settle_splits`).
    ``obs`` is an optional telemetry batch (``obs/timeline.py``): each round
    is a phase ``smo/round<i>`` of it."""
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.int64)
    if max_rounds is None:
        # a chain defers one level per round (the leaf waits for its full
        # parent's split, the parent for the grandparent's) and a leaf with
        # more than 64 pending keys splits again each round
        max_rounds = 2 * levels + 6
    pending = keys != KEY_MAX
    status = np.full(keys.shape, STATUS_MISS, np.int32)
    rounds = 0

    def totals(pend, st):
        """Pending lanes and splits done, over every rank, so that every
        rank runs the same rounds."""
        return mesh.host_sum(
            [int(pend.sum()), int(st.stats[:, STAT_SMO_SPLITS].sum())]
        ).tolist()

    n_pending, before = totals(pending, state)
    while n_pending and rounds < max_rounds:
        with obs_phase(obs, f"smo/round{rounds}"):
            state, st_r = smo(
                state, np.where(pending, keys, KEY_MAX), np.where(pending, values, 0)
            )
            st_np = st_r.cpu().numpy()
        rounds += 1
        settled = pending & (st_np != STATUS_SPLIT)
        status[settled] = st_np[settled]
        still = pending & (st_np == STATUS_SPLIT)
        # progress: lanes settled, or splits executed (a round that only
        # split a full parent settles nothing but unblocks its children)
        n_still, after = totals(still, state)
        if n_still >= n_pending and after <= before:
            pending = still
            break
        n_pending, before = n_still, after
        pending = still
    status[pending] = STATUS_SPLIT
    return state, status, rounds


def settle_splits(state, meta: PoolMeta, cfg, smo, host, shed_keys, shed_values,
                  boundaries, *, max_rounds=None, obs=None):
    """Settle one batch of ``STATUS_SPLIT`` lanes: bounded SMO rounds on the
    device first, the host's ``drain_splits`` rebuild for the residue only.

    ``host`` is the caller's ``HostBTree`` mirror; the lanes the rounds
    apply are replayed into it here, in lane order, and the residue goes
    through its eager-split path.  Returns ``(state, meta, info)``: ``meta``
    changes only when the drain rebuilt the pool (rebuild the ops against
    it then; the old state is spent, see ``drain_splits``), and ``info`` is
    ``{"onmesh": lanes applied on the device, "residual": lanes drained,
    "rounds": SMO rounds run, "drained": bool}``.  ``obs`` is an optional
    telemetry batch: each round and the drain (``smo/drain``) are phases of
    it."""
    shed_keys = np.asarray(shed_keys, np.int64)
    shed_values = np.asarray(shed_values, np.int64)
    mesh.refuse_on_ranks("settle_splits, the host fallback of the SMO", 4)
    if shed_keys.size == 0:
        return state, meta, {"onmesh": 0, "residual": 0, "rounds": 0, "drained": False}
    state, status, rounds = run_smo(
        smo, state, shed_keys, shed_values,
        max_rounds=max_rounds, levels=meta.levels_in_subtree, obs=obs,
    )
    ok = status == STATUS_OK
    for kk, vv in zip(shed_keys[ok].tolist(), shed_values[ok].tolist()):
        host.insert(kk, vv)
    residual = status == STATUS_SPLIT
    drained = bool(residual.any())
    if drained:
        with obs_phase(obs, "smo/drain"):
            state, meta = drain_splits(
                state, meta, cfg, host,
                shed_keys[residual], shed_values[residual], boundaries,
            )
    return state, meta, {
        "onmesh": int(ok.sum()),
        "residual": int(residual.sum()),
        "rounds": rounds,
        "drained": drained,
    }


def refresh_sep_planes(sep: SepPlanes, state, meta: PoolMeta, old_versions) -> SepPlanes:
    """Re-compress the separator planes after SMO rounds: every row a split
    touched (the split leaf, its sibling, the parents the separators merged
    into) had its version bumped, so the rows whose version on device 0
    differs from ``old_versions`` are recompressed from the key plane and
    the rest come back as they were.  Returns new planes.

    The engine and the SMO bump ``state.versions`` in place, so
    ``old_versions`` must be a copy taken before the rounds
    (``state.versions.clone()``): a view of the live plane shows no change
    and nothing is refreshed."""
    mesh.refuse_on_ranks("refresh_sep_planes, the separator planes", 3)
    vers, old = state.versions, torch.as_tensor(old_versions).to(state.versions.device)
    if vers.dim() == 2:
        vers = vers[0]
    if old.dim() == 2:
        old = old[0]
    changed = torch.nonzero(vers != old)[:, 0]
    if changed.numel() == 0:
        return sep
    s_idx = changed // meta.subtree_cap
    l_idx = changed % meta.subtree_cap
    p, nb, sf = compress_rows(state.pool.pool_keys[s_idx, l_idx])
    out = SepPlanes(*(t.clone() for t in sep))
    out.prefix[s_idx, l_idx] = p
    out.nbits[s_idx, l_idx] = nb
    out.suffix[s_idx, l_idx] = sf
    return out
