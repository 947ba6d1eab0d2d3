"""Request routing over the mesh.

Every per-device tensor carries a leading ``Dev`` axis (``core/mesh.py``:
every device of the mesh on the virtual mesh, a rank's block on ranks).
A batch moves between devices the way the reference moves it:

  1. bucket requests by destination with bounded capacity
     (:func:`pack_by_dest`);
  2. exchange the buckets (:func:`route_exchange`, ``mesh.a2a``);
  3. serve, exchange back, and scatter responses to the originating lanes
     (:func:`unpack_to_lanes`).

:func:`fetch_rows` is the remote row read: one request/response exchange
over the memory axis per tree level, with duplicate requests coalesced.
:func:`rt_predict` is the route table's leaf guess.

Scatters that the reference writes with ``mode="drop"`` become a scatter of
slot indices into a map with one spare slot, which the dropped entries land
in and which is cut off afterwards, and then a gather of the rows through
that map: no host synchronisation is needed to mask them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mesh
from repro_torch.core.nodes import FANOUT, KEY_MAX

_MIX1 = 0xFF51AFD7ED558CCD - 2**64
_MIX2 = 0xC4CEB9FE1A85EC53 - 2**64
_SALT_MUL = 0x5851F42D4C957F2D
_GID_XOR = 0x9E3779B9


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer on int64 bit patterns (the reference hashes in
    uint64; int64 multiplication wraps to the same bits)."""
    x = x.long()
    x = (x ^ _shr(x, 33)) * _MIX1
    x = (x ^ _shr(x, 33)) * _MIX2
    return x ^ _shr(x, 33)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` read as uint64, modulo the positive int ``m`` (int64 result)."""
    low = torch.remainder(x & (2**63 - 1), m)
    return torch.where(x < 0, (low + (2**63) % m) % m, low)


def leaf_admit_dice(gid: torch.Tensor, pct, salt=None) -> torch.Tensor:
    """Lazy leaf-admission coin flip (paper §5.4), deterministic per
    (node id, salt); ``salt`` is int64 and its product wraps."""
    x = gid.long() ^ _GID_XOR
    if salt is not None:
        x = x ^ (salt.long() * _SALT_MUL)
    return umod(hash64(x), 100) < pct


def rt_predict(rt_keys: torch.Tensor, rt_sub: torch.Tensor, rt_local: torch.Tensor,
               keys: torch.Tensor):
    """Route-table segment lookup: one ``searchsorted`` of ``keys`` (any
    shape) against the sorted fence-low plane ``rt_keys`` [R], no collective
    and no remote read.  Returns ``(idx, pred_subtree, pred_local)`` (int32),
    a guess that ``fleet_cache.rt_accept`` checks before the engine acts on
    it."""
    r = rt_keys.shape[0]
    idx = torch.searchsorted(rt_keys, keys, right=True) - 1
    idx = idx.clamp(0, r - 1)
    return idx.to(torch.int32), rt_sub[idx].to(torch.int32), rt_local[idx].to(torch.int32)


def route_capacity(b: int, n_dest: int, factor: float) -> int:
    """Per-destination bucket capacity for a batch of ``b`` requests."""
    return int(np.ceil(b / n_dest * factor))


def route_owners(boundaries: torch.Tensor, keys: torch.Tensor, n_route: int):
    """Owning route partition per lane of ``keys`` [Dev, b], plus this
    batch's per-partition demand [Dev, n_route].  Inactive (KEY_MAX) lanes
    get the out-of-bounds destination ``n_route`` and add no demand."""
    owner = torch.searchsorted(boundaries, keys, right=True) - 1
    owner = torch.clamp(owner, 0, n_route - 1)
    demand = torch.zeros(
        (keys.shape[0], n_route), dtype=torch.int64, device=keys.device
    ).scatter_add_(1, owner, (keys != KEY_MAX).long())
    owner = torch.where(keys == KEY_MAX, n_route, owner)
    return owner, demand


def _slot_map(n_slots: int, index: torch.Tensor, src: torch.Tensor, empty: int):
    """``[n_slots]`` map holding ``src`` at ``index`` and ``empty`` elsewhere;
    an index of ``n_slots`` drops its entry.  Only small integers are
    scattered: wide rows are then gathered through the map, never
    scattered (a scatter of wide rows with many dropped entries all aimed
    at one spare slot is slow on the card)."""
    out = torch.full((n_slots + 1,), empty, dtype=src.dtype, device=src.device)
    out.index_copy_(0, index, src)
    return out[:n_slots]


def _gather_rows(rows: torch.Tensor, index: torch.Tensor, ok: torch.Tensor, fill):
    """``rows[index]`` where ``ok``, else ``fill`` (``index`` any where not)."""
    got = rows[torch.where(ok, index, 0)]
    mask = ok.view(ok.shape + (1,) * (rows.dim() - 1))
    return torch.where(mask, got, fill)


def pack_by_dest(payload: torch.Tensor, dest: torch.Tensor, n_dest: int, cap: int):
    """Bucket ``payload`` [Dev, b, ...] rows by ``dest`` [Dev, b] with
    bounded capacity.  Returns ``(buf [Dev, n_dest, cap, ...] (KEY_MAX or 0
    padding), lane_of_slot [Dev, n_dest, cap] int32 (b = empty), dropped
    [Dev, b])``; ``dropped`` marks lanes beyond a bucket's capacity."""
    n_dev, b = dest.shape
    dev = payload.device
    sd, order = torch.sort(dest, dim=1, stable=True)
    new = torch.ones_like(sd, dtype=torch.bool)
    new[:, 1:] = sd[:, 1:] != sd[:, :-1]
    pos = torch.arange(b, device=dev).expand(n_dev, b)
    start = torch.cummax(torch.where(new, pos, 0), dim=1).values
    rank = pos - start
    ok = rank < cap
    n_slots = n_dev * n_dest * cap
    d = torch.arange(n_dev, device=dev)[:, None]
    slot = torch.where(ok & (sd < n_dest), (d * n_dest + sd) * cap + rank, n_slots)
    src = (d * b + order).reshape(-1)
    flat_lane = _slot_map(n_slots, slot.reshape(-1), src, n_dev * b)
    rest = tuple(payload.shape[2:])
    fill = KEY_MAX if payload.dtype == torch.int64 else 0
    buf = _gather_rows(
        payload.reshape((n_dev * b,) + rest), flat_lane, flat_lane < n_dev * b, fill
    )
    lane = torch.where(flat_lane < n_dev * b, flat_lane % b, b).to(torch.int32)
    dropped = torch.zeros_like(ok).scatter_(1, order, ~ok)
    return (
        buf.view((n_dev, n_dest, cap) + rest),
        lane.view(n_dev, n_dest, cap),
        dropped,
    )


def unpack_to_lanes(resp: torch.Tensor, lane_of_slot: torch.Tensor, b: int, fill):
    """Scatter ``[Dev, n_dest, cap, ...]`` responses back to ``[Dev, b, ...]``
    lanes; empty slots (lane ``b``) are dropped."""
    n_dev = resp.shape[0]
    rest = tuple(resp.shape[3:])
    lane = lane_of_slot.reshape(n_dev, -1).long()
    n_resp = lane.shape[1]
    d = torch.arange(n_dev, device=resp.device)[:, None]
    index = torch.where(lane < b, d * b + lane, n_dev * b).reshape(-1)
    src = (d * n_resp + torch.arange(n_resp, device=resp.device)).reshape(-1)
    slot_of_lane = _slot_map(n_dev * b, index, src, -1)
    flat = resp.reshape((-1,) + rest)
    out = _gather_rows(flat, slot_of_lane, slot_of_lane >= 0, fill)
    return out.view((n_dev, b) + rest)


def route_exchange(buf: torch.Tensor, cfg, *, reverse: bool = False) -> torch.Tensor:
    """Exchange ``[Dev, n_route, cap, ...]`` buckets across the route axes.

    With one axis this is one ``all_to_all``.  With two, the reference
    composes the exchanges over each axis, ``x1(x0(.))`` on the way out and
    ``x0(x1(.))`` on the way back (``reverse``), two ``all_to_all`` each
    time.  They act on disjoint (buffer, device) index pairs and commute,
    so the virtual mesh counts the two in the reference's order and moves
    the buffers once, by the composed permutation."""
    mesh.count("route_exchange")
    axes = cfg.route_axes
    if len(axes) == 1:
        return mesh.a2a(buf, cfg, axes[0])
    for _ in axes:
        mesh.count("all_to_all")
    return mesh.route_transpose(buf, cfg)


def fetch_rows(pool, meta, cfg, gid: torch.Tensor, want: torch.Tensor):
    """Remote-read node rows (the RDMA READ analogue) for ``gid`` [Dev, Q]
    where ``want``: a request/response exchange over the memory axis.
    Duplicate gids on one device collapse into one read whose response fans
    out to every requesting lane.  Returns ``(keys, children, values, shed,
    n_msgs [Dev])``."""
    n_dev, b = gid.shape
    dev = gid.device
    gidr = torch.where(want, gid, KEY_MAX)
    gs, order = torch.sort(gidr, dim=1, stable=True)
    head = torch.ones_like(gs, dtype=torch.bool)
    head[:, 1:] = gs[:, 1:] != gs[:, :-1]
    pos = torch.arange(b, device=dev).expand(n_dev, b)
    rep_sorted = torch.cummax(torch.where(head, pos, 0), dim=1).values
    rep = torch.empty_like(order).scatter_(1, order, order.gather(1, rep_sorted))
    is_head = torch.empty_like(head).scatter_(1, order, head)
    want_h = want & is_head

    nm = cfg.n_memory
    s_per = meta.n_subtrees_padded // nm
    owner = torch.where(want_h, (gid // meta.subtree_cap) // s_per, nm)
    cap = route_capacity(b, nm, cfg.route_capacity_factor)
    buf, lane, dropped = pack_by_dest(gid, owner, nm, cap)
    req = mesh.a2a(buf, cfg, cfg.memory_axis)  # [Dev, nm, cap]
    # serve on the owning column: a request on column m names a subtree of
    # m's shard, rows m*s_per .. (m+1)*s_per of the global pool, which this
    # process holds from its first column's rows on
    valid = req != KEY_MAX
    col = mesh.memory_linear_index(cfg, dev)[:, None, None] - mesh.local_columns(cfg)[0]
    st = col * s_per + torch.where(valid, (req // meta.subtree_cap) % s_per, 0)
    lo = torch.where(valid, req % meta.subtree_cap, 0)
    vm = valid[..., None]
    rk = torch.where(vm, pool.pool_keys[st, lo], KEY_MAX)
    rc = torch.where(vm, pool.pool_children[st, lo], 0)
    rv = torch.where(vm, pool.pool_values[st, lo], 0)
    rk = mesh.a2a(rk, cfg, cfg.memory_axis)
    rc = mesh.a2a(rc, cfg, cfg.memory_axis)
    rv = mesh.a2a(rv, cfg, cfg.memory_axis)
    fan = rep[..., None].expand(n_dev, b, FANOUT)
    out_k = unpack_to_lanes(rk, lane, b, KEY_MAX).gather(1, fan)
    out_c = unpack_to_lanes(rc, lane, b, 0).gather(1, fan)
    out_v = unpack_to_lanes(rv, lane, b, 0).gather(1, fan)
    shed = dropped.gather(1, rep) & want
    n_msgs = (want_h & ~dropped).sum(1)
    return out_k, out_c, out_v, shed, n_msgs
