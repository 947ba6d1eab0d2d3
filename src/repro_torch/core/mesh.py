"""The reference's route x memory device mesh, on a virtual axis or over
the ranks of a ``torch.distributed`` group.

The reference runs its engine body under ``shard_map`` over a
``(route, memory)`` mesh.  The port runs the same mesh as a leading ``Dev``
axis on every per-device tensor, route-major (``dev = r * n_memory + m``),
and runs the engine body once, batched over ``Dev``.  Two backends hold
that axis:

* **the virtual mesh** (the default): one process holds every device of
  the mesh, and the whole state, on one card.  The collectives become
  tensor operations on the ``Dev`` axis;
* **ranks** (a :class:`RankMesh` made active with :func:`use`, as
  ``launch/mesh.py::spawn_ranks`` does): each of the ``P`` processes of a
  group holds the contiguous block of ``Dl = n_devices / P`` devices
  ``p * Dl .. (p + 1) * Dl``, so every per-device plane keeps a leading
  axis of ``Dl``, and its share of the state (``core/dex.py::
  shard_state``): the pool rows, ``occupancy`` and ``n_alloc`` of the
  memory columns its devices belong to only (:func:`local_columns`).  The
  collectives run over the group, and every result equals the virtual
  mesh's, sliced to the rank's block.  ``"nccl"`` carries CUDA tensors, one
  rank a card; ``"gloo"`` carries CPU tensors, or CUDA tensors staged
  through pinned host buffers where ranks share a card.  ``bool`` planes
  travel as ``uint8``; ``int64``, ``int32`` and ``float32`` as they are.
  Every per-batch path of the engine runs there: the synchronous and the
  pipelined engine, scans, writes, the SMO round, a divergent or peeking
  cache policy, one route axis or two; so do the telemetry plane's reads
  of the fleet's counters (:func:`gather_devices`).  What is left to a
  later slice raises ``NotImplementedError`` (:func:`refuse_on_ranks`).

The collectives, with the virtual mesh's formula (the rank backend moves
the same blocks):

* ``a2a`` over the memory axis, on ``[Dev, n_memory, ...]`` buffers:
  ``out[r*nm + m, s] = buf[r*nm + s, m]``;
* ``a2a`` over the route axis, on ``[Dev, n_route, ...]`` buffers:
  ``out[r*nm + m, s] = buf[s*nm + m, r]``.  With two route axes ``(a0,
  a1)`` of sizes ``(s0, s1)`` the route index is ``r = d0 * s1 + d1``
  (route-major, as the reference's ``P(all_axes)`` orders devices), and an
  exchange over ``a0`` swaps the buffer's ``i0`` with the device's ``d0``,
  one over ``a1`` its ``i1`` with ``d1``.  On ranks a block whose source
  and destination lie on one rank is a local copy and the rest go in one
  ``all_to_all_single``, for an exchange over any one axis and for the
  composed exchange over both route axes (:func:`route_transpose`);
* ``psum`` and ``pmax`` over all axes: a sum or maximum over ``Dev``,
  broadcast back (on ranks: over the block, then ``all_reduce``);
  :func:`gather_devices`, the whole ``Dev`` axis of a plane on every rank
  (an ``all_gather``; the identity on the virtual mesh), counts nothing;
* ``gather_route``, the write round's all-gather over the route axis: the
  reference makes every route replica of a memory column apply the same
  gathered batch to its copy of the shard.  The virtual mesh holds the
  pool once, so it keeps one gathered batch per column; a rank gathers
  among the ranks that hold its columns and keeps its own columns' batches,
  which it applies to its own copy of their shard.  ``route_share`` hands
  each device its own route row of the response.

Every collective goes through this module, which counts the calls the way
``repro.core.routing`` counts them while tracing (``all_to_all`` and
``route_exchange``; the reference counts no all-gather), so the per-batch
counts can be held against the reference's.  A process counts one logical
collective once, however many process-group calls it makes, so every
rank's counts equal the virtual mesh's.  Inside a :func:`phase` block
each call is also counted under the block's label, as the reference's
``trace_phase`` does: the pipelined engine labels its two halves
``pipe/front`` and ``pipe/back``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

COUNTS = {"all_to_all": 0, "route_exchange": 0}
#: the counts of each :func:`phase` label since the last reset
PHASE_COUNTS: dict = {}
_PHASE: list = [None]
#: the active :class:`RankMesh`, None for the virtual mesh
_ACTIVE: list = [None]

BACKENDS = ("gloo", "nccl")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; raises when CUDA is asked for and missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(eq=False)
class RankMesh:
    """The rank backend of one process: its process ``group`` (None: the
    default group), the world size ``world`` (P), its ``rank`` (p) and the
    ``backend`` the group was made with.  Made by ``launch/mesh.py``; its
    collectives run only while it is active (:func:`use`)."""

    group: Any
    world: int
    rank: int
    backend: str
    # per mesh layout: the subgroup of ranks holding this rank's columns
    _column_groups: Dict[Tuple[int, int], Any] = dataclasses.field(
        default_factory=dict, repr=False
    )
    _plans: Dict[tuple, Any] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}; options: {BACKENDS}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    def block(self, cfg) -> Tuple[int, int]:
        """``(first device, Dl)`` of this rank's block of ``cfg``'s mesh."""
        return self.rank * local_devices(cfg, self), local_devices(cfg, self)


def current() -> Optional[RankMesh]:
    """The active :class:`RankMesh`, or None on the virtual mesh."""
    return _ACTIVE[0]


@contextlib.contextmanager
def use(rank_mesh: Optional[RankMesh]):
    """Run the block on ``rank_mesh`` (None: the virtual mesh)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = rank_mesh
    try:
        yield rank_mesh
    finally:
        _ACTIVE[0] = prev


def refuse_on_ranks(what: str, entry: int) -> None:
    """Raise ``NotImplementedError`` for ``what`` when a rank mesh is
    active: it runs on the virtual mesh only until entry ``entry`` of
    ``ROADMAP.md``'s queue "Across ranks" ports it, and is never quietly
    run on one rank."""
    if _ACTIVE[0] is not None:
        raise NotImplementedError(
            f"{what} does not run on the rank backend yet "
            f'(ROADMAP.md, queue "Across ranks", entry {entry})'
        )


def local_devices(cfg, rank_mesh: Optional[RankMesh] = None) -> int:
    """``Dl``, the devices this process holds: every device of the mesh on
    the virtual mesh, ``n_devices / P`` on ranks.  Raises ``ValueError``
    where ``P`` does not divide ``n_devices``, or where a block would hold
    part of a route row and part of the next (neither ``Dl`` nor
    ``n_memory`` divides the other)."""
    rm = _ACTIVE[0] if rank_mesh is None else rank_mesh
    if rm is None:
        return cfg.n_devices
    if cfg.n_devices % rm.world:
        raise ValueError(
            f"{rm.world} ranks do not divide the mesh's {cfg.n_devices} devices"
        )
    dl = cfg.n_devices // rm.world
    if dl % cfg.n_memory and cfg.n_memory % dl:
        raise ValueError(
            f"a block of {dl} devices straddles the mesh's route rows of "
            f"{cfg.n_memory} memory columns"
        )
    return dl


def local_columns(cfg, rank_mesh: Optional[RankMesh] = None) -> Tuple[int, int]:
    """``(first memory column, count)`` of the columns this process holds
    the pool shards of: all of them on the virtual mesh; on ranks, the
    columns its block of devices belongs to, which are contiguous."""
    rm = _ACTIVE[0] if rank_mesh is None else rank_mesh
    nm = cfg.n_memory
    if rm is None:
        return 0, nm
    dl = local_devices(cfg, rm)
    if dl >= nm:
        return 0, nm
    return (rm.rank * dl) % nm, dl


@contextlib.contextmanager
def phase(label: str):
    """Count the collectives called inside this block under ``label`` too
    (the innermost label wins)."""
    prev = _PHASE[0]
    _PHASE[0] = label
    try:
        yield
    finally:
        _PHASE[0] = prev


def count(kind: str) -> None:
    COUNTS[kind] += 1
    label = _PHASE[0]
    if label is not None:
        per = PHASE_COUNTS.setdefault(label, {"all_to_all": 0, "route_exchange": 0})
        per[kind] += 1


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    PHASE_COUNTS.clear()


def collective_counts(by_phase: bool = False) -> dict:
    """The counts since the last reset; with ``by_phase`` also ``"phases"``,
    the counts of each label that counted a collective."""
    out = dict(COUNTS)
    if by_phase:
        out["phases"] = {
            label: dict(per) for label, per in PHASE_COUNTS.items() if any(per.values())
        }
    return out


def device_linear_index(cfg, device) -> torch.Tensor:
    """``[Dev]`` linear device position over all mesh axes, route-major
    (on ranks: the block's global positions)."""
    dl = local_devices(cfg)
    d0 = 0 if _ACTIVE[0] is None else _ACTIVE[0].rank * dl
    return torch.arange(d0, d0 + dl, device=device)


def route_linear_index(cfg, device) -> torch.Tensor:
    """``[Dev]`` position of each device along the composed route axes,
    route-major (the leading axis of :func:`gather_route`)."""
    return device_linear_index(cfg, device) // cfg.n_memory


def memory_linear_index(cfg, device) -> torch.Tensor:
    """``[Dev]`` memory column of each device."""
    return device_linear_index(cfg, device) % cfg.n_memory


def a2a(x: torch.Tensor, cfg, axis: str) -> torch.Tensor:
    """``[Dev, n_axis, ...]`` per-destination buffers -> per-source buffers
    along the named mesh axis (``cfg.memory_axis`` or the route axis)."""
    count("all_to_all")
    rm = _ACTIVE[0]
    if rm is not None:
        if axis == cfg.memory_axis:
            return _rank_a2a(rm, x, cfg, "memory")
        if axis in cfg.route_axes:
            if len(cfg.route_axes) == 1:
                return _rank_a2a(rm, x, cfg, "route")
            return _rank_a2a(rm, x, cfg, cfg.route_axes.index(axis))
        raise ValueError(f"unknown mesh axis {axis!r}")
    nr, nm = cfg.n_route, cfg.n_memory
    rest = tuple(x.shape[2:])
    tail = tuple(range(3, 3 + len(rest)))
    if axis == cfg.memory_axis:
        y = x.reshape((nr, nm, nm) + rest).permute((0, 2, 1) + tail)
    elif axis in cfg.route_axes:
        if len(cfg.route_axes) == 1:
            return route_transpose(x, cfg)
        # [d0, d1, m, i0, i1, ...]: swap the device's and the buffer's
        # position along this axis
        sizes = cfg.route_sizes
        k = cfg.route_axes.index(axis)
        y = x.reshape(sizes + (nm,) + sizes + rest)
        perm = list(range(y.dim()))
        perm[k], perm[3 + k] = perm[3 + k], perm[k]
        y = y.permute(perm)
    else:
        raise ValueError(f"unknown mesh axis {axis!r}")
    return y.reshape(x.shape)


def route_transpose(x: torch.Tensor, cfg) -> torch.Tensor:
    """``[Dev, n_route, ...]`` -> the buffers exchanged over the whole route
    index: ``out[r*nm + m, s] = x[s*nm + m, r]``.  Counts nothing; with two
    route axes it is the composition of the exchanges over each, which act
    on disjoint index pairs and so commute.  On ranks the composed
    exchange is one ``all_to_all_single`` as well: each block crosses the
    group once, where the exchanges over each axis in turn would send a
    block that changes both coordinates twice."""
    rm = _ACTIVE[0]
    if rm is not None:
        return _rank_a2a(rm, x, cfg, "route")
    nr, nm = cfg.n_route, cfg.n_memory
    rest = tuple(x.shape[2:])
    tail = tuple(range(3, 3 + len(rest)))
    y = x.reshape((nr, nm, nr) + rest).permute((2, 1, 0) + tail)
    return y.reshape(x.shape)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ``Dev``, broadcast back to every device.  Callers only sum
    integer-valued planes (float32 ones below 2**24), which are exact in
    any order."""
    s = x.sum(0, keepdim=True)
    rm = _ACTIVE[0]
    if rm is not None:
        s = _all_reduce(rm, s, "sum")
    return s.expand_as(x)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Maximum over ``Dev``, broadcast back to every device."""
    s = x.amax(0, keepdim=True)
    rm = _ACTIVE[0]
    if rm is not None:
        s = _all_reduce(rm, s, "max")
    return s.expand_as(x)


def gather_route(x: torch.Tensor, cfg) -> torch.Tensor:
    """``[Dev, ...]`` -> ``[n_columns, n_route, ...]``: each memory column's
    batch gathered over its route replicas, ``out[m, r] = x[r*nm + m]``,
    for every column on the virtual mesh and for the rank's own columns
    (:func:`local_columns`) on ranks.

    The reference all-gathers so that every route replica of a column's pool
    shard applies the same writes; the virtual mesh holds one copy of the
    pool, so it keeps one gathered batch per column and applies it once.
    Like the reference's counter, this counts nothing.  With two route
    axes the reference gathers over ``a1`` then ``a0``, which leaves the
    route index in the same route-major order."""
    rest = tuple(x.shape[1:])
    rm = _ACTIVE[0]
    if rm is not None:
        _, n_cols = local_columns(cfg, rm)
        x = _column_all_gather(rm, x, cfg)
        return x.reshape((cfg.n_route, n_cols) + rest).transpose(0, 1)
    return x.reshape((cfg.n_route, cfg.n_memory) + rest).transpose(0, 1)


def route_share(x: torch.Tensor, cfg) -> torch.Tensor:
    """``[n_columns, n_route, ...]`` -> ``[Dev, ...]``, the inverse of
    :func:`gather_route`: device ``r*nm + m`` takes its own route row ``r``
    of column ``m``'s response."""
    rest = tuple(x.shape[2:])
    rm = _ACTIVE[0]
    if rm is not None:
        d0, dl = rm.block(cfg)
        r0 = d0 // cfg.n_memory
        rows = max(dl // cfg.n_memory, 1)
        return x.transpose(0, 1)[r0 : r0 + rows].reshape((dl,) + rest)
    return x.transpose(0, 1).reshape((cfg.n_devices,) + rest)


def host_sum(values) -> np.ndarray:
    """Host integers summed over the ranks (the values themselves on the
    virtual mesh): what a host loop over a rank's lanes needs so that
    every rank takes the same branch.  Counts nothing."""
    return _host_reduce(np.asarray(values, np.int64), "sum")


def host_max(values) -> np.ndarray:
    """Host float64 values, each the maximum over the ranks (the values
    themselves on the virtual mesh).  Counts nothing."""
    return _host_reduce(np.asarray(values, np.float64), "max")


def _host_reduce(v: np.ndarray, op: str) -> np.ndarray:
    rm = _ACTIVE[0]
    if rm is None:
        return v
    t = torch.from_numpy(v.copy())
    if rm.backend == "nccl":
        t = t.to(resolve_device())
    return _all_reduce(rm, t, op).cpu().numpy()


def gather_devices(x: torch.Tensor) -> torch.Tensor:
    """``[Dl, ...]`` -> ``[Dev, ...]``: every rank's block of a per-device
    plane, in device order, on every rank (``x`` itself on the virtual
    mesh).  What reads the whole fleet's counters calls it; every rank must
    call it, and, like :func:`gather_route`, it counts nothing.  Under
    ``"nccl"`` a CPU tensor travels through the card and comes back on the
    CPU."""
    import torch.distributed as dist

    rm = _ACTIVE[0]
    if rm is None:
        return x
    t = x.to(resolve_device()) if rm.backend == "nccl" and not x.is_cuda else x
    wire = _to_wire(rm, t)
    parts = [torch.empty_like(wire) for _ in range(rm.world)]
    dist.all_gather(parts, wire, group=rm.group)
    return _from_wire(torch.cat(parts), x)


def owner_merge(x: torch.Tensor, owned: torch.Tensor) -> torch.Tensor:
    """``x`` [N] (int64), each entry taken from the rank whose ``owned``
    [N] is True there (every rank that owns an entry holds the same value):
    a replicated table whose entries each column writes for its own nodes,
    as the reference's all-gather over the memory axis and pick by the
    owner column.  The virtual mesh owns every entry: ``x`` itself."""
    rm = _ACTIVE[0]
    if rm is None:
        return x
    low = torch.iinfo(x.dtype).min
    return _all_reduce(rm, torch.where(owned, x, low), "max")


# ---------------------------------------------------------------------------
# the rank backend's transport
# ---------------------------------------------------------------------------


def _check(rm: RankMesh, t: torch.Tensor) -> None:
    if rm.backend == "nccl" and not t.is_cuda:
        raise ValueError(
            f"the nccl backend carries CUDA tensors; got one on {t.device}"
        )


def _to_wire(rm: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend carries it: contiguous, ``bool`` viewed as
    ``uint8``, and for gloo on a CUDA tensor a pinned host copy."""
    _check(rm, t)
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    if rm.backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device != like.device:
        t = t.to(like.device)
    if like.dtype == torch.bool:
        t = t.view(torch.bool)
    return t


def _all_reduce(rm: RankMesh, x: torch.Tensor, op: str) -> torch.Tensor:
    import torch.distributed as dist

    w = _to_wire(rm, x)
    if w.data_ptr() == x.data_ptr():
        w = w.clone()  # reduce a copy, never the caller's tensor
    dist.all_reduce(
        w, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
        group=rm.group,
    )
    return _from_wire(w, x)


def _a2a_sources(cfg, kind):
    """``(src_g, src_j)`` ``[n_dev, n_axis]``: the device and buffer slot
    each ``(destination device, slot)`` pair of the exchange reads, the
    virtual mesh's permutation.  ``kind`` is ``"memory"``, ``"route"`` (the
    whole route index: one route axis, or the composition of several) or
    the position of one of several route axes."""
    nr, nm = cfg.n_route, cfg.n_memory
    n_ax = nm if kind == "memory" else nr
    g = np.arange(cfg.n_devices)[:, None]
    s = np.arange(n_ax)[None, :]
    r, m = g // nm, g % nm
    if kind == "memory":
        return r * nm + s, m
    if kind == "route":
        return s * nm + m, r
    # swap the device's and the slot's digit along route axis ``kind``
    # (route-major digits: the last axis varies fastest)
    stride = int(np.prod(cfg.route_sizes[kind + 1:], dtype=np.int64))
    size = cfg.route_sizes[kind]
    dr, ds = (r // stride) % size, (s // stride) % size
    src_r = r + (ds - dr) * stride
    src_j = s + (dr - ds) * stride
    return src_r * nm + m, src_j


def _a2a_plan(rm: RankMesh, cfg, kind):
    """Index tables of one exchange on this rank, from the virtual mesh's
    permutation over ``(destination device, buffer slot)`` pairs
    (:func:`_a2a_sources`): the local copy's source and destination rows,
    the rows sent to each other rank (grouped by rank, in pair order) and
    where the rows received from each land.  Both ends enumerate a rank
    pair's rows in the same order, so the receiver places them without an
    index on the wire."""
    key = (cfg.n_route, cfg.n_memory, tuple(cfg.route_sizes), kind)
    plan = rm._plans.get(key)
    if plan is not None:
        return plan
    p, n_dev = rm.rank, cfg.n_devices
    dl = local_devices(cfg, rm)
    n_ax = cfg.n_memory if kind == "memory" else cfg.n_route
    src_g, src_j = _a2a_sources(cfg, kind)
    src_g = np.broadcast_to(src_g, (n_dev, n_ax)).ravel()
    src_j = np.broadcast_to(src_j, (n_dev, n_ax)).ravel()
    dst_g = np.repeat(np.arange(n_dev), n_ax)
    dst_s = np.tile(np.arange(n_ax), n_dev)
    src_rank, dst_rank = src_g // dl, dst_g // dl
    src_row = (src_g - p * dl) * n_ax + src_j  # row of the local buffer
    dst_row = (dst_g - p * dl) * n_ax + dst_s  # row of the local result
    mine = (src_rank == p) & (dst_rank == p)
    send = np.nonzero((src_rank == p) & (dst_rank != p))[0]
    send = send[np.argsort(dst_rank[send], kind="stable")]
    recv = np.nonzero((dst_rank == p) & (src_rank != p))[0]
    recv = recv[np.argsort(src_rank[recv], kind="stable")]
    plan = {
        "remote": bool((src_rank != dst_rank).any()),
        "local_src": torch.from_numpy(src_row[mine]),
        "local_dst": torch.from_numpy(dst_row[mine]),
        "send_rows": torch.from_numpy(src_row[send]),
        "send_splits": np.bincount(dst_rank[send], minlength=rm.world).tolist(),
        "recv_rows": torch.from_numpy(dst_row[recv]),
        "recv_splits": np.bincount(src_rank[recv], minlength=rm.world).tolist(),
        "rows": dl * n_ax,
    }
    rm._plans[key] = plan
    return plan


def _rank_a2a(rm: RankMesh, x: torch.Tensor, cfg, kind: str) -> torch.Tensor:
    import torch.distributed as dist

    _check(rm, x)
    plan = _a2a_plan(rm, cfg, kind)
    if x.shape[0] * x.shape[1] != plan["rows"]:
        raise ValueError(
            f"a2a buffers {tuple(x.shape[:2])} do not fit this rank's block "
            f"of {plan['rows']} rows"
        )
    dev = x.device
    flat = x.reshape((plan["rows"], -1))
    out = torch.empty_like(flat)
    out[plan["local_dst"].to(dev)] = flat[plan["local_src"].to(dev)]
    if plan["remote"]:
        send = flat[plan["send_rows"].to(dev)]
        wire = _to_wire(rm, send)
        recv = torch.empty(
            (sum(plan["recv_splits"]), flat.shape[1]), dtype=wire.dtype,
            device=wire.device,
        )
        dist.all_to_all_single(
            recv, wire, plan["recv_splits"], plan["send_splits"], group=rm.group
        )
        out[plan["recv_rows"].to(dev)] = _from_wire(recv, send)
    return out.reshape(x.shape)


def _column_all_gather(rm: RankMesh, x: torch.Tensor, cfg) -> torch.Tensor:
    """``[Dl, ...]`` -> the blocks of every rank holding this rank's
    columns, concatenated in rank order (route-major over those columns)."""
    import torch.distributed as dist

    _check(rm, x)
    dl, nm = local_devices(cfg, rm), cfg.n_memory
    if dl >= nm:
        members = list(range(rm.world))
        group = rm.group
    else:
        key = (cfg.n_route, nm)
        per_row = nm // dl  # ranks a route row spans
        if key not in rm._column_groups:
            # every rank makes every subgroup, in one order
            groups = [
                dist.new_group(list(range(j, rm.world, per_row)), backend=rm.backend)
                for j in range(per_row)
            ]
            rm._column_groups[key] = groups[rm.rank % per_row]
        members = list(range(rm.rank % per_row, rm.world, per_row))
        group = rm._column_groups[key]
    wire = _to_wire(rm, x)
    parts = [torch.empty_like(wire) for _ in members]
    dist.all_gather(parts, wire, group=group)
    return _from_wire(torch.cat(parts), x)
