"""DEX on the mesh: configuration, state and the lookup entry point.

Compute servers are route rows of the mesh (logical partitioning, §4);
memory servers are its columns, each holding one shard of the
subtree-blocked pool (§3); each device keeps a set-associative node cache
(§5) and offloads a column's lanes when its cost model says a two-sided walk
is cheaper than fetching rows (§6.1).  The execution dataflow is in
``core/engine.py``.

``state_from_numpy`` / ``state_to_numpy`` carry a state across packages:
the reference's ``DexState`` flattened to numpy and keyed by field path
(``"pool.pool_keys"``, ``"cache.tags"``, ``"miss_ema"``, ...).
``shard_state`` / ``shard_pool`` / ``gather_state`` split a state over the
ranks of ``core/mesh.py``'s rank backend by ``state_shardings``' specs and
join it again.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.fleet_cache import P_ADMIT_LEAF_PCT, DexCache, init_cache
from repro_torch.core import mesh as _mesh
from repro_torch.core.mesh import resolve_device
from repro_torch.core.nodes import FANOUT, KEY_MAX
from repro_torch.core.pool import PoolMeta, SubtreePool, initial_succ
from repro_torch.obs import latency as _latency
from repro_torch.obs.registry import N_STATS

NODE_ROW_BYTES = FANOUT * 8 * 3  # keys + children + values on the wire
OFFLOAD_REQ_BYTES = 16
OFFLOAD_RESP_BYTES = 16


@dataclasses.dataclass(frozen=True)
class DexMeshConfig:
    """Static configuration of the mesh plane."""

    route_axes: Tuple[str, ...] = ("data",)  # compute-partition axes
    memory_axis: str = "model"  # pool-shard axis
    n_route: int = 1  # route axis size
    n_memory: int = 1  # memory axis size
    cache_sets: int = 256
    cache_ways: int = 4
    p_admit_leaf_pct: int = P_ADMIT_LEAF_PCT  # paper §5.4 P_A, in percent
    route_capacity_factor: float = 2.0  # bucket slack
    policy: str = "auto"  # fetch | offload | auto
    offload_c: float = 1.3  # cost coefficient (§6.1)
    ema_decay: float = 0.98
    route_table_slots: int = 0  # leaf-direct route table
    # the size of each route axis, in ``route_axes`` order; their product is
    # ``n_route``.  The reference reads them off its device mesh
    # (``mesh.shape``), which the virtual mesh does not have.  Empty means
    # ``(n_route,)``, which one route axis needs no more than
    route_shape: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.route_axes) not in (1, 2):
            raise ValueError(f"one or two route axes, got {self.route_axes!r}")
        sizes = self.route_sizes
        if len(sizes) != len(self.route_axes):
            raise ValueError(
                f"route_shape {self.route_shape!r} must give a size for each of "
                f"the route axes {self.route_axes!r}"
            )
        if int(np.prod(sizes)) != self.n_route or min(sizes) < 1:
            raise ValueError(
                f"route_shape {sizes!r} must multiply to n_route={self.n_route}"
            )

    @property
    def route_sizes(self) -> Tuple[int, ...]:
        """Each route axis's size, in ``route_axes`` order."""
        return tuple(self.route_shape) or (self.n_route,)

    @property
    def n_devices(self) -> int:
        return self.n_route * self.n_memory


class DexState(NamedTuple):
    pool: SubtreePool
    cache: DexCache
    boundaries: torch.Tensor  # [n_route + 1] int64, replicated
    # [Dev, n_memory, levels] f32 per-(column, level) miss-rate EMA of the
    # offload rule
    miss_ema: torch.Tensor
    stats: torch.Tensor  # [Dev, N_STATS] int64
    versions: torch.Tensor  # [Dev, n_nodes] int32 per-node write version
    occupancy: torch.Tensor  # [S, C] int32 keys per node
    route_demand: torch.Tensor  # [Dev, n_route] int64 routed requests
    succ: torch.Tensor  # [Dev, n_nodes] int64 leaf successor gid
    n_alloc: torch.Tensor  # [S] int32 per-subtree free-list watermark
    lat_hist: torch.Tensor  # [Dev, classes, paths, buckets] int64
    # [Dev, 2, n_memory, levels] f32 offload cost-model audit (predicted,
    # realized bytes)
    lat_audit: torch.Tensor
    rt_keys: torch.Tensor  # [R] int64 route-table fence-low keys
    rt_hi: torch.Tensor  # [R] int64 fence-high keys
    rt_sub: torch.Tensor  # [R] int32 predicted subtree
    rt_local: torch.Tensor  # [R] int32 predicted leaf local id
    rt_ver: torch.Tensor  # [R] int32 leaf version at training time


def init_state(
    pool: SubtreePool,
    meta: PoolMeta,
    cfg: DexMeshConfig,
    boundaries,
    *,
    device=None,
    mesh=None,
) -> DexState:
    """A fresh state over ``pool`` with cold caches and zeroed counters.
    ``succ`` is one successor table broadcast over ``Dev`` (a view, not a
    copy per device).

    With a ``core/mesh.py::RankMesh`` as ``mesh`` this is the rank's share
    (:func:`shard_state`'s layout): ``pool`` holds the pool rows of the
    rank's columns only (``pool.build_pool(columns=...)`` or
    :func:`shard_pool`), and the per-device planes its block of devices."""
    device = resolve_device(device)
    pool = SubtreePool(*(t.to(device) for t in pool))
    levels = meta.levels_in_subtree
    d, s_rows = cfg.n_devices, meta.n_subtrees_padded
    if mesh is not None:
        d = _mesh.local_devices(cfg, mesh)
        c0, n_cols = _mesh.local_columns(cfg, mesh)
        s_rows = meta.n_subtrees_padded // cfg.n_memory * n_cols
        if pool.pool_keys.shape[0] != s_rows:
            raise ValueError(
                f"pool holds {pool.pool_keys.shape[0]} subtree rows; columns "
                f"{c0}..{c0 + n_cols - 1} of this layout hold {s_rows}"
            )
    r = max(cfg.route_table_slots, 1)
    base = meta.base_cap if meta.base_cap > 0 else meta.subtree_cap
    i64 = dict(dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return DexState(
        pool=pool,
        cache=init_cache(cfg, device, n_dev=d),
        boundaries=torch.as_tensor(np.asarray(boundaries, np.int64)).to(device),
        miss_ema=torch.ones((d, cfg.n_memory, levels), **f32),
        stats=torch.zeros((d, N_STATS), **i64),
        versions=torch.zeros((d, meta.n_nodes), **i32),
        occupancy=(pool.pool_keys != KEY_MAX).sum(-1).to(torch.int32),
        route_demand=torch.zeros((d, cfg.n_route), **i64),
        succ=initial_succ(meta, device)[None].expand(d, meta.n_nodes),
        n_alloc=torch.full((s_rows,), base, **i32),
        lat_hist=torch.zeros(
            (d, _latency.N_CLASSES, _latency.N_PATHS, _latency.N_BUCKETS), **i64
        ),
        lat_audit=torch.zeros((d, 2, cfg.n_memory, levels), **f32),
        rt_keys=torch.full((r,), KEY_MAX, **i64),
        rt_hi=torch.full((r,), KEY_MAX, **i64),
        rt_sub=torch.zeros((r,), **i32),
        rt_local=torch.zeros((r,), **i32),
        rt_ver=torch.full((r,), -1, **i32),
    )


def state_shardings(mesh, cfg: DexMeshConfig) -> DexState:
    """A ``train/sharding.py::Placement`` for each ``DexState`` field on
    ``mesh`` (``launch/mesh.py``), with the reference's specs: the per-device
    planes over every route axis and the memory axis, the pool's shards,
    ``occupancy`` and ``n_alloc`` over the memory axis, the rest
    replicated.

    The two backends of ``core/mesh.py`` read these specs differently.  The
    virtual mesh keeps every plane whole on its device, so there a spec
    says how the described mesh would split it.  The rank backend splits
    the state by them (:func:`shard_state`, :func:`gather_state`): a rank
    holds the per-device planes' rows of its block of devices, the
    memory-axis planes' rows of its own columns, and the replicated planes
    whole."""
    from repro_torch.train.sharding import Placement

    dev = (cfg.route_axes + (cfg.memory_axis,),)
    mem = (cfg.memory_axis,)

    def ns(spec):
        return Placement(mesh, spec)

    pool_spec = SubtreePool(
        top_keys=ns(()),
        top_children=ns(()),
        pool_keys=ns(mem),
        pool_children=ns(mem),
        pool_values=ns(mem),
    )
    cache_spec = DexCache(
        tags=ns(dev), keys=ns(dev), children=ns(dev), values=ns(dev),
        fifo=ns(dev), ver=ns(dev),
    )
    return DexState(
        pool=pool_spec,
        cache=cache_spec,
        boundaries=ns(()),
        miss_ema=ns(dev),
        stats=ns(dev),
        versions=ns(dev),
        occupancy=ns(mem),
        route_demand=ns(dev),
        succ=ns(dev),
        n_alloc=ns(mem),
        lat_hist=ns(dev),
        lat_audit=ns(dev),
        rt_keys=ns(()),
        rt_hi=ns(()),
        rt_sub=ns(()),
        rt_local=ns(()),
        rt_ver=ns(()),
    )


def _plane_kinds(cfg: DexMeshConfig) -> Dict[str, str]:
    """Each field path's split under the rank backend, read off
    :func:`state_shardings`: ``"dev"`` (over every mesh axis), ``"mem"``
    (over the memory axis) or ``"rep"`` (replicated)."""
    from repro_torch.launch.mesh import MeshSpec

    spec_mesh = MeshSpec(
        cfg.route_axes + (cfg.memory_axis,),
        cfg.route_sizes + (cfg.n_memory,),
        torch.device("cpu"),
    )
    kinds = {}

    def kind(spec):
        if len(spec) == 0:
            return "rep"
        return "mem" if spec[0] == cfg.memory_axis else "dev"

    for name, value in state_shardings(spec_mesh, cfg)._asdict().items():
        if isinstance(value, tuple):
            for sub, p in value._asdict().items():
                kinds[f"{name}.{sub}"] = kind(p.spec)
        else:
            kinds[name] = kind(value.spec)
    return kinds


def _map_planes(state: DexState, fn) -> DexState:
    """``state`` with every plane ``t`` at field path ``k`` as ``fn(k, t)``."""
    out = {}
    for name, value in state._asdict().items():
        if isinstance(value, tuple):
            out[name] = type(value)(
                **{sub: fn(f"{name}.{sub}", t) for sub, t in value._asdict().items()}
            )
        else:
            out[name] = fn(name, value)
    return DexState(**out)


def _rank_rows(kind: str, t: torch.Tensor, cfg: DexMeshConfig, mesh) -> torch.Tensor:
    """The rows of a whole-mesh plane of split ``kind`` (:func:`_plane_kinds`)
    that rank ``mesh.rank`` holds, as a view: its block's rows of a ``"dev"``
    plane, its columns' rows of a ``"mem"`` plane, a ``"rep"`` plane whole."""
    if kind == "dev":
        d0, dl = mesh.block(cfg)
        if t.stride(0) == 0:  # one table broadcast over Dev stays one table
            return t[0][None].expand((dl,) + t.shape[1:])
        return t[d0 : d0 + dl]
    if kind == "mem":
        c0, n_cols = _mesh.local_columns(cfg, mesh)
        per = t.shape[0] // cfg.n_memory
        return t[c0 * per : (c0 + n_cols) * per]
    return t


def shard_state(state: DexState, cfg: DexMeshConfig, mesh) -> DexState:
    """The share of the whole-mesh ``state`` that rank ``mesh.rank`` of the
    ``core/mesh.py::RankMesh`` ``mesh`` holds, split by
    :func:`state_shardings`' specs: the per-device planes' rows of its
    block, the pool's, ``occupancy``'s and ``n_alloc``'s rows of its own
    memory columns, the replicated planes whole.  The planes are views of
    ``state``'s (clone them for a share that owns its memory)."""
    kinds = _plane_kinds(cfg)
    return _map_planes(state, lambda k, t: _rank_rows(kinds[k], t, cfg, mesh))


def shard_pool(pool: SubtreePool, cfg: DexMeshConfig, mesh) -> SubtreePool:
    """The rank's share of a whole pool, as :func:`shard_state` splits the
    pool (views): the top tree whole, the ``pool_*`` rows of its columns.
    ``init_state(..., mesh=mesh)`` takes it, once cloned where the whole
    pool is shared with other ranks (the engine writes the pool in place)."""
    kinds = _plane_kinds(cfg)
    return SubtreePool(
        **{f: _rank_rows(kinds[f"pool.{f}"], t, cfg, mesh) for f, t in pool._asdict().items()}
    )


def gather_state(state: DexState, cfg: DexMeshConfig, mesh):
    """The whole-mesh layout of a state split over the ranks of ``mesh``
    (the inverse of :func:`shard_state`), rebuilt on the CPU of rank 0;
    None on every other rank.  Every rank must call it.  Rank 0 checks
    that every route replica of each column's shard, and every rank's copy
    of each replicated plane, are equal bit for bit, and raises
    ``AssertionError`` naming the plane where they are not."""
    import torch.distributed as dist

    kinds = _plane_kinds(cfg)
    nm, p_all = cfg.n_memory, mesh.world
    cols = [_mesh.local_columns(cfg, _mesh.RankMesh(None, p_all, q, mesh.backend))
            for q in range(p_all)]

    def gather(key, t):
        wire = _mesh._to_wire(mesh, t.contiguous())
        parts = (
            [torch.empty_like(wire) for _ in range(p_all)] if mesh.rank == 0 else None
        )
        dist.gather(wire, parts, dst=0, group=mesh.group)
        if mesh.rank != 0:
            return None
        parts = [_mesh._from_wire(x, t).cpu() for x in parts]
        k = kinds[key]
        if k == "dev":
            return torch.cat(parts)
        if k == "rep":
            for q, x in enumerate(parts[1:], 1):
                if not torch.equal(x, parts[0]):
                    raise AssertionError(f"{key}: rank {q}'s copy differs from rank 0's")
            return parts[0]
        per = parts[0].shape[0] // cols[0][1]
        whole = torch.empty((per * nm,) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype)
        have = [None] * nm
        for q, x in enumerate(parts):
            c0, n_cols = cols[q]
            for j in range(n_cols):
                rows = x[j * per : (j + 1) * per]
                if have[c0 + j] is None:
                    whole[(c0 + j) * per : (c0 + j + 1) * per] = rows
                    have[c0 + j] = q
                elif not torch.equal(rows, whole[(c0 + j) * per : (c0 + j + 1) * per]):
                    raise AssertionError(
                        f"{key}: column {c0 + j}'s replica on rank {q} differs "
                        f"from rank {have[c0 + j]}'s"
                    )
        return whole

    out = _map_planes(state, gather)
    return out if mesh.rank == 0 else None


def state_to_numpy(state: DexState) -> Dict[str, np.ndarray]:
    """Flatten ``state`` to numpy arrays keyed by field path.  The arrays are
    copies: the engine updates cache planes in place, so a view of a CPU
    state would change under the caller's feet."""

    def copy(t):
        return t.detach().to("cpu", copy=True).numpy()

    out = {}
    for name, value in state._asdict().items():
        if isinstance(value, tuple):
            for sub, t in value._asdict().items():
                out[f"{name}.{sub}"] = copy(t)
        else:
            out[name] = copy(value)
    return out


def state_from_numpy(
    arrays: Dict[str, np.ndarray], meta: PoolMeta, cfg: DexMeshConfig, device=None
) -> DexState:
    """Build a state from numpy arrays keyed by field path (the reference's
    ``DexState`` flattened, or :func:`state_to_numpy`'s output), checking
    the planes' shapes against ``meta`` and ``cfg``."""
    device = resolve_device(device)

    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(device)

    state = DexState(
        pool=SubtreePool(*(t(f"pool.{f}") for f in SubtreePool._fields)),
        cache=DexCache(*(t(f"cache.{f}") for f in DexCache._fields)),
        **{
            f: t(f)
            for f in DexState._fields
            if f not in ("pool", "cache")
        },
    )
    d, levels = cfg.n_devices, meta.levels_in_subtree
    want = {
        "pool": (meta.n_subtrees_padded, meta.subtree_cap, FANOUT),
        "tags": (d, cfg.cache_sets, cfg.cache_ways),
        "miss_ema": (d, cfg.n_memory, levels),
        "versions": (d, meta.n_nodes),
    }
    got = {
        "pool": tuple(state.pool.pool_keys.shape),
        "tags": tuple(state.cache.tags.shape),
        "miss_ema": tuple(state.miss_ema.shape),
        "versions": tuple(state.versions.shape),
    }
    if got != want:
        raise ValueError(f"state planes {got} do not fit meta/cfg {want}")
    return state


def make_dex_lookup(meta: PoolMeta, cfg: DexMeshConfig, *, device=None):
    """Build the lookup: ``(state, keys) -> (state, found, values, shed)``.

    A thin wrapper over the engine (``core/engine.py``) with
    ``ops=("lookup",)``.  ``keys`` [B] lanes are split evenly over the
    devices; results come back in the caller's lane order.  ``shed`` marks
    lanes a routing bucket dropped: retry them."""
    from repro_torch.core import engine as engine_mod  # engine imports us

    eng = engine_mod.make_dex_engine(meta, cfg, ops=("lookup",), device=device)

    def lookup(state: DexState, keys):
        keys = torch.as_tensor(keys, dtype=torch.int64)
        opcodes = torch.full(keys.shape, engine_mod.OP_LOOKUP, dtype=torch.int32)
        new_state, r = eng(state, opcodes, keys, torch.zeros_like(keys))
        return new_state, r.found, r.values, r.shed

    return lookup
