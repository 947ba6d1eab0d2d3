"""The mesh plane's execution engine: point lookups, updates, inserts and
range scans, batch by batch or pipelined.

:func:`make_dex_engine` runs a batch of mixed lookups, updates, inserts and
scans over the virtual mesh (``core/mesh.py``) the way the reference's
unified engine does, batched over the ``Dev`` axis.  A batch runs in two
halves.  The **front half**:

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
     then the ``leaf_scan`` kernel compacts each lane's window of leaf rows.

The **back half**:

  4. one request/response exchange over the memory axis: offloaded lanes
     are walked by the owning column with the ``subtree_walk`` kernel, and
     every write is applied there in one conflict-resolved batch
     (``write._apply_leaf_writes``, the ``leaf_write`` kernel);
  5. version bumps and the write-through refresh (updates) or drop
     (inserts) of the writer's own cached row; the stat, latency-histogram
     and return trip over the route axis.

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

**Cache policies** (``core/fleet_cache.py``).  A divergent policy biases
each device's leaf admission toward its own memory column, and a policy
with a peek budget lets a lookup whose leaf misses on a subtree of another
column skip the row fetch: the lane rides the fused round as a ``MSG_PEEK``
record, and the device of the owning column that receives it answers from
its own cache, version-checked, or else by its block walk.  Peeks add no
collective.

**The pipeline** (``pipeline=True``) returns an :class:`EnginePipeline`:
step ``s`` runs batch ``s``'s front half, then batch ``s - 1``'s back half,
under the collective-count labels ``pipe/front`` and ``pipe/back``.
Navigation is static within a run (splits shed ``STATUS_SPLIT`` and settle
between flushes), so a front half lands on the right leaf; only the leaf's
contents can be one batch stale.  The front half stamps the version of the
leaf (and of each scan hop) it read; the back half re-reads the version
table, and a lookup or update whose leaf moved is forced onto the two-sided
tags (``MSG_OFF_LOOKUP`` / ``MSG_OFF_UPDATE``) to re-resolve against the
current pool, while a scan whose window crossed a written leaf is
stall-shed (``taken = -1``, ``shed``).  Both are ``STAT_PIPE_STALLS``.
Batches apply in order, so results, pool, occupancy and versions equal the
synchronous engine's, stall-shed scans apart.  On one card the two halves
run one after the other on one stream.

The engine writes its state in place: the cache planes, and with writes the
pool's key and value planes, ``occupancy`` and ``versions``.  The returned
state shares these tensors with the one it was given, which saves a copy of
the pool per batch; a caller that needs the pre-batch state keeps a copy.
One or two route axes (``cfg.route_axes``, their sizes ``cfg.route_sizes``)
run the same program: a route exchange over two axes counts the reference's
two ``all_to_all`` (``routing.route_exchange``).

On the rank backend (``core/mesh.py``) the engine, synchronous or
pipelined, runs the same program on a rank's block of devices and its share
of the state (``dex.shard_state``): it takes the rank's own lanes (a
pipeline's pushes and its drain too), indexes the pool rows of its own
columns, and each rank applies its columns' gathered writes to its copy of
their shard.  A cache policy is read at the rank's rows of its planes; a
``MSG_PEEK`` lane crosses ranks inside the fused round's exchange and is
answered by the receiving device from its own cache and versions.  The
pipeline's stale check reads the versions of the rank's devices, which
every write round joins over the ranks (``mesh.pmax``), and counts its
collectives by phase as the virtual mesh does.  One or two route axes run
there alike.  The leaf-direct route table raises ``NotImplementedError``
there.
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
    STAT_PEER_HITS,
    STAT_PEER_MISSES,
    STAT_PIPE_STALLS,
    STAT_RT_MISPREDICTS,
    STAT_RT_SKIPS,
    STAT_SPLITS,
    STAT_WRITES,
)

#: a profiler range with the reference's ``jax.named_scope`` label: metadata
#: only, it changes no state, result or count
_scope = torch.profiler.record_function

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
MSG_PEEK = 6  # peer peek: the owner answers from its cache, else walks
REQ_FIELDS = 6  # (tag, gid, subtree, key, value, prio)
# (status, value, gid, leaf-took-inserts flag, which is the peer-cache-hit
# bit of a MSG_PEEK lane) ahead of the value row (and, with updates, the
# keys row)
RESP_HEAD = 4


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
    miss_cl: torch.Tensor  # [Dev, n_memory, levels] misses per column/level
    want_cl: torch.Tensor  # [Dev, n_memory, levels] lanes per column/level
    realized: torch.Tensor  # [Dev, n_memory, levels] distinct fetched bytes
    n_hit: torch.Tensor  # [Dev]
    n_fetch: torch.Tensor  # [Dev] coalesced remote reads
    peeked: Optional[torch.Tensor] = None  # leaf misses sent as MSG_PEEK
    rows_k: Optional[torch.Tensor] = None  # [Dev, Q, F] leaf rows (scans)
    rows_v: Optional[torch.Tensor] = None


class Fused(NamedTuple):
    """The fused round's answers, per lane ``[Dev, Q]``."""

    send: torch.Tensor  # the lane sent a request
    dropped: torch.Tensor  # a request bucket dropped it
    status: torch.Tensor  # int32 STATUS_* from the owner
    value: torch.Tensor  # two-sided lookups' value
    ins: torch.Tensor  # the leaf took a fresh insert; for a peek: a peer hit
    peek: torch.Tensor  # the lane was sent as MSG_PEEK
    gid: Optional[torch.Tensor] = None  # the leaf the owner wrote (or KEY_MAX)
    row_v: Optional[torch.Tensor] = None  # [Dev, Q, F] post-batch value row
    row_k: Optional[torch.Tensor] = None  # [Dev, Q, F] post-batch keys row (updates)


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


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak constant."""
    return float(np.float32(x))


class EnginePipeline:
    """Two-stage software pipeline over a batch queue (prologue, steady
    state, drain).

    ``push(opcodes, keys, values)`` runs one step: the new batch's front
    half, then the previous batch's back half, and returns the **previous**
    batch's :class:`EngineResult` (``None`` on the priming push).
    ``drain()`` pushes an inactive batch, built on the engine's ``device``,
    to flush the last back half and returns its result.  Every pushed batch
    of a run has one width (on ranks: the rank's own lanes).
    ``step_fn(state, carry, opcodes, keys, values) -> (state, carry,
    result)`` and ``init_carry(b)`` (the all-inactive prologue carry) are
    exposed so a caller can count the collectives of one step by phase;
    ``plan`` is the synchronous engine's plus ``stages`` and
    ``overlap_phases``.  The state is written in place as by the
    synchronous engine; results are fresh tensors that later pushes leave
    alone."""

    def __init__(self, step, init_carry, plan, device):
        self.step_fn = step
        self.init_carry = init_carry
        self.plan = plan
        self.device = device
        self._state = None
        self._carry = None
        self._width = None
        self._primed = False

    @property
    def state(self):
        """The index state as of the last completed back half."""
        return self._state

    def start(self, state: DexState) -> "EnginePipeline":
        """Begin a run from ``state``; drops any carry in flight."""
        self._state = state
        self._carry = None
        self._primed = False
        return self

    def push(self, opcodes, keys, values) -> Optional[EngineResult]:
        if self._state is None:
            raise RuntimeError("EnginePipeline.push before start(state)")
        b = int(torch.as_tensor(keys).shape[0])
        if b == 0:
            raise ValueError("pipeline batches must be non-empty")
        if self._carry is None:
            self._width = b
            self._carry = self.init_carry(b)
        elif b != self._width:
            raise ValueError(
                f"pipeline batches must share one width: {b} != {self._width}"
            )
        was_primed = self._primed
        self._state, self._carry, result = self.step_fn(
            self._state, self._carry, opcodes, keys, values
        )
        self._primed = True
        # the first step's result answers the all-inactive prologue carry
        return result if was_primed else None

    def drain(self) -> Optional[EngineResult]:
        """Flush the batch in flight; the next push primes again."""
        if self._state is None or not self._primed:
            return None
        b, dev = self._width, self.device
        self._state, _, result = self.step_fn(
            self._state,
            self._carry,
            torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.full((b,), KEY_MAX, dtype=torch.int64, device=dev),
            torch.zeros((b,), dtype=torch.int64, device=dev),
        )
        self._carry = None
        self._primed = False
        return result

    def run(self, state: DexState, batches):
        """Stream ``batches`` (an iterable of ``(opcodes, keys, values)``)
        through a whole prologue, steady state and drain; returns ``(state,
        [EngineResult of each batch, in order])``."""
        self.start(state)
        results = []
        for opc, kk, vv in batches:
            r = self.push(opc, kk, vv)
            if r is not None:
                results.append(r)
        r = self.drain()
        if r is not None:
            results.append(r)
        return self._state, results


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
    EngineResult)`` on ``device`` (None = CUDA), or with ``pipeline=True``
    an :class:`EnginePipeline` over the same two halves.

    ``ops`` is any non-empty subset of ``ALL_OPS``.
    ``opcodes``/``keys``/``values`` are [B] lanes, split evenly over the
    devices this process holds (lanes ``dev*b .. (dev+1)*b`` start on its
    ``dev``-th device: on ranks, a rank passes its block's slice of the
    batch and gets its results back);
    ``keys == KEY_MAX`` lanes and opcodes outside ``ops`` are inactive.
    Update and insert lanes carry their new value in ``values``, scan lanes
    their record count (clipped to ``max_count``); lookups ignore it.
    ``ops`` prunes statically: an engine without writes or scans routes keys
    alone and carries no write round, one without scans no hops.
    ``cache_policy`` is a ``fleet_cache`` policy (None: uniform).  The
    returned object carries the reference's ``plan`` attribute.  The state
    is updated in place (see the module's docstring)."""
    ops = tuple(ops)
    for o in ops:
        if o not in ALL_OPS:
            raise ValueError(f"unknown op {o!r}; options: {ALL_OPS}")
    if not ops:
        raise ValueError("ops must name at least one operation")
    if cfg.policy not in ("fetch", "offload", "auto"):
        raise ValueError(f"unknown policy {cfg.policy!r}")
    device = mesh.resolve_device(device)
    rank_mesh = mesh.current()
    if cfg.route_table_slots > 0:
        mesh.refuse_on_ranks("the leaf-direct route table", 3)

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
    # the pipeline forces stale lookups and updates onto the two-sided tags,
    # so those branches exist under ``fetch`` too where forcing can occur
    needs_force = bool(pipeline) and has_writes and (has_lookup or has_update)
    may_offload = has_offloadable and (cfg.policy != "fetch" or needs_force)
    # scans need the descent to their start leaf under every policy
    do_descent = has_scan or cfg.policy != "offload" or not has_offloadable
    # the leaf level serves lookups, updates and a scan's first hop; inserts
    # stop above it
    do_leaf = has_lookup or has_update or has_scan
    # peer peeks exist only for descending lookups under a peek budget
    may_peek = (
        has_lookup and do_descent and do_leaf and fleet_cache.peeks_enabled(cache_policy)
    )
    do_fused = has_writes or may_offload or may_peek
    audit = has_offloadable and cfg.policy == "auto"
    # the leaf-direct route table; with no slots the program is the
    # descent-only one
    use_rt = cfg.route_table_slots > 0 and do_descent
    # the devices this process holds (all of them on the virtual mesh) and
    # the first of its pool columns
    nr, nm, n_dev = cfg.n_route, cfg.n_memory, mesh.local_devices(cfg)
    col0, n_cols = mesh.local_columns(cfg)
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
    r_lin = mesh.route_linear_index(cfg, device)
    first = (dev_index == 0).long()
    my_col = mesh.memory_linear_index(cfg, device)[:, None]
    peek_budget = (
        fleet_cache.device_peek_budget(cache_policy, cfg, device) if may_peek else None
    )
    plan = {
        "route_rounds": 1,
        "fused_pairs": 1 if do_fused else 0,
        "descent_levels": (levels if do_leaf else levels - 1) if do_descent else 0,
        "scan_hops": hops,
        "pipeline": bool(pipeline),
    }

    def offload_decision(ema, col, live):
        """Each destination column's group of live lanes offloads when its
        predicted fetch bytes beat the RPC bytes; counts are mesh-global.
        Returns ``(want_off_c, grp_live, caps)``."""
        none = torch.zeros((n_dev, nm), dtype=torch.bool, device=device)
        if not has_offloadable or cfg.policy == "fetch":
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
        state, q, opc, subtree, col, want, leaf_want, cost, is_scan, boost,
        acc=None, p_loc=None,
    ) -> Descent:
        """The version-checked cached descent: one ``cached_fetch_level`` per
        level for the ``want`` lanes (``leaf_want`` at the leaf),
        ``node_search`` for the child at inner levels and for the match at
        the leaf.  Without a leaf level it stops at the leaf's id.  Scan
        lanes leave the miss observation and the audit's realized bytes
        alone; an engine with scans keeps the leaf rows for their window.
        Lanes of ``acc`` (route-table guesses accepted) skip the inner
        levels and land on their predicted leaf ``p_loc``.  Under a peek
        budget, a lookup's leaf miss on another column's subtree may be
        peeked instead of fetched."""
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
        peeked = leaf_k = leaf_v = None
        inner_want = want if acc is None else want & ~acc
        for lvl in range(levels if do_leaf else levels - 1):
            leaf = lvl == levels - 1
            if leaf and acc is not None:
                local = torch.where(acc, p_loc, local)
            gid = meta.node_gid(subtree, local)
            peek_elig = None
            if leaf:
                want = leaf_want
                salt = state.stats[:, STAT_OPS, None] + torch.arange(
                    nq, device=device
                )
                p_ok = fleet_cache.leaf_admit(
                    meta, cfg, cache_policy, gid, salt, boost=boost
                )
                if may_peek:
                    peek_elig = want & (col != my_col)
                    if opc is not None:
                        peek_elig = peek_elig & (opc == OP_LOOKUP)
            else:
                want = inner_want
                p_ok = torch.ones_like(want)
            with _scope(f"dex/descent/l{lvl}"):
                rows_k, rows_c, rows_v, hit, miss, f_drop, n_msgs, cache, pk = (
                    cached_fetch_level(
                        state.pool, meta, cfg, cache, state.versions, gid, want, p_ok,
                        peek_elig, peek_budget,
                    )
                )
            # a peeked lane fetched nothing here: its two-sided trip is
            # priced in the back half
            fetched = miss & ~f_drop
            if pk is not None:
                peeked = pk
                fetched = fetched & ~pk
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
            miss_cl=miss_cl,
            want_cl=want_cl,
            realized=realized,
            n_hit=n_hit,
            n_fetch=n_fetch,
            peeked=peeked,
            rows_k=leaf_k,
            rows_v=leaf_v,
        )

    def scan_window(state, q, cnt, is_scan, d: Descent, boost, stamp):
        """The scan lanes' successor-chain hops: the start leaf's row, then
        one ``cached_fetch_level`` per hop over ``DexState.succ`` for the
        lanes whose collected records fall short of their count, then the
        ``leaf_scan`` kernel over each lane's window.  Reads the pre-batch
        pool and runs before any write.  Returns the descent with its shed,
        cost and counters carried forward, ``(keys, values, taken)`` and,
        with ``stamp``, each hop's leaf (-1 where the lane did not hop) and
        the version it read, ``[Dev, Q, hops - 1]``."""
        nq = q.shape[1]
        succ = state.succ[0]
        vers = state.versions
        qc = q[..., None]
        win_k = [torch.where(is_scan[..., None], d.rows_k, KEY_MAX)]
        win_v = [torch.where(is_scan[..., None], d.rows_v, 0)]
        collected = ((win_k[0] != KEY_MAX) & (win_k[0] >= qc)).sum(-1)
        in_range = is_scan
        gid_h = d.gid
        shed, cost, fmiss, cache = d.shed, d.cost, d.fmiss, state.cache
        n_hit, n_fetch = d.n_hit, d.n_fetch
        hop_gids, hop_vers = [], []
        for h in range(1, hops):
            nxt = succ[torch.where(in_range, gid_h, 0)]
            in_range = in_range & (collected < cnt) & (nxt >= 0)
            gid_h = torch.where(in_range, nxt, gid_h)
            gid = torch.where(in_range, gid_h, 0)
            if stamp:
                hop_gids.append(torch.where(in_range, gid_h, -1))
                hop_vers.append(torch.where(in_range, vers.gather(1, gid), 0))
            salt = state.stats[:, STAT_OPS, None] + h + torch.arange(
                nq, device=device
            )
            p_ok = fleet_cache.leaf_admit(meta, cfg, cache_policy, gid, salt, boost=boost)
            with _scope(f"dex/scan/h{h}"):
                rows_k, _, rows_v, hit, miss, f_drop, n_msgs, cache, _ = (
                    cached_fetch_level(
                        state.pool, meta, cfg, cache, vers, gid, in_range, p_ok
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
            n_hit=n_hit,
            n_fetch=n_fetch,
            rows_k=None,
            rows_v=None,
        )
        stamps = None
        if stamp:
            if hop_gids:
                stamps = (torch.stack(hop_gids, -1), torch.stack(hop_vers, -1))
            else:
                stamps = (
                    torch.full((n_dev, nq, 0), -1, dtype=torch.int64, device=device),
                    torch.zeros((n_dev, nq, 0), dtype=vers.dtype, device=device),
                )
        return d, (sc_k, sc_v, taken), stamps

    def no_descent(q, subtree, cost) -> Descent:
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
            miss_cl=zero_cl,
            want_cl=zero_cl,
            realized=zero_cl,
            n_hit=zero_dev,
            n_fetch=zero_dev,
        )

    def run_front(state, keys, opc_in, values, *, stamp):
        """The front half of a batch (``keys`` [Dev, b], masked): the route
        round, the top walk and offload decision, the route-table probe,
        the cached descent and the scan window.  Updates the cache in place
        and returns ``(carry, new_ema, demand, stats update, audit
        update)``; the carry holds what the back half needs, with
        ``stamp`` the versions the descent read."""
        b = keys.shape[1]
        # 1. route round: every lane to the route row owning its key
        owner, demand = routing.route_owners(state.boundaries, keys, nr)
        cap = routing.route_capacity(b, nr, cfg.route_capacity_factor)
        if route_planes:
            lane_prio = dev_index[:, None] * b + torch.arange(b, device=device)
            # phase-offset priority: all updates replay before all inserts
            phase = torch.where(opc_in == OP_INSERT, cfg.n_devices * b, 0)
            payload = torch.stack([keys, values, opc_in, lane_prio + phase], -1)
        else:
            payload = keys
        buf, lane, dropped_r = routing.pack_by_dest(payload, owner, nr, cap)
        dropped_r = dropped_r & (keys != KEY_MAX)
        with _scope("dex/route"):
            routed = routing.route_exchange(buf, cfg).reshape(
                (n_dev, nr * cap) + tuple(payload.shape[2:])
            )
        carry = {"lane": lane, "dropr": dropped_r}
        if route_planes:
            q = routed[..., 0].contiguous()
            val, pr = routed[..., 1], routed[..., 3]
            opc = routed[..., 2].to(torch.int32)
            carry.update(val=val, opc=opc, pr=pr)
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

        # 3. cached descent of the lanes that stay one-sided; a divergent
        # policy scales its dice by each device's own route demand
        boost = fleet_cache.demand_boost(cache_policy, cfg, state.route_demand, r_lin)
        if do_descent:
            leaf_want = fetchable if opc is None else fetchable & (opc != OP_INSERT)
            d = descent(
                state, q, opc, subtree, col, fetchable, leaf_want, cost, is_scan,
                boost, acc, p_loc,
            )
        else:
            d = no_descent(q, subtree, cost)
        if has_scan:
            # the scan window, read before any write touches the pool
            cnt = torch.clamp(torch.where(is_scan, val, 0), 0, mc).to(torch.int32)
            d, (sc_k, sc_v, taken), stamps = scan_window(
                state, q, cnt, is_scan, d, boost, stamp
            )
            carry.update(sck=sc_k, scv=sc_v, taken=taken)
            if stamp:
                carry.update(hgid=stamps[0], hver=stamps[1])
        cost = d.cost
        if has_lookup:
            # the compute-side leaf search of one-sided lookups
            searched = fetchable if opc is None else fetchable & (opc == OP_LOOKUP)
            cost = cost + searched.float() * obs_latency.T_LOCAL
        if has_scan:
            # and of a scan's first (descent) hop
            cost = cost + is_scan.float() * obs_latency.T_LOCAL

        # the EMA over mesh-global counts, the front half's stats and the
        # cost-model audit
        g_want = mesh.psum(d.want_cl)
        rates = mesh.psum(d.miss_cl) / torch.clamp(g_want, min=1.0)
        new_ema = torch.where(
            g_want > 0, fma32(cfg.ema_decay, ema, (1 - cfg.ema_decay) * rates), ema
        )
        upd = torch.zeros((n_dev, N_STATS), dtype=torch.int64, device=device)
        upd[:, STAT_OPS] = live.sum(1)
        upd[:, STAT_HITS] = d.n_hit
        upd[:, STAT_FETCHES] = d.n_fetch
        upd[:, STAT_DROPS] = dropped_r.sum(1)
        # group decisions are mesh-global: count them once, on device 0
        upd[:, STAT_OFFLOAD_GROUPS] = first * (want_off_c & grp_live).sum(1)
        upd[:, STAT_FETCH_GROUPS] = first * (~want_off_c & grp_live).sum(1)
        if use_rt:
            # an accepted lane skips every inner level of its subtree
            upd[:, STAT_RT_SKIPS] = acc.sum(1) * (levels - 1)
            upd[:, STAT_RT_MISPREDICTS] = (guess & ~acc).sum(1)
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

        carry.update(
            q=q, subtree=subtree, offl=offl, gid=d.gid, found=d.found,
            vleaf=d.value, shed=d.shed, cost=cost, fmiss=d.fmiss,
        )
        if may_peek:
            carry["peek"] = d.peeked
        if stamp:
            gsafe = d.gid.clamp(0, n_nodes - 1)
            carry["vseen"] = torch.where(live, state.versions.gather(1, gsafe), 0)
        return carry, new_ema, demand, upd, audit_upd

    def lookup_round(state, q, subtree, gid, tag) -> Fused:
        """The fused exchange of an engine without writes: each two-sided
        lane (``tag`` ``MSG_OFF_LOOKUP`` or ``MSG_PEEK``) goes to its leaf's
        memory column; a peek is answered from the receiving device's cache
        where its row is fresh, and every other request by the owner's
        block walk (``subtree_walk``)."""
        nq = q.shape[1]
        send = tag != MSG_NONE
        dest = torch.where(send, subtree // s_per, nm)
        wcap = routing.route_capacity(nq, nm, cfg.route_capacity_factor)
        fields = [subtree, q]
        if may_peek:
            fields += [tag, torch.where(tag == MSG_PEEK, gid, KEY_MAX)]
        wbuf, wlane, dropped = routing.pack_by_dest(
            torch.stack(fields, -1), dest, nm, wcap
        )
        with _scope("dex/fused_a2a/request"):
            req = mesh.a2a(wbuf, cfg, cfg.memory_axis).reshape(n_dev, -1, len(fields))
        stf, kf = req[..., 0], req[..., 1]
        walk = kf != KEY_MAX
        if may_peek:
            peer_hit, p_found, p_val = fleet_cache.peer_answer(
                state.cache, cfg, state.versions, req[..., 3], kf,
                req[..., 2] == MSG_PEEK,
            )
            walk = walk & ~peer_hit
        # a request on column m names a subtree of m's shard, whose rows
        # this process holds from its first column on
        st = (my_col - col0) * s_per + torch.where(walk, stf % s_per, 0)
        o_found, o_val, _ = kops.subtree_walk(
            state.pool.pool_keys,
            state.pool.pool_children,
            state.pool.pool_values,
            st.reshape(-1).to(torch.int32),
            kf.reshape(-1).contiguous(),
            levels=levels,
            active=walk.reshape(-1),
        )
        o_found = o_found.view(walk.shape) & walk
        o_val = torch.where(walk, o_val.view(walk.shape), 0)
        resp = [o_found, o_val]
        if may_peek:
            resp = [
                torch.where(peer_hit, p_found, o_found),
                torch.where(peer_hit, p_val, o_val),
                peer_hit,
            ]
        width = len(resp)
        resp = torch.stack([t.long() for t in resp], -1).view(n_dev, nm, wcap, width)
        with _scope("dex/fused_a2a/response"):
            resp = mesh.a2a(resp, cfg, cfg.memory_axis)
        back = routing.unpack_to_lanes(resp, wlane, nq, 0)
        return Fused(
            send=send,
            dropped=dropped & send,
            status=torch.where(back[..., 0] != 0, STATUS_OK, STATUS_MISS).to(
                torch.int32
            ),
            value=back[..., 1],
            ins=back[..., 2] != 0 if may_peek else torch.zeros_like(send),
            peek=tag == MSG_PEEK,
        )

    def write_round(state, q, val, pr, subtree, col, gid, tag) -> Fused:
        """The fused tagged request/response exchange of an engine with
        writes.  Each lane's request goes to its leaf's memory column; the
        columns' batches are gathered over the route replicas and applied
        to the pool once per copy (the virtual mesh's one pool; each rank's
        copy of its own columns): two-sided lanes first walk the pre-batch
        pool (``subtree_walk``; a peek answered from the receiving device's
        cache does not walk), then every write applies (``leaf_write``),
        and each device takes its own route row of the response."""
        pool = state.pool
        nq = q.shape[1]
        send = tag != MSG_NONE
        dest = torch.where(send, col, nm)
        wcap = routing.route_capacity(nq, nm, cfg.route_capacity_factor)
        with_gid = (tag == MSG_UPDATE) | (tag == MSG_INSERT) | (tag == MSG_PEEK)
        payload = torch.stack(
            [tag, torch.where(with_gid, gid, KEY_MAX), subtree, q, val, pr], -1
        )
        wbuf, wlane, dropped = routing.pack_by_dest(payload, dest, nm, wcap)
        dropped = dropped & send
        with _scope("dex/fused_a2a/request"):
            req = mesh.a2a(wbuf, cfg, cfg.memory_axis)  # [Dev, nm, wcap, RF]
        # [n_cols, nr, nm, wcap, RF]: each held column's batch, gathered once
        flat = mesh.gather_route(req, cfg).reshape(-1, REQ_FIELDS)
        tagf, gidf, stf, kf, vf, prf = (c.contiguous() for c in flat.unbind(-1))
        wgid = torch.where((tagf == MSG_UPDATE) | (tagf == MSG_INSERT), gidf, KEY_MAX)
        resp_val = torch.zeros_like(kf)
        peekf = tagf == MSG_PEEK
        if may_peek:
            # each device probes its own cache for the peeks it received
            rq = req.reshape(n_dev, -1, REQ_FIELDS)
            ph, pf, pv = fleet_cache.peer_answer(
                state.cache, cfg, state.versions, rq[..., 1], rq[..., 3],
                rq[..., 0] == MSG_PEEK,
            )
            peer_hit, p_found, p_val = (
                mesh.gather_route(t, cfg).reshape(-1) for t in (ph, pf, pv)
            )
        if may_offload or may_peek:
            # the owner-side walk reads the pre-batch pool
            walk = peekf & ~peer_hit if may_peek else torch.zeros_like(peekf)
            if may_offload:
                walk = walk | ((tagf >= MSG_OFF_LOOKUP) & (tagf <= MSG_OFF_INSERT))
            # the held column of each gathered request: its shard's rows
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
            if may_offload:
                off_w = (tagf == MSG_OFF_UPDATE) | (tagf == MSG_OFF_INSERT)
                wgid = torch.where(off_w, meta.node_gid(stf, o_loc.long()), wgid)
            if may_peek:
                o_found = torch.where(peer_hit, p_found, o_found)
                o_val = torch.where(peer_hit, p_val, o_val)
            lk = peekf | (tagf == MSG_OFF_LOOKUP)
            resp_val = torch.where(lk, o_val, 0)
        allow_ins = (tagf == MSG_INSERT) | (tagf == MSG_OFF_INSERT)
        # the shard's node ids: a constant shift, which keeps their order
        gid0 = col0 * s_per * meta.subtree_cap
        with _scope("dex/apply"):
            _, _, _, wstat, rows_v, ins_in_leaf = _apply_leaf_writes(
                pool.pool_keys,
                pool.pool_values,
                state.occupancy,
                meta,
                torch.where(wgid != KEY_MAX, wgid - gid0, KEY_MAX) if gid0 else wgid,
                kf,
                vf,
                prf,
                allow_ins,
            )
        if may_offload or may_peek:
            wstat = torch.where(
                lk, torch.where(o_found, STATUS_OK, STATUS_MISS).to(wstat.dtype), wstat
            )
        if may_peek:
            # a peek's flag is its peer hit (peeks are lookups, which the
            # insert path's readers never see)
            ins_in_leaf = torch.where(peekf, peer_hit, ins_in_leaf)
        rows = [rows_v]
        if has_update:
            # the post-batch keys row, which the writer's cached keys must
            # equal for a refresh of its value row
            rows.append(pool.pool_keys.view(-1, FANOUT)[
                torch.where(wgid != KEY_MAX, wgid - gid0, 0)])
        resp = torch.cat(
            [
                wstat[:, None].long(),
                resp_val[:, None],
                wgid[:, None],
                ins_in_leaf[:, None].long(),
                *rows,
            ],
            -1,
        )
        del rows_v, rows
        width = resp.shape[-1]
        # each device answers its own route row
        resp = mesh.route_share(resp.view(n_cols, nr, nm, wcap, width), cfg)
        with _scope("dex/fused_a2a/response"):
            resp = mesh.a2a(resp, cfg, cfg.memory_axis)
        back = routing.unpack_to_lanes(resp, wlane, nq, 0)
        return Fused(
            send=send,
            dropped=dropped,
            status=back[..., 0].to(torch.int32),
            value=back[..., 1],
            ins=back[..., 3] != 0,
            peek=tag == MSG_PEEK,
            gid=back[..., 2],
            row_v=back[..., RESP_HEAD : RESP_HEAD + FANOUT],
            row_k=back[..., RESP_HEAD + FANOUT :] if has_update else None,
        )

    def write_through(state, opc, f: Fused, force_off):
        """Version bumps (mesh-wide maximum) and the writer's own cache:
        refresh an updated leaf's value row, drop an inserted leaf's row."""
        cache = state.cache
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
        # this process's bumps join the maximum over the mesh (on ranks each
        # holds only its own lanes' bumps)
        new_vers = mesh.pmax(torch.maximum(vers.amax(0, keepdim=True), bump[None, :n_nodes]))
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
            # stale under a current version; the old stamp forces a refetch.
            # Nor for a stale-forced update: the cached keys are a batch
            # behind the response's value row.  Nor where the cached keys
            # differ from the leaf's post-batch keys row: a row that went
            # stale under an earlier batch's insert (an offloaded update
            # skips the descent that would have refetched it) would serve
            # its old keys with the new values under a current stamp
            # (ROADMAP.md, queue 3, entry 22).
            same = (cache.keys.view(-1, FANOUT)[slot] == f.row_k).all(-1)
            u = (chit & same & (opc == OP_UPDATE) & ~f.ins & ~force_off).nonzero(
                as_tuple=True
            )
            cache.values.view(-1, FANOUT)[slot[u]] = f.row_v[u]
            cache.ver.view(-1)[slot[u]] = nv[u]
        if has_insert:
            i = (chit & (opc == OP_INSERT)).nonzero(as_tuple=True)
            cache.tags.view(-1)[slot[i]] = -1
        vers.copy_(new_vers)

    def run_back(state, carry, b, *, check_stale):
        """The back half of a batch from its carry: the pipeline's stale
        check, the fused round, the write-through, the back half's stats and
        latency histogram, and the return trip.  Writes the pool, occupancy,
        versions and cache in place; returns ``(stats update, histogram
        update, EngineResult)``."""
        q = carry["q"]
        opc = carry.get("opc")
        subtree, offl, lane = carry["subtree"], carry["offl"], carry["lane"]
        found, shed, cost = carry["found"], carry["shed"], carry["cost"]
        dropped_r = carry["dropr"]
        live = q != KEY_MAX
        is_scan = live & (opc == OP_SCAN) if has_scan else torch.zeros_like(live)
        col = subtree // s_per
        if has_scan:
            sc_k, sc_v, taken = carry["sck"], carry["scv"], carry["taken"]
        upd = torch.zeros((n_dev, N_STATS), dtype=torch.int64, device=device)

        # the overlap window's stale check (pipelined back half only)
        stalled = force_off = torch.zeros_like(live)
        if check_stale:
            vers = state.versions
            gsafe = carry["gid"].clamp(0, n_nodes - 1)
            stale = live & (vers.gather(1, gsafe) != carry["vseen"])
            if has_lookup or has_update:
                # lookups and updates whose leaf the overlapped batch wrote
                # re-run two-sided against the current pool; inserts
                # re-search their leaf anyway; offloaded lanes are current
                force_off = stale & ~offl & ~shed & ~is_scan
                if opc is not None:
                    force_off = force_off & ((opc == OP_LOOKUP) | (opc == OP_UPDATE))
            n_stalls = force_off.sum(1)
            if has_scan:
                # a scan whose window crossed a written leaf sheds to retry
                hg, hv = carry["hgid"], carry["hver"]
                hseen = vers.gather(1, hg.clamp(0, n_nodes - 1).view(n_dev, -1))
                hstale = ((hg >= 0) & (hseen.view(hg.shape) != hv)).any(-1)
                sc_stale = is_scan & ~shed & (stale | hstale)
                n_stalls = n_stalls + sc_stale.sum(1)
                sc_k = torch.where(sc_stale[..., None], KEY_MAX, sc_k)
                sc_v = torch.where(sc_stale[..., None], 0, sc_v)
                taken = torch.where(sc_stale, -1, taken).to(torch.int32)
                shed = shed | sc_stale
                stalled = sc_stale
            stalled = stalled | force_off
            upd[:, STAT_PIPE_STALLS] = n_stalls
            # a stale lane re-resolves two-sided at its leaf: one RPC and a
            # one-level memory-side walk
            with _scope("dex/lat/stale_forced"), mesh.phase("dex/lat"):
                cost = cost + stalled.float() * (obs_latency.T_RPC + obs_latency.T_MEM)
        offl_eff = offl | force_off

        # the fused round over the memory axis
        f = None
        if do_fused:
            ok_lane = live & ~shed
            is_lk = ok_lane if opc is None else ok_lane & (opc == OP_LOOKUP)
            tag = torch.zeros_like(q)
            if has_lookup and may_offload:
                tag = torch.where(is_lk & offl_eff, MSG_OFF_LOOKUP, tag)
            if may_peek:
                # a stale-forced lane keeps its MSG_OFF_LOOKUP
                tag = torch.where(is_lk & carry["peek"] & ~offl_eff, MSG_PEEK, tag)
            if has_update:
                is_up = ok_lane & (opc == OP_UPDATE)
                if may_offload:
                    tag = torch.where(is_up & offl_eff, MSG_OFF_UPDATE, tag)
                tag = torch.where(is_up & ~offl_eff & found, MSG_UPDATE, tag)
            if has_insert:
                is_in = ok_lane & (opc == OP_INSERT)
                if may_offload:
                    tag = torch.where(is_in & offl_eff, MSG_OFF_INSERT, tag)
                tag = torch.where(is_in & ~offl_eff, MSG_INSERT, tag)
            if has_writes:
                f = write_round(
                    state, q, carry["val"], carry["pr"], subtree, col, carry["gid"], tag
                )
                write_through(state, opc, f, force_off)
            else:
                f = lookup_round(state, q, subtree, carry["gid"], tag)
            send, dropped_w = f.send, f.dropped
        else:
            send = dropped_w = torch.zeros_like(live)
        delivered = send & ~dropped_w
        is_off = offl_eff & send
        sent_peek = f.peek if may_peek else torch.zeros_like(live)
        two_sided = offl_eff | sent_peek
        out_found = torch.where(
            two_sided,
            (f.status == STATUS_OK) & delivered if do_fused else two_sided,
            found & ~shed,
        )
        if opc is not None:
            out_found = out_found & (opc == OP_LOOKUP)
        out_found = out_found & live
        out_val = torch.where(
            out_found, torch.where(two_sided, f.value if do_fused else 0, carry["vleaf"]), 0
        )
        status = None
        if has_writes:
            is_w = live & ((opc == OP_UPDATE) | (opc == OP_INSERT))
            status = torch.where(
                is_w & delivered & ~shed,
                f.status,
                torch.where(
                    is_w & (shed | dropped_w), STATUS_SHED, STATUS_MISS
                ).to(torch.int32),
            )
        lane_shed = shed | (send & dropped_w)

        # stats, then each lane's two-sided trip priced (one RPC plus the
        # owner's per-level walk; a peek one RPC plus a cached access or a
        # one-level walk; a fetched-path write one write-through, which the
        # pipeline hides under the next batch), and binned into one (op
        # class, path, bucket) cell
        upd[:, STAT_OFFLOADS] = (delivered & is_off).sum(1)
        upd[:, STAT_DROPS] = (lane_shed & live).sum(1)
        if has_writes:
            upd[:, STAT_WRITES] = (delivered & ~is_off & (opc != OP_LOOKUP)).sum(1)
            upd[:, STAT_SPLITS] = (status == STATUS_SPLIT).sum(1)
        off_norm = delivered & is_off & ~stalled
        with _scope("dex/lat/offload"), mesh.phase("dex/lat"):
            cost = cost + off_norm.float() * (
                obs_latency.T_RPC + float(levels) * obs_latency.T_MEM
            )
        if may_peek:
            pk = delivered & sent_peek
            upd[:, STAT_PEER_HITS] = (pk & f.ins).sum(1)
            upd[:, STAT_PEER_MISSES] = (pk & ~f.ins).sum(1)
            with _scope("dex/lat/peer_peek"), mesh.phase("dex/lat"):
                # the reference adds the constants in float64, then rounds
                trip = torch.where(
                    f.ins,
                    _f32(obs_latency.T_RPC + obs_latency.T_CACHED),
                    _f32(obs_latency.T_RPC + obs_latency.T_MEM),
                ).float()
                cost = cost + pk.float() * trip
        if has_writes and not check_stale:
            with _scope("dex/lat/write_through"), mesh.phase("dex/lat"):
                wl = delivered & ~is_off & ((opc == OP_UPDATE) | (opc == OP_INSERT))
                cost = cost + wl.float() * obs_latency.T_WRITE
        with _scope("dex/lat/bin"), mesh.phase("dex/lat"):
            path = torch.where(carry["fmiss"], 1, 0)
            if may_peek:
                path = torch.where(delivered & sent_peek, 2, path)
            path = torch.where(off_norm, 3, path)
            path = torch.where(lane_shed, 5, path)
            if check_stale:
                path = torch.where(stalled, 4, path)
            cell = path * obs_latency.N_BUCKETS + obs_latency.bucket_index(cost)
            if opc is not None:
                cls = torch.clamp(opc, 0, obs_latency.N_CLASSES - 1).long()
                cell = cell + cls * (obs_latency.N_PATHS * obs_latency.N_BUCKETS)
            hist = torch.zeros_like(state.lat_hist).view(n_dev, -1)
            hist.scatter_add_(1, cell, live.long())

        # the return trip over the route axis
        fields = [out_found.long(), out_val]
        if has_writes:
            fields.append(status.long())
        fields.append(lane_shed.long())
        head = len(fields)
        fields = torch.stack(fields, -1)
        if has_scan:
            fields = torch.cat([fields, taken.long()[..., None], sc_k, sc_v], -1)
            del sc_k, sc_v
        width = fields.shape[-1]
        cap = lane.shape[2]
        with _scope("dex/route_back"):
            back = routing.route_exchange(
                fields.view(n_dev, nr, cap, width), cfg, reverse=True
            )
        del fields
        out = routing.unpack_to_lanes(back, lane, b, 0)
        if has_writes:
            res_status = torch.where(dropped_r, STATUS_SHED, out[..., 2].to(torch.int32))
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
        return upd, hist.view(state.lat_hist.shape), result

    def prepare(state, opcodes, keys, values):
        """Lanes to ``[Dev, b]`` on the engine's device; opcodes outside
        ``ops`` are no-ops, masked before routing."""
        keys = torch.as_tensor(keys).to(device=device, dtype=torch.int64)
        if keys.shape[0] % n_dev:
            raise ValueError(
                f"batch width {keys.shape[0]} must divide over {n_dev} devices"
            )
        if state.stats.device != device:
            raise ValueError(f"state lies on {state.stats.device}, engine on {device}")
        if state.stats.shape[0] != n_dev:
            raise ValueError(
                f"state holds {state.stats.shape[0]} devices; this process "
                f"holds {n_dev}"
            )
        if mesh.current() is not rank_mesh:
            raise RuntimeError("the engine runs on the mesh it was built on")
        b = keys.shape[0] // n_dev
        opcodes = torch.as_tensor(opcodes).to(device=device, dtype=torch.int32)
        allowed = opcodes == enabled[0]
        for code in enabled[1:]:
            allowed = allowed | (opcodes == code)
        keys = torch.where(allowed, keys, KEY_MAX).view(n_dev, b)
        opc_in = vals = None
        if route_planes:
            vals = torch.as_tensor(values).to(device=device, dtype=torch.int64)
            vals = vals.view(n_dev, b)
            opc_in = opcodes.view(n_dev, b).long()
        return keys, opc_in, vals

    def advance(state, new_ema, demand, f_upd, audit_upd, b_upd, hist):
        return state._replace(
            miss_ema=new_ema,
            stats=state.stats + f_upd + b_upd,
            route_demand=state.route_demand + demand,
            lat_hist=state.lat_hist + hist,
            lat_audit=state.lat_audit + audit_upd,
        )

    def engine(state: DexState, opcodes, keys, values):
        keys, opc_in, vals = prepare(state, opcodes, keys, values)
        b = keys.shape[1]
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
        carry, new_ema, demand, f_upd, audit_upd = run_front(
            state, keys, opc_in, vals, stamp=False
        )
        b_upd, hist, result = run_back(state, carry, b, check_stale=False)
        return advance(state, new_ema, demand, f_upd, audit_upd, b_upd, hist), result

    engine.plan = plan
    if not pipeline:
        return engine

    def init_carry(b_lanes: int):
        """The all-inactive prologue carry for a batch of ``b_lanes`` lanes
        of this process (on ranks: the rank's own, over its block of
        devices): every routed slot holds the KEY_MAX sentinel, so the
        first step's back half sends, writes and answers nothing."""
        if b_lanes % n_dev:
            raise ValueError(f"batch width {b_lanes} must divide over {n_dev} devices")
        b = b_lanes // n_dev
        cap = routing.route_capacity(b, nr, cfg.route_capacity_factor)
        qs = (n_dev, nr * cap)
        i64 = dict(dtype=torch.int64, device=device)
        none = torch.zeros(qs, dtype=torch.bool, device=device)
        carry = {
            "lane": torch.full((n_dev, nr, cap), b, dtype=torch.int32, device=device),
            "dropr": torch.zeros((n_dev, b), dtype=torch.bool, device=device),
            "q": torch.full(qs, KEY_MAX, **i64),
            "subtree": torch.zeros(qs, **i64),
            "offl": none,
            "gid": torch.zeros(qs, **i64),
            "found": none,
            "vleaf": torch.zeros(qs, **i64),
            "shed": none,
            "cost": torch.zeros(qs, dtype=torch.float32, device=device),
            "fmiss": none,
            "vseen": torch.zeros(qs, dtype=torch.int32, device=device),
        }
        if route_planes:
            carry.update(
                val=torch.zeros(qs, **i64),
                opc=torch.zeros(qs, dtype=torch.int32, device=device),
                pr=torch.zeros(qs, **i64),
            )
        if may_peek:
            carry["peek"] = none
        if has_scan:
            h = max(hops - 1, 0)
            carry.update(
                sck=torch.full(qs + (mc,), KEY_MAX, **i64),
                scv=torch.zeros(qs + (mc,), **i64),
                taken=torch.zeros(qs, dtype=torch.int32, device=device),
                hgid=torch.full(qs + (h,), -1, **i64),
                hver=torch.zeros(qs + (h,), dtype=torch.int32, device=device),
            )
        return carry

    def pipe_step(state: DexState, carry, opcodes, keys, values):
        """One pipeline step: the new batch's front half, then the carried
        batch's back half, which sees the cache as the front half left it
        and the versions as they were before this step."""
        keys, opc_in, vals = prepare(state, opcodes, keys, values)
        b = keys.shape[1]
        with _scope("pipe/front"), mesh.phase("pipe/front"):
            carry_out, new_ema, demand, f_upd, audit_upd = run_front(
                state, keys, opc_in, vals, stamp=True
            )
        with _scope("pipe/back"), mesh.phase("pipe/back"):
            b_upd, hist, result = run_back(state, carry, b, check_stale=True)
        # the histogram lags STAT_OPS by one batch (a lane bins when its
        # back half lands); the drain closes the gap
        new_state = advance(state, new_ema, demand, f_upd, audit_upd, b_upd, hist)
        return new_state, carry_out, result

    pplan = dict(
        plan,
        pipeline=True,
        stages=("front", "back"),
        overlap_phases=("pipe/front", "pipe/back"),
    )
    return EnginePipeline(pipe_step, init_carry, pplan, device)
