"""Event-level simulator of DEX and its competitors (Plane A).

Executes the paper's protocols *per operation* against a host-resident
B+-tree, counting every remote verb (RDMA READ / small READ / WRITE / CAS /
two-sided RPC) and every cache event, exactly as the paper's Table 2 reports
them.  Latency/contention conversion to throughput lives in
``core/cost_model.py``; this module is purely mechanistic.

Fidelity notes (mapped to the paper):
  * Algorithm 1 traversal with cache lookup / remote_read / offload decision.
  * Shared nodes (fence range crossing a partition boundary) pay RDMA-based
    optimistic synchronization: version read + node read + version re-read
    (§4, lines 3–6); non-shared nodes are one READ (line 8).
  * Offloading only for non-shared subtrees rooted at level <= M, gated by
    the cost model `l_p < (L+1)(l_o+l_s)c` with moving averages and an
    ε-exploration of the contrary action (§6.1).
  * Offloaded writes that would split fall back to the normal path (§6).
  * Eager splits on the way down; splits of shared parents take the global
    lock, re-validate freshness, else refresh-from-root (§7 Insert).
  * Updates to cached non-shared leaves only dirty the cache; write-back
    happens at cooling/eviction (§4) — this is why DEX's WI write count is
    ~0.19 instead of ~1.

The simulator is single-threaded; thread-level contention (FIFO-queue locks,
memory-side CPU saturation) is modeled analytically downstream from the
counters collected here (DESIGN.md §2.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import btree as btree_mod
from repro_torch.core.cache import ComputeCache, DEFAULT_P_ADMIT_LEAF
from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN, NULL
from repro_torch.core.partition import LogicalPartitions
from repro_torch.obs import latency as obs_latency

NODE_BYTES = 1024          # paper: 1KB nodes
SMALL_READ_BYTES = 8       # version word
RPC_BYTES = 64             # offload request/response payload

# constants of the mesh engine's per-group byte-cost model, mirrored here so
# ``SimConfig.group_offload`` prices the identical decision rule
# (core/engine.py; keep in sync with core/dex.py NODE_ROW_BYTES /
# OFFLOAD_REQ_BYTES / OFFLOAD_RESP_BYTES)
ENGINE_NODE_ROW_BYTES = FANOUT * 8 * 3
ENGINE_RPC_BYTES = 16 + 16


# ---------------------------------------------------------------------------
# Host B+-tree with true eager-split SMOs
# ---------------------------------------------------------------------------


class HostBTree:
    """Mutable numpy B+-tree used as 'the memory pool'.

    Same layout/semantics as core/btree.py plus parent pointers, in-place
    eager splits, and node->memory-server placement with level-M subtree
    grouping (paper §3 Index Placement).
    """

    def __init__(self, keys: np.ndarray, values: Optional[np.ndarray] = None,
                 *, fill: float = 0.7, level_m: int = 1, n_mem_servers: int = 1,
                 placement: str = "round_robin",
                 subtrees_per_server: Optional[int] = None):
        if placement not in ("round_robin", "blocked"):
            raise ValueError(f"unknown placement {placement!r}")
        self.placement = placement
        self.subtrees_per_server = subtrees_per_server
        # the CPU tensors share the arrays the build made: no copy
        tree, meta = btree_mod.bulk_build(keys, values, fill=fill, device="cpu")
        self.K = tree.keys.numpy()
        self.C = tree.children.numpy()
        self.V = tree.values.numpy()
        self.NK = tree.num_keys.numpy()
        self.LV = tree.level.numpy()
        self.FLO = tree.fence_lo.numpy()
        self.FHI = tree.fence_hi.numpy()
        self.root = int(tree.root)
        self.height = meta.height
        self.num_nodes = meta.num_nodes
        self.level_m = level_m
        self.n_mem_servers = n_mem_servers
        self._next_free = meta.num_nodes
        self.parent = np.full((self.K.shape[0],), -1, dtype=np.int32)
        self._rebuild_parents()
        self.server = np.full((self.K.shape[0],), -1, dtype=np.int32)
        self._assign_placement()
        self.splits = 0
        self.merges = 0

    # -- storage management ---------------------------------------------------

    def _grow(self) -> None:
        cap = self.K.shape[0]
        new = cap * 2
        def g(a, fillv):
            out = np.full((new,) + a.shape[1:], fillv, dtype=a.dtype)
            out[:cap] = a
            return out
        self.K = g(self.K, KEY_MAX)
        self.C = g(self.C, NULL)
        self.V = g(self.V, 0)
        self.NK = g(self.NK, 0)
        self.LV = g(self.LV, -1)
        self.FLO = g(self.FLO, KEY_MIN)
        self.FHI = g(self.FHI, KEY_MAX)
        self.parent = g(self.parent, -1)
        self.server = g(self.server, -1)

    def _alloc(self) -> int:
        if self._next_free >= self.K.shape[0] - 1:
            self._grow()
        nid = self._next_free
        self._next_free += 1
        self.num_nodes += 1
        return nid

    def _rebuild_parents(self) -> None:
        self.parent[:] = -1
        inner = np.nonzero(self.LV > 0)[0]
        nk = self.NK[inner]
        live = np.arange(FANOUT)[None, :] < nk[:, None]
        # row-major order: parents ascending, slots ascending, as a loop
        self.parent[self.C[inner][live]] = np.repeat(inner, nk).astype(np.int32)

    def _assign_placement(self) -> None:
        """Subtrees rooted at level M live wholly on one memory server.

        ``placement="round_robin"`` (the default) deals subtrees out in
        key order; ``placement="blocked"`` assigns contiguous runs of
        ``subtrees_per_server`` subtrees to each server — the mesh pool's
        block sharding (``subtree // s_per``, core/pool.py), so the two
        planes agree on which "memory column" owns a key range.

        Runs once, on the freshly built tree, where every allocated node is
        reachable.  Nodes above level M take ``nid % n_mem_servers``; each
        level-M root (the root itself when the tree is no taller) takes its
        rank in key order through the placement rule, and every node below
        takes its parent's server, level by level."""
        m = self.level_m
        n = self.n_mem_servers
        lv = self.LV
        if int(lv[self.root]) <= m:
            roots = np.array([self.root])
        else:
            roots = np.nonzero(lv == m)[0]
            roots = roots[np.argsort(self.FLO[roots], kind="stable")]
            above = np.nonzero(lv > m)[0]
            self.server[above] = (above % n).astype(np.int32)
        order = np.arange(roots.size)
        if self.placement == "blocked":
            sps = self.subtrees_per_server or -(-roots.size // n)
            self.server[roots] = np.minimum(order // sps, n - 1)
        else:
            self.server[roots] = order % n
        for lvl in range(int(lv[roots[0]]) - 1, -1, -1):
            nodes = np.nonzero(lv == lvl)[0]
            self.server[nodes] = self.server[self.parent[nodes]]

    def subtree_root_of(self, nid: int) -> int:
        """Ancestor at level M (or self when the tree is shorter)."""
        cur = nid
        while self.LV[cur] < self.level_m and self.parent[cur] >= 0:
            cur = int(self.parent[cur])
        return cur

    # -- queries ---------------------------------------------------------------

    def search_path(self, key: int) -> List[int]:
        """Root-to-leaf node ids for ``key``."""
        path = [self.root]
        nid = self.root
        while self.LV[nid] > 0:
            nk = int(self.NK[nid])
            row = self.K[nid, :nk]
            slot = int(np.searchsorted(row, key, side="right")) - 1
            slot = max(slot, 0)
            nid = int(self.C[nid, slot])
            path.append(nid)
        return path

    def get(self, key: int) -> Optional[int]:
        leaf = self.search_path(key)[-1]
        nk = int(self.NK[leaf])
        row = self.K[leaf, :nk]
        i = int(np.searchsorted(row, key))
        if i < nk and row[i] == key:
            return int(self.V[leaf, i])
        return None

    def fence_valid(self, nid: int, key: int) -> bool:
        return self.FLO[nid] <= key < self.FHI[nid]

    # -- mutations ---------------------------------------------------------------

    def update(self, key: int, value: int) -> bool:
        leaf = self.search_path(key)[-1]
        nk = int(self.NK[leaf])
        row = self.K[leaf, :nk]
        i = int(np.searchsorted(row, key))
        if i < nk and row[i] == key:
            self.V[leaf, i] = value
            return True
        return False

    def would_split(self, key: int) -> bool:
        """True if inserting ``key`` hits any full node on its path (the
        memory-side SMO check that triggers offload fallback)."""
        return any(int(self.NK[n]) >= FANOUT for n in self.search_path(key))

    def insert(self, key: int, value: int) -> Tuple[bool, List[int]]:
        """Eager-split insert.  Returns (is_new_key, split_node_ids)."""
        splits: List[int] = []
        nid = self.root
        if int(self.NK[nid]) >= FANOUT:
            nid = self._split_root()
            splits.append(nid)
        while self.LV[nid] > 0:
            nk = int(self.NK[nid])
            slot = max(int(np.searchsorted(self.K[nid, :nk], key, side="right")) - 1, 0)
            child = int(self.C[nid, slot])
            if int(self.NK[child]) >= FANOUT:
                self._split_child(nid, slot)
                splits.append(child)
                nk = int(self.NK[nid])
                slot = max(
                    int(np.searchsorted(self.K[nid, :nk], key, side="right")) - 1, 0
                )
                child = int(self.C[nid, slot])
            nid = child
        # leaf insert
        nk = int(self.NK[nid])
        row = self.K[nid, :nk]
        i = int(np.searchsorted(row, key))
        if i < nk and row[i] == key:
            self.V[nid, i] = value
            return False, splits
        assert nk < FANOUT, "leaf full despite eager splits"
        self.K[nid, i + 1 : nk + 1] = self.K[nid, i:nk]
        self.V[nid, i + 1 : nk + 1] = self.V[nid, i:nk]
        self.K[nid, i] = key
        self.V[nid, i] = value
        self.NK[nid] = nk + 1
        return True, splits

    def _split_root(self) -> int:
        old = self.root
        new_root = self._alloc()
        self.LV[new_root] = int(self.LV[old]) + 1
        self.K[new_root, 0] = KEY_MIN
        self.C[new_root, 0] = old
        self.NK[new_root] = 1
        self.FLO[new_root] = KEY_MIN
        self.FHI[new_root] = KEY_MAX
        self.parent[old] = new_root
        self.server[new_root] = new_root % self.n_mem_servers
        self.root = new_root
        self.height += 1
        self._split_child(new_root, 0)
        return new_root

    def _split_child(self, pnode: int, slot: int) -> int:
        """Split C[pnode, slot]; parent must have room (eager policy)."""
        child = int(self.C[pnode, slot])
        nk = int(self.NK[child])
        half = nk // 2
        sib = self._alloc()
        self.LV[sib] = self.LV[child]
        # sibling gets the upper half
        self.K[sib, : nk - half] = self.K[child, half:nk]
        self.V[sib, : nk - half] = self.V[child, half:nk]
        self.C[sib, : nk - half] = self.C[child, half:nk]
        self.NK[sib] = nk - half
        sep = int(self.K[child, half])
        self.K[child, half:nk] = KEY_MAX
        self.V[child, half:nk] = 0
        self.C[child, half:nk] = NULL
        self.NK[child] = half
        # fences
        self.FLO[sib] = sep
        self.FHI[sib] = self.FHI[child]
        self.FHI[child] = sep
        # parent pointers of moved children
        if self.LV[sib] > 0:
            for i in range(int(self.NK[sib])):
                self.parent[self.C[sib, i]] = sib
        # placement: sibling stays on the same memory server (subtree intact)
        self.server[sib] = self.server[child]
        # insert separator into parent
        pk = int(self.NK[pnode])
        assert pk < FANOUT, "parent full in eager split"
        self.K[pnode, slot + 2 : pk + 1] = self.K[pnode, slot + 1 : pk]
        self.C[pnode, slot + 2 : pk + 1] = self.C[pnode, slot + 1 : pk]
        self.K[pnode, slot + 1] = sep
        self.C[pnode, slot + 1] = sib
        self.NK[pnode] = pk + 1
        self.parent[sib] = pnode
        self.splits += 1
        return sib

    def delete(self, key: int) -> bool:
        """Logical delete with lazy structural merge (empty leaves are merged
        into the parent; full rebalance is out of scope for the simulator —
        the paper's merges propagate the same counters we track)."""
        path = self.search_path(key)
        leaf = path[-1]
        nk = int(self.NK[leaf])
        row = self.K[leaf, :nk]
        i = int(np.searchsorted(row, key))
        if not (i < nk and row[i] == key):
            return False
        self.K[leaf, i : nk - 1] = self.K[leaf, i + 1 : nk]
        self.V[leaf, i : nk - 1] = self.V[leaf, i + 1 : nk]
        self.K[leaf, nk - 1] = KEY_MAX
        self.V[leaf, nk - 1] = 0
        self.NK[leaf] = nk - 1
        if self.NK[leaf] == 0 and len(path) >= 2:
            self._remove_empty_child(path[-2], leaf)
        return True

    def _remove_empty_child(self, pnode: int, child: int) -> None:
        pk = int(self.NK[pnode])
        if pk <= 1:
            return  # keep degenerate chain; rare in workloads
        slot = None
        for i in range(pk):
            if int(self.C[pnode, i]) == child:
                slot = i
                break
        if slot is None:
            return
        # absorb fence into left neighbour when possible
        self.K[pnode, slot : pk - 1] = self.K[pnode, slot + 1 : pk]
        self.C[pnode, slot : pk - 1] = self.C[pnode, slot + 1 : pk]
        if slot == 0:
            self.K[pnode, 0] = self.FLO[pnode]
        self.K[pnode, pk - 1] = KEY_MAX
        self.C[pnode, pk - 1] = NULL
        self.NK[pnode] = pk - 1
        self.merges += 1

    def scan(self, key: int, count: int) -> List[Tuple[int, List[int]]]:
        """Fence-key subdivided scan: list of (leaf, collected_keys) hops."""
        hops = []
        cur = key
        got = 0
        while got < count:
            leaf = self.search_path(cur)[-1]
            nk = int(self.NK[leaf])
            row = self.K[leaf, :nk]
            take = row[row >= cur][: count - got]
            hops.append((leaf, [int(x) for x in take]))
            got += take.size
            nxt = int(self.FHI[leaf])
            if nxt == int(KEY_MAX):
                break
            cur = nxt
        return hops


# ---------------------------------------------------------------------------
# Remote-verb counters (Table 2 columns)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Counters:
    ops: int = 0
    rdma_read: float = 0.0        # node-sized READs
    rdma_small_read: float = 0.0  # 8B version READs
    rdma_write: float = 0.0
    rdma_cas: float = 0.0         # atomics
    two_sided: float = 0.0        # offload RPCs
    bytes: float = 0.0
    local_accesses: float = 0.0   # cached-node searches
    offload_fallbacks: int = 0
    coherence_invalidations: int = 0
    refresh_from_root: int = 0
    smo_inserts: int = 0          # inserts whose split ran memory-side
    #                               (SimConfig.onmesh_smo pricing)
    offload_groups: int = 0       # (window, memory server) groups the
    #                               per-group cost model sent two-sided
    #                               (SimConfig.group_offload; mirrors the
    #                               mesh's STAT_OFFLOAD_GROUPS)
    fetch_groups: int = 0         # groups that stayed one-sided
    #                               (STAT_FETCH_GROUPS analogue)
    pipeline_stalls: int = 0      # pipelined overlap window: lanes whose
    #                               leaf the previous window wrote — the
    #                               version check catches the stale descent
    #                               and the lane re-resolves two-sided
    #                               (STAT_PIPE_STALLS analogue)
    peer_hits: int = 0            # leaf misses answered from a sibling
    #                               cache's version-fresh copy via a peer
    #                               peek (STAT_PEER_HITS analogue)
    peer_misses: int = 0          # peer peeks the sibling could not serve
    #                               (stale/absent row; resolved by the
    #                               owning server's walk —
    #                               STAT_PEER_MISSES analogue)
    rt_skips: int = 0             # within-subtree inner reads skipped by
    #                               accepted leaf-direct route-table probes
    #                               (STAT_RT_SKIPS analogue)
    rt_mispredicts: int = 0       # route-table guesses rejected by the
    #                               fence bounds / leaf-freshness check;
    #                               the op falls back to full descent
    #                               (STAT_RT_MISPREDICTS analogue)

    def add_read(self, nbytes: int = NODE_BYTES) -> None:
        self.rdma_read += 1
        self.bytes += nbytes

    def add_small_read(self) -> None:
        self.rdma_small_read += 1
        self.bytes += SMALL_READ_BYTES

    def add_write(self, nbytes: int = NODE_BYTES) -> None:
        self.rdma_write += 1
        self.bytes += nbytes

    def add_cas(self) -> None:
        self.rdma_cas += 1
        self.bytes += 8

    def add_rpc(self) -> None:
        self.two_sided += 1
        self.bytes += RPC_BYTES

    def per_op(self) -> Dict[str, float]:
        n = max(self.ops, 1)
        return {
            "reads": (self.rdma_read + self.rdma_small_read) / n,
            "node_reads": self.rdma_read / n,
            "writes": self.rdma_write / n,
            "atomics": self.rdma_cas / n,
            "two_sided": self.two_sided / n,
            "traffic_bytes": self.bytes / n,
            "local_accesses": self.local_accesses / n,
        }


# ---------------------------------------------------------------------------
# Simulator configuration (DEX + all baselines via knobs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimConfig:
    """Protocol knobs.  Presets for the paper's competitors live in
    core/baselines.py."""

    name: str = "dex"
    n_compute: int = 4
    n_mem_servers: int = 4
    threads_per_compute: int = 36
    mem_threads_per_server: int = 4
    cache_bytes: int = 256 << 20           # per compute server (paper default)
    level_m: int = 3                        # subtree grouping level (paper: M=3)

    # --- technique toggles (Fig. 8 ablation) ---
    logical_partitioning: bool = True
    caching: bool = True
    offloading: bool = True
    route_dispersion: int = 1               # caches serving each partition;
                                            # > 1 models the mesh plane's
                                            # source-dispersed within-row
                                            # routing (fig6_mesh_mixed cross-
                                            # validation): an op lands on a
                                            # random one of the partition's
                                            # `route_dispersion` caches
    coherence_batch: int = 1                # ops per batch window when
                                            # pricing the mesh plane's
                                            # *batched* execution: repeated
                                            # misses of one node coalesce
                                            # into one read per window, and
                                            # write-staleness marks flush at
                                            # window boundaries (the pmax
                                            # version sync)
    pipeline_overlap: bool = False          # two-stage pipelined engine
                                            # (engine.py pipeline=True):
                                            # window N+1's descents overlap
                                            # window N's write round, so a
                                            # descent into a leaf the
                                            # previous window wrote is one
                                            # window stale — priced as a
                                            # forced two-sided re-resolution
                                            # (the conservative conflict
                                            # fallback; needs
                                            # coherence_batch > 1)

    # --- cache behaviour (Fig. 9) ---
    cache_leaves: bool = True               # False for Sherman/SMART-like
    cache_top_inner_only: bool = False      # Sherman: lowest inner + above
    p_admit_leaf: float = DEFAULT_P_ADMIT_LEAF
    eager_admission: bool = False
    fleet_col_affinity: float = 1.0         # divergent fleet policy
                                            # (core/fleet_cache.py
                                            # divergent_policy mirror): each
                                            # of a partition's
                                            # route_dispersion sibling caches
                                            # multiplies its leaf-admission
                                            # probability by this for leaves
                                            # whose memory server matches
                                            # its own sibling coordinate
                                            # (server % d == cache % d), and
                                            # by the reciprocal otherwise;
                                            # 1.0 keeps the uniform dice
    fleet_peek_budget: int = 0              # peer peeks one cache may issue
                                            # per coherence window: a leaf
                                            # miss whose subtree another
                                            # sibling specializes on asks
                                            # that sibling's cache (one
                                            # compute-to-compute message)
                                            # before paying the remote read;
                                            # 0 disables the peek path
    centralized_fifo: bool = False          # single-bucket cooling map baseline
    cooling_slots: int = 6
    route_table_slots: int = 0              # leaf-direct route table
                                            # (core/route_table.py mirror):
                                            # > 0 enables a host-trained
                                            # (lo, hi, leaf) fence-segment
                                            # table; an accepted non-scan op
                                            # probes the predicted leaf
                                            # directly, skipping the within-
                                            # subtree inner levels (counted
                                            # in Counters.rt_skips).  Any
                                            # write/split since the last
                                            # train marks the leaf dirty —
                                            # the mesh's leaf version fence —
                                            # so the entry rejects and the op
                                            # pays full descent
                                            # (Counters.rt_mispredicts).
                                            # 0 disables the table entirely.

    # --- synchronization style ---
    rdma_optimistic_reads: bool = False     # version+node+version for ALL reads
                                            # (shared-everything baselines)
    immediate_leaf_writeback: bool = True   # overridden by partitioning
    write_through: bool = False             # every leaf write goes home at
                                            # once (cached copy refreshed, no
                                            # dirty state) — the protocol the
                                            # mesh plane (core/write.py) uses,
                                            # enabling counter-level cross-
                                            # validation between the planes
    single_record_leaves: bool = False      # SMART-like trie: 1 record/leaf
    write_combining: bool = False           # SMART: consolidate concurrent
                                            # writes (Table 2: ~8x fewer)
    write_combine_factor: float = 0.11
    cache_above_m_only: bool = False        # Offload-only variant (Fig. 5)
    onmesh_smo: bool = False                # price structural splits as the
                                            # mesh plane's SMO engine does
                                            # (core/smo.py): the insert ships
                                            # one tiny two-sided message to
                                            # the owning memory server, which
                                            # runs the split next to the data
                                            # — instead of the compute-side
                                            # CAS + read + write-back per
                                            # split node (counted in
                                            # Counters.smo_inserts for
                                            # cross-plane validation,
                                            # benchmarks/fig14_mesh_load.py)

    # --- offload policy ---
    group_offload: bool = False             # per-(memory server, window)
                                            # byte-cost offload decision,
                                            # mirroring the mesh engine's
                                            # per-group cost model
                                            # (core/engine.py): a window's
                                            # live non-scan ops targeting a
                                            # server form one group whose
                                            # predicted fetch bytes (per-
                                            # level miss EMA x node bytes,
                                            # population-capped) are
                                            # compared against per-op RPC
                                            # bytes; counted in
                                            # Counters.offload_groups /
                                            # fetch_groups for cross-plane
                                            # validation
                                            # (benchmarks/fig13_mesh_engine)
    group_ema_decay: float = 0.98           # matches DexMeshConfig.ema_decay
    offload_always: bool = False            # Offload-only variant (Fig. 5)
    offload_epsilon: float = 0.01           # contrary-action probability (§6.1)
    offload_window: int = 50                # moving-average window (§6.1)
    offload_c: float = 1.3                  # cache-op coefficient c (>1, §6.1)

    # --- latency constants (paper §2.3 / §6.1), seconds ---
    t_cached_access: float = 400e-9         # T_c: 1KB cached page access
    t_rdma_read: float = 2e-6               # l_o
    t_rdma_small: float = 1.5e-6
    t_rdma_write: float = 2e-6
    t_rdma_cas: float = 2e-6
    t_rpc_base: float = 4e-6                # l_p floor (two-sided round trip)
    t_mem_search: float = 600e-9            # per-node search on memory-side CPU
    t_local_search: float = 150e-9          # l_s


@dataclasses.dataclass
class OffloadEstimator:
    """Moving-average latency estimates for l_p and l_o (§6.1)."""

    window: int
    l_o: float
    l_p: float

    def observe_read(self, v: float) -> None:
        self.l_o += (v - self.l_o) / self.window

    def observe_rpc(self, v: float) -> None:
        self.l_p += (v - self.l_p) / self.window


class Simulator:
    """Runs a workload against one protocol configuration."""

    def __init__(self, tree: HostBTree, cfg: SimConfig, *, seed: int = 0):
        self.tree = tree
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        if cfg.n_compute % max(cfg.route_dispersion, 1):
            raise ValueError("n_compute must be a multiple of route_dispersion")
        n_parts = (
            cfg.n_compute // max(cfg.route_dispersion, 1)
            if cfg.logical_partitioning
            else 1
        )
        lo = int(np.min(tree.K[tree.LV == 0][tree.K[tree.LV == 0] != KEY_MAX]))
        hi = int(
            np.max(
                np.where(
                    tree.K[tree.LV == 0] == KEY_MAX, KEY_MIN, tree.K[tree.LV == 0]
                )
            )
        )
        parts = LogicalPartitions.equal_width(n_parts, lo, hi + 1)
        self.partitions = self._snap_to_leaf_fences(parts)
        cap_nodes = max(8, cfg.cache_bytes // NODE_BYTES)

        def _bias_for(i: int):
            # divergent fleet policy: cache i specializes on the memory
            # servers matching its sibling coordinate (i % d) — the Plane B
            # CachePolicy.admit_bias column-affinity mirror
            if cfg.fleet_col_affinity == 1.0:
                return None
            a = float(cfg.fleet_col_affinity)
            d = max(cfg.route_dispersion, 1)

            def bias(nid: int, _i=i, _a=a, _d=d) -> float:
                ms = int(tree.server[tree.subtree_root_of(nid)])
                return _a if ms % _d == _i % _d else 1.0 / _a

            return bias

        self.caches = [
            ComputeCache(
                cap_nodes,
                parent_of=lambda n: int(tree.parent[n]),
                is_leaf=lambda n: int(tree.LV[n]) == 0,
                p_admit_leaf=cfg.p_admit_leaf,
                eager_admission=cfg.eager_admission,
                n_cooling_buckets=(1 if cfg.centralized_fifo else None),
                cooling_slots=(
                    10**9 if cfg.centralized_fifo else cfg.cooling_slots
                ),
                rng=np.random.default_rng(seed + 17 * i + 1),
                admit_bias=_bias_for(i),
            )
            for i in range(cfg.n_compute)
        ]
        self.counters = [Counters() for _ in range(cfg.n_compute)]
        # write-through coherence state: nodes whose cached copy on server s
        # is version-stale (kept cached, refreshed in place on next access)
        self.stale = [set() for _ in range(cfg.n_compute)]
        # batched-execution state (coherence_batch > 1): per-server nodes
        # already fetched this window, and write-staleness marks deferred
        # to the next window boundary
        self._window_fetched = [set() for _ in range(cfg.n_compute)]
        # peer peeks already issued this window, per cache (budget mirror of
        # the mesh's per-batch CachePolicy.peek_budget)
        self._window_peeks = np.zeros((cfg.n_compute,), dtype=np.int64)
        self._pending_writes = []           # (writer server, leaf)
        # leaves written by the immediately-preceding window — the
        # pipelined overlap set (pipeline_overlap pricing)
        self._prev_window_writes = set()
        self._ops_in_window = 0
        self.mem_busy = np.zeros((cfg.n_mem_servers,), dtype=np.float64)
        self.mem_reqs = np.zeros((cfg.n_mem_servers,), dtype=np.int64)
        self.estimators = [
            OffloadEstimator(cfg.offload_window, cfg.t_rdma_read, cfg.t_rpc_base)
            for _ in range(cfg.n_compute)
        ]
        self.op_clock = np.zeros((cfg.n_compute,), dtype=np.float64)  # cpu-side work time
        self._rr = 0
        # per-op latency sampling into the mesh plane's bucket schema
        # (obs/latency.py): ``_dispatch`` snapshots the owning server's
        # op_clock around each op and adds ``_op_extra`` — the service
        # components op_clock books elsewhere (offload RPC + memory-side
        # walk, a peek sibling's access, a window-coalesced read repriced as
        # the remote fetch the mesh's per-lane ledger charges) — then bins
        # into (op class, outcome path, bucket)
        self.lat_hist = np.zeros(
            (obs_latency.N_CLASSES, obs_latency.N_PATHS,
             obs_latency.N_BUCKETS),
            dtype=np.int64,
        )
        self._op_extra = 0.0
        self._op_offl = False
        self._op_stall = False
        self._op_peek = False
        self._op_miss = False
        # per-group (mesh-engine) offload state: a per-(memory server, block
        # level) miss-rate EMA — the exact analogue of the mesh's
        # ``DexState.miss_ema`` — plus this window's observation
        # accumulators and the current per-server decisions (EMA starts at
        # 1, so like the mesh a cold index begins on the two-sided path)
        lv_blk = cfg.level_m + 1
        self._gema = np.ones((cfg.n_mem_servers, lv_blk), dtype=np.float64)
        self._gwin_miss = np.zeros((cfg.n_mem_servers, lv_blk), np.float64)
        self._gwin_live = np.zeros((cfg.n_mem_servers, lv_blk), np.float64)
        self._gdecision = np.ones((cfg.n_mem_servers,), dtype=bool)
        self._group_active = False
        self._group_obs_off = False
        # leaf-direct route table (route_table_slots > 0), trained host-side
        # by ``train_route_table``: fence segments sorted by low key, plus
        # the set of leaves touched since the last train — the sim's
        # stand-in for the mesh plane's per-leaf version fence
        self._rt_lo = np.zeros((0,), dtype=np.int64)
        self._rt_hi = np.zeros((0,), dtype=np.int64)
        self._rt_leaf = np.zeros((0,), dtype=np.int64)
        self._rt_dirty: set = set()

    # -- helpers ---------------------------------------------------------------

    def _snap_to_leaf_fences(self, parts: LogicalPartitions) -> LogicalPartitions:
        """Snap partition boundaries to leaf fence keys so every leaf is
        exclusively owned by one partition (paper §4: boundaries are picked
        from lowest-inner-node keys, i.e. leaf fence keys)."""
        b = parts.boundaries.copy()
        for i in range(1, b.size - 1):
            leaf = self.tree.search_path(int(b[i]))[-1]
            b[i] = int(self.tree.FLO[leaf])
        b = np.unique(b)
        if b.size < 2 or b[0] != KEY_MIN or b[-1] != KEY_MAX:
            b = np.concatenate([[KEY_MIN], b[(b > KEY_MIN) & (b < KEY_MAX)], [KEY_MAX]])
        return LogicalPartitions(np.asarray(b, dtype=np.int64))

    def reset_counters(self) -> None:
        """Zero all accounting after a warmup phase (paper §8.1: 10M warmup
        ops precede measurement)."""
        self.counters = [Counters() for _ in range(self.cfg.n_compute)]
        self.mem_busy[:] = 0.0
        self.mem_reqs[:] = 0
        self.op_clock[:] = 0.0
        self.lat_hist[:] = 0
        for cache in self.caches:
            cache.stats.reset()
            cache.cooling.lock_acquires[:] = 0

    def _owner(self, key: int) -> int:
        if self.cfg.logical_partitioning:
            p = int(self.partitions.owner_of(np.asarray([key]))[0])
            d = max(self.cfg.route_dispersion, 1)
            if d > 1:
                # one of the partition's d caches, chosen per op — the mesh
                # plane's within-row dispersion (requests reach the route
                # row's chips by source lane, not by key)
                return (p * d + int(self.rng.integers(d))) % self.cfg.n_compute
            return p % self.cfg.n_compute
        self._rr = (self._rr + 1) % self.cfg.n_compute
        return self._rr

    def _is_shared(self, nid: int) -> bool:
        if not self.cfg.logical_partitioning:
            return True  # shared-everything: every node is shared
        return bool(
            self.partitions.is_shared_range(
                np.asarray([self.tree.FLO[nid]]), np.asarray([self.tree.FHI[nid]])
            )[0]
        )

    def _write_coherence(self, server: int, nid: int, *,
                         drop_self: bool = False) -> None:
        """Write-through-and-invalidate (core/write.py): after a leaf write,
        every *other* cache serving the partition (``route_dispersion`` > 1)
        holds a version-stale copy — it stays cached but must pay one remote
        read to refresh on its next access.  The writer's own copy is
        refreshed in place (update) or dropped (insert: the key set
        shifted, ``drop_self``).  Under batched pricing
        (``coherence_batch`` > 1) sibling staleness flushes at the window
        boundary — the mesh's pmax version sync — so same-window writers
        of one leaf all end up fresh."""
        self.stale[server].discard(nid)
        if drop_self and self.caches[server].invalidate(nid):
            self.counters[server].coherence_invalidations += 1
        if self.cfg.coherence_batch > 1:
            self._pending_writes.append((server, nid))
            return
        # the version table is global: every other cache's copy goes stale,
        # not just the writer's dispersion group (scans cache across
        # partitions), matching _flush_window's batched flush
        for s in range(self.cfg.n_compute):
            if s != server and nid in self.caches[s]:
                self.stale[s].add(nid)
                self.counters[s].coherence_invalidations += 1

    def _flush_window(self) -> None:
        """Window boundary: publish deferred staleness (every cache that is
        not one of the window's writers of a leaf goes stale on it) and
        clear the per-window read-coalescing sets."""
        writers = {}
        for server, nid in self._pending_writes:
            writers.setdefault(nid, set()).add(server)
        for nid, ws in writers.items():
            for s in range(self.cfg.n_compute):
                if s not in ws and nid in self.caches[s]:
                    self.stale[s].add(nid)
                    self.counters[s].coherence_invalidations += 1
        # rotate the overlap set: the next window's descents overlap THIS
        # window's write round (pipeline_overlap pricing)
        self._prev_window_writes = {nid for _, nid in self._pending_writes}
        self._pending_writes.clear()
        for w in self._window_fetched:
            w.clear()
        self._window_peeks[:] = 0

    def _cacheable(self, nid: int) -> bool:
        cfg = self.cfg
        if not cfg.caching:
            return False
        lvl = int(self.tree.LV[nid])
        if cfg.cache_above_m_only:
            return lvl > cfg.level_m
        if lvl == 0:
            return cfg.cache_leaves
        return True

    def _shared_write(self, server: int) -> None:
        """Leaf write in shared-everything mode: RDMA CAS lock + write-back
        (optionally write-combined, SMART-style)."""
        cfg = self.cfg
        c = self.counters[server]
        f = cfg.write_combine_factor if cfg.write_combining else 1.0
        c.rdma_cas += f
        c.bytes += 8 * f
        c.rdma_write += f
        c.bytes += NODE_BYTES * f
        # lock release is an RDMA WRITE of the lock word (Ziegler et al. [49])
        c.rdma_write += f
        c.bytes += SMALL_READ_BYTES * f
        self.op_clock[server] += f * (
            cfg.t_rdma_cas + cfg.t_rdma_write + cfg.t_rdma_small
        )

    def _remote_read(self, server: int, nid: int, shared: bool) -> float:
        """One cache::remote_read (Algorithm 1, lines 1–10).  Returns latency."""
        c = self.counters[server]
        cfg = self.cfg
        lat = 0.0
        if shared or cfg.rdma_optimistic_reads:
            c.add_small_read()
            c.add_read()
            c.add_small_read()
            lat = cfg.t_rdma_read + 2 * cfg.t_rdma_small
        else:
            c.add_read()
            lat = cfg.t_rdma_read
        self.estimators[server].observe_read(cfg.t_rdma_read)
        self._op_miss = True
        return lat

    def _deserve_offload(self, server: int, levels_left: int) -> bool:
        cfg = self.cfg
        if cfg.offload_always:
            return True
        est = self.estimators[server]
        rdma_cost = levels_left * (est.l_o + cfg.t_local_search) * cfg.offload_c
        decision = est.l_p < rdma_cost
        if self.rng.random() < cfg.offload_epsilon:
            decision = not decision
        return decision

    def _offload(self, server: int, nid: int, levels_left: int) -> None:
        """Push the remaining traversal to the memory server (§6.2)."""
        cfg = self.cfg
        c = self.counters[server]
        c.add_rpc()
        ms = int(self.tree.server[nid])
        service = levels_left * cfg.t_mem_search
        self.mem_busy[ms] += service
        self.mem_reqs[ms] += 1
        self.estimators[server].observe_rpc(cfg.t_rpc_base + service)
        # the RPC round trip and the owner's walk never touch op_clock
        # (they run memory-side); the per-op latency sample still pays them
        self._op_extra += cfg.t_rpc_base + service
        self._op_offl = True

    # -- leaf-direct route table (core/route_table.py mirror) --------------------

    def _live_leaves(self) -> List[int]:
        """Leaves reachable from the root (delete's lazy merges can orphan
        array rows, so a plain LV == 0 scan over-collects)."""
        out: List[int] = []
        stack = [self.tree.root]
        while stack:
            nid = stack.pop()
            if int(self.tree.LV[nid]) == 0:
                out.append(nid)
            else:
                for i in range(int(self.tree.NK[nid])):
                    stack.append(int(self.tree.C[nid, i]))
        return out

    def train_route_table(self, slots: Optional[int] = None) -> int:
        """(Re)train the leaf-direct table from the host tree's live leaves,
        exactly as ``core/route_table.py`` trains from the mesh pool: fence
        segments sorted by low key; when leaves outnumber the slots, the
        leaves of the demand-hottest partitions are kept first (a
        partition's demand is the op count its caches have served — the
        ``DexState.route_demand`` analogue).  Returns the entry count."""
        r = int(self.cfg.route_table_slots if slots is None else slots)
        self._rt_lo = np.zeros((0,), dtype=np.int64)
        self._rt_hi = np.zeros((0,), dtype=np.int64)
        self._rt_leaf = np.zeros((0,), dtype=np.int64)
        self._rt_dirty = set()
        if r <= 0:
            return 0
        leaves = self._live_leaves()
        lo = np.array([int(self.tree.FLO[n]) for n in leaves], dtype=np.int64)
        order = np.argsort(lo, kind="stable")
        leaves = [leaves[i] for i in order]
        lo = lo[order]
        hi = np.array([int(self.tree.FHI[n]) for n in leaves], dtype=np.int64)
        if len(leaves) > r:
            d = max(self.cfg.route_dispersion, 1)
            part = self.partitions.owner_of(lo)
            demand = np.array(
                [
                    sum(
                        self.counters[(int(p) * d + j) % self.cfg.n_compute].ops
                        for j in range(d)
                    )
                    for p in part
                ],
                dtype=np.int64,
            )
            # hot partitions first; the stable sort keeps key order within a
            # partition so the kept prefix is a union of hot key ranges
            keep = np.sort(np.argsort(-demand, kind="stable")[:r])
            leaves = [leaves[i] for i in keep]
            lo, hi = lo[keep], hi[keep]
        self._rt_lo = lo
        self._rt_hi = hi
        self._rt_leaf = np.array(leaves, dtype=np.int64)
        return len(leaves)

    def poison_route_table(self) -> None:
        """Adversarial-table arm (``route_table.poison_route_table`` mirror):
        mark every entry's leaf dirty so the fence rejects every guess — the
        contract under test is bit-identical results to descent-only."""
        self._rt_dirty.update(int(n) for n in self._rt_leaf)

    def _rt_predict(self, key: int) -> int:
        """Leaf of the covering, fence-fresh entry for ``key``; -1 when the
        table rejects (the caller books the mispredict)."""
        n = self._rt_lo.size
        if n == 0:
            return -1
        i = min(
            max(int(np.searchsorted(self._rt_lo, key, side="right")) - 1, 0),
            n - 1,
        )
        leaf = int(self._rt_leaf[i])
        if (
            int(self._rt_lo[i]) <= key < int(self._rt_hi[i])
            and leaf not in self._rt_dirty
        ):
            return leaf
        return -1

    def _rt_touch(self, *nids: int) -> None:
        """Mark leaves written/split since the last train — the version bump
        the mesh's write path applies, which fences out their entries."""
        if self.cfg.route_table_slots > 0:
            self._rt_dirty.update(int(n) for n in nids)

    # -- operations --------------------------------------------------------------

    def run(
        self,
        ops: np.ndarray,
        keys: np.ndarray,
        scan_len: int = 100,
        scan_lens: Optional[np.ndarray] = None,
        *,
        group_policy: Optional[str] = None,
    ) -> None:
        """Execute a workload.  ``ops``: array of {0:lookup, 1:update,
        2:insert, 3:scan, 4:delete}; ``keys``: target keys.  ``scan_lens``
        (per-op record counts, e.g. YCSB-E's uniform lengths) overrides the
        fixed ``scan_len`` when given.

        With ``SimConfig.group_offload`` the stream executes in windows of
        ``coherence_batch`` ops (the mesh's batch): each window's live
        non-scan ops per memory server form one cost group, decided and
        counted *before* the window runs, exactly as the engine decides per
        batch (core/engine.py).  ``group_policy`` overrides the cost model
        for this call — ``"fetch"`` forces one-sided (and, like the mesh's
        ``policy="fetch"``, mints no groups), ``"offload"`` forces
        two-sided; ``None`` applies the byte-cost comparison."""
        if self.cfg.group_offload:
            w = max(self.cfg.coherence_batch, 1)
            self._group_active = True
            try:
                for lo in range(0, len(ops), w):
                    hi = min(lo + w, len(ops))
                    self._group_window_begin(
                        ops[lo:hi], keys[lo:hi], group_policy
                    )
                    for i in range(lo, hi):
                        self._dispatch(i, ops[i], keys[i], scan_len, scan_lens)
                    self._flush_window()
                    self._group_window_end()
            finally:
                self._group_active = False
            return
        for i, (op, key) in enumerate(zip(ops, keys)):
            self._dispatch(i, op, key, scan_len, scan_lens)
            if self.cfg.coherence_batch > 1:
                self._ops_in_window += 1
                if self._ops_in_window >= self.cfg.coherence_batch:
                    self._flush_window()
                    self._ops_in_window = 0

    def _dispatch(self, i, op, key, scan_len, scan_lens) -> None:
        key = int(key)
        server = self._owner(key)
        self.counters[server].ops += 1
        t0 = self.op_clock[server]
        self._op_extra = 0.0
        self._op_offl = self._op_stall = False
        self._op_peek = self._op_miss = False
        if op == 0:
            self._op_lookup(server, key)
        elif op == 1:
            self._op_update(server, key)
        elif op == 2:
            self._op_insert(server, key)
        elif op == 3:
            n = int(scan_lens[i]) if scan_lens is not None else scan_len
            self._op_scan(server, key, n)
        elif op == 4:
            self._op_delete(server, key)
        else:
            raise ValueError(f"bad op {op}")
        # latency sample: this server's clock delta plus the off-clock
        # service components; path priority mirrors the mesh ledger's
        # (stale_forced > offload > peer_peek > remote_fetch > cache_hit;
        # the simulator has no shed lane).  Deletes share the update class.
        lat = (self.op_clock[server] - t0) + self._op_extra
        cls = 1 if op == 4 else min(int(op), obs_latency.N_CLASSES - 1)
        if self._op_stall:
            path = obs_latency.PATHS.index("stale_forced")
        elif self._op_offl:
            path = obs_latency.PATHS.index("offload")
        elif self._op_peek:
            path = obs_latency.PATHS.index("peer_peek")
        elif self._op_miss:
            path = obs_latency.PATHS.index("remote_fetch")
        else:
            path = obs_latency.PATHS.index("cache_hit")
        self.lat_hist[cls, path, int(obs_latency.bucket_index(lat))] += 1

    # -- per-group offload machinery (SimConfig.group_offload) ----------------

    def _mem_server_of(self, key: int) -> int:
        """Memory server owning the level-M subtree of ``key``'s leaf."""
        leaf = self.tree.search_path(key)[-1]
        return int(self.tree.server[self.tree.subtree_root_of(leaf)])

    def _group_level_nodes(self) -> np.ndarray:
        """Per-(server, mesh level) block-node population; mesh level 0 is
        the subtree root (tree level M), the last is the leaves.  Caps the
        group cost model's predicted fetch bytes: a batch's coalesced reads
        never exceed a level's distinct nodes."""
        m = self.cfg.level_m
        lv = self.tree.LV
        sv = self.tree.server
        out = np.zeros((self.cfg.n_mem_servers, m + 1), np.float64)
        for l_mesh in range(m + 1):
            mask = (lv == m - l_mesh) & (sv >= 0)
            if mask.any():
                np.add.at(out, (sv[mask] % self.cfg.n_mem_servers, l_mesh), 1.0)
        return out

    def _group_window_begin(self, ops, keys, group_policy) -> None:
        """Decide (and count) this window's per-server cost groups from its
        live non-scan population — the sim-side mirror of the engine's
        per-(destination column) decision on psum'd live-lane counts."""
        cfg = self.cfg
        live = np.zeros((cfg.n_mem_servers,), np.int64)
        # the tree is static while a window's population is taken, and
        # skewed windows repeat keys heavily: memoize the per-key server to
        # avoid paying a second full tree walk per op
        servers: Dict[int, int] = {}
        for op, key in zip(ops, keys):
            if op == 3:          # scans never offload (§7)
                continue
            k = int(key)
            ms = servers.get(k)
            if ms is None:
                ms = servers[k] = self._mem_server_of(k)
            live[ms] += 1
        if group_policy == "fetch":
            # forced one-sided windows mint no groups (mesh policy="fetch")
            self._gdecision[:] = False
            return
        if group_policy == "offload":
            self._gdecision[:] = True
        else:
            caps = np.minimum(
                live[:, None].astype(np.float64), self._group_level_nodes()
            )
            fetch_cost = (
                (caps * self._gema).sum(axis=1)
                * ENGINE_NODE_ROW_BYTES * cfg.offload_c
            )
            rpc_cost = live.astype(np.float64) * ENGINE_RPC_BYTES
            self._gdecision = fetch_cost > rpc_cost
        c = self.counters[0]   # groups are index-global: count them once
        c.offload_groups += int((self._gdecision & (live > 0)).sum())
        c.fetch_groups += int((~self._gdecision & (live > 0)).sum())

    def _group_window_end(self) -> None:
        """Fold this window's per-(server, level) miss observations into the
        EMA (decay matches the mesh's ``DexMeshConfig.ema_decay``); servers
        whose window held no fetch-path ops keep their estimate, exactly
        like an offloaded mesh column."""
        obs = self._gwin_live > 0
        rate = np.where(
            obs, self._gwin_miss / np.maximum(self._gwin_live, 1.0), 0.0
        )
        d = self.cfg.group_ema_decay
        self._gema = np.where(obs, d * self._gema + (1 - d) * rate, self._gema)
        self._gwin_miss[:] = 0.0
        self._gwin_live[:] = 0.0

    def _gobs(self, nid: int, hit: bool) -> None:
        """One fetch-path block-level cache observation (scan traversals are
        excluded, as on the mesh)."""
        if not self._group_active or self._group_obs_off:
            return
        lvl = int(self.tree.LV[nid])
        if lvl > self.cfg.level_m:
            return
        ms = int(self.tree.server[nid]) % self.cfg.n_mem_servers
        self._gwin_live[ms, self.cfg.level_m - lvl] += 1
        if not hit:
            self._gwin_miss[ms, self.cfg.level_m - lvl] += 1

    # Traversal core: walk the ground-truth path, consulting the cache and
    # issuing remote verbs per the configured protocol.  Returns the list of
    # (node, was_cached) and whether the op was completed via offload.
    def _traverse(self, server: int, key: int, *, for_write: bool,
                  is_insert: bool = False,
                  peek_ok: bool = True,
                  rt_ok: bool = True) -> Tuple[List[Tuple[int, bool]], bool]:
        cfg = self.cfg
        cache = self.caches[server]
        c = self.counters[server]
        path = self.tree.search_path(key)
        height = len(path)
        visited: List[Tuple[int, bool]] = []
        group_tried = False
        # leaf-direct route table: predict once per op (scans are never
        # eligible, matching the mesh engine's eligibility mask); counters
        # are booked at the subtree boundary below so group-offloaded ops —
        # which the mesh excludes from eligibility — book nothing
        rt_guess = cfg.route_table_slots > 0 and rt_ok and self._rt_lo.size > 0
        rt_leaf = self._rt_predict(key) if rt_guess else -1
        rt_counted = False
        for depth, nid in enumerate(path):
            lvl = int(self.tree.LV[nid])
            if (
                cfg.pipeline_overlap
                and lvl == 0
                and nid in self._prev_window_writes
            ):
                # pipelined overlap window: this leaf was written by the
                # immediately-preceding window, so a descent that overlapped
                # that window's write round read it one batch stale.  The
                # version check catches it in the back half and the lane
                # re-resolves two-sided against the owning memory server —
                # the conservative conflict fallback (scans stall-shed and
                # retry at the same price)
                c.pipeline_stalls += 1
                self._op_stall = True
                self._offload(server, nid, 1)
                return visited, True
            if (
                self._group_active
                and cfg.offloading
                and not group_tried
                and lvl <= cfg.level_m
                and self._gdecision[int(self.tree.server[nid])
                                    % cfg.n_mem_servers]
            ):
                # per-group mode: the whole column's traffic goes two-sided
                # at the first block-level node, before any cache probe
                # (the mesh's offloaded lanes skip the descent entirely);
                # decided once per op.  Only inserts that would split fall
                # back to the one-sided path (§6 — on the mesh they shed
                # STATUS_SPLIT to core/smo.py; offloaded updates always
                # apply memory-side)
                group_tried = True
                if for_write and is_insert and self.tree.would_split(key):
                    c.offload_fallbacks += 1
                else:
                    self._offload(server, nid, lvl + 1)
                    return visited, True
            if rt_guess and lvl <= cfg.level_m and not rt_counted:
                # subtree boundary: the op survived the offload decision, so
                # it is rt-eligible — book the accept/reject outcome once
                rt_counted = True
                if rt_leaf < 0:
                    c.rt_mispredicts += 1
            if rt_leaf >= 0 and 1 <= lvl <= cfg.level_m:
                # accepted leaf-direct probe: the within-subtree inner
                # levels are never fetched — the lane lands straight on the
                # (fence-verified) leaf, which is processed normally below
                c.rt_skips += 1
                continue
            if cfg.caching and self._cacheable(nid):
                r = cache.lookup(nid)
                if r == "hit":
                    if nid in self.stale[server]:
                        # version-stale copy: one remote read refreshes it
                        # in place (no re-admission dice), mirroring the
                        # mesh's version-checked probe + in-place refresh
                        lat = self._remote_read(
                            server, nid, self._is_shared(nid)
                        )
                        self.op_clock[server] += lat
                        self.stale[server].discard(nid)
                        self._window_fetched[server].add(nid)
                        self._gobs(nid, False)
                        visited.append((nid, True))
                        continue
                    c.local_accesses += 1
                    self.op_clock[server] += cfg.t_cached_access
                    self._gobs(nid, True)
                    visited.append((nid, True))
                    continue
            if (
                cfg.coherence_batch > 1
                and nid in self._window_fetched[server]
            ):
                # batched read coalescing: this node was already fetched in
                # the current window — the row is on chip, no second read
                # (the mesh's duplicate-gid request combining); admission
                # still re-rolls its dice per access
                c.local_accesses += 1
                self.op_clock[server] += cfg.t_cached_access
                if cfg.caching and self._cacheable(nid):
                    cache.admit(nid, ignore_parent=(rt_leaf >= 0 and lvl == 0))
                # a window-coalesced read is still a cache-probe miss on the
                # mesh (duplicate lanes of one batch all miss, then share
                # one coalesced message) — the EMA counts the probe, and the
                # latency sample re-prices it as the remote read the mesh's
                # duplicate lane models (the clock above only paid a cached
                # access, but the lane still waited on the coalesced fetch)
                self._op_extra += cfg.t_rdma_read - cfg.t_cached_access
                self._op_miss = True
                self._gobs(nid, False)
                visited.append((nid, cfg.caching and nid in cache))
                continue
            shared = self._is_shared(nid)
            levels_left = lvl + 1  # nodes from here to leaf inclusive
            if (
                not self._group_active
                and cfg.offloading
                and not shared
                and lvl <= cfg.level_m
                and self._deserve_offload(server, levels_left)
            ):
                # SMO fallback: a write that would split cannot be offloaded
                if for_write and self.tree.would_split(key):
                    c.offload_fallbacks += 1
                else:
                    self._offload(server, nid, levels_left)
                    return visited, True
            if (
                cfg.fleet_peek_budget > 0
                and lvl == 0
                and peek_ok
                and not for_write
                and self._window_peeks[server] < cfg.fleet_peek_budget
            ):
                # peer peek (core/fleet_cache.py MSG_PEEK mirror): instead of
                # paying the remote row read, ask the sibling cache that
                # specializes on this leaf's memory server — one compute-to-
                # compute message riding the window's fused round.  A
                # version-fresh sibling copy answers; a stale or absent one
                # is a peer miss resolved by the owning server's walk next
                # to the data.  Peeked lanes fetch and admit nothing here.
                d = max(cfg.route_dispersion, 1)
                ms = int(self.tree.server[nid]) % cfg.n_mem_servers
                sib = (server // d) * d + ms % d
                if sib != server:
                    self._window_peeks[server] += 1
                    self._op_peek = True
                    c.bytes += RPC_BYTES
                    self.op_clock[server] += cfg.t_rpc_base
                    if nid in self.caches[sib] and nid not in self.stale[sib]:
                        c.peer_hits += 1
                        self.counters[sib].local_accesses += 1
                        self.op_clock[sib] += cfg.t_cached_access
                        # the sibling's lookup runs off this op's clock
                        self._op_extra += cfg.t_cached_access
                    else:
                        c.peer_misses += 1
                        service = (lvl + 1) * cfg.t_mem_search
                        self.mem_busy[ms] += service
                        self.mem_reqs[ms] += 1
                        self._op_extra += service
                    self._gobs(nid, False)
                    visited.append((nid, False))
                    continue
            lat = self._remote_read(server, nid, shared)
            self.op_clock[server] += lat
            if cfg.coherence_batch > 1:
                self._window_fetched[server].add(nid)
            if self._cacheable(nid):
                # a leaf reached through an accepted route-table probe has no
                # cached ancestors to swizzle under — the table entry IS the
                # path, so admission falls back to the dice alone
                cache.admit(nid, ignore_parent=(rt_leaf >= 0 and lvl == 0))
            self._gobs(nid, False)
            visited.append((nid, False))
        return visited, False

    def _op_lookup(self, server: int, key: int) -> Optional[int]:
        visited, offloaded = self._traverse(server, key, for_write=False)
        if offloaded:
            return self.tree.get(key)
        self.op_clock[server] += self.cfg.t_local_search
        return self.tree.get(key)

    def _op_update(self, server: int, key: int) -> bool:
        cfg = self.cfg
        cache = self.caches[server]
        c = self.counters[server]
        visited, offloaded = self._traverse(server, key, for_write=True)
        ok = self.tree.update(key, key ^ 0x5A5A)
        if offloaded:
            # memory-side update; invalidate any cached copies (rare: path-
            # aware caching means the subpath is usually uncached, §6.2)
            leaf = self.tree.search_path(key)[-1]
            self._rt_touch(leaf)
            if cache.invalidate(leaf):
                c.coherence_invalidations += 1
            return ok
        leaf, was_cached = visited[-1]
        self._rt_touch(leaf)
        shared = self._is_shared(leaf)
        if cfg.logical_partitioning and not shared:
            if cfg.write_through:
                c.add_write()                # write-through: always go home
                # pipelined engine: the leaf write-back rides the fused
                # round that overlaps the NEXT window's descents — the verb
                # still crosses the NIC (bandwidth / message-rate caps
                # unchanged) but its latency leaves the op's critical path
                # (cost_model thread cap)
                if not cfg.pipeline_overlap:
                    self.op_clock[server] += cfg.t_rdma_write
                self._write_coherence(server, leaf)
            elif was_cached or (self.cfg.caching and leaf in cache):
                cache.mark_dirty(leaf)       # deferred write-back
            else:
                c.add_write()                # not cached: write home now
                self.op_clock[server] += cfg.t_rdma_write
        else:
            # shared-everything: RDMA lock + write back + unlock
            self._shared_write(server)
        return ok

    def _op_insert(self, server: int, key: int) -> None:
        cfg = self.cfg
        cache = self.caches[server]
        c = self.counters[server]
        visited, offloaded = self._traverse(server, key, for_write=True,
                                            is_insert=True)
        if (
            cfg.onmesh_smo
            and not offloaded
            and self.tree.would_split(key)
        ):
            # the mesh SMO engine (core/smo.py): the insert ships one tiny
            # (key, value) message to the owning memory server, which runs
            # the split next to the data — no compute-side CAS/read/write
            # per split node, no pool rebuild; the writer's own cached leaf
            # copy drops (key set shifted) and siblings' copies go stale
            _, split_nodes = self.tree.insert(key, key)
            c.add_rpc()
            leaf = self.tree.search_path(key)[-1]
            self._rt_touch(leaf, *split_nodes)
            ms = int(self.tree.server[leaf])
            service = (len(split_nodes) + 1) * self.cfg.t_mem_search
            self.mem_busy[ms] += service
            self.mem_reqs[ms] += 1
            c.smo_inserts += 1
            self._write_coherence(server, leaf, drop_self=True)
            for snode in split_nodes:
                self._write_coherence(server, snode, drop_self=True)
            return
        _, split_nodes = self.tree.insert(key, key)
        if cfg.route_table_slots > 0:
            self._rt_touch(self.tree.search_path(key)[-1], *split_nodes)
        if offloaded:
            leaf = self.tree.search_path(key)[-1]
            if cache.invalidate(leaf):
                c.coherence_invalidations += 1
            return
        # split handling (§7 Insert)
        for snode in split_nodes:
            shared = self._is_shared(snode)
            if shared:
                # global lock + freshness check on the shared parent
                c.add_cas()
                c.add_read()
                c.add_write()
                self.op_clock[server] += (
                    cfg.t_rdma_cas + cfg.t_rdma_read + cfg.t_rdma_write
                )
            else:
                if cfg.caching and not cfg.write_through and snode in cache:
                    cache.mark_dirty(snode)
                else:
                    c.add_write()
                    self.op_clock[server] += cfg.t_rdma_write
        # leaf write itself
        leaf = self.tree.search_path(key)[-1]
        shared = self._is_shared(leaf)
        if cfg.logical_partitioning and not shared:
            if cfg.caching and not cfg.write_through and leaf in cache:
                cache.mark_dirty(leaf)
            else:
                c.add_write()
                # write-through + pipelined: the insert's leaf write rides
                # the overlapped fused round like an update's (latency off
                # the critical path, verb still counted)
                if not (cfg.write_through and cfg.pipeline_overlap):
                    self.op_clock[server] += cfg.t_rdma_write
                if cfg.write_through:
                    # an insert shifts the leaf's key set: the writer drops
                    # its own copy, siblings' copies go stale
                    self._write_coherence(server, leaf, drop_self=True)
        else:
            self._shared_write(server)

    def _op_delete(self, server: int, key: int) -> None:
        self._op_update(server, key)  # same remote-verb profile as update
        self.tree.delete(key)

    def _op_scan(self, server: int, key: int, count: int) -> None:
        """Fence-key-subdivided scan (§7 Range Query): repeated lookups, no
        offloading."""
        cfg = self.cfg
        cache = self.caches[server]
        c = self.counters[server]
        hops = self.tree.scan(key, count)
        if cfg.single_record_leaves:
            # SMART-like: every record is its own leaf -> one remote read per
            # record (minus cache hits on the radix path, approximated by the
            # inner-node hit rate)
            total = sum(len(ks) for _, ks in hops)
            for _ in range(total):
                c.add_read()
                self.op_clock[server] += cfg.t_rdma_read
            return
        first = True
        for leaf, _ks in hops:
            # each hop is a fresh root-to-leaf traversal; offloading disabled
            # and no group-EMA observations (scans leave the mesh EMA alone)
            save = self.cfg.offloading
            self.cfg.offloading = False
            self._group_obs_off = True
            self._traverse(server, int(self.tree.K[leaf, 0]) if not first else key,
                           for_write=False, peek_ok=False, rt_ok=False)
            self._group_obs_off = False
            self.cfg.offloading = save
            first = False
            self.op_clock[server] += cfg.t_local_search

    # -- reporting ---------------------------------------------------------------

    def totals(self) -> Counters:
        out = Counters()
        for c in self.counters:
            out.ops += c.ops
            out.rdma_read += c.rdma_read
            out.rdma_small_read += c.rdma_small_read
            out.rdma_write += c.rdma_write
            out.rdma_cas += c.rdma_cas
            out.two_sided += c.two_sided
            out.bytes += c.bytes
            out.local_accesses += c.local_accesses
            out.offload_fallbacks += c.offload_fallbacks
            out.coherence_invalidations += c.coherence_invalidations
            out.smo_inserts += c.smo_inserts
            out.offload_groups += c.offload_groups
            out.fetch_groups += c.fetch_groups
            out.pipeline_stalls += c.pipeline_stalls
            out.peer_hits += c.peer_hits
            out.peer_misses += c.peer_misses
            out.rt_skips += c.rt_skips
            out.rt_mispredicts += c.rt_mispredicts
        return out

    def cache_stats(self):
        return [c.stats for c in self.caches]

    def repartition(self, new_parts: LogicalPartitions) -> Dict[str, float]:
        """Logical repartitioning (§4, Fig. 10): flush dirty pages, adjust
        boundaries, drop caches of moved ranges.  Returns cost summary."""
        new_parts = self._snap_to_leaf_fences(new_parts)
        flushed = 0
        for cache in self.caches:
            flushed += cache.flush_dirty()
        moved = self.partitions.assignment_diff(new_parts)
        self.partitions = new_parts
        # moved ranges must re-warm: invalidate everything for simplicity
        for cache in self.caches:
            cache.drop_all()
        # the route table follows the caches: a boundary install bumps the
        # moved leaves' versions on the mesh, so conservatively drop every
        # entry here (the mesh controller retrains right after an install;
        # callers mirror that with train_route_table())
        self._rt_lo = self._rt_lo[:0]
        self._rt_hi = self._rt_hi[:0]
        self._rt_leaf = self._rt_leaf[:0]
        self._rt_dirty = set()
        flush_time = flushed * (NODE_BYTES / 12.5e9 + 2e-6)  # 100Gbps + per-op
        return {
            "dirty_pages_flushed": float(flushed),
            "flush_seconds_single_thread": float(flush_time),
            "fraction_keyspace_moved": float(moved),
        }
