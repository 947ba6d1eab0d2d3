"""Compute-side caching (paper §5), event-level implementation (Plane A).

Implements the paper's cache machinery faithfully, per node, with statistics
for RDMA accounting and for the contention cost model:

  * mapping table: node id -> frame state (HOT / COOLING / IO) (§5.1)
  * pointer swizzling bookkeeping (parents know which children are cached)
  * cooling map: hash table of CPU-cacheline-sized FIFO arrays (§5.2);
    ``n_buckets=1`` degenerates to the centralized FIFO-queue baseline that
    Fig. 4/9 show cannot scale
  * path-aware cooling with delegation to the deepest swizzled child (§5.3)
  * selective/lazy admission: leaves with probability P_A, inner always,
    and a child is only admitted if its parent is cached (§5.4)
  * second chance: touching a COOLING node restores it to HOT (§5.1)

The mesh-plane cache (core/fleet_cache.py) keeps the same *idea* —
hash-distributed FIFO buckets == set-associative FIFO ways — in vectorized
form, and derives its integer admission percent from this module's
``DEFAULT_P_ADMIT_LEAF`` (the single source of truth for the paper's P_A).
Per-server divergent admission (``admit_bias``) mirrors that module's
``CachePolicy.admit_bias`` so the two planes' fleet-cache counters stay
drift-comparable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set

import numpy as np

HOT = 1
COOLING = 2
IO = 3

#: paper: each 64-byte bucket holds six FIFO slots
BUCKET_SLOTS = 6
#: paper: cooling map capacity is 10% of the cache
COOLING_FRACTION = 0.10
#: paper §5.4: default leaf admission probability
DEFAULT_P_ADMIT_LEAF = 0.10


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    second_chance_hits: int = 0
    misses: int = 0
    admissions: int = 0
    rejected_admissions: int = 0
    evictions: int = 0
    writebacks: int = 0          # dirty-page RDMA WRITEs caused by cooling/eviction
    cooling_ops: int = 0
    delegations: int = 0
    bucket_lock_acquires: int = 0     # critical sections on cooling structures
    mapping_ops: int = 0              # mapping-table critical sections
    io_flag_restarts: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class CoolingMap:
    """Hash table of fixed-size FIFO arrays (paper Fig. 3).

    Every mutation acquires exactly one bucket lock; with ``n_buckets == 1``
    this is the centralized FIFO-list baseline.  ``bucket_lock_acquires`` per
    bucket feed the contention model in ``cost_model.py``.
    """

    def __init__(self, n_buckets: int, slots: int = BUCKET_SLOTS):
        assert n_buckets >= 1
        self.n_buckets = n_buckets
        self.slots = slots
        self.buckets: List[List[int]] = [[] for _ in range(n_buckets)]
        self.where: Dict[int, int] = {}  # node -> bucket
        self.lock_acquires = np.zeros((n_buckets,), dtype=np.int64)

    def __len__(self) -> int:
        return len(self.where)

    def _bucket_of(self, node: int) -> int:
        # Fibonacci hash of node id
        return int((node * 11400714819323198485) % (2**64)) % self.n_buckets

    def insert(self, node: int) -> Optional[int]:
        """FIFO-insert ``node``; returns the evicted head if the bucket was
        full (that page leaves the cache; paper §5.2)."""
        b = self._bucket_of(node)
        self.lock_acquires[b] += 1
        bucket = self.buckets[b]
        evicted = None
        if len(bucket) >= self.slots:
            evicted = bucket.pop(0)
            del self.where[evicted]
        bucket.append(node)
        self.where[node] = b
        return evicted

    def remove(self, node: int) -> bool:
        """Second-chance restore: pull a node back out of cooling."""
        b = self.where.pop(node, None)
        if b is None:
            return False
        self.lock_acquires[b] += 1
        self.buckets[b].remove(node)
        return True

    def pop_any(self, rng: np.random.Generator) -> Optional[int]:
        """Evict the oldest page of a random non-empty bucket (free-page
        provisioning, §5.4)."""
        if not self.where:
            return None
        non_empty = [i for i, b in enumerate(self.buckets) if b]
        b = int(rng.choice(non_empty))
        self.lock_acquires[b] += 1
        node = self.buckets[b].pop(0)
        del self.where[node]
        return node


class ComputeCache:
    """Per-compute-server node cache (Plane A).

    The simulator (core/sim.py) supplies tree topology callbacks so the cache
    can do path-aware delegation and swizzling bookkeeping without owning
    the tree:

      * ``parent_of(node) -> node | -1``
      * ``is_leaf(node) -> bool``
    """

    def __init__(
        self,
        capacity: int,
        *,
        parent_of: Callable[[int], int],
        is_leaf: Callable[[int], bool],
        p_admit_leaf: float = DEFAULT_P_ADMIT_LEAF,
        n_cooling_buckets: Optional[int] = None,
        cooling_slots: int = BUCKET_SLOTS,
        eager_admission: bool = False,
        rng: Optional[np.random.Generator] = None,
        admit_bias: Optional[Callable[[int], float]] = None,
    ):
        assert capacity >= 4
        self.capacity = capacity
        self.parent_of = parent_of
        self.is_leaf = is_leaf
        self.p_admit_leaf = 1.0 if eager_admission else p_admit_leaf
        # divergent fleet policy (core/fleet_cache.py CachePolicy.admit_bias
        # mirror): per-node multiplier on the leaf-admission probability;
        # None keeps the uniform §5.4 dice exactly
        self.admit_bias = admit_bias
        if n_cooling_buckets is None:
            n_cooling_buckets = max(
                1, int(capacity * COOLING_FRACTION / cooling_slots)
            )
        self.cooling = CoolingMap(n_cooling_buckets, cooling_slots)
        self.rng = rng or np.random.default_rng(0)
        self.stats = CacheStats()

        self.state: Dict[int, int] = {}          # node -> HOT/COOLING/IO
        self.dirty: Set[int] = set()
        self.pinned: Set[int] = set()
        self.swizzled_children: Dict[int, Set[int]] = {}
        self.free = capacity

    # -- basic queries -------------------------------------------------------

    def __contains__(self, node: int) -> bool:
        return self.state.get(node) in (HOT, COOLING)

    def num_cached(self) -> int:
        return self.capacity - self.free

    def is_dirty(self, node: int) -> bool:
        return node in self.dirty

    # -- mapping-table access (Algorithm 1 cache.lookup) ----------------------

    def lookup(self, node: int) -> str:
        """Probe the mapping table.  Returns 'hit', 'io' (restart from root),
        or 'miss'."""
        self.stats.mapping_ops += 1
        st = self.state.get(node)
        if st == HOT:
            self.stats.hits += 1
            return "hit"
        if st == COOLING:
            # second chance: restore to HOT, re-swizzle in parent
            self.cooling.remove(node)
            self.state[node] = HOT
            p = self.parent_of(node)
            if p >= 0 and p in self:
                self.swizzled_children.setdefault(p, set()).add(node)
            self.stats.second_chance_hits += 1
            self.stats.hits += 1
            return "hit"
        if st == IO:
            self.stats.io_flag_restarts += 1
            return "io"
        self.stats.misses += 1
        return "miss"

    # -- admission (§5.4) ------------------------------------------------------

    def admit(self, node: int, *, dirty: bool = False,
              ignore_parent: bool = False) -> bool:
        """Try to admit a freshly fetched node.  Returns True if cached.

        Applies (1) path-aware admission — parent must already be cached
        (root has no parent, always admissible); (2) lazy admission for
        leaves with probability P_A; (3) free-page provisioning through the
        cooling map.

        ``ignore_parent`` waives check (1) for leaves reached through the
        leaf-direct route table (core/sim.py): the table entry stands in
        for the cached ancestor path, matching the mesh fleet cache's
        dice-only leaf admission (core/fleet_cache.py ``leaf_admit``).
        """
        if node in self:
            if dirty:
                self.dirty.add(node)
            return True
        parent = self.parent_of(node)
        if not ignore_parent and parent >= 0 and parent not in self:
            self.stats.rejected_admissions += 1
            return False
        if self.is_leaf(node):
            p = self.p_admit_leaf
            if self.admit_bias is not None:
                p = min(1.0, p * self.admit_bias(node))
            if self.rng.random() > p:
                self.stats.rejected_admissions += 1
                return False

        if self.free <= 0 and not self._provision_free_page():
            self.stats.rejected_admissions += 1
            return False

        # mark I/O while "fetching" (concurrency bookkeeping), then admit
        self.stats.mapping_ops += 1
        self.state[node] = HOT
        self.free -= 1
        if dirty:
            self.dirty.add(node)
        if parent >= 0 and parent in self:
            self.swizzled_children.setdefault(parent, set()).add(node)
        self.stats.admissions += 1
        # keep the cooling map stocked (background sampling in LeanStore;
        # worker-driven here, per the paper)
        self._maybe_sample_cooling()
        return True

    # -- cooling & eviction (§5.2, §5.3) --------------------------------------

    def _maybe_sample_cooling(self) -> None:
        target = max(1, int(self.capacity * COOLING_FRACTION))
        # sampling only starts when free frames run low (paper §5.1: a thread
        # samples when its free-page set is empty); a mostly-empty cache must
        # not cool fresh admissions
        if self.free > target:
            return
        tries = 0
        while len(self.cooling) < target and tries < 2:
            tries += 1
            victim = self._sample_hot_node()
            if victim is None:
                return
            self._cool(victim)

    def _sample_hot_node(self) -> Optional[int]:
        hot = [n for n, s in self.state.items() if s == HOT and n not in self.pinned]
        if not hot:
            return None
        # random sampling of two; prefer non-root-ish nodes implicitly via
        # path-aware delegation afterwards
        pick = self.rng.choice(len(hot), size=min(2, len(hot)), replace=False)
        return int(hot[int(pick[0])])

    def _cool(self, node: int) -> None:
        """Transition ``node`` toward COOLING with path-aware delegation: the
        cooling command is recursively delegated to a swizzled child so a
        cached path stays contiguous from the root (§5.3)."""
        self.stats.cooling_ops += 1
        cur = node
        while True:
            kids = self.swizzled_children.get(cur)
            live = [k for k in kids if k in self and self.state.get(k) == HOT] if kids else []
            if not live:
                break
            self.stats.delegations += 1
            cur = int(self.rng.choice(live))
        if self.state.get(cur) != HOT or cur in self.pinned:
            return
        # proactively unswizzle from parent, write back if dirty
        p = self.parent_of(cur)
        if p >= 0 and p in self.swizzled_children:
            self.swizzled_children[p].discard(cur)
        if cur in self.dirty:
            self.dirty.discard(cur)
            self.stats.writebacks += 1
        self.state[cur] = COOLING
        evicted = self.cooling.insert(cur)
        if evicted is not None:
            self._finish_eviction(evicted)

    def _provision_free_page(self) -> bool:
        """Get a free frame by evicting the oldest page of a random cooling
        bucket; sample hot pages into cooling first if the map ran dry."""
        if not len(self.cooling):
            victim = self._sample_hot_node()
            if victim is None:
                return False
            self._cool(victim)
        node = self.cooling.pop_any(self.rng)
        if node is None:
            return False
        self._finish_eviction(node)
        return True

    def _finish_eviction(self, node: int) -> None:
        if self.state.get(node) != COOLING:
            # raced back to HOT via second chance; nothing to evict
            return
        del self.state[node]
        self.swizzled_children.pop(node, None)
        if node in self.dirty:  # defensive: cooling already wrote back
            self.dirty.discard(node)
            self.stats.writebacks += 1
        self.free += 1
        self.stats.evictions += 1

    # -- dirty handling / pinning (offloading + repartition support) ----------

    def mark_dirty(self, node: int) -> None:
        if node in self:
            self.dirty.add(node)

    def pin(self, node: int) -> None:
        self.pinned.add(node)

    def unpin(self, node: int) -> None:
        self.pinned.discard(node)

    def set_io(self, node: int) -> None:
        """Mark an in-progress fetch/offload (Algorithm fig.3 ②, §6.2)."""
        self.stats.mapping_ops += 1
        self.state[node] = IO

    def clear_io(self, node: int) -> None:
        if self.state.get(node) == IO:
            del self.state[node]

    def invalidate(self, node: int) -> bool:
        """Drop a (possibly stale) node; returns True if it was cached.
        Used for coherence after offloaded updates (§6.2) and fence-key
        mismatch refreshes (§4)."""
        st = self.state.get(node)
        if st is None:
            return False
        if st == COOLING:
            self.cooling.remove(node)
        p = self.parent_of(node)
        if p >= 0 and p in self.swizzled_children:
            self.swizzled_children[p].discard(node)
        if st in (HOT, COOLING):
            self.free += 1
        del self.state[node]
        self.dirty.discard(node)
        self.swizzled_children.pop(node, None)
        return True

    def flush_dirty(self) -> int:
        """Write back every dirty page (logical repartitioning, Fig. 10).
        Returns the number of pages flushed."""
        n = len(self.dirty)
        self.stats.writebacks += n
        self.dirty.clear()
        return n

    def drop_all(self) -> None:
        """Full reset (after repartition hand-off the new owner re-warms)."""
        self.state.clear()
        self.dirty.clear()
        self.pinned.clear()
        self.swizzled_children.clear()
        self.cooling = CoolingMap(self.cooling.n_buckets, self.cooling.slots)
        self.free = self.capacity
