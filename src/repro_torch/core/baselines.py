"""Competitor presets (paper §2.3, §8): Sherman, SMART, their partitioned
variants, the naive RDMA B+-tree, and the Offload-only policy.

Each preset is a :class:`~repro_torch.core.sim.SimConfig` driving the same
mechanistic simulator, so the *only* differences are the protocol decisions
each system makes — mirroring how the paper isolates design choices.

Modeling notes (recorded per DESIGN.md §2.1):
  * Sherman/SMART are shared-everything: every node access pays RDMA-based
    optimistic synchronization (version+node+version reads) and leaf writes
    take RDMA CAS locks with immediate write-back.
  * Neither caches leaf nodes (their key trade-off, §2.3), so every op pays
    >= 1 remote read even with an infinite cache.
  * SMART is a trie with one record per "leaf": range scans degrade to one
    remote read per record (the 56.3x scan gap), its cache uses a
    centralized FIFO + counter (the Fig. 4/9 contention collapse), and its
    write-combining consolidates concurrent leaf writes (~8x fewer WRITEs,
    Table 2: 0.11 vs 0.99).
  * P-variants add DEX's logical partitioning only (the paper enables it for
    them "to better understand its benefits").
  * Offload-only caches nodes above level M and always pushes down (Fig. 5).
"""

from __future__ import annotations

from repro_torch.core.sim import SimConfig


def dex(**kw) -> SimConfig:
    return SimConfig(name="dex", **kw)


def dex_cache_only(**kw) -> SimConfig:
    """DEX without opportunistic offloading (ablation middle bar, Fig. 8)."""
    return SimConfig(name="dex-cache", offloading=False, **kw)


def dex_write_through(**kw) -> SimConfig:
    """DEX with write-through leaf writes and no offloading: the exact
    protocol the mesh plane's write path (core/write.py) implements, used
    for counter-level cross-validation (benchmarks/fig6_mesh_mixed.py)."""
    return SimConfig(
        name="dex-wt", offloading=False, write_through=True, **kw
    )


def dex_partition_only(**kw) -> SimConfig:
    """Logical partitioning alone (ablation second bar, Fig. 8)."""
    return SimConfig(name="dex-partition", caching=False, offloading=False, **kw)


def naive_rdma_btree(**kw) -> SimConfig:
    """Baseline B+-tree of §2.2: no partitioning, no cache, no offloading;
    every node is fetched with RDMA optimistic reads."""
    return SimConfig(
        name="naive",
        logical_partitioning=False,
        caching=False,
        offloading=False,
        rdma_optimistic_reads=True,
        **kw,
    )


def sherman_like(**kw) -> SimConfig:
    return SimConfig(
        name="sherman",
        logical_partitioning=False,
        caching=True,
        cache_leaves=False,
        cache_top_inner_only=True,
        eager_admission=True,
        offloading=False,
        rdma_optimistic_reads=True,
        **kw,
    )


def p_sherman(**kw) -> SimConfig:
    """Sherman + DEX's logical partitioning: non-shared accesses skip the
    RDMA optimistic-read verification and leaf writes skip the lock."""
    return SimConfig(
        name="p-sherman",
        logical_partitioning=True,
        caching=True,
        cache_leaves=False,
        cache_top_inner_only=True,
        eager_admission=True,
        offloading=False,
        rdma_optimistic_reads=False,
        **kw,
    )


def smart_like(**kw) -> SimConfig:
    return SimConfig(
        name="smart",
        logical_partitioning=False,
        caching=True,
        cache_leaves=False,
        eager_admission=True,
        centralized_fifo=True,
        single_record_leaves=True,
        write_combining=True,
        offloading=False,
        rdma_optimistic_reads=True,
        **kw,
    )


def p_smart(**kw) -> SimConfig:
    return SimConfig(
        name="p-smart",
        logical_partitioning=True,
        caching=True,
        cache_leaves=False,
        eager_admission=True,
        centralized_fifo=True,
        single_record_leaves=True,
        write_combining=True,
        offloading=False,
        rdma_optimistic_reads=False,
        **kw,
    )


def offload_only(**kw) -> SimConfig:
    """Cache levels > M, always push the rest down (Fig. 5 'Offload-only')."""
    return SimConfig(
        name="offload-only",
        caching=True,
        cache_leaves=False,
        cache_above_m_only=True,
        offloading=True,
        offload_always=True,
        **kw,
    )


ALL = {
    "dex": dex,
    "dex-cache": dex_cache_only,
    "dex-wt": dex_write_through,
    "dex-partition": dex_partition_only,
    "naive": naive_rdma_btree,
    "sherman": sherman_like,
    "p-sherman": p_sherman,
    "smart": smart_like,
    "p-smart": p_smart,
    "offload-only": offload_only,
}
