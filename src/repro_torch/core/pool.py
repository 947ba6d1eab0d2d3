"""Subtree-blocked memory pool: the paper's level-M placement.

Every subtree rooted at level M is one block of ``subtree_cap`` node rows;
the pool is ``[n_subtrees, subtree_cap, FANOUT]`` keys, children and values,
and the levels above M (the top tree) are replicated.  Local node ids inside
a block are level-ordered (root = 0), so the owner-side walk never leaves
its block.  The last ``subtree_cap - base_cap`` rows of each block are
free-list headroom for on-mesh splits.  ``SepPlanes`` are the rows'
prefix-compressed separators (``compress_separators``).

``build_pool`` builds the same arrays as ``repro.core.pool.build_pool``,
vectorised over subtrees so that it runs on the card at full scale.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mesh import refuse_on_ranks, resolve_device
from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN, NULL
from repro_torch.kernels import ops
from repro_torch.kernels.ref import subtree_walk_ref as _walk_ref


class SubtreePool(NamedTuple):
    """Pool arrays.  ``top_*`` are replicated; ``pool_*`` shard on axis 0
    over the memory columns."""

    top_keys: torch.Tensor  # [T, FANOUT] int64, root last
    top_children: torch.Tensor  # [T, FANOUT] int32; subtree ids at level M+1
    pool_keys: torch.Tensor  # [S, C, FANOUT] int64
    pool_children: torch.Tensor  # [S, C, FANOUT] int32 (block-local ids)
    pool_values: torch.Tensor  # [S, C, FANOUT] int64 (leaf payloads)


@dataclasses.dataclass(frozen=True)
class PoolMeta:
    level_m: int  # subtree root level (0 = leaves only)
    per_node: int  # fill-factor entries per node at build
    subtree_cap: int  # nodes per subtree block (incl. headroom)
    n_subtrees: int  # real subtrees (<= padded S)
    n_subtrees_padded: int
    top_height: int  # levels above M
    n_keys: int
    leaf_start: int  # local id of the first leaf within a block
    base_cap: int = 0  # nodes per block used by the bulk layout
    subtree_leaves: int = 0  # leaves per block at build

    @property
    def leaves_per_subtree(self) -> int:
        return self.subtree_leaves or self.per_node**self.level_m

    @property
    def levels_in_subtree(self) -> int:
        return self.level_m + 1

    @property
    def min_leaf_fill(self) -> int:
        """Fewest keys a leaf that is not the last can hold: bulk-built
        leaves carry ``per_node`` keys, and an on-mesh split leaves each half
        at least ``FANOUT // 2`` (``core/smo.py`` splits only rows that
        overflow)."""
        return min(self.per_node, FANOUT // 2)

    @property
    def n_nodes(self) -> int:
        return self.n_subtrees_padded * self.subtree_cap

    @property
    def headroom_frac(self) -> float:
        """Free-list fraction this pool was built with (for rebuilds)."""
        if self.base_cap <= 0:
            return 0.0
        return (self.subtree_cap - self.base_cap) / self.base_cap

    def node_gid(self, subtree: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
        """Global node id (int64), the cache tag."""
        return subtree.long() * self.subtree_cap + local


def _level_offsets(per_node: int, level_m: int, subtree_leaves: int) -> np.ndarray:
    """Local-id offset of each block level: level M at 0, leaves last."""
    counts = [subtree_leaves]
    for _ in range(level_m):
        counts.append(-(-counts[-1] // per_node))
    counts[-1] = 1
    return np.concatenate([[0], np.cumsum(counts[::-1])]).astype(np.int64)


DEFAULT_HEADROOM = 0.5


def _pad_last(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    """``x`` padded with ``fill`` to ``width`` along the last axis (exact for
    int64 fills, unlike ``torch.nn.functional.pad``)."""
    out = torch.full(x.shape[:-1] + (width,), fill, dtype=x.dtype, device=x.device)
    out[..., : x.shape[-1]] = x
    return out


def _rows(mins: torch.Tensor, refs: torch.Tensor, valid: torch.Tensor, per_node):
    """Group ``[..., n]`` child minima and ids into rows of ``per_node``
    entries: ``([..., n_rows, per_node] keys, [..., n_rows, per_node] ids)``
    with KEY_MAX / NULL where ``valid`` is False."""
    n = mins.shape[-1]
    n_rows = -(-n // per_node)
    k = _pad_last(torch.where(valid, mins, KEY_MAX), n_rows * per_node, KEY_MAX)
    c = _pad_last(torch.where(valid, refs, NULL), n_rows * per_node, NULL)
    shape = mins.shape[:-1] + (n_rows, per_node)
    return k.reshape(shape), c.reshape(shape).to(torch.int32)


def build_pool(
    keys,
    values=None,
    *,
    level_m: int = 1,
    fill: float = 0.7,
    n_shards: int = 1,
    headroom: float = DEFAULT_HEADROOM,
    subtree_leaves: Optional[int] = None,
    columns: Optional[Tuple[int, int]] = None,
    device=None,
) -> Tuple[SubtreePool, PoolMeta]:
    """Bulk-build the blocked pool from sorted unique int64 keys (numpy or
    torch) on ``device``.  ``n_shards`` pads the subtree axis to a multiple of
    the memory columns; ``headroom`` adds free-list rows per block;
    ``subtree_leaves`` sets leaves per block (default ``per_node**level_m``).

    ``columns = (first, count)`` keeps the ``pool_*`` rows of those memory
    columns only (of ``n_shards``), as a rank of ``core/mesh.py``'s rank
    backend holds them: the other columns' blocks are never built, and the
    rows kept equal the same rows of the whole build.  The top tree and
    ``meta`` are the whole index's."""
    device = resolve_device(device)
    keys = torch.as_tensor(keys, dtype=torch.int64).to(device)
    if keys.numel() == 0:
        raise ValueError("keys must not be empty")
    if bool((keys[1:] <= keys[:-1]).any()):
        raise ValueError("keys must be sorted and unique")
    values = keys.clone() if values is None else torch.as_tensor(values).to(device)
    values = values.to(torch.int64)
    if headroom < 0:
        raise ValueError(f"headroom must be >= 0, got {headroom!r}")

    per_node = max(2, int(FANOUT * fill))
    n = keys.numel()
    n_leaves = -(-n // per_node)
    if subtree_leaves is None:
        subtree_leaves = per_node**level_m
    if not (1 <= subtree_leaves <= per_node**level_m):
        raise ValueError(
            "subtree_leaves must be in [1, per_node**level_m], got "
            f"{subtree_leaves!r}"
        )
    lps = int(subtree_leaves)
    n_subtrees = -(-n_leaves // lps)
    S = -(-n_subtrees // n_shards) * n_shards
    offs = _level_offsets(per_node, level_m, lps)
    base_cap = int(offs[-1])
    cap = base_cap + int(np.ceil(base_cap * headroom))
    leaf_start = int(offs[-2])

    # the blocks built: rows s_lo .. s_hi of the whole pool
    s_lo, s_hi = 0, S
    if columns is not None:
        c0, n_cols = (int(c) for c in columns)
        if not (0 <= c0 and n_cols >= 1 and c0 + n_cols <= n_shards):
            raise ValueError(f"columns {columns!r} outside {n_shards} shards")
        s_per = S // n_shards
        s_lo, s_hi = c0 * s_per, (c0 + n_cols) * s_per
    n_rows = s_hi - s_lo

    i64 = dict(dtype=torch.int64, device=device)
    PK = torch.full((n_rows, cap, FANOUT), KEY_MAX, **i64)
    PC = torch.full((n_rows, cap, FANOUT), NULL, dtype=torch.int32, device=device)
    PV = torch.zeros((n_rows, cap, FANOUT), **i64)

    # leaves: global leaf g is row leaf_start + g % lps of block g // lps
    pad = n_leaves * per_node - n
    leaf_k = _pad_last(keys, n + pad, KEY_MAX)
    leaf_v = _pad_last(values, n + pad, 0)
    g_lo, g_hi = min(s_lo * lps, n_leaves), min(s_hi * lps, n_leaves)
    g = torch.arange(g_lo, g_hi, **i64)
    rows_k = leaf_k.view(n_leaves, per_node)[g_lo:g_hi]
    rows_v = leaf_v.view(n_leaves, per_node)[g_lo:g_hi]
    PK[g // lps - s_lo, leaf_start + g % lps, :per_node] = rows_k
    PV[g // lps - s_lo, leaf_start + g % lps, :per_node] = rows_v

    # inner block levels 1..M, bottom-up, all blocks at once: ``mins`` holds
    # each block's child minima, ``cnt`` how many children it really has
    leaf_mins = leaf_k[::per_node]
    mins = torch.full((n_rows * lps,), KEY_MAX, **i64)
    mins[: g_hi - g_lo] = leaf_mins[g_lo:g_hi]
    mins = mins.view(n_rows, lps)
    cnt = torch.clamp(n_leaves - torch.arange(s_lo, s_hi, **i64) * lps, 0, lps)
    subtree_mins = leaf_mins[::lps][:n_subtrees].clone()
    subtree_mins[0] = KEY_MIN
    child_off = leaf_start
    for lvl in range(1, level_m + 1):
        lvl_off = int(offs[level_m - lvl])
        j = torch.arange(mins.shape[1], **i64)
        valid = j[None, :] < cnt[:, None]
        rk, rc = _rows(mins, (child_off + j).expand_as(mins), valid, per_node)
        PK[:, lvl_off : lvl_off + rk.shape[1], :per_node] = rk
        PC[:, lvl_off : lvl_off + rk.shape[1], :per_node] = rc
        mins = rk[:, :, 0]
        cnt = -(-cnt // per_node)
        child_off = lvl_off

    # top tree over the subtree minima, level by level, root last
    top_k, top_c = [], []
    refs = torch.arange(n_subtrees, **i64)
    mins = subtree_mins
    while True:
        rk, rc = _rows(mins, refs, torch.ones_like(mins, dtype=torch.bool), per_node)
        n_rows = rk.shape[0]
        top_k.append(_pad_last(rk, FANOUT, KEY_MAX))
        top_c.append(_pad_last(rc, FANOUT, NULL))
        done = sum(t.shape[0] for t in top_k)
        refs = torch.arange(done - n_rows, done, **i64)
        mins = rk[:, 0]
        if n_rows == 1:
            break

    pool = SubtreePool(
        top_keys=torch.cat(top_k),
        top_children=torch.cat(top_c),
        pool_keys=PK,
        pool_children=PC,
        pool_values=PV,
    )
    meta = PoolMeta(
        level_m=level_m,
        per_node=per_node,
        subtree_cap=cap,
        n_subtrees=n_subtrees,
        n_subtrees_padded=S,
        top_height=len(top_k),
        n_keys=n,
        leaf_start=leaf_start,
        base_cap=base_cap,
        subtree_leaves=lps,
    )
    return pool, meta


def initial_succ(meta: PoolMeta, device=None) -> torch.Tensor:
    """Leaf successor table over the bulk layout: ``succ[gid]`` is the next
    leaf's global node id in key order (-1 ends the chain and marks
    non-leaf slots)."""
    device = resolve_device(device)
    succ = torch.full((meta.n_nodes,), -1, dtype=torch.int64, device=device)
    n_leaves = -(-meta.n_keys // meta.per_node)
    lps = meta.leaves_per_subtree
    g = torch.arange(n_leaves, dtype=torch.int64, device=device)
    gid = (g // lps) * meta.subtree_cap + meta.leaf_start + (g % lps)
    succ[gid[:-1]] = gid[1:]
    return succ


# ---------------------------------------------------------------------------
# Prefix-compressed separators
# ---------------------------------------------------------------------------

#: Suffixes keep at most 30 low bits, so they fit a non-negative int32 with
#: room for a padding sentinel above every real value.
SEP_MAX_NBITS = 30
SEP_SUFFIX_SENTINEL = 0x7FFFFFFF
# 2**0 .. 2**30: the bit length of x in [0, 2**30) is how many are <= x
_POW2 = [1 << i for i in range(SEP_MAX_NBITS + 1)]
# rows compressed at a time (bounds the [rows, FANOUT] temporaries)
_COMPRESS_CHUNK = 1 << 20


class SepPlanes(NamedTuple):
    """Prefix-compressed separator planes of the pool's node rows.

    A row's keys share their high bits, so each row stores one 8-byte
    ``prefix`` (its low ``nbits`` zeroed), the retained bit count ``nbits``
    and FANOUT 4-byte ``suffix``es: 8 + 4 + 4 * FANOUT bytes against the
    canonical 8 * FANOUT.  ``nbits = -1`` marks a row whose span needs more
    than ``SEP_MAX_NBITS`` bits (the ``node_search_prefix`` kernel reads the
    canonical row there).  Padding suffixes hold ``SEP_SUFFIX_SENTINEL``,
    above every real suffix; an empty row has ``nbits = 0``."""

    prefix: torch.Tensor  # [S, C] int64 shared high bits (low nbits zeroed)
    nbits: torch.Tensor  # [S, C] int32 retained low bits; -1 = incompressible
    suffix: torch.Tensor  # [S, C, FANOUT] int32 truncated separators


def _compress_chunk(keys: torch.Tensor):
    real = keys != KEY_MAX
    any_real = real.any(1)
    lo = torch.where(any_real, torch.where(real, keys, KEY_MAX).amin(1), 0)
    hi = torch.where(any_real, torch.where(real, keys, KEY_MIN).amax(1), 0)
    # the keys differ only below the bit length of the extremes' xor; a
    # negative xor (a span across the sign bit) counts all 64 bits
    x = lo ^ hi
    good = any_real & (x >= 0) & (x < (1 << SEP_MAX_NBITS))
    pow2 = torch.tensor(_POW2, dtype=torch.int64, device=keys.device)
    bits = torch.searchsorted(pow2, x, right=True)
    nbits = torch.where(any_real, torch.where(good, bits, -1), 0)
    one = torch.ones_like(x)
    mask = torch.where(good, torch.bitwise_left_shift(one, nbits.clamp(min=0)) - 1, 0)
    prefix = torch.where(good, lo & ~mask, 0)
    suffix = torch.where(
        real & good[:, None], keys & mask[:, None], SEP_SUFFIX_SENTINEL
    )
    return prefix, nbits.to(torch.int32), suffix.to(torch.int32)


def compress_rows(keys: torch.Tensor):
    """Compress ``[N, FANOUT]`` int64 separator rows (KEY_MAX padding) into
    ``(prefix [N] int64, nbits [N] int32, suffix [N, FANOUT] int32)``.

    A row keeps the bit length of ``min ^ max`` over its real keys (every
    key between them shares the bits above), when that is at most
    ``SEP_MAX_NBITS``; the bit length comes from a table of powers of two,
    exact there, so no row takes a host loop.  Equals
    ``repro.core.pool.compress_rows``."""
    parts = [
        _compress_chunk(keys[i : i + _COMPRESS_CHUNK])
        for i in range(0, keys.shape[0], _COMPRESS_CHUNK)
    ]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p) for p in zip(*parts))


def compress_separators(pool: SubtreePool, meta: PoolMeta) -> SepPlanes:
    """The compressed planes of every pool row, built on the pool's device
    (``core/smo.py::refresh_sep_planes`` keeps them current across on-mesh
    splits)."""
    refuse_on_ranks("compress_separators, the separator planes", 3)
    s, c, f = pool.pool_keys.shape
    prefix, nbits, suffix = compress_rows(pool.pool_keys.view(s * c, f))
    return SepPlanes(
        prefix=prefix.view(s, c), nbits=nbits.view(s, c), suffix=suffix.view(s, c, f)
    )


def sep_compression_stats(sep: SepPlanes, meta: PoolMeta) -> dict:
    """Byte and fanout accounting of the compressed layout, as
    ``repro.core.pool.sep_compression_stats``: ``effective_fanout`` is how
    many separators a canonical row's bytes hold under the compressed
    layout; ``modeled_subtree_depth`` the in-subtree depth that fanout would
    need for the same leaves."""
    nbits = sep.nbits.reshape(-1)
    f = sep.suffix.shape[-1]
    occupied = (sep.suffix != SEP_SUFFIX_SENTINEL).any(-1).reshape(-1)
    kept = occupied & (nbits >= 0)
    n_rows = int(occupied.sum())
    compressible = int(kept.sum())
    canon_bytes = 8 * f
    comp_bytes = 8 + 4 + 4 * f
    eff_fanout = f * canon_bytes / comp_bytes
    leaves = max(meta.leaves_per_subtree, 1)
    modeled_depth = int(np.ceil(np.log(max(leaves, 2)) / np.log(eff_fanout)))
    # an integer sum is exact, as numpy's float64 mean of int32 is here
    nb_sum = int(torch.where(kept, nbits, 0).sum())
    return {
        "rows": n_rows,
        "compressible_rows": compressible,
        "compressible_frac": compressible / max(n_rows, 1),
        "mean_nbits": nb_sum / compressible if compressible else 0.0,
        "canonical_row_bytes": canon_bytes,
        "compressed_row_bytes": comp_bytes,
        "effective_fanout": eff_fanout,
        "modeled_subtree_depth": modeled_depth,
        "baseline_subtree_depth": meta.level_m,
    }


def top_walk(pool: SubtreePool, meta: PoolMeta, queries: torch.Tensor) -> torch.Tensor:
    """Walk the replicated top tree with the ``node_search`` kernel; returns
    the subtree id (int64) per query."""
    b = queries.shape[0]
    nodes = torch.full(
        (b,), pool.top_keys.shape[0] - 1, dtype=torch.int64, device=queries.device
    )
    for _ in range(meta.top_height):
        slot, _, _ = ops.node_search(pool.top_keys[nodes], queries)
        nodes = pool.top_children[nodes, slot.long()].long()
    return nodes


def subtree_walk_ref(block_keys, block_children, block_values, queries, *, levels):
    """Walk one subtree block ``[C, FANOUT]`` from its root for a batch of
    queries; plain oracle of the ``subtree_walk`` kernel with ``S = 1``.
    Returns ``(found, values)``."""
    zero = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    return _walk_ref(
        block_keys[None],
        block_children[None],
        block_values[None],
        zero,
        queries,
        levels=levels,
    )[:2]


def pool_lookup_ref(pool: SubtreePool, meta: PoolMeta, queries: torch.Tensor):
    """Single-device plain lookup over the blocked layout (no mesh)."""
    st = top_walk(pool, meta, queries)
    return _walk_ref(
        pool.pool_keys,
        pool.pool_children,
        pool.pool_values,
        st.to(torch.int32),
        queries,
        levels=meta.levels_in_subtree,
    )[:2]
