"""Flat array B+-tree: bulk build on the host, batched operations on the
device.  The serving page table (``serve/kv_cache.py``) is one of these.

The same arrays as ``repro.core.btree``, op for op:

* ``bulk_build`` builds on the host in numpy and moves the arrays to the
  device;
* traversal is level-synchronous: a batch advances one level per step, and
  every level's in-node search is the ``node_search`` kernel (the reference
  inlines the same lower bound as ``_search_slot``);
* ``batch_insert`` applies the inserts that fit in leaf slack on the device
  (``_insert_fast_path``) and sends the keys of leaves that would overflow
  to a host rebuild (``_host_insert_with_splits``), which replaces every
  array of the tree;
* ``bulk_delete`` removes keys and compacts each touched leaf row;
* ``bulk_update`` sets the values of existing keys, and ``bulk_scan`` reads
  up to ``count`` records from each start key, leaf by leaf through the
  fence keys.

Every vectorised mutation routes inactive lanes to the scratch row
``capacity - 1`` with that row's own contents, so duplicate scatter indices
only ever write equal values.  The operations are functional: they return a
new tree and leave the old one as it was.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mesh import resolve_device
from repro_torch.core.nodes import (
    DEFAULT_FILL,
    FANOUT,
    KEY_MAX,
    KEY_MIN,
    NULL,
    TreeArrays,
    TreeMeta,
)
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# bulk build (host side, numpy)
# ---------------------------------------------------------------------------


def bulk_build(
    keys: np.ndarray,
    values: Optional[np.ndarray] = None,
    *,
    fill: float = DEFAULT_FILL,
    capacity_slack: float = 1.5,
    device=None,
) -> Tuple[TreeArrays, TreeMeta]:
    """Build a B+-tree from sorted unique int64 ``keys`` strictly inside
    (KEY_MIN, KEY_MAX), leaves loaded to ``fill``.  The arrays go to
    ``device`` (``None`` means CUDA)."""
    device = resolve_device(device)
    keys = np.asarray(keys, dtype=np.int64)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    if keys.size == 0:
        raise ValueError("cannot bulk build an empty tree")
    if np.any(keys[1:] <= keys[:-1]):
        raise ValueError("keys must be sorted and unique")
    if keys[0] <= KEY_MIN or keys[-1] >= KEY_MAX:
        raise ValueError("keys must be strictly inside (KEY_MIN, KEY_MAX)")
    if values is None:
        values = keys.copy()
    values = np.asarray(values, dtype=np.int64)
    if values.shape != keys.shape:
        raise ValueError("values must match keys")

    per_leaf = max(2, int(FANOUT * fill))
    n = keys.size
    n_leaves = -(-n // per_leaf)
    level_sizes = [n_leaves]
    while level_sizes[-1] > 1:
        level_sizes.append(-(-level_sizes[-1] // per_leaf))
    height = len(level_sizes)
    num_nodes = int(sum(level_sizes))
    capacity = max(num_nodes + 8, int(num_nodes * capacity_slack))

    K = np.full((capacity, FANOUT), KEY_MAX, dtype=np.int64)
    C = np.full((capacity, FANOUT), NULL, dtype=np.int32)
    V = np.zeros((capacity, FANOUT), dtype=np.int64)
    NK = np.zeros((capacity,), dtype=np.int32)
    LV = np.full((capacity,), -1, dtype=np.int32)
    FLO = np.full((capacity,), KEY_MIN, dtype=np.int64)
    FHI = np.full((capacity,), KEY_MAX, dtype=np.int64)

    # leaves
    pad = (-n) % per_leaf
    kp = np.concatenate([keys, np.full((pad,), KEY_MAX, np.int64)]).reshape(
        n_leaves, per_leaf
    )
    vp = np.concatenate([values, np.zeros((pad,), np.int64)]).reshape(
        n_leaves, per_leaf
    )
    K[:n_leaves, :per_leaf] = kp
    V[:n_leaves, :per_leaf] = vp
    NK[:n_leaves] = np.minimum(per_leaf, n - per_leaf * np.arange(n_leaves))
    LV[:n_leaves] = 0
    mins = kp[:, 0].copy()
    mins[0] = KEY_MIN
    FLO[:n_leaves] = mins
    FHI[: n_leaves - 1] = mins[1:]
    FHI[n_leaves - 1] = KEY_MAX

    # inner levels
    next_id = n_leaves
    child_ids = np.arange(n_leaves, dtype=np.int32)
    child_mins = mins
    for lvl in range(1, height):
        n_nodes = level_sizes[lvl]
        ids = np.arange(next_id, next_id + n_nodes, dtype=np.int32)
        next_id += n_nodes
        new_mins = np.empty((n_nodes,), dtype=np.int64)
        for i in range(n_nodes):
            ch = child_ids[i * per_leaf : (i + 1) * per_leaf]
            cm = child_mins[i * per_leaf : (i + 1) * per_leaf]
            nid = ids[i]
            K[nid, : cm.size] = cm
            C[nid, : ch.size] = ch
            NK[nid] = ch.size
            LV[nid] = lvl
            new_mins[i] = cm[0]
        FLO[ids] = new_mins
        FHI[ids[:-1]] = new_mins[1:]
        FHI[ids[-1]] = KEY_MAX
        child_ids, child_mins = ids, new_mins

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    tree = TreeArrays(
        keys=dev(K),
        children=dev(C),
        values=dev(V),
        num_keys=dev(NK),
        level=dev(LV),
        fence_lo=dev(FLO),
        fence_hi=dev(FHI),
        version=torch.zeros((capacity,), dtype=torch.int32, device=device),
        root=scalar(int(child_ids[0])),
        height=scalar(height),
        num_nodes=scalar(num_nodes),
    )
    meta = TreeMeta(
        height=height,
        num_nodes=num_nodes,
        num_leaves=n_leaves,
        capacity=capacity,
        keys_per_leaf=per_leaf,
    )
    return tree, meta


# ---------------------------------------------------------------------------
# batched point lookups
# ---------------------------------------------------------------------------


def _queries(tree: TreeArrays, x) -> torch.Tensor:
    """Keys (numpy, a sequence or a tensor) as a contiguous int64 tensor on
    the tree's device."""
    if isinstance(x, torch.Tensor):
        return x.to(tree.keys.device, torch.int64).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.int64)).to(tree.keys.device)


def bulk_lookup(
    tree: TreeArrays, queries, *, height: int, with_path: bool = False
):
    """Look up a batch of keys.  Returns ``(found, values)`` or, with
    ``with_path``, ``(found, values, path)`` with ``path[b, l]`` the node id
    at depth ``l`` (root first).  Every level is one ``node_search``."""
    q = _queries(tree, queries)
    nodes = tree.root.expand(q.shape[0]).long()
    path = [nodes] if with_path else None
    for _ in range(height - 1):
        slot, _, _ = ops.node_search(tree.keys[nodes], q)
        nodes = tree.children[nodes, slot.long()].long()
        if with_path:
            path.append(nodes)
    _, found, vals = ops.node_search(tree.keys[nodes], q, tree.values[nodes])
    if with_path:
        return found, vals, torch.stack(path, 1).to(torch.int32)
    return found, vals


def bulk_find_leaf(tree: TreeArrays, queries, *, height: int) -> torch.Tensor:
    """Route each query to its leaf id (int64; no value fetch)."""
    q = _queries(tree, queries)
    nodes = tree.root.expand(q.shape[0]).long()
    for _ in range(height - 1):
        slot, _, _ = ops.node_search(tree.keys[nodes], q)
        nodes = tree.children[nodes, slot.long()].long()
    return nodes


# ---------------------------------------------------------------------------
# batched updates (write to existing keys)
# ---------------------------------------------------------------------------


def bulk_update(tree: TreeArrays, queries, new_values, *, height: int):
    """Set the value of every existing key in ``queries``.  Returns
    ``(tree', updated mask)``; each updated leaf's version goes up by 2 a
    lane.  Of duplicate batch keys the last lane wins, as the reference's
    scatter does on the CPU."""
    q = _queries(tree, queries)
    nv = _queries(tree, new_values)
    leaves = bulk_find_leaf(tree, q, height=height)
    hit = tree.keys[leaves] == q[:, None]
    found = hit.any(-1)
    slot = _first_match(tree.keys[leaves], q)
    # one write a (leaf, slot): the last lane of each run in lane order
    flat = torch.where(found, leaves * FANOUT + slot, -1)
    order = _stable_argsort(flat)
    fs = flat[order]
    last = torch.ones_like(fs, dtype=torch.bool)
    last[:-1] = fs[:-1] != fs[1:]
    win = order[last & (fs >= 0)]
    new_vals = tree.values.clone()
    new_vals.view(-1)[flat[win]] = nv[win]
    new_version = tree.version.clone()
    new_version.index_add_(
        0, leaves, torch.where(found, 2, 0).to(new_version.dtype)
    )
    return tree._replace(values=new_vals, version=new_version), found


# ---------------------------------------------------------------------------
# segment machinery shared by the vectorised mutations
# ---------------------------------------------------------------------------


def _stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sort(x, dim=dim, stable=True).indices


def _leaf_segments(leaves: torch.Tensor, active: torch.Tensor, order_key):
    """Group batch lanes by target leaf.  Returns ``(sort_idx, seg_id,
    pos_in_seg, seg_leaf, seg_active)``: lanes sorted by (active leaf,
    ``order_key``), one segment per distinct active leaf, inactive lanes in
    a trailing dead segment (``jnp.lexsort`` as two stable sorts)."""
    b = leaves.shape[0]
    dev = leaves.device
    route = torch.where(active, leaves.long(), torch.full_like(leaves.long(), 1 << 40))
    by_key = _stable_argsort(order_key)
    sort_idx = by_key[_stable_argsort(route[by_key])]
    sorted_route = route[sort_idx]
    new_seg = torch.ones((b,), dtype=torch.bool, device=dev)
    new_seg[1:] = sorted_route[1:] != sorted_route[:-1]
    seg_id = torch.cumsum(new_seg.long(), 0) - 1
    ar = torch.arange(b, device=dev)
    seg_start = torch.cummax(torch.where(new_seg, ar, 0), 0).values
    pos_in_seg = ar - seg_start
    lane_leaf = torch.where(active[sort_idx], leaves[sort_idx].long(), 0)
    seg_leaf = torch.zeros((b,), dtype=torch.int64, device=dev).scatter_reduce(
        0, seg_id, lane_leaf, "amax"
    )
    seg_active = torch.zeros((b,), dtype=torch.int64, device=dev).scatter_reduce(
        0, seg_id, active[sort_idx].long(), "amax"
    ).bool()
    return sort_idx, seg_id, pos_in_seg, seg_leaf, seg_active


def _first_match(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Index of the first slot of each row equal to its query (0 if none)."""
    return torch.argmax((rows == q[:, None]).to(torch.uint8), -1)


# ---------------------------------------------------------------------------
# batched inserts: device fast path + host rebuild
# ---------------------------------------------------------------------------


def _insert_fast_path(tree: TreeArrays, keys, values, *, height: int):
    """Insert a batch into leaf slack on the device.  Returns ``(tree',
    handled, overflow)``: ``handled`` covers the inserts applied plus keys
    already present (they become value updates); ``overflow`` marks the
    keys whose leaf would pass FANOUT, for the host path."""
    dev = tree.keys.device
    keys = _queries(tree, keys)
    values = _queries(tree, values)
    b = keys.shape[0]
    scratch = tree.capacity - 1
    leaves = bulk_find_leaf(tree, keys, height=height)

    # existing keys become value updates, not inserts
    is_dup = (tree.keys[leaves] == keys[:, None]).any(-1)
    # deduplicate within the batch (first occurrence wins)
    order = _stable_argsort(keys)
    sk = keys[order]
    first = torch.ones((b,), dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    is_first = torch.zeros((b,), dtype=torch.bool, device=dev)
    is_first[order] = first
    eligible = ~is_dup & is_first

    incoming = torch.zeros((tree.capacity,), dtype=torch.int32, device=dev)
    incoming.index_add_(0, leaves, eligible.to(torch.int32))
    leaf_overflow = (tree.num_keys + incoming) > FANOUT
    overflow = eligible & leaf_overflow[leaves]
    do_insert = eligible & ~leaf_overflow[leaves]

    sort_idx, seg_id, pos_in_seg, seg_leaf, seg_active = _leaf_segments(
        leaves, do_insert, keys
    )
    # merge rows [B, 2F]: the leaf's row, then this segment's staged keys
    tgt = torch.where(seg_active, seg_leaf, scratch)
    merge_keys = torch.full((b, 2 * FANOUT), KEY_MAX, dtype=torch.int64, device=dev)
    merge_vals = torch.zeros((b, 2 * FANOUT), dtype=torch.int64, device=dev)
    merge_keys[:, :FANOUT] = tree.keys[tgt]
    merge_vals[:, :FANOUT] = tree.values[tgt]
    put = do_insert[sort_idx]
    col = FANOUT + torch.clamp(pos_in_seg, max=FANOUT - 1)
    merge_keys[seg_id, col] = torch.where(put, keys[sort_idx], KEY_MAX)
    merge_vals[seg_id, col] = torch.where(put, values[sort_idx], 0)
    sidx = _stable_argsort(merge_keys)
    merged_k = merge_keys.gather(1, sidx)[:, :FANOUT]
    merged_v = merge_vals.gather(1, sidx)[:, :FANOUT]

    # inactive rows rewrite the scratch row with its own contents
    out_k = torch.where(seg_active[:, None], merged_k, tree.keys[tgt])
    out_v = torch.where(seg_active[:, None], merged_v, tree.values[tgt])
    new_keys = tree.keys.clone()
    new_keys[tgt] = out_k
    new_values = tree.values.clone()
    new_values[tgt] = out_v
    cnt = (out_k != KEY_MAX).sum(-1).to(torch.int32)
    new_num = tree.num_keys.clone()
    new_num[tgt] = torch.where(seg_active, cnt, tree.num_keys[tgt])
    new_version = tree.version.clone()
    new_version.index_add_(0, tgt, torch.where(seg_active, 2, 0).to(torch.int32))

    # duplicates update values in place, located in the post-merge rows
    dleaf = torch.where(is_dup, leaves, scratch)
    dslot = torch.where(is_dup, _first_match(new_keys[dleaf], keys), 0)
    dval = torch.where(is_dup, values, new_values[scratch, 0])
    new_values[dleaf, dslot] = dval

    tree = tree._replace(
        keys=new_keys, values=new_values, num_keys=new_num, version=new_version
    )
    return tree, do_insert | is_dup, overflow


def batch_insert(
    tree: TreeArrays, meta: TreeMeta, keys, values
) -> Tuple[TreeArrays, TreeMeta, np.ndarray]:
    """Insert a batch: the device fast path first, then a host rebuild with
    the keys that overflow a leaf merged in.  Returns ``(tree', meta',
    handled mask)``; the rebuild replaces every array of the tree."""
    keys = np.asarray(keys, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    tree, ok, overflow = _insert_fast_path(tree, keys, values, height=meta.height)
    overflow = overflow.cpu().numpy()
    ok = ok.cpu().numpy()
    if overflow.any():
        tree, meta = _host_insert_with_splits(tree, keys[overflow], values[overflow])
        ok = ok | overflow
    return tree, meta, ok


def _host_insert_with_splits(
    tree: TreeArrays, keys: np.ndarray, values: np.ndarray
) -> Tuple[TreeArrays, TreeMeta]:
    """Rebuild the tree with the extra keys merged in (a later write wins
    for a key already present), on the tree's device."""
    all_keys, all_vals = tree_items(tree)
    merged_keys = np.concatenate([all_keys, keys])
    merged_vals = np.concatenate([all_vals, values])
    order = np.argsort(merged_keys, kind="stable")
    merged_keys, merged_vals = merged_keys[order], merged_vals[order]
    keep = np.concatenate([merged_keys[1:] != merged_keys[:-1], [True]])
    return bulk_build(merged_keys[keep], merged_vals[keep], device=tree.keys.device)


# ---------------------------------------------------------------------------
# batched deletes (logical removal)
# ---------------------------------------------------------------------------


def bulk_delete(tree: TreeArrays, queries, *, height: int):
    """Remove keys, compacting each touched leaf row.  Returns ``(tree',
    deleted mask)``."""
    dev = tree.keys.device
    q = _queries(tree, queries)
    scratch = tree.capacity - 1
    leaves = bulk_find_leaf(tree, q, height=height)
    hit = tree.keys[leaves] == q[:, None]
    found = hit.any(-1)
    slot = torch.argmax(hit.to(torch.uint8), -1)

    kleaf = torch.where(found, leaves, scratch)
    kslot = torch.where(found, slot, 0)
    kill = torch.zeros((tree.capacity, FANOUT), dtype=torch.bool, device=dev)
    kill[kleaf, kslot] = found
    kill[scratch] = False

    _, _, _, seg_leaf, seg_active = _leaf_segments(leaves, found, q)
    tgt = torch.where(seg_active, seg_leaf, scratch)
    rows_k = torch.where(kill[tgt], KEY_MAX, tree.keys[tgt])
    rows_v = torch.where(kill[tgt], 0, tree.values[tgt])
    sidx = _stable_argsort(rows_k)
    rows_k = rows_k.gather(1, sidx)
    rows_v = rows_v.gather(1, sidx)
    out_k = torch.where(seg_active[:, None], rows_k, tree.keys[tgt])
    out_v = torch.where(seg_active[:, None], rows_v, tree.values[tgt])
    new_keys = tree.keys.clone()
    new_keys[tgt] = out_k
    new_vals = tree.values.clone()
    new_vals[tgt] = out_v
    cnt = (out_k != KEY_MAX).sum(-1).to(torch.int32)
    new_num = tree.num_keys.clone()
    new_num[tgt] = torch.where(seg_active, cnt, tree.num_keys[tgt])
    new_version = tree.version.clone()
    new_version.index_add_(0, tgt, torch.where(seg_active, 2, 0).to(torch.int32))
    tree = tree._replace(
        keys=new_keys, values=new_vals, num_keys=new_num, version=new_version
    )
    return tree, found


# ---------------------------------------------------------------------------
# range scans (paper §7: repeated lookups through the fence keys)
# ---------------------------------------------------------------------------


def bulk_scan(tree: TreeArrays, start_keys, *, height: int, count: int,
              max_hops: Optional[int] = None):
    """Scan up to ``count`` records in ascending order from each start key.

    DEX keeps no leaf links, so a scan over several leaves is a repeated
    root-to-leaf lookup whose next start key is the current leaf's
    ``fence_hi``.  Returns ``(keys, values)``, each ``[B, count]``,
    KEY_MAX-padded."""
    cur = _queries(tree, start_keys)
    b = cur.shape[0]
    dev = cur.device
    hops = max_hops if max_hops is not None else max(2, count // (FANOUT // 2) + 2)
    out_k = torch.full((b, hops * FANOUT), KEY_MAX, dtype=torch.int64, device=dev)
    out_v = torch.zeros((b, hops * FANOUT), dtype=torch.int64, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    taken = torch.zeros((b,), dtype=torch.int32, device=dev)
    for h in range(hops):
        leaves = bulk_find_leaf(tree, cur, height=height)  # a fresh descent
        lk = tree.keys[leaves]
        lv = tree.values[leaves]
        pre = (lk >= cur[:, None]) & (lk != KEY_MAX) & ~done[:, None]
        mask = pre & ((taken[:, None] + torch.cumsum(pre, -1)) <= count)
        out_k[:, h * FANOUT : (h + 1) * FANOUT] = torch.where(mask, lk, KEY_MAX)
        out_v[:, h * FANOUT : (h + 1) * FANOUT] = torch.where(mask, lv, 0)
        taken = taken + mask.sum(-1).to(torch.int32)
        nxt = tree.fence_hi[leaves]
        done = done | (taken >= count) | (nxt == KEY_MAX)
        cur = torch.where(done, cur, nxt)
    sidx = _stable_argsort(out_k)
    return out_k.gather(1, sidx)[:, :count], out_v.gather(1, sidx)[:, :count]


# ---------------------------------------------------------------------------
# validation + host helpers
# ---------------------------------------------------------------------------


def validate(tree: TreeArrays, meta: TreeMeta) -> None:
    """Check structural invariants; raises AssertionError on violation."""
    K = tree.keys.cpu().numpy()
    C = tree.children.cpu().numpy()
    NK = tree.num_keys.cpu().numpy()
    LV = tree.level.cpu().numpy()
    FLO = tree.fence_lo.cpu().numpy()
    FHI = tree.fence_hi.cpu().numpy()
    root = int(tree.root)
    assert LV[root] == meta.height - 1, "root level mismatch"
    seen = set()

    def rec(nid: int, lo: int, hi: int, lvl: int):
        assert nid not in seen, "node visited twice"
        seen.add(nid)
        assert LV[nid] == lvl, f"level mismatch at {nid}"
        nk = int(NK[nid])
        assert 1 <= nk <= FANOUT
        row = K[nid]
        if lvl == 0:
            valid = row[row != KEY_MAX]
            assert valid.size == nk, f"leaf count mismatch at {nid}"
            assert np.all(np.diff(valid.astype(object)) > 0), f"unsorted leaf {nid}"
            assert np.all(
                (valid >= max(lo, KEY_MIN + 1)) & (valid < hi)
            ), f"leaf keys outside fences at {nid}"
        else:
            srt = row[:nk]
            assert np.all(np.diff(srt.astype(object)) > 0), f"unsorted inner {nid}"
        assert FLO[nid] == lo and FHI[nid] == hi, f"fence mismatch at {nid}"
        if lvl == 0:
            return
        for i in range(nk):
            c = int(C[nid, i])
            assert c != NULL
            clo = int(row[i])
            chi = int(row[i + 1]) if i + 1 < nk else hi
            rec(c, clo, chi, lvl - 1)

    rec(root, KEY_MIN, KEY_MAX, meta.height - 1)
    assert len(seen) == int(tree.num_nodes), "reachable nodes != num_nodes"


def tree_items(tree: TreeArrays) -> Tuple[np.ndarray, np.ndarray]:
    """All (key, value) pairs in sorted order (host helper)."""
    leaf = (tree.level == 0).cpu().numpy()
    k = tree.keys.cpu().numpy()[leaf].reshape(-1)
    v = tree.values.cpu().numpy()[leaf].reshape(-1)
    m = k != KEY_MAX
    k, v = k[m], v[m]
    order = np.argsort(k, kind="stable")
    return k[order], v[order]
