"""The port's node_search and subtree_walk against the reference's Pallas
kernels (run in interpret mode through ``repro.kernels.ops``, as
tests/test_kernels.py runs them): bit-equal outputs on the same numpy
inputs.  On the CPU the port's wrappers take their plain versions; the CUDA
kernels are held to those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pool as ref_pool  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402


def _keys(n, seed=0, lo=1, hi=None):
    rng = np.random.default_rng(seed)
    hi = hi or 8 * n
    return np.sort(rng.choice(hi - lo, size=n, replace=False).astype(np.int64) + lo)


def _node_case(b, seed):
    """Sorted rows with KEY_MAX padding, KEY_MIN/negative keys, and queries
    that hit, fall between keys, fall below a row's first key, or are
    KEY_MIN / KEY_MAX."""
    rng = np.random.default_rng(seed)
    rows = np.sort(
        rng.integers(-(2**62), 2**62, size=(b, FANOUT), dtype=np.int64), axis=1
    )
    occ = rng.integers(1, FANOUT + 1, size=b)
    rows[np.arange(FANOUT)[None, :] >= occ[:, None]] = KEY_MAX
    rows[::5, 0] = KEY_MIN
    vals = rng.integers(-(2**62), 2**62, size=(b, FANOUT), dtype=np.int64)
    q = rows[np.arange(b), rng.integers(0, occ)].copy()
    q[1::4] += 1
    q[2::4] = rows[2::4, 0] - 1
    q[3::16] = KEY_MAX
    q[7::16] = KEY_MIN
    q[11::16] = -3
    return rows, q, vals


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("b,seed", [(1, 0), (17, 1), (256, 2), (300, 3)])
def test_node_search_matches_reference_kernel(b, seed):
    rows, q, vals = _node_case(b, seed)
    slot, found, value = ref_ops.node_search(rows, q, vals)
    t_slot, t_found, t_value = t_ops.node_search(
        torch.from_numpy(rows), torch.from_numpy(q), torch.from_numpy(vals)
    )
    assert t_slot.dtype == torch.int32 and t_found.dtype == torch.bool
    _eq(slot, t_slot)
    _eq(found, t_found)
    # the Pallas kernel sums a value's (hi, lo) halves apart, so a query that
    # matches several slots (KEY_MAX against padding) loses the carry; the
    # port sums int64 as the jnp oracle and the engine's inline match do
    one = (rows == q[:, None]).sum(-1) <= 1
    np.testing.assert_array_equal(np.asarray(value)[one], t_value.numpy()[one])
    _eq(ref_ref.node_search_ref(rows, q, vals)[2], t_value)


def test_node_search_without_values():
    rows, q, _ = _node_case(64, 5)
    slot, found, _ = ref_ops.node_search(rows, q, np.zeros_like(rows))
    t_slot, t_found, t_value = t_ops.node_search(
        torch.from_numpy(rows), torch.from_numpy(q)
    )
    _eq(slot, t_slot)
    _eq(found, t_found)
    assert not bool(t_value.any())


def _block(level_m, seed):
    keys = _keys(3000 if level_m < 2 else 9000, seed=seed, lo=-(2**40), hi=2**40)
    pool, meta = ref_pool.build_pool(keys, keys ^ 0x5DEECE66D, level_m=level_m)
    return keys, pool, meta


@pytest.mark.parametrize("level_m", [0, 1, 2])
def test_subtree_walk_matches_reference_kernel(level_m):
    keys, pool, meta = _block(level_m, seed=level_m)
    st = np.asarray(ref_pool.top_walk(pool, meta, keys))
    q = keys[st == 0][:200].copy()
    q[::3] += 1
    q = np.concatenate([q, [KEY_MIN, KEY_MAX, -7, q[0] - 1]]).astype(np.int64)
    bk, bc, bv = (
        np.array(pool.pool_keys[0]),
        np.array(pool.pool_children[0]),
        np.array(pool.pool_values[0]),
    )
    levels = meta.levels_in_subtree
    # the Pallas kernel's one-hot gather reads a NULL child (reached only by
    # a KEY_MAX query) as an all-zero row, where the jnp walk the engine
    # inlines wraps it to the block's last row; the port follows the engine
    real = q != KEY_MAX
    found, value = ref_ops.subtree_walk(bk, bc, bv, q[real], levels=levels)
    j_found, j_value = ref_pool.subtree_walk_ref(bk, bc, bv, q, levels=levels)
    np.testing.assert_array_equal(np.asarray(j_found)[real], np.asarray(found))
    np.testing.assert_array_equal(np.asarray(j_value)[real], np.asarray(value))
    found, value = j_found, j_value
    # the port's generalised contract with S = 1, subtree = 0
    t_found, t_value, t_leaf = t_ops.subtree_walk(
        torch.from_numpy(bk[None]),
        torch.from_numpy(bc[None]),
        torch.from_numpy(bv[None]),
        torch.zeros(q.shape, dtype=torch.int32),
        torch.from_numpy(q),
        levels=levels,
    )
    _eq(found, t_found)
    _eq(value, t_value)
    # the leaf id is the last child id read, unwrapped, as the reference
    # engine's inline walk (engine.py:968-984) gives it to its writes
    loc = np.zeros(q.shape, np.int64)
    for _ in range(levels - 1):
        slot = np.maximum((bk[loc] <= q[:, None]).sum(-1) - 1, 0)
        loc = bc[loc, slot].astype(np.int64)
    assert t_leaf.dtype == torch.int32
    np.testing.assert_array_equal(loc, t_leaf.numpy())
    f2, v2 = t_pool.subtree_walk_ref(
        torch.from_numpy(bk),
        torch.from_numpy(bc),
        torch.from_numpy(bv),
        torch.from_numpy(q),
        levels=levels,
    )
    _eq(found, f2)
    _eq(value, v2)


@pytest.mark.parametrize("level_m", [1, 2])
def test_subtree_walk_whole_pool_matches_per_block_walks(level_m):
    """Each lane names its own block: the answer equals the reference
    kernel's walk of that block alone."""
    keys, pool, meta = _block(level_m, seed=10 + level_m)
    rng = np.random.default_rng(level_m)
    q = rng.choice(keys, size=96).astype(np.int64)
    q[::4] += 1
    st = np.asarray(ref_pool.top_walk(pool, meta, q)).astype(np.int32)
    t_found, t_value, _ = t_ops.subtree_walk(
        torch.from_numpy(np.array(pool.pool_keys)),
        torch.from_numpy(np.array(pool.pool_children)),
        torch.from_numpy(np.array(pool.pool_values)),
        torch.from_numpy(st),
        torch.from_numpy(q),
        levels=meta.levels_in_subtree,
    )
    for s in np.unique(st):
        sel = st == s
        found, value = ref_ops.subtree_walk(
            np.asarray(pool.pool_keys[s]),
            np.asarray(pool.pool_children[s]),
            np.asarray(pool.pool_values[s]),
            q[sel],
            levels=meta.levels_in_subtree,
        )
        np.testing.assert_array_equal(np.asarray(found), t_found.numpy()[sel])
        np.testing.assert_array_equal(np.asarray(value), t_value.numpy()[sel])
    assert not t_found.numpy()[::4].any()


@pytest.mark.parametrize("level_m", [0, 1, 2])
def test_subtree_walk_all_active_matches_reference_kernel(level_m):
    """``active`` all True keeps the contract: the Pallas kernel's answers
    on the queries it takes (KEY_MAX aside, queue 3 entry 4)."""
    keys, pool, meta = _block(level_m, seed=20 + level_m)
    st = np.asarray(ref_pool.top_walk(pool, meta, keys))
    q = keys[st == 0][:150].copy()
    q[::3] += 1
    q = np.concatenate([q, [KEY_MIN, -7, q[0] - 1]]).astype(np.int64)
    bk, bc, bv = (
        np.array(pool.pool_keys[0]),
        np.array(pool.pool_children[0]),
        np.array(pool.pool_values[0]),
    )
    found, value = ref_ops.subtree_walk(bk, bc, bv, q, levels=meta.levels_in_subtree)
    t_found, t_value, _ = t_ops.subtree_walk(
        torch.from_numpy(bk[None]),
        torch.from_numpy(bc[None]),
        torch.from_numpy(bv[None]),
        torch.zeros(q.shape, dtype=torch.int32),
        torch.from_numpy(q),
        levels=meta.levels_in_subtree,
        active=torch.ones(q.shape, dtype=torch.bool),
    )
    _eq(found, t_found)
    _eq(value, t_value)


@pytest.mark.parametrize("mask", ["front", "random", "none"])
@pytest.mark.parametrize("level_m", [1, 2])
def test_subtree_walk_masked_lanes(level_m, mask):
    """With ``active``, the plain version equals the unmasked walk on the
    active lanes and gives ``(False, 0, 0)`` on the others (KEY_MAX and
    random subtrees included)."""
    keys, pool, meta = _block(level_m, seed=30 + level_m)
    rng = np.random.default_rng(level_m)
    q = rng.choice(keys, size=160).astype(np.int64)
    q[1::4] += 1
    q[2::8] = KEY_MAX
    q[3::8] = KEY_MIN
    st = np.asarray(ref_pool.top_walk(pool, meta, q)).astype(np.int32)
    st[::5] = rng.integers(0, meta.n_subtrees, st[::5].size)
    if mask == "front":
        active = np.arange(q.size) % 32 < 5
    elif mask == "random":
        active = rng.random(q.size) < 0.3
    else:
        active = np.zeros(q.size, bool)
    args = tuple(
        torch.from_numpy(np.array(a))
        for a in (pool.pool_keys, pool.pool_children, pool.pool_values, st, q)
    )
    want = t_ops.subtree_walk(*args, levels=meta.levels_in_subtree)
    got = t_ops.subtree_walk(
        *args, levels=meta.levels_in_subtree, active=torch.from_numpy(active)
    )
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy()[active], w.numpy()[active])
        assert not g.numpy()[~active].any()


def test_cpu_tensors_take_the_plain_version_without_counting():
    t_ops.reset_launches()
    rows, q, vals = _node_case(8, 9)
    t_ops.node_search(torch.from_numpy(rows), torch.from_numpy(q))
    z = torch.zeros((2, FANOUT), dtype=torch.int64)
    t_ops.leaf_write(z, z, z.to(torch.int32) - 1, z, z + KEY_MAX, z)
    t_ops.leaf_scan(z, z, z[:, 0].contiguous(), z[:, 0].to(torch.int32), max_count=8)
    t_ops.leaf_split(z, z, z + KEY_MAX, z)
    t_ops.node_search_prefix(
        z[:, 0].contiguous(), z[:, 0].to(torch.int32), z.to(torch.int32), z,
        z[:, 0].contiguous(),
    )
    q = torch.zeros((2, 4, 8))
    t_ops.paged_attention(
        q, torch.zeros((3, 4, 2, 8)), torch.zeros((3, 4, 2, 8)),
        torch.zeros((2, 1), dtype=torch.int32), torch.ones(2, dtype=torch.int32),
    )
    t_ops.flash_attention(q[None], q[None, :2], q[None, :2])
    qg = q[None].clone().requires_grad_()
    t_ops.flash_attention(qg, q[None, :2], q[None, :2]).sum().backward()
    t_ops.mamba_scan(q, torch.zeros((8, 16)), torch.zeros((2, 4, 16)),
                     torch.zeros((2, 4, 16)), q)
    t_ops.mamba_scan(q.clone().requires_grad_(), torch.zeros((8, 16)), torch.zeros((2, 4, 16)),
                     torch.zeros((2, 4, 16)), q)[0].sum().backward()
    assert t_ops.LAUNCHES == {
        "node_search": 0,
        "node_search_prefix": 0,
        "subtree_walk": 0,
        "leaf_write": 0,
        "leaf_scan": 0,
        "leaf_split": 0,
        "paged_attention": 0,
        "flash_attention": 0,
        "flash_attention_bwd": 0,
        "mamba_scan": 0,
        "mamba_scan_bwd": 0,
    }
