"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on an NVIDIA GPU.  Imports neither JAX nor the reference package, so it
runs where only PyTorch and the CUDA toolkit are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips with its reason."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN  # noqa: E402
from repro_torch.kernels import node_search as ns_kernel  # noqa: E402
from repro_torch.kernels import subtree_walk as sw_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serve.serve_step import paged_decode_step  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def leaf_case(q, seed):
    """Contract inputs of ``leaf_write``: sorted rows with KEY_MAX padding,
    KEY_MIN and negative keys; rows with only updates, only inserts, both,
    and nothing staged (by ``row % 4``); rows filled to exactly 64; staged
    keys below a row's first key and above its last; active staged entries
    as a prefix or spread among inactive ones."""
    f = FANOUT
    rng = np.random.default_rng(seed)
    big = 2**62

    def ints(shape):
        return rng.integers(-big, big, size=shape)

    r = np.arange(q)[:, None]
    col = np.arange(f)[None, :]
    pool = np.sort(ints((q, 2 * f)), axis=1) + np.arange(2 * f)  # ascending
    pool[::5, 0] = KEY_MIN
    inv = np.argsort(np.argsort(rng.random((q, 2 * f)), axis=1), axis=1)
    occ = rng.integers(0, f + 1, size=q)
    kind = np.arange(q) % 4
    n_ins = np.where((kind == 1) | (kind == 2), rng.integers(0, f + 1, size=q), 0)
    n_ins = np.minimum(n_ins, f - occ)
    n_ins[1::8] = f - occ[1::8]  # filled to exactly 64

    def pick(mask, n):
        idx = np.argsort(~mask, axis=1, kind="stable")[:, :f]
        return np.where(col < n[:, None], pool[r, idx], KEY_MAX)

    rows_k = pick(inv < occ[:, None], occ)
    staged = pick((inv >= occ[:, None]) & (inv < (occ + n_ins)[:, None]), n_ins)
    rows_v = np.where(rows_k != KEY_MAX, ints((q, f)), 0)
    ins_key = staged.copy()
    # spread the active entries of every third row among inactive ones
    for i in range(0, q, 3):
        m = int(n_ins[i])
        ins_key[i] = KEY_MAX
        ins_key[i, np.sort(rng.choice(f, size=m, replace=False))] = staged[i, :m]
    ins_val = np.where(ins_key != KEY_MAX, ints((q, f)), 0)

    n_upd = np.where((kind == 0) | (kind == 2), rng.integers(0, f + 1, size=q), 0)
    n_upd = np.minimum(n_upd, occ)
    scores = np.where(col < occ[:, None], rng.random((q, f)), 2.0)
    slots = np.argsort(scores, axis=1)
    upd_slot = np.where(col < n_upd[:, None], slots, -1).astype(np.int32)
    upd_val = np.where(upd_slot >= 0, ints((q, f)), 0)
    return rows_k, rows_v, upd_slot, upd_val, ins_key, ins_val


def scan_case(b, hops, seed, max_count):
    """Contract inputs of ``leaf_scan``: windows of ``hops`` sorted leaf rows
    (32 to 64 keys each, KEY_MAX padding, some rows empty as a lane's unread
    hops are, negative keys); starts on a key, between keys, below the
    window, past it, KEY_MIN and KEY_MAX; counts 0, 1, ``max_count``, above
    it and negative."""
    f = FANOUT
    rng = np.random.default_rng(seed)
    w = hops * f
    fill = rng.integers(32, f + 1, size=(b, hops))
    fill[:, 1:][rng.random((b, hops - 1)) < 0.2] = 0  # hops a lane did not read
    gaps = rng.integers(1, 2**20, size=(b, hops * f))
    keys = np.cumsum(gaps, axis=1) - rng.integers(0, 2**40, size=(b, 1))
    col = np.arange(f)[None, None, :]
    k = np.where(col < fill[..., None], keys.reshape(b, hops, f), KEY_MAX)
    k = k.reshape(b, w)
    v = np.where(k != KEY_MAX, rng.integers(-(2**62), 2**62, size=(b, w)), 0)
    real = k != KEY_MAX
    pick = np.array([rng.choice(np.flatnonzero(r)) for r in real])
    start = k[np.arange(b), pick].copy()
    kind = np.arange(b) % 8
    start[kind == 1] += 1
    start[kind == 2] = k[kind == 2, 0] - 5
    start[kind == 3] = keys[kind == 3, -1] + 7
    start[kind == 4] = KEY_MIN
    start[kind == 5] = KEY_MAX
    counts = rng.integers(0, max_count + 1, size=b)
    counts[::7] = 0
    counts[1::7] = 1
    counts[2::7] = max_count
    counts[3::7] = max_count + 40
    counts[4::11] = -3
    return k, v, start.astype(np.int64), counts.astype(np.int32)


def split_case(q, seed):
    """Contract inputs of ``leaf_split``: sorted rows with KEY_MAX padding,
    KEY_MIN and negative keys; staged keys distinct from the row's,
    ascending, spread among inactive entries.  By ``row % 6``: nothing staged, a
    merge to exactly m = 65 (the least split), m = 128 (a full row and a full
    staged list), m = 64 (full, no split), and two random mixes."""
    f = FANOUT
    rng = np.random.default_rng(seed)
    rows_k = np.full((q, f), KEY_MAX, np.int64)
    rows_v = np.zeros((q, f), np.int64)
    ins_key = np.full((q, f), KEY_MAX, np.int64)
    ins_val = np.zeros((q, f), np.int64)
    for i in range(q):
        pool = np.sort(rng.integers(-(2**62), 2**62, size=2 * f)) + np.arange(2 * f)
        if i % 5 == 0:
            pool[0] = KEY_MIN
        kind = i % 6
        occ = int(rng.integers(0, f + 1))
        n_ins = int(rng.integers(0, f + 1))
        if kind == 0:
            n_ins = 0
        elif kind == 1:
            occ = int(rng.integers(1, f + 1))
            n_ins = 65 - occ
        elif kind == 2:
            occ, n_ins = f, f
        elif kind == 3:
            n_ins = f - occ
        perm = rng.permutation(2 * f)
        rows_k[i, :occ] = np.sort(pool[perm[:occ]])
        rows_v[i, :occ] = rng.integers(-(2**62), 2**62, size=occ)
        slots = np.sort(rng.choice(f, size=n_ins, replace=False))
        ins_key[i, slots] = np.sort(pool[perm[occ : occ + n_ins]])
        ins_val[i, slots] = rng.integers(-(2**62), 2**62, size=n_ins)
    return rows_k, rows_v, ins_key, ins_val


def _rows(b, seed):
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
    return rows, q, vals


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 4097])
@pytest.mark.parametrize("with_values", [True, False])
def test_node_search_kernel_matches_plain(cuda, b, with_values):
    rows, q, vals = (torch.from_numpy(a).to(cuda) for a in _rows(b, b))
    vals = vals if with_values else None
    before = ops.LAUNCHES["node_search"]
    got = ops.node_search(rows, q, vals)
    assert ops.LAUNCHES["node_search"] == before + 1
    for g, w in zip(got, ref.node_search_ref(rows, q, vals)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _run_rows(b, seed):
    """Sorted rows with a run of one key across sector boundaries (2 to 40
    slots from a random start), KEY_MAX padding with random values, and
    queries on the run (KEY_MIN runs on every fifth row), beside the
    ``_rows`` kinds."""
    rows, q, vals = _rows(b, seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(b):
        a = int(rng.integers(0, FANOUT - 2))
        e = min(FANOUT, a + int(rng.integers(2, 41)))
        rows[i, a:e] = KEY_MIN if i % 5 == 0 else rows[i, a]
        if i % 5 == 0:
            rows[i, :a] = KEY_MIN
        if i % 3 == 0:
            q[i] = rows[i, a]
    vals[::7] = 2**62  # runs whose values sum past 2**63
    return rows, q, vals


def engine_case(buckets, cap, live, seed, padding_rows="empty"):
    """One descent level of the engine: ``buckets`` buckets of ``cap``
    slots, the first ``live`` of each a lane of ``_rows``, the rest padding
    with a KEY_MAX query and zero values, its row all KEY_MAX (the leaf
    level) or, with ``padding_rows="real"``, a real row (the top walk and
    the inner levels)."""
    rows_l, q_l, vals_l = _rows(buckets * live, seed)
    n = buckets * cap
    if padding_rows == "empty":
        rows = np.full((n, FANOUT), KEY_MAX, np.int64)
    else:
        rows = _rows(n, seed + 1)[0]
    vals = np.zeros((n, FANOUT), np.int64)
    q = np.full(n, KEY_MAX, np.int64)
    slot = (np.arange(buckets)[:, None] * cap + np.arange(live)).reshape(-1)
    rows[slot], vals[slot], q[slot] = rows_l, vals_l, q_l
    return rows, q, vals


def _check_node_search(rows, q, vals, variants):
    want = ref.node_search_ref(rows, q, vals)
    lib = ops.library()
    for v in variants:
        got = ns_kernel.launch(lib, rows, q, vals, variant=v)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), v


ALL_VARIANTS = (None,) + ns_kernel.VARIANTS


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 4097, 262144])
@pytest.mark.parametrize("with_values", [True, False])
def test_node_search_variants_match_plain(cuda, b, with_values):
    rows, q, vals = (torch.from_numpy(a).to(cuda) for a in _rows(b, b + 1))
    _check_node_search(rows, q, vals if with_values else None, ALL_VARIANTS)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 4097])
@pytest.mark.parametrize("with_values", [True, False])
def test_node_search_variants_on_runs_across_sectors(cuda, b, with_values):
    rows, q, vals = (torch.from_numpy(a).to(cuda) for a in _run_rows(b, b))
    _check_node_search(rows, q, vals if with_values else None, ALL_VARIANTS)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_rows", ["empty", "real"])
@pytest.mark.parametrize("with_values", [True, False])
def test_node_search_variants_on_the_engine_mix(cuda, padding_rows, with_values):
    case = engine_case(16, 16_384, 4_096, 3, padding_rows)
    rows, q, vals = (torch.from_numpy(a).to(cuda) for a in case)
    assert float((q == KEY_MAX).float().mean()) > 0.75
    _check_node_search(rows, q, vals if with_values else None, ALL_VARIANTS)


@pytest.mark.cuda
def test_node_search_at_the_top_walk_shape(cuda):
    """65,536 lanes through the top tree of a built pool, level by level."""
    rng = np.random.default_rng(12)
    keys = np.sort(rng.choice(2**40, size=400_000, replace=False)) - 2**39
    pool, meta = t_pool.build_pool(keys, keys, level_m=0, device=cuda)
    q = torch.from_numpy(rng.choice(keys, 65_536)).to(cuda)
    q[::9] = KEY_MAX
    q[1::9] += 1
    nodes = torch.full_like(q, pool.top_keys.shape[0] - 1)
    assert meta.top_height >= 1
    for _ in range(meta.top_height):
        rows = pool.top_keys[nodes]
        _check_node_search(rows, q, None, ALL_VARIANTS)
        slot, _, _ = ops.node_search(rows, q)
        nodes = pool.top_children[nodes, slot.long()].long()


@pytest.mark.cuda
@pytest.mark.parametrize("level_m", [0, 1, 2])
def test_subtree_walk_kernel_matches_plain(cuda, level_m):
    rng = np.random.default_rng(level_m)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    keys -= 2**39
    pool, meta = t_pool.build_pool(keys, keys * 3, level_m=level_m, device=cuda)
    q = torch.from_numpy(np.concatenate([keys[::7], keys[::11] + 1])).to(cuda)
    q[::13] = KEY_MAX
    q[::17] = KEY_MIN
    st = t_pool.top_walk(pool, meta, q)
    st = torch.where(torch.arange(q.numel(), device=cuda) % 3 == 0, 0, st)
    args = (pool.pool_keys, pool.pool_children, pool.pool_values, st.to(torch.int32), q)
    before = ops.LAUNCHES["subtree_walk"]
    got = ops.subtree_walk(*args, levels=meta.levels_in_subtree)
    assert ops.LAUNCHES["subtree_walk"] == before + 1
    want = ref.subtree_walk_ref(*args, levels=meta.levels_in_subtree)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("level_m", [1, 2])
def test_subtree_walk_kernel_returns_the_leaf_id(cuda, level_m):
    """The third output is the leaf's block-local id: a key the walk finds
    sits in that leaf's row."""
    rng = np.random.default_rng(10 + level_m)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    pool, meta = t_pool.build_pool(keys, keys * 3, level_m=level_m, device=cuda)
    q = torch.from_numpy(np.concatenate([keys[::5], keys[::9] + 1])).to(cuda)
    st = t_pool.top_walk(pool, meta, q).to(torch.int32)
    args = (pool.pool_keys, pool.pool_children, pool.pool_values, st, q)
    found, _, leaf = ops.subtree_walk(*args, levels=meta.levels_in_subtree)
    assert leaf.dtype == torch.int32
    want = ref.subtree_walk_ref(*args, levels=meta.levels_in_subtree)
    assert torch.equal(leaf, want[2])
    rows = pool.pool_keys[st.long(), leaf.long()]
    assert torch.equal((rows == q[:, None]).any(1), found)
    assert bool(found[: keys[::5].size].all())


def walk_case(level_m, mask, device, n=40_000, seed=0):
    """Lanes of the owner walk on a built pool: hits, misses, KEY_MIN,
    KEY_MAX (NULL children at level M >= 1), -3, real and random subtrees
    (negative ids too), under a lane mask: ``all``, ``none``, ``front``
    (32-slot buckets, their live lanes first, as ``pack_by_dest`` leaves
    them) or ``random``.  A masked lane names a subtree far past the pool,
    so a kernel that read anything for it would fault."""
    rng = np.random.default_rng(seed + level_m)
    keys = np.sort(rng.choice(2**40, size=30_000, replace=False).astype(np.int64))
    keys -= 2**39
    pool, meta = t_pool.build_pool(
        keys, keys * 3, level_m=level_m, subtree_leaves=None if level_m < 2 else 64,
        device=device,
    )
    q = rng.choice(keys, n)
    q[1::4] += 1
    q[2::16] = KEY_MAX
    q[3::16] = KEY_MIN
    q[5::16] = -3
    q = torch.from_numpy(q).to(device)
    st = t_pool.top_walk(pool, meta, q).to(torch.int32)
    lane = torch.arange(n, device=device)
    rand = torch.from_numpy(
        rng.integers(-meta.n_subtrees_padded, meta.n_subtrees, n).astype(np.int32)
    ).to(device)
    st = torch.where(lane % 3 == 0, rand, st)
    if mask == "all":
        active = torch.ones(n, dtype=torch.bool, device=device)
    elif mask == "none":
        active = torch.zeros(n, dtype=torch.bool, device=device)
    elif mask == "front":
        active = (lane % 32) < 7
    else:
        active = torch.from_numpy(rng.random(n) < 0.3).to(device)
    st = torch.where(active, st, 2**30)
    args = (pool.pool_keys, pool.pool_children, pool.pool_values, st, q)
    return args, active, meta.levels_in_subtree


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["all", "none", "front", "random"])
@pytest.mark.parametrize("level_m", [1, 2])
def test_subtree_walk_variants_match_plain(cuda, level_m, mask):
    args, active, levels = walk_case(level_m, mask, cuda)
    want = ref.subtree_walk_ref(*args, levels=levels, active=active)
    if mask != "none":
        assert bool((want[2][active] < 0).any())  # NULL children were reached
    lib = ops.library()
    for v in (None,) + sw_kernel.VARIANTS:
        got = sw_kernel.launch(lib, *args, levels, active, variant=v)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), v


@pytest.mark.cuda
def test_subtree_walk_counts_one_launch_a_call(cuda):
    args, active, levels = walk_case(1, "front", cuda, n=4_099)
    before = ops.LAUNCHES["subtree_walk"]
    ops.subtree_walk(*args, levels=levels, active=active)
    # every lane active: the masked lanes' subtree ids made valid
    st = torch.where(active, args[3], 0)
    ops.subtree_walk(*args[:3], st, args[4], levels=levels, active=torch.ones_like(active))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["subtree_walk"] == before + 2
    with pytest.raises(ValueError, match="unknown variant"):
        sw_kernel.launch(ops.library(), *args, levels, active, variant="D4")
    with pytest.raises(ValueError, match="active"):
        ops.subtree_walk(*args, levels=levels, active=active.to(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 37, 4099])
def test_leaf_write_kernel_matches_plain(cuda, q):
    case = [torch.from_numpy(a).to(cuda) for a in leaf_case(q, q)]
    before = ops.LAUNCHES["leaf_write"]
    got = ops.leaf_write(*case)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["leaf_write"] == before + 1
    for g, w in zip(got, ref.leaf_write_ref(*case)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hops,max_count", [(1, 2, 16), (37, 3, 48), (4099, 5, 100)])
def test_leaf_scan_kernel_matches_plain(cuda, b, hops, max_count):
    case = [torch.from_numpy(a).to(cuda) for a in scan_case(b, hops, b, max_count)]
    before = ops.LAUNCHES["leaf_scan"]
    got = ops.leaf_scan(*case, max_count=max_count)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["leaf_scan"] == before + 1
    for g, w in zip(got, ref.leaf_scan_ref(*case, max_count=max_count)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 37, 4099])
def test_leaf_split_kernel_matches_plain(cuda, q):
    case = [torch.from_numpy(a).to(cuda) for a in split_case(q, q)]
    before = ops.LAUNCHES["leaf_split"]
    got = ops.leaf_split(*case)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["leaf_split"] == before + 1
    for g, w in zip(got, ref.leaf_split_ref(*case)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def prefix_case(b, seed):
    """Contract inputs of ``node_search_prefix``: ``b`` lanes over sorted
    rows whose spans run from 2 to 2**40 (compressible and not), empty rows,
    rows with KEY_MIN, rows across the sign bit; their planes from the port's
    ``compress_rows``; queries on a key, between keys, below and past the
    row, KEY_MIN, KEY_MAX and negative."""
    rng = np.random.default_rng(seed)
    rows = np.full((b, FANOUT), KEY_MAX, np.int64)
    for i in range(b):
        if i % 7 == 6:
            continue  # an empty row
        base = -5 if i % 11 == 5 else int(rng.integers(-(2**62), 2**62))
        span = int(2 ** rng.integers(1, 41))
        k = np.unique(base + rng.integers(0, span, size=rng.integers(1, FANOUT + 1)))
        if i % 13 == 4:
            k[0] = KEY_MIN
        rows[i, : k.size] = k
    prefix, nbits, suffix = t_pool.compress_rows(torch.from_numpy(rows))
    occ = np.maximum((rows != KEY_MAX).sum(1), 1)
    q = rows[np.arange(b), rng.integers(0, occ)].copy()
    q[1::5] += 1
    q[2::5] = rows[2::5, 0] - 1
    q[3::16] = KEY_MAX
    q[7::16] = KEY_MIN
    q[11::16] = -3
    q[q == KEY_MAX - 1] = KEY_MAX  # an empty row's probe
    return (prefix.numpy(), nbits.numpy(), suffix.numpy(), rows, q)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 4097])
def test_node_search_prefix_kernel_matches_plain(cuda, b):
    case = [torch.from_numpy(a).to(cuda) for a in prefix_case(b, b)]
    before = ops.LAUNCHES["node_search_prefix"]
    got = ops.node_search_prefix(*case)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["node_search_prefix"] == before + 1
    want = ref.node_search_prefix_ref(*case)
    assert got.dtype == want.dtype and torch.equal(got, want)
    slot, _, _ = ref.node_search_ref(case[3], case[4])
    live = case[4] != KEY_MAX
    assert torch.equal(got[live], slot[live])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 4097, 262144])
def test_node_search_prefix_variants_match_plain(cuda, b):
    case = [torch.from_numpy(a).to(cuda) for a in prefix_case(b, b + 2)]
    want = ref.node_search_prefix_ref(*case)
    lib = ops.library()
    for v in (None,) + ns_kernel.PREFIX_VARIANTS:
        got = ns_kernel.launch_prefix(lib, *case, variant=v)
        torch.cuda.synchronize()
        assert torch.equal(got, want), v


@pytest.mark.cuda
def test_node_search_prefix_kernel_on_a_pool(cuda):
    """Real rows of a dense index, all levels, and its free-list rows."""
    rng = np.random.default_rng(3)
    keys = np.cumsum(rng.integers(1, 2**24, size=50_000)).astype(np.int64) - 2**38
    pool, meta = t_pool.build_pool(keys, keys, level_m=1, device=cuda)
    sep = t_pool.compress_separators(pool, meta)
    s, c = sep.nbits.shape
    lane = torch.from_numpy(rng.integers(0, s * c, size=8192)).to(cuda)
    q = torch.from_numpy(rng.choice(keys, 8192)).to(cuda)
    q[::3] += 1
    args = (sep.prefix.view(-1)[lane], sep.nbits.view(-1)[lane],
            sep.suffix.view(-1, FANOUT)[lane], pool.pool_keys.view(-1, FANOUT)[lane], q)
    got = ops.node_search_prefix(*args)
    assert torch.equal(got, ref.node_search_prefix_ref(*args))
    assert bool((args[1] >= 0).any()) and bool((args[1] < 0).any())


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    rows = torch.zeros((4, FANOUT), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ops.node_search(rows, torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        ops.node_search(rows[:, :32], torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ops.node_search(rows, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):  # upd_slot must be int32
        ops.leaf_write(rows, rows, rows, rows, rows, rows)
    with pytest.raises(ValueError):  # counts must be int32
        ops.leaf_scan(rows, rows, rows[:, 0], rows[:, 0].contiguous(), max_count=8)
    with pytest.raises(ValueError):  # max_count above the window width
        ops.leaf_scan(
            rows, rows, rows[:, 0].contiguous(),
            torch.zeros(4, dtype=torch.int32, device=cuda), max_count=65,
        )
    with pytest.raises(ValueError):  # staged rows must be [Q, 64]
        ops.leaf_split(rows, rows, rows[:, :32], rows[:, :32])
    nb = torch.zeros(4, dtype=torch.int32, device=cuda)
    suf = torch.zeros((4, FANOUT), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # nbits must be int32
        ops.node_search_prefix(rows[:, 0].contiguous(), nb.long(), suf, rows,
                               rows[:, 0].contiguous())
    with pytest.raises(ValueError):  # the suffix plane must be 8-byte aligned
        ops.node_search_prefix(
            rows[:, 0].contiguous(), nb,
            torch.zeros(4 * FANOUT + 1, dtype=torch.int32, device=cuda)[1:].view(4, FANOUT),
            rows, rows[:, 0].contiguous(),
        )


TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def paged_case(b, h, hkv, d, page, ppr, seed, dtype):
    """Inputs of ``paged_attention``: a pool larger than the tables, every
    row random, so a stale page read past a request's length would change
    its answer; seq_lens 0, 1, one page exactly, a partial last page, the
    whole table, and random."""
    rng = np.random.default_rng(seed)
    n_pages = b * ppr + 5
    q = rng.standard_normal((b, h, d))
    kp = rng.standard_normal((n_pages, page, hkv, d))
    vp = rng.standard_normal((n_pages, page, hkv, d))
    table = rng.permutation(n_pages)[: b * ppr].reshape(b, ppr).astype(np.int32)
    lens = rng.integers(0, ppr * page + 1, size=b)
    for i, n in enumerate((0, 1, page, page + 3, ppr * page)):
        lens[i % b] = n
    return [torch.from_numpy(a).to(dtype) for a in (q, kp, vp)] + [
        torch.from_numpy(table), torch.from_numpy(lens.astype(np.int32))
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,hkv,d,page,ppr",
    [(6, 24, 8, 128, 16, 4), (5, 8, 2, 64, 16, 3), (5, 4, 4, 32, 8, 5),
     (5, 8, 2, 256, 4, 3), (5, 8, 8, 8, 16, 2), (5, 16, 2, 96, 16, 2)],
)
def test_paged_attention_kernel_matches_plain(cuda, dtype, b, h, hkv, d, page, ppr):
    args = [t.to(cuda) for t in paged_case(b, h, hkv, d, page, ppr, d + b, dtype)]
    got = ops.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    empty = args[4] == 0
    assert bool((got[empty] == 0).all()), "seq_len 0 must give zeros"
    assert bool(want[empty].isnan().all())
    err = (got.float() - want.float().nan_to_num()).abs().max().item()
    assert err <= TOL[dtype], err


#: lse: products of bf16 inputs are exact in f32, so only the order of the
#: sums differs from the plain version
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def check_paged(args, dtype):
    """The kernel's ``(out, lse)`` against the plain version's: zeros and
    ``-inf`` at length 0, ``out`` within ``TOL``, ``lse`` within
    ``LSE_TOL``."""
    got, lse = ops.paged_attention(*args, with_lse=True)
    want, want_lse = ref.paged_attention_ref(*args, with_lse=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and lse.dtype == torch.float32
    empty = args[4] == 0
    assert bool((got[empty] == 0).all()), "seq_len 0 must give zeros"
    assert bool((lse[empty] == float("-inf")).all()), "seq_len 0 must give lse -inf"
    err = (got.float() - want.float().nan_to_num()).abs().max().item()
    assert err <= TOL[dtype], err
    live = ~torch.isinf(want_lse)
    assert torch.equal(live, ~torch.isinf(lse))
    lse_err = (lse[live] - want_lse[live]).abs().max().item() if bool(live.any()) else 0.0
    assert lse_err <= LSE_TOL[dtype], lse_err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,hkv,d,page,ppr",
    [(6, 24, 8, 128, 16, 4), (5, 8, 2, 64, 16, 3), (5, 4, 4, 32, 8, 5),
     (5, 8, 2, 256, 4, 3), (5, 8, 8, 8, 16, 2), (5, 16, 2, 96, 16, 2),
     (5, 32, 2, 128, 16, 3),  # G = 16, two n tiles of heads
     (2, 24, 8, 128, 16, 36),  # a short batch of long requests, the full table
     (64, 16, 8, 64, 16, 36)],  # granite-moe-1b-a400m's serving: G = 2 at D = 64
)
def test_paged_attention_kernel_lse_matches_plain(cuda, dtype, b, h, hkv, d, page, ppr):
    args = [t.to(cuda) for t in paged_case(b, h, hkv, d, page, ppr, d + b, dtype)]
    if b == 2:
        args[4] = torch.tensor([ppr * page, ppr * page - 1], dtype=torch.int32, device=cuda)
    check_paged(args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_at_split_boundaries(cuda, dtype):
    """Lengths on either side of the bf16 plan's split boundaries (64 and
    128 positions at serving's shape), and of the table's end."""
    from repro_torch.kernels import paged_attention as pa

    split = pa.plan(8, 8, 3, 128, 16, 36, torch.bfloat16).split_tokens
    args = [t.to(cuda) for t in paged_case(8, 24, 8, 128, 16, 36, 5, dtype)]
    args[4] = torch.tensor(
        [split - 1, split, split + 1, 2 * split - 1, 2 * split, 2 * split + 1, 575, 576],
        dtype=torch.int32, device=cuda,
    )
    check_paged(args, dtype)


@pytest.mark.cuda
def test_paged_attention_counters_return_to_zero(cuda):
    """Calls in a row at different B x HKV share the kept merge counters:
    each is right, and the last CTA of every (request, kv head) leaves its
    counter at 0."""
    from repro_torch.kernels import paged_attention as pa

    for i, (b, h, hkv) in enumerate(((64, 24, 8), (3, 8, 2), (200, 16, 4), (64, 24, 8))):
        args = [t.to(cuda) for t in paged_case(b, h, hkv, 128, 16, 36, 40 + i, torch.bfloat16)]
        for _ in range(2):
            check_paged(args, torch.bfloat16)
        counters = pa._COUNTERS[args[0].device, torch.cuda.current_stream().cuda_stream]
        assert counters.numel() >= b * hkv
        assert int(counters.abs().sum()) == 0


@pytest.mark.cuda
def test_paged_attention_counters_per_stream(cuda):
    """Calls on two streams at once keep counters of their own, and both
    are right."""
    from repro_torch.kernels import paged_attention as pa

    cases = [[t.to(cuda) for t in paged_case(64, 24, 8, 128, 16, 36, 50 + i, torch.bfloat16)]
             for i in range(2)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        outs.append(ops.paged_attention(*cases[0], with_lse=True))
        with torch.cuda.stream(side):
            outs.append(ops.paged_attention(*cases[1], with_lse=True))
    torch.cuda.synchronize()
    for i, (out, lse) in enumerate(outs):
        want, want_lse = ref.paged_attention_ref(*cases[i % 2], with_lse=True)
        assert float((out.float() - want.nan_to_num().float()).abs().max()) <= TOL[torch.bfloat16]
        live = torch.isfinite(want_lse)
        assert float((lse[live] - want_lse[live]).abs().max()) <= LSE_TOL[torch.bfloat16]
    dev = cases[0][0].device
    for stream in (torch.cuda.current_stream(dev), side):
        assert int(pa._COUNTERS[dev, stream.cuda_stream].abs().sum()) == 0


def flash_case(b, h, hkv, sq, sk, d, dtype, device):
    rng = np.random.default_rng(sq + sk + d)
    return [
        torch.from_numpy(rng.standard_normal(s)).to(device, dtype)
        for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,d,causal",
    [(1, 4, 4, 128, 128, 64, True), (2, 6, 2, 100, 100, 32, True),
     (1, 3, 1, 64, 200, 128, True), (1, 4, 2, 70, 130, 8, False),
     (1, 2, 2, 33, 33, 256, True), (1, 24, 8, 130, 130, 128, True),
     # zamba2-2.7b's head dim (a padded 128), G = 1
     (1, 32, 32, 300, 300, 80, True),
     # head dims 8, 24 and 200 (padded 64, 64, 256) and 256, ragged lengths
     (1, 4, 1, 129, 257, 8, True), (1, 6, 3, 200, 260, 24, True),
     (2, 4, 2, 190, 190, 200, False), (1, 8, 2, 77, 333, 256, True),
     # minitron-4b's prefill at one sequence: 24 heads over 8
     (1, 24, 8, 2048, 2048, 128, True),
     # granite-moe-1b-a400m's: 16 heads over 8 of 64, a GQA group of 2
     (1, 16, 8, 2048, 2048, 64, True), (2, 16, 8, 300, 300, 64, True)],
)
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, h, hkv, sq, sk, d, causal):
    q, k, v = flash_case(b, h, hkv, sq, sk, d, dtype, cuda)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    scaled = ops.flash_attention(q, k, v, causal=causal, scale=0.3)
    err = (scaled.float() - ref.flash_attention_ref(
        q, k, v, causal=causal, scale=0.3).float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_with_v_padded_from_64(cuda, dtype):
    """minicpm3-4b's prefill attention at one sequence of 300: q and k 96
    wide over 40 heads, v 64 wide zero-padded to 96 as ``sdpa`` passes it,
    MLA's scale 1 / sqrt(96); the padded columns of the output are 0 and
    the rest match the plain version."""
    q, k, v = flash_case(1, 40, 40, 300, 300, 96, dtype, cuda)
    v = torch.nn.functional.pad(v[..., :64], (0, 32))
    scale = 1 / np.sqrt(96)
    got = ops.flash_attention(q, k, v, scale=scale)
    want = ref.flash_attention_ref(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert bool((got[..., 64:] == 0).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_layer_on_the_card_matches_the_cpu(cuda, dtype):
    """minicpm3-4b's MLA layer at full width (d_model 2560, 40 heads, q and
    k 96 wide, v 64), random weights carried bit for bit: a prefill of 2 x
    40 tokens (``sdpa``: the flash kernel on the card, its plain version on
    the CPU), then three one-token steps into a compressed cache of 8
    positions; outputs and both cache planes within 1e-4 in f32 and 2e-2 in
    bf16."""
    from repro_torch.models import layers as t_layers

    cfg = dataclasses.replace(get_config("minicpm3-4b"), dtype=dtype, n_layers=1)
    dt = t_layers.torch_dtype(cfg)
    gen = torch.Generator().manual_seed(0)
    host = t_model.layer_params(t_layers.init_mla(cfg, gen, layers=1, device="cpu"), 0)
    card = {k: v.to(cuda) for k, v in host.items()}
    rng = np.random.default_rng(1)
    tol = 1e-4 if dtype == "float32" else 2e-2

    def check(got, want):
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        err = (got.cpu().float() - want.float()).abs().max().item()
        assert err <= tol, err

    x = torch.from_numpy(rng.standard_normal((2, 40, 2560))).to(dt)
    want, _ = t_layers.mla_attention(cfg, host, x, torch.arange(40))
    got, _ = t_layers.mla_attention(cfg, card, x.to(cuda), torch.arange(40, device=cuda))
    check(got, want)
    planes = [(torch.zeros((2, 8, 256), dtype=dt), torch.zeros((2, 8, 32), dtype=dt))]
    planes.append(tuple(p.to(cuda) for p in planes[0]))
    for t in range(3):
        x = torch.from_numpy(rng.standard_normal((2, 1, 2560))).to(dt)
        want, _ = t_layers.mla_attention(cfg, host, x, torch.tensor([t]), kv_cache=planes[0],
                                         cache_len=t)
        got, _ = t_layers.mla_attention(cfg, card, x.to(cuda), torch.tensor([t], device=cuda),
                                        kv_cache=planes[1], cache_len=t)
        check(got, want)
        for a, b in zip(planes[1], planes[0]):
            check(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_zeroes_rows_no_key_reaches(cuda, dtype):
    """Causal with Sk < Sq: query i sees keys up to i + Sk - Sq, so the
    first Sq - Sk rows see none; the kernel writes them 0 (the plain version
    NaN) and the rest match.  With no key at all (Sk = 0) every row is 0."""
    q, k, v = flash_case(1, 4, 2, 300, 100, 64, dtype, cuda)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert bool((got[:, :, :200] == 0).all())
    assert bool(want[:, :, :200].isnan().all())
    err = (got[:, :, 200:].float() - want[:, :, 200:].float()).abs().max().item()
    assert err <= TOL[dtype], err
    for causal in (True, False):
        empty = ops.flash_attention(q, k[:, :, :0], v[:, :, :0], causal=causal)
        torch.cuda.synchronize()
        assert empty.shape == q.shape and bool((empty == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_the_grid_limit(cuda, dtype):
    """B * H at 65,535, the most ``validate`` takes."""
    q, k, v = flash_case(3, 21_845, 257, 9, 9, 16, dtype, cuda)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_attention_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((2, 4, 12), device=cuda)  # head dim not a multiple of 8
    kp = torch.zeros((3, 4, 2, 12), device=cuda)
    tbl = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.paged_attention(q, kp, kp, tbl, lens)
    q = torch.zeros((2, 4, 16), device=cuda)
    kp = torch.zeros((3, 4, 2, 16), device=cuda)
    with pytest.raises(ValueError):  # pages in another dtype
        ops.paged_attention(q, kp.bfloat16(), kp.bfloat16(), tbl, lens)
    with pytest.raises(ValueError):  # int64 table
        ops.paged_attention(q, kp, kp, tbl.long(), lens)
    q4 = torch.zeros((1, 4, 8, 16), device=cuda)
    kv = torch.zeros((1, 3, 8, 16), device=cuda)  # 4 heads over 3
    with pytest.raises(ValueError):
        ops.flash_attention(q4, kv, kv)
    with pytest.raises(ValueError):  # a strided view
        ops.flash_attention(q4.transpose(1, 2), q4, q4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_step_kernel_matches_plain(cuda, dtype):
    """Three requests at lengths 1 (empty history), 17 and 40, pages of 16
    and a recycled page with stale rows: the step's logits with the kernel
    against ``use_kernel=False``.  Tolerance: 1e-4 in f32; 0.05 x RMS of
    the logits in bf16 (one bf16 rounding of each layer's attention output
    may differ)."""
    cfg = get_config("minitron-4b").reduced(
        n_layers=2, d_model=64, n_heads=6, n_kv_heads=2, head_dim=32, dtype=dtype
    )
    params = t_model.init_params(cfg, seed=0, device=cuda)
    kv = PagedKVCache(cfg=cfg, n_pages=12, page_size=16, max_batch=3, device=cuda)
    kv.k_pages.normal_()
    kv.v_pages.normal_()
    kv.admit_request(7, prompt_len=40)
    kv.release_request(7)  # its pages come back holding rows
    req = np.array([1, 2, 3])
    for r, n in zip(req, (0, 16, 39)):
        kv.admit_request(int(r), prompt_len=n)
        kv.extend_request(int(r))
    tok = torch.tensor([[5], [6], [7]], device=cuda)
    args = (cfg, params, tok, kv.k_pages, kv.v_pages, kv.resolve_tables(req, 3),
            kv.batch_seq_lens(req))
    got, k1, v1 = paged_decode_step(*args)
    want, k2, v2 = paged_decode_step(*args, use_kernel=False)
    torch.cuda.synchronize()
    # the first layer's new keys and values precede any attention
    assert torch.equal(k1[0], k2[0]) and torch.equal(v1[0], v2[0])
    err = (got - want).abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    assert err <= (1e-4 if dtype == "float32" else 0.05 * rms), (err, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_on_the_card_matches_the_cpu(cuda, dtype):
    """granite-moe-1b-a400m's MoE block at full width (d_model 1024, 32
    experts of 512, top-8) over 3 x 7 tokens, random weights carried bit for
    bit: the routing (top-k choices, and the pairs kept at the served
    capacity factor of 1.25) equal on both, the output within 1e-5 in f32
    and 2e-2 in bf16 (the products' sums and the scatter-add's order differ;
    ``index_add_`` on the card adds in no fixed order), and in bf16 an RMS
    difference of at most 1e-3 x RMS, the limit ``tests/test_torch_moe.py``
    sets between the sound rounding order and ``mlp``'s."""
    from repro_torch.models import layers as t_layers

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), dtype=dtype, n_layers=1)
    gen = torch.Generator().manual_seed(0)
    host = t_model.layer_params(t_layers.init_moe(cfg, gen, layers=1, device="cpu"), 0)
    card = {k: v.to(cuda) for k, v in host.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 7, 1024)) + 0.5)
    x = x.to(t_layers.torch_dtype(cfg))
    routes = []
    for p, xi in ((host, x), (card, x.to(cuda))):
        xt = xi.reshape(-1, 1024)
        _, idx, _ = t_layers.moe_route(cfg, p["router"], xt)
        keep = t_layers.moe_queue(idx, t_layers.moe_capacity(cfg, xt.shape[0]))[3]
        routes.append((idx.cpu(), keep.cpu()))
    assert torch.equal(routes[0][0], routes[1][0]) and torch.equal(routes[0][1], routes[1][1])
    want, want_aux = t_layers.moe_block(cfg, host, x)
    got, aux = t_layers.moe_block(cfg, card, x.to(cuda))
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == want.dtype
    diff = got.cpu().double() - want.double()
    err = diff.abs().max().item()
    assert err <= tol, err
    if dtype == "bfloat16":
        rms = (diff.pow(2).mean() / want.double().pow(2).mean()).sqrt().item()
        assert rms <= 1e-3, rms
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def mamba_case(b, l, d, n, seed, dtype):
    """``mamba_scan`` operands: delta at the model's init scale
    (``softplus(N(0, 1) - 4)``) with every fifth channel decay-heavy (0.5-2),
    ``A = -(1..N) / N``, ``B``, ``C``, ``x`` N(0, 1) in ``dtype``."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((b, l, d)) - 4))
    delta[..., ::5] = rng.uniform(0.5, 2.0, size=delta[..., ::5].shape)
    A = -np.tile((1.0 + np.arange(n)) / n, (d, 1))
    f32 = [torch.from_numpy(a.astype(np.float32)) for a in (delta, A)]
    rest = [torch.from_numpy(rng.standard_normal(s)).to(dtype) for s in ((b, l, n), (b, l, n), (b, l, d))]
    return f32 + rest


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,l,d,n",
    [(2, 256, 1024, 16), (2, 256, 640, 64), (1, 100, 1000, 16), (2, 70, 333, 64),
     (2, 1, 512, 16), (1, 33, 64, 8), (1, 35, 7, 1)],
)
def test_mamba_scan_kernel_matches_plain(cuda, dtype, b, l, d, n):
    """The phase-3 cases of ``chip_smoke.py`` cut down: y and the final state
    within 1e-4 + 1e-4 |plain| at every plan variant of the shape."""
    from repro_torch.kernels import mamba_scan as mamba_mod

    args = [t.to(cuda) for t in mamba_case(b, l, d, n, l + d + n, dtype)]
    want = ref.mamba_scan_ref(*args)
    sms, item = mamba_mod.device_sms(cuda), args[-1].element_size()
    for label, p in [("ops", None), *mamba_mod.variants(b, d, n, sms, item).items()]:
        got = ops.mamba_scan(*args) if p is None else mamba_mod.launch(
            ops.library(), *args, plan=p
        )
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            excess = ((g - w).abs() - 1e-4 * w.abs()).max().item()
            assert excess <= 1e-4, (label, excess)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n", [(2, 256, 1024, 16), (2, 256, 640, 64), (1, 70, 333, 12)])
def test_mamba_scan_state_bit_equal_where_decay_is_not_heavy(cuda, dtype, b, l, d, n):
    """The state update rounds as the plain version's tensor operations do,
    so the final state is bit-equal to the plain version's on every channel
    outside the decay-heavy fifth (``mamba_case``), at every plan variant."""
    from repro_torch.kernels import mamba_scan as mamba_mod

    args = [t.to(cuda) for t in mamba_case(b, l, d, n, 7 + d, dtype)]
    _, want = ref.mamba_scan_ref(*args)
    calm = torch.arange(d, device=cuda) % 5 != 0
    item = args[-1].element_size()
    for label, p in mamba_mod.variants(b, d, n, mamba_mod.device_sms(cuda), item).items():
        _, h = mamba_mod.launch(ops.library(), *args, plan=p)
        torch.cuda.synchronize()
        assert torch.equal(h[:, calm], want[:, calm]), label


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,change",
    [(16, dict(channels=12)), (16, dict(channels=4)), (16, dict(chunk=12)),
     (16, dict(chunk=128)), (16, dict(states=8, lanes=2)), (16, dict(lanes=32, states=1)),
     (2, dict(lanes=2, states=1))],
)
def test_mamba_scan_entry_refuses_a_plan_it_cannot_run(cuda, n, change):
    """A plan with no kernel (8 states x 2 lanes, 32 lanes, fewer than four
    states a channel), a CTA of channels not a multiple of 8, or a chunk
    not a multiple of 8 or past 64: the CUDA entry launches nothing and
    reports CUDA error 1 (invalid value)."""
    from repro_torch.kernels import mamba_scan as mamba_mod

    args = [t.to(cuda) for t in mamba_case(2, 40, 64, n, 0, torch.float32)]
    p = dataclasses.replace(mamba_mod.plan(2, 64, n, item=4), **change)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        mamba_mod.launch(ops.library(), *args, plan=p)


@pytest.mark.cuda
def test_mamba_scan_kernel_edge_inputs(cuda):
    """ROADMAP queue 3 entry 14's input gives the recurrence's 2.313; L = 0
    gives an empty y and a zero state; a strided B is refused."""
    one = torch.ones((1, 35, 1), device=cuda)
    y, h = ops.mamba_scan(2 * one, -torch.ones((1, 1), device=cuda), one, one, one)
    assert abs(y[0, -1, 0].item() - 2.313) < 1e-3 and abs(h.item() - 2.313) < 1e-3
    delta, A, bm, c, x = (t.to(cuda) for t in mamba_case(2, 8, 40, 16, 0, torch.float32))
    y, h = ops.mamba_scan(delta[:, :0].contiguous(), A, bm[:, :0].contiguous(),
                          c[:, :0].contiguous(), x[:, :0].contiguous())
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 40) and h.shape == (2, 40, 16) and not h.any()
    wide = torch.cat([bm, c], -1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_scan(delta, A, wide[..., :16], c, x)
    with pytest.raises(ValueError):  # B in another dtype than x
        ops.mamba_scan(delta, A, bm.bfloat16(), c, x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_forward_matches_decode_on_the_card(cuda, name):
    """Reduced float32 model: ``forward`` (the kernel) against
    ``decode_step`` a token at a time (the recurrence), within 1e-4."""
    cfg = get_config(name).reduced(dtype="float32")
    params = t_model.init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 20))).to(cuda)
    full, _ = t_model.forward(cfg, params, toks)
    cache = t_model.init_decode_cache(cfg, 2, 20, device=cuda)
    dec = torch.stack(
        [t_model.decode_step(cfg, params, toks[:, t : t + 1], cache, t)[0] for t in range(20)], 1
    )
    assert (dec - full).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,sq,sk",
    # whisper-small's shapes, 12 heads over 12 of 64, non-causal: the
    # encoder's 1,500 frames (11 whole 128-row kv tiles and a masked tail of
    # 92), the prefill's cross attention, and the decode step's, one query
    # row over the 1,500-frame cross cache
    [(64, 1500, 1500), (8, 448, 1500), (64, 1, 1500)],
    ids=["encoder", "prefill-cross", "decode-cross"],
)
def test_flash_attention_kernel_at_whisper_shapes(cuda, dtype, b, sq, sk):
    q, k, v = flash_case(b, 12, 12, sq, sk, 64, dtype, cuda)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_decode_on_the_card_matches_the_cpu(cuda, dtype):
    """Reduced whisper-small (2 encoder and 2 decoder layers) over 48
    frames: ``prefill_cross_kv`` and six ``decode_step``s of three slots on
    the card (the flash kernel, one query row in the cross attention)
    against the CPU (its plain version), weights carried bit for bit; the
    logits and the cross planes within 1e-4 in f32 and 2e-2 in bf16, and
    the card's decode against its own ``forward``."""
    from repro_torch.models import layers as t_layers

    cfg = get_config("whisper-small").reduced(dtype=dtype)
    dt = t_layers.torch_dtype(cfg)
    host = t_model.init_params(cfg, seed=0, device="cpu")
    card = t_model.params_from_numpy(cfg, t_model.params_to_numpy(host), cuda)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((3, 48, cfg.d_model))).to(dt)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 6)))
    tol = 1e-4 if dtype == "float32" else 2e-2
    runs = []
    for params, dev in ((host, "cpu"), (card, cuda)):
        cache = t_model.init_decode_cache(cfg, 3, 6, device=dev, enc_len=48)
        t_model.prefill_cross_kv(cfg, params, emb.to(dev), cache)
        logits = torch.stack([
            t_model.decode_step(cfg, params, toks[:, t : t + 1].to(dev), cache, t)[0]
            for t in range(6)
        ], 1)
        runs.append((logits.cpu(), cache["xk"].cpu(), cache["xv"].cpu()))
    torch.cuda.synchronize()
    for got, want in zip(runs[1], runs[0]):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, err
    full, _ = t_model.forward(cfg, card, toks.to(cuda), enc_emb=emb.to(cuda))
    err = (full.cpu() - runs[1][0]).abs().max().item()
    assert err <= tol, err


# the backward of flash_attention: each gradient within this share of its
# largest magnitude (bf16: P and dS are rounded to bf16 as wgmma
# operands, measured about 5e-3; f32: sums in another order, about 1e-6)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def grad_err(got, want):
    return max(
        float((g.double() - w.double()).abs().max() / w.double().abs().max().clamp(min=1e-30))
        for g, w in zip(got, want)
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,d,causal",
    [  # minitron-4b's training shape, cut to 512 positions: 24 heads over 8
     (1, 24, 8, 512, 512, 128, True),
     # granite-moe-1b-a400m's: 16 heads over 8 of 64
     (2, 16, 8, 256, 256, 64, True),
     # whisper-small's cross attention, non-causal, G = 1, cut
     (2, 12, 12, 100, 300, 64, False),
     # zamba2-2.7b's and minicpm3-4b's head dims, ragged lengths, Sq < Sk
     (1, 4, 4, 150, 230, 80, True), (1, 6, 2, 77, 129, 96, True),
     # Sq > Sk: rows no key reaches get dq = 0
     (1, 4, 2, 150, 70, 64, True),
     # lengths off the 64- and 128-row tiles: G = 3 causal, G = 1 not
     (1, 6, 2, 200, 333, 128, True), (2, 4, 4, 130, 190, 64, False),
     # one query row over a 1,500-frame source, non-causal, G = 1
     (1, 6, 6, 1, 1500, 64, False),
     # G = 6 at D = 96; and Sq > Sk at D = 128, rows no key reaches
     (1, 6, 1, 100, 300, 96, True), (1, 6, 1, 257, 130, 128, True)],
)
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, b, h, hkv, sq, sk, d, causal):
    """The backward kernel against ``flash_attention_bwd_ref`` on the
    forward kernel's own output and log-sum-exp; two launches bit-equal,
    one launch counted each."""
    q, k, v = flash_case(b, h, hkv, sq, sk, d, dtype, cuda)
    do = flash_case(b, h, h, sq, sq, d, dtype, cuda)[0]
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert [t.dtype for t in got] == [dtype] * 3
    assert grad_err(got, want) <= GRAD_TOL[dtype]
    if causal and sq > sk:
        assert bool((got[0][:, :, : sq - sk] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_forward_lse_matches_plain(cuda, dtype):
    """Both forward kernels' natural log-sum-exp (the bf16 one from its
    base-2 softmax) within 1e-5 in f32 and 1e-3 in bf16 of the plain
    version's, -inf at rows no key reaches; without the pointer the output
    is the same."""
    q, k, v = flash_case(1, 4, 2, 300, 200, 128, dtype, cuda)
    o, lse = ops.flash_attention_fwd(q, k, v, with_lse=True, scale=0.2)
    want_o, want = ref.flash_attention_ref(q, k, v, with_lse=True, scale=0.2)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 300)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    live = torch.isfinite(want)
    assert float((lse[live] - want[live]).abs().max()) <= LSE_TOL[dtype]
    assert torch.equal(o, ops.flash_attention_fwd(q, k, v, scale=0.2))
    empty = ops.flash_attention_fwd(q, k[:, :, :0], v[:, :, :0], with_lse=True)
    assert bool((empty[0] == 0).all()) and bool(torch.isinf(empty[1]).all())


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_other_head_dims(cuda):
    q, k, v = flash_case(1, 2, 2, 16, 16, 32, torch.bfloat16, cuda)
    o, lse = ops.flash_attention_fwd(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention_bwd(q, k, v, o, o, lse)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """A reduced minitron-4b (2 layers, head dim 64, float32, remat) train
    step on the card (the flash kernels, forward and backward) against the
    same step on the CPU (their plain versions), weights carried bit for
    bit: the loss within 1e-5 relative, every gradient within 1e-3 x its
    RMS, the parameters after the update within 5% of the learning rate;
    every gradient finite and not all zero."""
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.train import optimizer as t_opt
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    cfg = dataclasses.replace(
        get_config("minitron-4b").reduced(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
                                          dtype="float32"), remat=True)
    host = t_model.init_params(cfg, seed=0, device="cpu")
    batch = TokenPipeline(cfg, global_batch=2, seq_len=96, seed=1).next_batch()
    runs = []
    for dev in ("cpu", cuda):
        params = t_model.params_from_numpy(cfg, t_model.params_to_numpy(host), dev)
        before = ops.LAUNCHES["flash_attention_bwd"]
        loss, _, grads = loss_and_grads(cfg, params, to_device(batch, cfg, dev))
        launched = ops.LAUNCHES["flash_attention_bwd"] - before
        assert launched == (cfg.n_layers if dev != "cpu" else 0)
        ocfg = t_opt.OptConfig(warmup_steps=1, total_steps=3)
        step = make_train_step(cfg, ocfg)
        params, _, m = step(params, t_opt.init_opt_state(params, ocfg), to_device(batch, cfg, dev))
        runs.append((loss.cpu(), t_opt.tree_map(lambda t: t.cpu(), grads),
                     t_opt.tree_map(lambda t: t.cpu(), params), float(m["loss"])))
    torch.cuda.synchronize()
    (l0, g0, p0, m0), (l1, g1, p1, m1) = runs
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    assert abs(m1 - m0) <= 1e-5 * abs(m0)
    for a, b in zip(t_opt.leaves(g0), t_opt.leaves(g1)):
        rms = float(a.double().pow(2).mean().sqrt())
        assert bool(torch.isfinite(b).all()) and rms > 0
        assert float((a - b).abs().max()) <= 1e-3 * rms
    for a, b in zip(t_opt.leaves(p0), t_opt.leaves(p1)):
        assert float((a - b).abs().max()) <= 0.05 * 3e-4


@pytest.mark.cuda
def test_head_product_gradient_on_the_card(cuda):
    """The bf16 head product keeps its f32 result, and its backward is the
    f32 product of the operands with the output gradient rounded once to
    bf16 (the design's one rounding), within 1e-2 of the largest
    magnitude (each result is rounded to bf16 once)."""
    rng = np.random.default_rng(7)
    x, head = (torch.from_numpy(rng.standard_normal(s)).to(cuda, torch.bfloat16)
               for s in ((2, 24, 128), (128, 1000)))
    g = torch.from_numpy(rng.standard_normal((2, 24, 1000)).astype(np.float32)).to(cuda)
    xs, hs = x.clone().requires_grad_(), head.clone().requires_grad_()
    out = t_model._logits(xs, hs)
    assert out.dtype == torch.float32
    out.backward(g)
    xf, hf = x.float().requires_grad_(), head.float().requires_grad_()
    want = xf @ hf
    want.backward(g.to(torch.bfloat16).float())
    assert float((out - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for got, ref_ in ((xs.grad, xf.grad), (hs.grad, hf.grad)):
        assert got.dtype == torch.bfloat16
        assert float((got.float() - ref_).abs().max()) <= 1e-2 * float(ref_.abs().max())


def mamba_bwd_case(b, l, d, n, seed, dtype):
    """``mamba_case`` with the output gradients ``dy`` [B, L, D] and
    ``dh_last`` [B, D, N] (f32)."""
    args = [t.cuda() for t in mamba_case(b, l, d, n, seed, dtype)]
    rng = np.random.default_rng(seed + 1)
    dy, dh = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
              for s in ((b, l, d), (b, d, n)))
    return args, dy, dh


def rel_errs(got, want):
    """Each gradient's largest |difference| over its largest |plain|."""
    return [float((g.double() - w.double()).abs().max() / w.double().abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,l,d,n",
    [(2, 67, 333, 8), (2, 31, 40, 64), (1, 33, 100, 16), (1, 1, 16, 4),
     (2, 4096, 8192, 16), (2, 4096, 5120, 64),
     # 25 CTAs of 16 channels in 4 clusters of 7: the last cluster's last
     # three CTAs hold no channel; L off the 8-step sub-block
     (1, 37, 390, 64),
     # three batch elements, 3 clusters of 7 CTAs each
     (3, 45, 333, 16)],
)
def test_mamba_scan_bwd_kernel_matches_plain(cuda, b, l, d, n, dtype, with_dh):
    """The backward kernel on the forward kernel's saved states against the
    plain backward: each gradient within 1e-4 of its largest magnitude (f32
    sums in another order; measured up to 3.5e-6 at the full shapes), two
    launches bit-equal, and, at the small shapes, the kernel's torch
    decomposition (``lane_scan_bwd``: its warps, cluster ranks and clusters
    in order) bit for bit.  The forward with its states gives the forward's
    outputs bit for bit."""
    from repro_torch.kernels import mamba_scan as mamba_mod

    args, dy, dh = mamba_bwd_case(b, l, d, n, b + l + d + n, dtype)
    dh = dh if with_dh else None
    y0, h0 = ops.mamba_scan(*args)
    y, h, states = ops.mamba_scan_fwd(*args, with_states=True)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    before = ops.LAUNCHES["mamba_scan_bwd"]
    got = ops.mamba_scan_bwd(*args, dy, dh, states=states)
    again = ops.mamba_scan_bwd(*args, dy, dh, states=states)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan_bwd"] == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert max(rel_errs(got, ref.mamba_scan_bwd_ref(*args, dy, dh))) <= 1e-4
    if l * d <= 40_000:
        p = mamba_mod.device_plan_bwd(ops.library(), cuda, b, d, n, args[-1].element_size())
        want = mamba_mod.lane_scan_bwd(*args, dy, dh, p)
        assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.cuda
def test_mamba_scan_bwd_entry_refuses_a_plan_it_cannot_run(cuda):
    """A pair the backward has no kernel for (2 lanes), and a missing set of
    saved states: nothing launches."""
    from repro_torch.kernels import mamba_scan as mamba_mod

    args, dy, _ = mamba_bwd_case(2, 40, 64, 8, 0, torch.float32)
    _, _, states = ops.mamba_scan_fwd(*args, with_states=True)
    p = dataclasses.replace(mamba_mod.plan_bwd(2, 64, 8, item=4), states=4, lanes=2)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        mamba_mod.launch_bwd(ops.library(), *args, dy, None, states, plan=p)
    with pytest.raises(ValueError, match="states"):
        ops.mamba_scan_bwd(*args, dy)


@pytest.mark.cuda
def test_mamba_scan_under_checkpoint(cuda):
    """``MambaScan`` under ``torch.utils.checkpoint``: the forward runs
    without grad, the recompute with its states (two ``mamba_scan``
    launches), one backward launch, and the gradients equal those of the
    same graph without the checkpoint bit for bit."""
    from torch.utils.checkpoint import checkpoint

    args, dy, dh = mamba_bwd_case(2, 100, 256, 16, 3, torch.bfloat16)

    def f(*a):
        y, h = ops.mamba_scan(*a)
        return (y * dy).sum() + (h * dh).sum()

    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(f(*plain), plain)
    held = [t.clone().requires_grad_() for t in args]
    before = dict(ops.LAUNCHES)
    got = torch.autograd.grad(checkpoint(f, *held, use_reentrant=False), held)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == before["mamba_scan"] + 2
    assert ops.LAUNCHES["mamba_scan_bwd"] == before["mamba_scan_bwd"] + 1
    for a, c, t in zip(got, want, args):
        assert a.dtype == t.dtype and torch.equal(a, c)


@pytest.mark.cuda
def test_ssm_train_step_on_the_card_matches_the_cpu(cuda):
    """A reduced zamba2-2.7b (4 Mamba layers, the shared block after every
    2, head dim 64 for the flash kernels, float32, remat) train step on the
    card (the mamba_scan and flash kernels, forward and backward) against
    the same step on the CPU (their plain versions), weights carried bit
    for bit: the loss within 1e-5 relative, every gradient within 1e-3 x
    its RMS, the parameters after the update within 5% of the learning
    rate; every gradient finite and not all zero."""
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.train import optimizer as t_opt
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    cfg = dataclasses.replace(
        get_config("zamba2-2.7b").reduced(d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                                          dtype="float32"), remat=True)
    host = t_model.init_params(cfg, seed=0, device="cpu")
    batch = TokenPipeline(cfg, global_batch=2, seq_len=96, seed=1).next_batch()
    runs = []
    for dev in ("cpu", cuda):
        params = t_model.params_from_numpy(cfg, t_model.params_to_numpy(host), dev)
        before = ops.LAUNCHES["mamba_scan_bwd"]
        loss, _, grads = loss_and_grads(cfg, params, to_device(batch, cfg, dev))
        launched = ops.LAUNCHES["mamba_scan_bwd"] - before
        assert launched == (cfg.n_layers if dev != "cpu" else 0)
        ocfg = t_opt.OptConfig(warmup_steps=1, total_steps=3)
        step = make_train_step(cfg, ocfg)
        params, _, m = step(params, t_opt.init_opt_state(params, ocfg), to_device(batch, cfg, dev))
        runs.append((loss.cpu(), t_opt.tree_map(lambda t: t.cpu(), grads),
                     t_opt.tree_map(lambda t: t.cpu(), params), float(m["loss"])))
    torch.cuda.synchronize()
    (l0, g0, p0, m0), (l1, g1, p1, m1) = runs
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    assert abs(m1 - m0) <= 1e-5 * abs(m0)
    for a, b in zip(t_opt.leaves(g0), t_opt.leaves(g1)):
        rms = float(a.double().pow(2).mean().sqrt())
        assert bool(torch.isfinite(b).all()) and rms > 0
        assert float((a - b).abs().max()) <= 1e-3 * rms
    for a, b in zip(t_opt.leaves(p0), t_opt.leaves(p1)):
        assert float((a - b).abs().max()) <= 0.05 * 3e-4


ENGINE_CASES = {
    # label: (ops, traffic, policy, pipeline, divergent)
    "pipelined": (("lookup", "update", "insert"), "mixed", "fetch", True, False),
    "pipelined auto": (("lookup", "update", "insert"), "mixed", "auto", True, False),
    "pipelined scans": (("lookup", "update", "insert", "scan"), "scans", "fetch", True,
                        False),
    "divergent": (("lookup", "update", "insert"), "mixed", "fetch", False, True),
    "divergent lookups": (("lookup",), "lookups", "fetch", False, True),
    "divergent pipelined": (("lookup", "update"), "mixed", "fetch", True, True),
}


def engine_traffic(kind, keys, rng):
    """Three batches of 4,096 lanes: lookups (misses, inactive lanes), or
    lookups, updates and inserts (hot keys written in every batch, 30 fresh
    keys into one leaf in batch 1), with scans of up to 40 records."""
    out = []
    for i in range(3):
        if kind == "lookups":
            q = rng.choice(keys, size=4096).astype(np.int64)
            q[::13] += 1
            q[::29] = KEY_MAX
            out.append((np.zeros(4096, np.int32), q, np.zeros(4096, np.int64)))
            continue
        opc = rng.integers(0, 3, size=4096).astype(np.int32)
        kk = rng.choice(keys, size=4096)
        fresh = kk + rng.integers(1, 4, size=4096)
        ins = (opc == 2) & ~np.isin(fresh, keys)
        kk[ins] = fresh[ins]
        opc[:16] = 1
        kk[:16] = keys[100:116]
        if i == 1:
            opc[16:46] = 2
            kk[16:46] = keys[4400:4430] + 1
        vals = kk ^ rng.integers(1, 2**40, size=4096)
        kk[::29] = KEY_MAX
        if kind == "scans":
            scn = (np.arange(4096) >= 46) & (rng.random(4096) < 0.35)
            opc[scn] = 3
            vals[scn] = rng.integers(1, 41, size=int(scn.sum()))
        out.append((opc, kk, vals))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(ENGINE_CASES))
def test_pipelined_and_divergent_engines_on_the_card_match_the_cpu(cuda, label):
    """The pipelined engine and the divergent cache policy (peek budget 512)
    at 2x4 on 20k keys, on the CPU (plain versions) and on the card
    (kernels): every plane after every step, and every result, bit-equal;
    ``chip_smoke.py`` phase 4's cases."""
    from repro_torch.core import dex, engine, fleet_cache
    from repro_torch.obs import registry as reg

    ops_, kind, policy, pipelined, divergent = ENGINE_CASES[label]
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    keys -= 2**39
    bounds = np.array([KEY_MIN, keys[keys.size // 2], KEY_MAX], np.int64)
    batches = engine_traffic(kind, keys, rng)
    cfg = dex.DexMeshConfig(n_route=2, n_memory=4, cache_sets=64, cache_ways=4,
                            policy=policy, route_capacity_factor=4.0)
    pol = fleet_cache.divergent_policy(cfg, peek_budget=512) if divergent else None
    runs = []
    for dev in ("cpu", cuda):
        pool, meta = t_pool.build_pool(keys, keys ^ 0x5DEECE66D, level_m=1, n_shards=4,
                                       device=dev)
        state = dex.init_state(pool, meta, cfg, bounds, device=dev)
        eng = engine.make_dex_engine(meta, cfg, ops=ops_, max_count=32, cache_policy=pol,
                                     pipeline=pipelined, device=dev)
        steps = []
        if pipelined:
            eng.start(state)
        for b in batches + ([None] if pipelined else []):
            if pipelined:
                r = eng.push(*b) if b is not None else eng.drain()
                state = eng.state
            else:
                state, r = eng(state, *b)
            got = dex.state_to_numpy(state)
            for k, a in (r._asdict() if r is not None else {}).items():
                if a is not None:
                    got[k] = a.cpu().numpy()
            steps.append(got)
        runs.append(steps)
    for i, (a, b) in enumerate(zip(*runs)):
        assert sorted(a) == sorted(b), i
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label} step {i}: {k}")
    stats = runs[0][-1]["stats"].sum(0)
    if pipelined and policy == "fetch":
        assert stats[reg.STAT_PIPE_STALLS] > 0
    if divergent:
        assert stats[reg.STAT_PEER_HITS] + stats[reg.STAT_PEER_MISSES] > 0


AXES_CASES = {
    # label: (ops, traffic, policy, route capacity factor)
    "lookups fetch": (("lookup",), "lookups", "fetch", 4.0),
    "lookups auto shedding": (("lookup",), "lookups", "auto", 0.75),
    "mixed auto": (("lookup", "update", "insert"), "mixed", "auto", 4.0),
    "scans auto": (("lookup", "update", "insert", "scan"), "scans", "auto", 4.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(AXES_CASES))
def test_two_route_axes_on_the_card_match_the_cpu(cuda, label):
    """The engine on a 2x2x2 virtual mesh (route axes ``("data", "pod")`` of
    2 x 2 over 2 memory columns) on 20k keys, on the CPU (plain versions)
    and on the card (kernels): every plane and result after every batch
    bit-equal, and equal collective counts (two ``all_to_all`` a route
    exchange)."""
    from repro_torch.core import dex, engine, mesh

    ops_, kind, policy, factor = AXES_CASES[label]
    rng = np.random.default_rng(1)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    keys -= 2**39
    bounds = np.array([KEY_MIN] + [int(keys[keys.size * i // 4]) for i in (1, 2, 3)]
                      + [KEY_MAX], np.int64)
    batches = engine_traffic(kind, keys, rng)
    cfg = dex.DexMeshConfig(route_axes=("data", "pod"), route_shape=(2, 2), n_route=4,
                            n_memory=2, cache_sets=64, cache_ways=4, policy=policy,
                            route_capacity_factor=factor)
    runs = []
    for dev in ("cpu", cuda):
        pool, meta = t_pool.build_pool(keys, keys ^ 0x5DEECE66D, level_m=1, n_shards=2,
                                       device=dev)
        state = dex.init_state(pool, meta, cfg, bounds, device=dev)
        eng = engine.make_dex_engine(meta, cfg, ops=ops_, max_count=32, device=dev)
        steps = []
        for b in batches:
            mesh.reset_counts()
            state, r = eng(state, *b)
            got = dex.state_to_numpy(state)
            got.update({k: a.cpu().numpy() for k, a in r._asdict().items() if a is not None})
            got["counts"] = np.array(list(mesh.collective_counts().values()))
            steps.append(got)
        runs.append(steps)
    for i, (a, b) in enumerate(zip(*runs)):
        assert sorted(a) == sorted(b), i
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label} batch {i}: {k}")


@pytest.mark.cuda
def test_settle_splits_with_a_drain_on_the_card_matches_the_cpu(cuda):
    """An insert batch into six leaves of one block whose free list holds
    three rows, settled by ``settle_splits`` (three leaves split on the
    mesh, the rest drained through the ``HostBTree`` mirror), then a lookup
    batch through ops rebuilt against the new meta: every plane, ``meta``,
    ``info`` and result equal on the CPU and the card, and the mirror's
    planes too."""
    from repro_torch.core import dex, sim, smo, write

    rng = np.random.default_rng(3)
    keys = np.sort(rng.choice(48_000, size=3000, replace=False).astype(np.int64) + 1)
    burst = [rng.choice(np.setdiff1d(np.arange(keys[i * 44] + 1, keys[i * 44 + 43]), keys),
                        30, replace=False) for i in range(6)]
    kk = np.full(256, KEY_MAX, np.int64)
    kk[:180] = rng.permutation(np.concatenate(burst))
    vv = np.where(kk != KEY_MAX, kk * 11, 0)
    probe = np.concatenate([kk[:180], keys[::10]])
    cfg = dex.DexMeshConfig(cache_sets=128, policy="fetch")
    bounds = np.array([KEY_MIN, KEY_MAX], np.int64)
    runs = []
    for dev in ("cpu", cuda):
        pool, meta = t_pool.build_pool(keys, keys * 5, level_m=1, headroom=0.05, device=dev)
        state = dex.init_state(pool, meta, cfg, bounds, device=dev)
        host = sim.HostBTree(keys, keys * 5)
        state, st = write.make_dex_insert(meta, cfg, device=dev)(state, kk, vv)
        shed = st.cpu().numpy() == write.STATUS_SPLIT
        round_ = smo.make_dex_smo(meta, cfg, device=dev)
        state, meta, info = smo.settle_splits(
            state, meta, cfg, round_, host, np.where(shed, kk, KEY_MAX),
            np.where(shed, vv, 0), bounds,
        )
        state, found, vals, _ = dex.make_dex_lookup(meta, cfg, device=dev)(state, probe)
        got = dex.state_to_numpy(state)
        got.update(found=found.cpu().numpy(), vals=vals.cpu().numpy(),
                   **{p: getattr(host, p) for p in ("K", "C", "V", "NK", "parent")})
        runs.append((got, dataclasses.asdict(meta), info))
    (a, meta_a, info_a), (b, meta_b, info_b) = runs
    assert info_a == info_b and info_a["drained"] and info_a["onmesh"] > 0
    assert meta_a == meta_b
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["found"].all()


@pytest.mark.cuda
def test_fence_waits_for_the_card(cuda):
    """``obs.timeline.fence`` on a tree of CUDA tensors returns only after
    the card has run the work queued before it."""
    from repro_torch.obs import timeline

    x = torch.ones(4096, 4096, device=cuda)
    for _ in range(20):
        x = x @ x / 4096
    done = torch.cuda.Event()
    done.record()
    tree = {"a": (x, [torch.zeros(3, device=cuda)]), "b": 1}
    assert timeline.fence(tree) is tree
    assert done.query()


@pytest.mark.cuda
def test_launch_ranges_time_each_launch_on_the_card(cuda):
    """Each ``flash_attention`` launch's profiler range (kernel and shapes)
    spans its kernel on the device, so device time is read by range."""
    from torch.autograd import DeviceType

    q = torch.randn(1, 4, 256, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 4, 512, 64, device=cuda, dtype=torch.bfloat16)
    ops.flash_attention(q, k, k)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for causal in (True, False, True):
            ops.flash_attention(q, k, k, causal=causal)
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.name.startswith("flash_attention "):
            spans.setdefault((e.name, e.device_type), []).append(e.time_range.elapsed_us())
    causal = ops.launch_label("flash_attention", q.shape, k.shape, causal=True)
    full = ops.launch_label("flash_attention", q.shape, k.shape, causal=False)
    for device in (DeviceType.CPU, DeviceType.CUDA):
        assert len(spans[(causal, device)]) == 2 and len(spans[(full, device)]) == 1
    assert all(t > 0 for t in spans[(full, DeviceType.CUDA)])


@pytest.mark.cuda
def test_expert_product_has_a_gradient_on_the_card(cuda):
    """On the card a bf16 expert product asks for its f32 result directly,
    a form of ``torch.bmm`` without a derivative, so MoE training failed
    there ("derivative for aten::bmm is not implemented") while the CPU's
    f32 copies trained.  ``BmmF32`` gives it the gradient of those
    copies: the f32 output gradient times the other operand in f32,
    rounded to bf16."""
    from repro_torch.models import layers as t_layers

    g = torch.Generator().manual_seed(0)
    a = torch.randn(4, 32, 64, generator=g).to(cuda, torch.bfloat16).requires_grad_()
    b = torch.randn(4, 64, 48, generator=g).to(cuda, torch.bfloat16).requires_grad_()
    w = torch.randn(4, 32, 48, generator=g).to(cuda)
    out = t_layers._bmm_f32(a, b)
    assert out.dtype == torch.float32
    da, db = torch.autograd.grad((out * w).sum(), (a, b))
    a32, b32 = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
    want = torch.bmm(a32, b32)
    ea, eb = torch.autograd.grad((want * w).sum(), (a32, b32))
    assert float((out - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert da.dtype == db.dtype == torch.bfloat16
    assert torch.equal(da, ea.to(torch.bfloat16)) and torch.equal(db, eb.to(torch.bfloat16))


@pytest.mark.cuda
def test_launcher_trains_moe_on_the_card_and_resumes(cuda, tmp_path, monkeypatch):
    """``launch/train.py`` on the card: a reduced granite-moe-1b-a400m (bf16,
    head dim 64 for the flash backward, its expert products on the
    f32-result path) trains 2 steps with a checkpoint a step, and the last
    checkpoint restores onto the card bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import leaves

    arch = "granite-moe-1b-a400m"
    monkeypatch.setitem(registry.ARCHS, arch, registry.ARCHS[arch].reduced(head_dim=64, remat=True))
    run = launch.build_run(arch, batch=2, seq=64, steps=2, ckpt_dir=str(tmp_path))
    losses, _ = launch.train(run, 2, ckpt_every=1, log_every=10)
    assert run.step == 2 and all(np.isfinite(losses))
    back, step, _ = CheckpointManager(str(tmp_path)).restore((run.params, run.opt_state))
    assert step == 2 and back[1].step == 2
    for got, want in zip(leaves(back[0]), leaves(run.params)):
        assert got.device.type == "cuda" and torch.equal(got, want)


@pytest.mark.cuda
def test_dryrun_predicted_peak_matches_the_card(cuda):
    """A train step of falcon-mamba-7b and minitron-4b cut to 4 layers of
    width 1,024 (vocab 4,096) at 2 x 1,024 tokens: the dry-run's predicted
    peak (``launch/dryrun.py::lower_cell`` on the meta device: the
    parameters', moments' and batch's bytes plus the counted step's peak)
    within 15% of ``torch.cuda.max_memory_allocated`` over the step, from
    what was allocated before the parameters."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeCell
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    for arch in ("falcon-mamba-7b", "minitron-4b"):
        cfg = get_config(arch).reduced(remat=True, head_dim=64, n_layers=4, d_model=1024,
                                       d_ff=2048, vocab=4096, n_heads=16, n_kv_heads=4)
        b, s = 2, 1024
        low = dryrun.lower_cell(cfg, ShapeCell("t", s, b, "train"),
                                make_mesh((1, 1), ("data", "model"), "meta"), "1x1",
                                microbatches=1)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = t_model.init_params(cfg, 0, device=cuda)
        opt = init_opt_state(params, OptConfig())
        toks = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32, device=cuda)
        make_train_step(cfg, OptConfig())(params, opt, {"tokens": toks, "labels": toks.clone()})
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
        predicted = low.argument_bytes + low.temp_bytes
        assert abs(predicted / measured - 1) <= 0.15, (arch, predicted, measured)
        del params, opt, toks
        torch.cuda.empty_cache()
