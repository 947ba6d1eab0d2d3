"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on an NVIDIA GPU.  Imports neither JAX nor the reference package, so it
runs where only PyTorch and the CUDA toolkit are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips with its reason."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


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
