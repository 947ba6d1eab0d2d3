"""The port's prefix-compressed separators against the reference's, bit for
bit on the CPU:

* ``compress_rows`` on edge rows: empty, a single key, ``nbits`` exactly 30
  and 31, spans across the sign bit, ``KEY_MIN`` and keys next to
  ``KEY_MAX``, and seeded rows of every span;
* ``compress_separators`` and ``sep_compression_stats`` on built pools;
* ``smo.refresh_sep_planes`` after an SMO round, equal to the reference's
  and to a fresh ``compress_separators`` of the new pool; a view of the
  live versions plane refreshes nothing, which is why the caller passes a
  copy;
* ``node_search_prefix_ref`` against the reference's Pallas kernel
  (interpret mode) and its jnp oracle, and its slot equal to
  ``node_search``'s (``pool._slot``) for every query below KEY_MAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import smo as ref_smo  # noqa: E402
from repro.core import write as ref_write  # noqa: E402
from repro.kernels import node_search as ref_ns  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import smo as t_smo  # noqa: E402
from repro_torch.core import write as t_write  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

#: the reference runs its jnp kernels (``repro/kernels/ref.py``), bit for bit
#: its Pallas ones (``tests/test_kernels.py``), which hold the port's kernels in
#: ``tests/test_torch_{kernels,write,scan,smo}.py``: interpret mode's trace and
#: compile were most of a reference run's time
PLAIN = dict(use_kernel=False)

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
FANOUT = 64


def _row(keys):
    r = np.full(FANOUT, KEY_MAX, np.int64)
    k = np.sort(np.asarray(keys, np.int64))
    r[: k.size] = k
    return r


def edge_rows(seed=0, n_random=40):
    """``[N, 64]`` sorted rows with KEY_MAX padding: the edge cases, then
    seeded rows whose spans run from 2 to 2**40."""
    rows = [
        _row([]),
        _row([12345]),
        _row([0, 2**29]),  # xor 2**29: nbits exactly 30
        _row([0, 2**29 + 5, 2**29 + 9]),
        _row([0, 2**30]),  # xor 2**30: nbits 31, incompressible
        _row([2**30 - 1, 2**30]),  # xor 2**31 - 1: incompressible
        _row([-5, 5]),  # across the sign bit
        _row([-1, 0]),
        _row([KEY_MIN]),
        _row([KEY_MIN, KEY_MIN + 3]),
        _row(np.arange(FANOUT) * 3 + 2**40),  # a full row
        _row(np.arange(-100, -50)),
        _row([KEY_MAX - 1]),
        _row([KEY_MAX - 5, KEY_MAX - 1]),
        _row([-(2**62), -(2**62) + 2**30 - 1]),
    ]
    rng = np.random.default_rng(seed)
    for _ in range(n_random):
        base = int(rng.integers(-(2**62), 2**62))
        span = int(2 ** rng.integers(1, 41))
        n = int(rng.integers(1, FANOUT + 1))
        rows.append(_row(np.unique(base + rng.integers(0, span, size=n))[:FANOUT]))
    return np.stack(rows)


def test_compress_rows_matches_reference_on_edge_rows():
    rows = edge_rows()
    want = ref_pool.compress_rows(rows)
    got = t_pool.compress_rows(torch.from_numpy(rows))
    for w, g, dt in zip(want, got, (torch.int64, torch.int32, torch.int32)):
        assert g.dtype == dt
        np.testing.assert_array_equal(w, g.numpy())
    nbits = got[1].numpy()
    # empty, single key, 30 bits kept, 31 bits and the sign bit refused
    assert nbits[0] == 0 and nbits[1] == 0 and nbits[2] == 30
    assert (nbits[[4, 5, 6, 7]] == -1).all() and nbits[9] == 2
    assert (nbits >= 0).any() and (nbits == -1).any()


def test_compress_rows_in_chunks_matches_one_pass(monkeypatch):
    rows = torch.from_numpy(edge_rows(seed=1, n_random=100))
    whole = t_pool.compress_rows(rows)
    monkeypatch.setattr(t_pool, "_COMPRESS_CHUNK", 16)
    for a, b in zip(whole, t_pool.compress_rows(rows)):
        assert torch.equal(a, b)


def _dense_keys(n, gap, seed, offset=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.integers(1, gap, size=n)).astype(np.int64) + offset


@pytest.mark.parametrize(
    "level_m,gap,offset",
    [(1, 2**20, -(2**33)), (1, 2**26, 0), (2, 2**16, -(2**30)), (0, 2**5, 7)],
)
def test_compress_separators_and_stats_match_reference(level_m, gap, offset):
    keys = _dense_keys(6000, gap, seed=level_m, offset=offset)
    pool, meta = ref_pool.build_pool(keys, keys, level_m=level_m, fill=0.7, n_shards=2)
    t_pool_, t_meta = t_pool.build_pool(
        keys, keys, level_m=level_m, fill=0.7, n_shards=2, device="cpu"
    )
    want = ref_pool.compress_separators(pool, meta)
    got = t_pool.compress_separators(t_pool_, t_meta)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    ws = ref_pool.sep_compression_stats(want, meta)
    gs = t_pool.sep_compression_stats(got, t_meta)
    assert gs == ws
    assert [type(v) for v in gs.values()] == [type(v) for v in ws.values()]


def test_sep_compression_stats_sees_only_compressible_rows():
    """The reference's ``rows`` counts rows with a real suffix, and an
    incompressible row keeps none, so ``compressible_frac`` is 1.0 whenever
    any row compresses (ROADMAP, faults found, entry 11).  The port keeps
    the reference's numbers; the smallest input shows it."""
    keys = np.array([[0, 2**31] + [KEY_MAX] * 62, [5, 6] + [KEY_MAX] * 62])
    planes = ref_pool.compress_rows(keys)
    want = ref_pool.sep_compression_stats(
        ref_pool.SepPlanes(*(p[None] for p in planes)), ref_pool.PoolMeta(
            level_m=1, per_node=44, subtree_cap=2, n_subtrees=1,
            n_subtrees_padded=1, top_height=1, n_keys=4, leaf_start=1,
        ),
    )
    t_planes = t_pool.compress_rows(torch.from_numpy(keys))
    _, t_meta = t_pool.build_pool(np.arange(4), device="cpu")
    got = t_pool.sep_compression_stats(
        t_pool.SepPlanes(*(p[None] for p in t_planes)), t_meta
    )
    for k in ("rows", "compressible_rows", "compressible_frac", "mean_nbits"):
        assert got[k] == want[k], k
    assert got["rows"] == 1 and got["compressible_frac"] == 1.0


def _split_pair(seed=4):
    """A 1x1 index in both packages, an insert burst that overflows four
    leaves and more keys into others, and the SMO rounds that settle it."""
    keys = _dense_keys(4000, 2**22, seed, offset=-(2**33))
    vals = keys * 3
    pool, meta = ref_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=1)
    t_pool_, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, device="cpu")
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    kw = dict(n_route=1, n_memory=1, cache_sets=64, policy="fetch")
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
    t_state = t_dex.state_from_numpy(
        {
            ".".join(p.name for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(state)[0]
        },
        t_meta,
        t_cfg,
        "cpu",
    )
    rng = np.random.default_rng(seed)
    burst = []
    for leaf, n in ((3, 30), (20, 30), (41, 25), (70, 30), (5, 4), (60, 2)):
        lo, hi = keys[leaf * 44], keys[leaf * 44 + 43]
        cand = np.setdiff1d(rng.integers(lo + 1, hi, size=4 * n), keys)
        burst.append(rng.choice(np.unique(cand), size=n, replace=False))
    kk = np.concatenate(burst)
    vv = kk ^ 77
    sep = ref_pool.compress_separators(pool, meta)
    t_sep = t_pool.compress_separators(t_state.pool, t_meta)
    old = np.asarray(state.versions).copy()
    state, st = jax.jit(ref_write.make_dex_insert(meta, cfg, mesh, **PLAIN))(
        state, jnp.asarray(kk), jnp.asarray(vv)
    )
    shed = np.asarray(st) == ref_write.STATUS_SPLIT
    state, _, _ = ref_smo.run_smo(
        jax.jit(ref_smo.make_dex_smo(meta, cfg, mesh, **PLAIN)),
        state, np.where(shed, kk, KEY_MAX), np.where(shed, vv, 0),
    )
    want = ref_smo.refresh_sep_planes(sep, state, meta, old)
    return (state, meta, want), (t_state, t_meta, t_cfg, t_sep, kk, vv)


def test_refresh_sep_planes_matches_reference_and_fresh_compress():
    (state, meta, want), (t_state, t_meta, t_cfg, t_sep, kk, vv) = _split_pair()
    old_copy = t_state.versions.clone()
    old_view = t_state.versions  # the live plane the rounds bump in place
    t_state, st = t_write.make_dex_insert(t_meta, t_cfg, device="cpu")(t_state, kk, vv)
    shed = (st == t_write.STATUS_SPLIT).numpy()
    assert shed.sum() >= 4 * 25
    t_state, _, _ = t_smo.run_smo(
        t_smo.make_dex_smo(t_meta, t_cfg, device="cpu"),
        t_state, np.where(shed, kk, KEY_MAX), np.where(shed, vv, 0),
    )
    np.testing.assert_array_equal(
        t_state.pool.pool_keys.numpy(), np.asarray(state.pool.pool_keys)
    )
    before = [t.clone() for t in t_sep]
    got = t_smo.refresh_sep_planes(t_sep, t_state, t_meta, old_copy)
    fresh = t_pool.compress_separators(t_state.pool, t_meta)
    for w, g, f, b, s in zip(want, got, fresh, before, t_sep):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        assert torch.equal(g, f)
        assert torch.equal(s, b)  # the planes it was given are untouched
    assert not all(torch.equal(g, b) for g, b in zip(got, before))
    # a view of the live versions plane has moved with it: nothing changed
    # against it, so nothing is refreshed and the planes stay stale
    stale = t_smo.refresh_sep_planes(t_sep, t_state, t_meta, old_view)
    assert stale is t_sep
    assert not all(torch.equal(a, b) for a, b in zip(stale, fresh))
    # the reference is held to the same: no delta, the same planes back
    assert ref_smo.refresh_sep_planes(want, state, meta, state.versions) is want


def prefix_cases(seed=0):
    """Per-row queries over ``edge_rows``: KEY_MIN, KEY_MAX, -3, 0, 1,
    KEY_MAX - 1, and each row's first and last key, their neighbours and a
    middle key; returns the gathered ``(prefix, nbits, suffix, rows,
    queries)``."""
    rows = edge_rows(seed)
    prefix, nbits, suffix = ref_pool.compress_rows(rows)
    lane, qs = [], []
    for i, r in enumerate(rows):
        real = r[r != KEY_MAX].tolist()
        q = [KEY_MIN, KEY_MAX, -3, 0, 1, KEY_MAX - 1]
        if real:
            mid = real[len(real) // 2]
            q += [real[0], max(real[0] - 1, KEY_MIN), real[-1],
                  min(real[-1] + 1, KEY_MAX), mid, min(mid + 1, KEY_MAX)]
        lane += [i] * len(q)
        qs += q
    lane = np.asarray(lane)
    return (prefix[lane], nbits[lane], suffix[lane], rows[lane],
            np.asarray(qs, np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_node_search_prefix_ref_matches_reference_kernel(seed):
    case = prefix_cases(seed)
    want = ref_ns.node_search_prefix(*map(jnp.asarray, case), interpret=True)
    oracle = ref_ref.node_search_prefix_ref(*map(jnp.asarray, case))
    got = t_ops.node_search_prefix(*map(torch.from_numpy, case))
    assert t_ops.LAUNCHES["node_search_prefix"] == 0
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(np.asarray(oracle), got.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_node_search_prefix_slot_equals_node_search_below_key_max(seed):
    """The contract of the TPU kernel's docstring, held here for the first
    time: the compressed search's slot equals ``pool._slot`` on the
    canonical row for every query below KEY_MAX."""
    prefix, nbits, suffix, rows, q = prefix_cases(seed)
    got = t_ref.node_search_prefix_ref(
        *map(torch.from_numpy, (prefix, nbits, suffix, rows, q))
    ).numpy()
    want = np.asarray(ref_pool._slot(jnp.asarray(rows), jnp.asarray(q)))
    slot, _, _ = t_ops.node_search(torch.from_numpy(rows), torch.from_numpy(q))
    live = q != KEY_MAX
    np.testing.assert_array_equal(got[live], want[live])
    np.testing.assert_array_equal(got[live], slot.numpy()[live])
    assert (nbits == -1).any() and (nbits >= 0).any()


def test_node_search_prefix_on_a_pool_descent():
    """Level by level down a built index through its planes: the compressed
    slot picks the same child as ``node_search`` at every level, and the
    leaf slot holds the key."""
    keys = _dense_keys(8000, 2**24, seed=3, offset=-(2**35))
    pool, meta = t_pool.build_pool(keys, keys ^ 5, level_m=2, fill=0.7, device="cpu")
    sep = t_pool.compress_separators(pool, meta)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(np.concatenate([rng.choice(keys, 300), keys[:5] - 1]))
    st = t_pool.top_walk(pool, meta, q)
    local = torch.zeros_like(q)
    for lvl in range(meta.levels_in_subtree):
        args = (sep.prefix[st, local], sep.nbits[st, local],
                sep.suffix[st, local], pool.pool_keys[st, local], q)
        slot = t_ops.node_search_prefix(*args)
        want, found, _ = t_ops.node_search(pool.pool_keys[st, local], q)
        assert torch.equal(slot, want)
        if lvl < meta.level_m:
            local = pool.pool_children[st, local, slot.long()].long()
    hit = pool.pool_keys[st, local, slot.long()] == q
    np.testing.assert_array_equal(hit.numpy(), np.isin(q.numpy(), keys))
    assert (sep.nbits >= 0).any() and (sep.nbits == -1).any()


def test_node_search_prefix_checks_layout():
    prefix, nbits, suffix, rows, q = map(torch.from_numpy, prefix_cases())
    with pytest.raises(ValueError):
        t_ops.node_search_prefix(prefix, nbits.long(), suffix, rows, q)
    with pytest.raises(ValueError):
        t_ops.node_search_prefix(prefix, nbits, suffix.t().contiguous().t(), rows, q)
    with pytest.raises(ValueError):
        t_ops.node_search_prefix(prefix[:-1], nbits, suffix, rows, q)
