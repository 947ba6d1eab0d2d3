"""The read order of the CUDA ``subtree_walk`` kernel, mirrored in plain
Python (``kernels/subtree_walk.py::walk_schedule``: ``node_search``'s
``search_schedule`` per level, plus the child id and value reads), on the
CPU.

The mirror must give the plain version's answers (``ref.subtree_walk_ref``)
on pools from ``core/pool.py::build_pool`` at level M 1 and 2, for hits,
misses, keys below a row's first key, KEY_MIN, KEY_MAX, -3, lanes that
reach a NULL child and lanes on random subtrees, under every lane mask;
``read_sectors``, the vectorised count ``chip_smoke.py`` prices the
kernel's reads with, must equal the mirror's; the default design must read
within its budget a lane.  The mirror's constants are read out of the CUDA
source, so the two cannot drift apart."""

import functools
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core.nodes import KEY_MAX, KEY_MIN  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import subtree_walk as sw  # noqa: E402

CSRC = pathlib.Path(sw.__file__).resolve().parents[1] / "csrc"
KINDS = ("hits", "misses", "edges", "random_subtrees", "null_children")
MASKS = ("all", "none", "front", "random")


@functools.lru_cache(maxsize=None)
def _pool(level_m):
    """A pool of several subtree blocks, values a function of the key."""
    rng = np.random.default_rng(level_m)
    n = 4000 if level_m == 1 else 6000
    keys = np.sort(rng.choice(2**40, size=n, replace=False)).astype(np.int64)
    keys -= 2**39
    leaves = None if level_m == 1 else 40
    pool, meta = t_pool.build_pool(
        keys, keys ^ 0x5DEECE66D, level_m=level_m, subtree_leaves=leaves,
        device="cpu",
    )
    assert meta.n_subtrees > 2
    return keys, pool, meta


def _lanes(level_m, kind, n=96):
    """``(subtree int32, queries int64)`` of one kind of lane."""
    keys, pool, meta = _pool(level_m)
    rng = np.random.default_rng(KINDS.index(kind) + 10 * level_m)
    q = rng.choice(keys, n).astype(np.int64)
    if kind == "misses":
        q += 1
    elif kind == "edges":
        q[0::4] = KEY_MIN
        q[1::4] = -3
        q[2::4] = keys[0] - 1
    elif kind == "null_children":
        q[:] = KEY_MAX  # slot 63 of an inner row that is not full: NULL
    qt = torch.from_numpy(q)
    st = t_pool.top_walk(pool, meta, qt).to(torch.int32)
    if kind in ("random_subtrees", "null_children", "edges"):
        st = torch.from_numpy(
            rng.integers(-meta.n_subtrees_padded, meta.n_subtrees, n).astype(np.int32)
        )
    return st, qt


def _mask(kind, n, seed=0):
    if kind == "all":
        return torch.ones(n, dtype=torch.bool)
    if kind == "none":
        return torch.zeros(n, dtype=torch.bool)
    if kind == "front":  # pack_by_dest: each bucket's live lanes first
        return (torch.arange(n) % 32) < 9
    return torch.from_numpy(np.random.default_rng(seed).random(n) < 0.4)


def _numpy(pool):
    return tuple(t.numpy() for t in (pool.pool_keys, pool.pool_children, pool.pool_values))


def _schedules(level_m, st, q, active, design=sw.DESIGN):
    _, pool, meta = _pool(level_m)
    planes = _numpy(pool)
    return [
        sw.walk_schedule(*planes, int(s), int(k), meta.levels_in_subtree, bool(a), design)
        for s, k, a in zip(st, q, active)
    ]


@pytest.mark.parametrize("design", ("B", "C"))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level_m", (1, 2))
def test_schedule_matches_subtree_walk_ref(level_m, kind, design):
    _, pool, meta = _pool(level_m)
    st, q = _lanes(level_m, kind)
    active = _mask("random", q.numel(), level_m)
    got = _schedules(level_m, st, q, active, design)
    want = ref.subtree_walk_ref(
        pool.pool_keys, pool.pool_children, pool.pool_values, st, q,
        levels=meta.levels_in_subtree, active=active,
    )
    for i, (found, value, leaf, reads) in enumerate(got):
        assert (found, value, leaf) == tuple(int(w[i]) for w in want), i
        assert bool(active[i]) or reads == []
    if kind == "null_children":
        assert (want[2][active] < 0).any()  # the walk did reach NULL children
    if kind == "hits":
        assert bool(want[0][active].all())


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("level_m", (1, 2))
def test_read_sectors_matches_the_schedule(level_m, mask):
    _, pool, meta = _pool(level_m)
    lanes = [_lanes(level_m, k, 48) for k in KINDS]
    st = torch.cat([s for s, _ in lanes])
    q = torch.cat([k for _, k in lanes])
    active = _mask(mask, q.numel(), level_m)
    sectors, granules = sw.read_sectors(
        pool.pool_keys, pool.pool_children, st, q, meta.levels_in_subtree, active
    )
    for i, (*_, reads) in enumerate(_schedules(level_m, st, q, active)):
        assert int(sectors[i]) == sum(len(s) for _, _, s in reads), i
        assert int(granules[i]) == sum(len({x // 2 for x in s}) for _, _, s in reads), i
    assert int(sectors.sum()) == 0 or mask != "none"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level_m", (1, 2))
def test_default_design_reads_within_its_budget(level_m, kind):
    """A live lane reads, at each inner level, at most 7 key sectors (5
    granules) and its child id's sector; at its leaf at most 7 key sectors
    and, on a hit, one value sector.  A KEY_MAX lane searches no inner
    row and reads its leaf's row[63] and row[0] first.  A masked lane
    reads nothing."""
    _, pool, meta = _pool(level_m)
    inner = meta.levels_in_subtree - 1
    st, q = _lanes(level_m, kind)
    active = _mask("random", q.numel(), 7)
    for k, a, (found, _, _, reads) in zip(q, active, _schedules(level_m, st, q, active)):
        if not a:
            assert reads == []
            continue
        planes = [p for p, _, _ in reads]
        assert planes[: 2 * inner + 1] == ["keys", "children"] * inner + ["keys"]
        assert all(len(secs) == 1 for p, _, secs in reads if p == "children")
        keys_read = [secs for p, _, secs in reads if p == "keys"]
        if k == KEY_MAX:
            assert all(secs == () for secs in keys_read[:-1])
            assert keys_read[-1][:2] == (15, 0)
            continue
        for secs in keys_read:
            assert len(secs) <= 7 and len({s // 2 for s in secs}) <= 5
        assert planes[2 * inner + 1 :] == (["values"] if found else [])
        assert all(len(secs) == 1 for p, _, secs in reads if p == "values")


@pytest.mark.parametrize("level_m", (1, 2))
def test_masked_lanes_read_nothing(level_m):
    _, pool, meta = _pool(level_m)
    st, q = _lanes(level_m, "hits")
    active = _mask("front", q.numel())
    sectors, granules = sw.read_sectors(
        pool.pool_keys, pool.pool_children, st, q, meta.levels_in_subtree, active
    )
    assert not sectors[~active].any() and not granules[~active].any()
    assert bool((sectors[active] > 0).all())
    found, value, leaf = ops.subtree_walk(
        pool.pool_keys, pool.pool_children, pool.pool_values, st, q,
        levels=meta.levels_in_subtree, active=active,
    )
    assert not (found[~active].any() or value[~active].any() or leaf[~active].any())


def test_cpu_path_refuses_an_unsorted_pool_row():
    _, pool, meta = _pool(1)
    keys = pool.pool_keys.clone()
    keys[1, 2] = keys[1, 2].flip(0)
    st, q = _lanes(1, "hits", 8)
    with pytest.raises(ValueError, match="sorted"):
        ops.subtree_walk(
            keys, pool.pool_children, pool.pool_values, st, q,
            levels=meta.levels_in_subtree,
        )


def test_mirror_constants_match_the_cuda_source():
    src = (CSRC / "subtree_walk.cu").read_text()
    design = re.search(r"constexpr char kWalkDesign = '(\w)';", src)
    group = re.search(r"constexpr int kWalkGroup = (\d+);", src)
    threads = re.search(r"constexpr int kThreads = (\d+);", src)
    assert (design.group(1), int(group.group(1))) == (sw.DESIGN, sw.GROUP)
    assert int(threads.group(1)) == sw.THREADS
    table = src.split("kVariants[] = {")[1].split("};")[0]
    first, rest = table.split(">,", 1)
    assert first.strip() == "launch<kWalkDesign, kWalkGroup"
    names = [d + g for d, g in re.findall(r"launch<'(\w)', (\d+)>", rest)]
    assert "launch_warp" in rest
    assert tuple(names) + ("W",) == sw.VARIANTS
    assert f"{sw.DESIGN}{sw.GROUP}" in sw.VARIANTS
    assert "subtree_walk_kernel<D, G>" in src and "dex::match_row<D>" in src
