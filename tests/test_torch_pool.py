"""The port's subtree-blocked pool against ``repro.core.pool``: the
vectorised ``build_pool`` gives identical arrays and metadata, and the
successor table, top walk and plain lookup agree."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pool as ref_pool  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402

KEY_MIN = np.iinfo(np.int64).min


def _dataset(n, seed=0, lo=1):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(8 * n, size=n, replace=False).astype(np.int64) + lo)


def _both(keys, **kw):
    vals = keys * 3
    p1, m1 = ref_pool.build_pool(keys, vals, **kw)
    p2, m2 = t_pool.build_pool(keys, vals, device="cpu", **kw)
    return p1, m1, p2, m2


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("level_m", [0, 1, 2])
def test_build_pool_arrays_identical(level_m, n_shards):
    keys = _dataset(5000 if level_m < 2 else 3000, seed=level_m, lo=-20_000)
    p1, m1, p2, m2 = _both(keys, level_m=level_m, n_shards=n_shards)
    assert dataclasses.asdict(m1) == dataclasses.asdict(m2)
    for field in ref_pool.SubtreePool._fields:
        a, b = np.asarray(getattr(p1, field)), getattr(p2, field).numpy()
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(
        ref_pool.initial_succ(m1), t_pool.initial_succ(m2, "cpu").numpy()
    )


@pytest.mark.parametrize(
    "n,kw",
    [
        (29, dict(level_m=1)),
        (44 * 44 + 1, dict(level_m=1, n_shards=4)),
        (3000, dict(level_m=2, subtree_leaves=100)),
        (3000, dict(level_m=1, fill=1.0, headroom=0.0)),
    ],
)
def test_build_pool_edge_shapes(n, kw):
    keys = _dataset(n, seed=n)
    p1, m1, p2, m2 = _both(keys, **kw)
    assert dataclasses.asdict(m1) == dataclasses.asdict(m2)
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("level_m", [0, 1, 2])
def test_top_walk_and_pool_lookup_match(level_m):
    keys = _dataset(4000, seed=7 + level_m)
    p1, m1, p2, m2 = _both(keys, level_m=level_m, n_shards=4)
    q = np.concatenate([keys[::7], keys[::5] + 1, [KEY_MIN, -5, 0, keys[-1] + 9]])
    q = q.astype(np.int64)
    tq = torch.from_numpy(q)
    np.testing.assert_array_equal(
        np.asarray(ref_pool.top_walk(p1, m1, q)), t_pool.top_walk(p2, m2, tq).numpy()
    )
    f1, v1 = ref_pool.pool_lookup_ref(p1, m1, q)
    f2, v2 = t_pool.pool_lookup_ref(p2, m2, tq)
    np.testing.assert_array_equal(np.asarray(f1), f2.numpy())
    np.testing.assert_array_equal(np.asarray(v1), v2.numpy())
    expect = np.isin(q, keys)
    np.testing.assert_array_equal(f2.numpy(), expect)


def test_build_pool_rejects_unsorted_keys():
    with pytest.raises(ValueError, match="sorted"):
        t_pool.build_pool(np.array([3, 1, 2], np.int64), device="cpu")
