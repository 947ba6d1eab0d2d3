"""The port's flat B+-tree (``repro_torch.core.btree``) against the
reference's on the cases of tests/test_btree.py: the same numpy keys go
through both, and every array of the resulting trees, every result mask and
every value must be equal, bit for bit (no tolerance: both are integer
programs)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import btree as rb  # noqa: E402
from repro_torch.core import btree as tb  # noqa: E402
from repro_torch.core.nodes import FANOUT, KEY_MAX  # noqa: E402


def make_keys(n, seed=0, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = hi if hi is not None else max(4 * n, 1024)
    keys = rng.choice(np.arange(lo + 1, lo + hi, dtype=np.int64), size=n, replace=False)
    return np.sort(keys)


def assert_same_tree(t, t_meta, r, r_meta):
    assert dataclasses.astuple(t_meta) == dataclasses.astuple(r_meta)
    for name in t._fields:
        got = getattr(t, name).numpy()
        want = np.asarray(getattr(r, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def build_both(keys, values=None, **kw):
    t, tm = tb.bulk_build(keys, values, device="cpu", **kw)
    r, rm = rb.bulk_build(keys, values, **kw)
    assert_same_tree(t, tm, r, rm)
    return t, tm, r, rm


@pytest.mark.parametrize("n", [1, 7, 44, 45, 1000, 20_000])
def test_bulk_build_arrays_equal_the_reference(n):
    keys = make_keys(n, seed=n)
    t, tm, _, _ = build_both(keys, keys * 3)
    tb.validate(t, tm)
    k, v = tb.tree_items(t)
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(v, keys * 3)


@pytest.mark.parametrize("fill", [0.5, 0.7, 1.0])
def test_bulk_build_fill_factors(fill):
    t, tm, _, _ = build_both(make_keys(500, seed=2), fill=fill)
    tb.validate(t, tm)
    assert tm.keys_per_leaf == max(2, int(FANOUT * fill))


def test_bulk_build_rejects_what_the_reference_rejects():
    for bad in ([3, 1, 2], [1, 1, 2], [KEY_MAX]):
        with pytest.raises(ValueError):
            tb.bulk_build(np.array(bad, dtype=np.int64), device="cpu")


def test_lookup_hits_misses_and_path():
    keys = make_keys(5000, seed=1)
    t, tm, r, rm = build_both(keys, keys + 7)
    all_set = set(keys.tolist())
    miss = np.array([k for k in range(1, 40000, 997) if k not in all_set], np.int64)
    q = np.concatenate([keys[::17], miss])
    found, vals, path = tb.bulk_lookup(t, q, height=tm.height, with_path=True)
    r_found, r_vals, r_path = rb.bulk_lookup(r, q, height=rm.height, with_path=True)
    np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))
    np.testing.assert_array_equal(path.numpy(), np.asarray(r_path))
    assert found.numpy()[: keys[::17].size].all() and not found.numpy()[-miss.size:].any()
    leaves = tb.bulk_find_leaf(t, q, height=tm.height)
    np.testing.assert_array_equal(
        leaves.numpy(), np.asarray(rb.bulk_find_leaf(r, q, height=rm.height))
    )


INSERT_CASES = {
    # the device fast path: fresh keys into leaf slack
    "fast_path": lambda: (
        make_keys(2000, seed=6, hi=100_000),
        lambda keys: np.setdiff1d(make_keys(300, seed=7, hi=100_000), keys),
        {},
    ),
    # a full-fill build: every insert overflows a leaf and goes to the host
    "host_split": lambda: (
        np.arange(1, 2001, dtype=np.int64) * 10,
        lambda keys: keys[:256] + 1,
        {"fill": 1.0},
    ),
    # keys already present become value updates
    "duplicates": lambda: (
        make_keys(500, seed=8),
        lambda keys: keys[10:20],
        {},
    ),
    # fast path and host split in one batch, with repeats inside the batch
    "mixed": lambda: (
        np.arange(1, 3001, dtype=np.int64) * 4,
        lambda keys: np.concatenate([keys[:40] + 1, keys[:40] + 1, keys[2000:2010] + 2]),
        {"fill": 0.9},
    ),
}


@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_batch_insert_equals_the_reference(case):
    keys, make_new, kw = INSERT_CASES[case]()
    new = make_new(keys)
    t, tm, r, rm = build_both(keys, keys, **kw)
    t, tm, ok = tb.batch_insert(t, tm, new, new * 5)
    r, rm, r_ok = rb.batch_insert(r, rm, new, new * 5)
    np.testing.assert_array_equal(ok, np.asarray(r_ok))
    # a key repeated inside the batch is handled once, at its first lane
    _, first = np.unique(new, return_index=True)
    assert ok[first].all()
    assert_same_tree(t, tm, r, rm)
    tb.validate(t, tm)
    found, vals = tb.bulk_lookup(t, new, height=tm.height)
    assert found.numpy().all()


DELETE_CASES = {
    "some": (make_keys(3000, seed=9), lambda k: k[::13]),
    "missing": (
        make_keys(200, seed=10, hi=5000),
        lambda k: np.setdiff1d(np.arange(1, 400, dtype=np.int64), k)[:8],
    ),
    "same_leaf": (np.arange(1, 100, dtype=np.int64), lambda k: np.arange(5, 10)),
}


@pytest.mark.parametrize("case", sorted(DELETE_CASES))
def test_bulk_delete_equals_the_reference(case):
    keys, pick = DELETE_CASES[case]
    gone = pick(keys).astype(np.int64)
    t, tm, r, rm = build_both(keys, keys)
    t, ok = tb.bulk_delete(t, gone, height=tm.height)
    r, r_ok = rb.bulk_delete(r, gone, height=rm.height)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r_ok))
    assert_same_tree(t, tm, r, rm)
    k, _ = tb.tree_items(t)
    np.testing.assert_array_equal(k, np.setdiff1d(keys, gone))


def test_insert_delete_trace_equals_the_reference():
    """A page-table-like trace: each request's page keys inserted as one
    small batch, every third step one live request released."""
    rng = np.random.default_rng(3)
    t, tm, r, rm = build_both(np.array([KEY_MAX - 1], np.int64), np.zeros(1, np.int64))
    live = []
    for step in range(24):
        req = 100 + step
        new = (np.int64(req) << 24) | np.arange(6, dtype=np.int64)
        t, tm, ok = tb.batch_insert(t, tm, new, new % 97)
        r, rm, r_ok = rb.batch_insert(r, rm, new, new % 97)
        np.testing.assert_array_equal(ok, np.asarray(r_ok))
        live.append(new)
        if step % 3 == 2:
            gone = live.pop(int(rng.integers(0, len(live))))
            t, _ = tb.bulk_delete(t, gone, height=tm.height)
            r, _ = rb.bulk_delete(r, gone, height=rm.height)
        assert_same_tree(t, tm, r, rm)
