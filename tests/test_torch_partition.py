"""The port's ``core/partition.py`` against ``repro.core.partition``: every
``LogicalPartitions`` method gives the same tables and owners on the same
numpy inputs, including the ``tests/test_repartition.py::
TestRebalanceEdgeCases`` cases and the ``LogicalPartitions`` cases of
``tests/test_partition_cache_sim.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.partition import LogicalPartitions as RefParts  # noqa: E402
from repro_torch.core.partition import LogicalPartitions  # noqa: E402

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max


def _same(ref, port):
    assert port.num_partitions == ref.num_partitions
    np.testing.assert_array_equal(port.boundaries, ref.boundaries)
    assert port.boundaries.dtype == np.int64


def _both(boundaries):
    b = np.asarray(boundaries, np.int64)
    return RefParts(b), LogicalPartitions(b)


@pytest.mark.parametrize(
    "n,lo,hi",
    [(4, 0, 1000), (2, 0, 100), (4, 0, 2), (8, -(2**40), 2**40), (1, 0, 10),
     (3, -(2**60), 2**60)],
)
def test_equal_width_matches_reference(n, lo, hi):
    _same(RefParts.equal_width(n, lo, hi), LogicalPartitions.equal_width(n, lo, hi))


@pytest.mark.parametrize(
    "keys,n",
    [
        ((np.random.default_rng(0).pareto(2.0, 20_000) * 1000).astype(np.int64) + 1, 4),
        (np.array([7, 7, 7, 7, 7]), 4),
        (np.arange(-50, 50, dtype=np.int64) * 3, 6),
    ],
)
def test_from_samples_matches_reference(keys, n):
    _same(RefParts.from_samples(keys, n), LogicalPartitions.from_samples(keys, n))


def test_owners_and_shared_ranges_match_reference():
    ref, port = _both([KEY_MIN, -5, 100, 200, KEY_MAX])
    probe = np.array(
        [KEY_MIN, KEY_MIN + 1, -6, -5, 99, 100, 101, 199, 200, 201, KEY_MAX - 1,
         KEY_MAX],
        np.int64,
    )
    np.testing.assert_array_equal(port.owner_of(probe), ref.owner_of(probe))
    assert port.owner_of(probe).dtype == np.int32
    got = port.owner_of_device(torch.from_numpy(probe))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.owner_of(probe))
    lo = np.array([KEY_MIN, 10, 95, -5, 200, KEY_MIN, 150], np.int64)
    hi = np.array([KEY_MAX, 20, 105, 100, 201, KEY_MIN + 1, 200], np.int64)
    np.testing.assert_array_equal(
        port.is_shared_range(lo, hi), ref.is_shared_range(lo, hi)
    )


def test_split_and_merge_match_reference():
    ref, port = RefParts.equal_width(2, 0, 100), LogicalPartitions.equal_width(2, 0, 100)
    _same(ref.split_partition(0, 10), port.split_partition(0, 10))
    _same(
        ref.split_partition(0, 10).merge_partitions(0),
        port.split_partition(0, 10).merge_partitions(0),
    )
    for bad in (lambda p: p.split_partition(0, 500), lambda p: p.merge_partitions(1)):
        with pytest.raises(ValueError):
            bad(port)


@pytest.mark.parametrize(
    "parts,loads,key_range",
    [
        # TestRebalanceEdgeCases
        ((4, 0, 1000), [100.0, 1.0, 1.0, 1.0], None),
        ((4, 0, 1000), [100.0, 1.0, 1.0, 1.0], (0, 999)),
        ((4, 0, 1000), [0.0, 0.0, 0.0, 0.0], None),
        ((4, 0, 1000), [10.0, 0.0, 0.0, 0.0], (0, 999)),
        # test_partition_cache_sim.py::test_rebalance_moves_boundaries
        ((2, 0, 1000), [9.0, 1.0], None),
        ((2, 0, 1000), [1.0, 4.0], (999, 5)),
        ((6, -(2**50), 2**50), [5.0, 0.0, 3.0, 1e6, 0.5, 2.0], (-(2**49), 2**51)),
        ((3, 0, 6), [1.0, 1.0, 1e9], (2, 3)),
    ],
)
def test_rebalance_matches_reference(parts, loads, key_range):
    ref, port = RefParts.equal_width(*parts), LogicalPartitions.equal_width(*parts)
    r2 = ref.rebalance(loads, key_range=key_range)
    p2 = port.rebalance(loads, key_range=key_range)
    _same(r2, p2)
    assert p2.assignment_diff(port) == r2.assignment_diff(ref)
    assert port.assignment_diff(p2) == ref.assignment_diff(r2)


def test_single_hot_partition_converges_as_reference():
    """TestRebalanceEdgeCases.test_single_hot_partition_converges, step by
    step against the reference."""
    ref = RefParts.equal_width(4, 0, 100_000)
    port = LogicalPartitions.equal_width(4, 0, 100_000)
    hot = np.arange(40_000, 50_000)
    for _ in range(6):
        loads = np.bincount(port.owner_of(hot), minlength=4)
        np.testing.assert_array_equal(
            loads, np.bincount(ref.owner_of(hot), minlength=4)
        )
        ref = ref.rebalance(loads, key_range=(0, 99_999))
        port = port.rebalance(loads, key_range=(0, 99_999))
        _same(ref, port)
    assert np.bincount(port.owner_of(hot), minlength=4).max() < 0.3 * hot.size


def test_single_partition_is_noop_as_reference():
    ref, port = _both([KEY_MIN, KEY_MAX])
    _same(ref.rebalance([42.0]), port.rebalance([42.0]))
    assert port.rebalance([42.0]) is port


def test_seeded_rebalance_sweep_matches_reference():
    """Random tables and loads (the property test of
    test_partition_cache_sim.py, drawn from a seed)."""
    rng = np.random.default_rng(7)
    for _ in range(60):
        n = int(rng.integers(2, 13))
        ref = RefParts.equal_width(n, 0, 100_000)
        port = LogicalPartitions.equal_width(n, 0, 100_000)
        loads = rng.random(n) * 1e6 * (rng.random(n) < 0.7)
        lo = int(rng.integers(-(2**40), 2**40))
        hi = lo + int(rng.integers(4 * n, 2**41))
        _same(ref.rebalance(loads, key_range=(lo, hi)),
              port.rebalance(loads, key_range=(lo, hi)))
        keys = rng.integers(-(2**50), 2**50, size=50)
        np.testing.assert_array_equal(port.owner_of(keys), ref.owner_of(keys))


def test_invalid_tables_raise():
    with pytest.raises(AssertionError):
        LogicalPartitions(np.array([0, 10, KEY_MAX], np.int64))
    with pytest.raises(AssertionError):
        LogicalPartitions(np.array([KEY_MIN, 10, 10, KEY_MAX], np.int64))
