"""The port's YCSB generator against ``repro.data.ycsb``: the same ops,
keys and per-op scan lengths for the same seed (workload E's uniform scan
lengths are drawn after the ops and keys, so the traces of the other mixes
do not change), and ``engine_lanes`` gives the reference's three planes."""

import numpy as np
import pytest

from repro.data import ycsb as ref_ycsb
from repro_torch.data import ycsb as t_ycsb


def _dataset(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(8 * n, size=n, replace=False).astype(np.int64) + 1)


@pytest.mark.parametrize(
    "name,dist,scan_len",
    [
        ("ycsb-e", "uniform", 100),
        ("ycsb-e", "uniform", 40),
        ("ycsb-e", "fixed", 100),
        ("scan-intensive", "fixed", 100),
        ("ycsb-a", "fixed", 100),
        ("insert-intensive", "uniform", 100),
    ],
)
def test_generate_matches_reference(name, dist, scan_len):
    ds = _dataset(3000, seed=1)
    want = ref_ycsb.generate(name, ds, 5000, seed=2, scan_len=scan_len,
                             scan_len_dist=dist)
    got = t_ycsb.generate(name, ds, 5000, seed=2, scan_len=scan_len,
                          scan_len_dist=dist)
    np.testing.assert_array_equal(want.ops, got.ops)
    np.testing.assert_array_equal(want.keys, got.keys)
    assert got.scan_len == want.scan_len == scan_len
    if dist == "uniform":
        assert got.scan_lens.dtype == want.scan_lens.dtype
        np.testing.assert_array_equal(want.scan_lens, got.scan_lens)
        assert got.scan_lens.min() >= 1 and got.scan_lens.max() <= scan_len
    else:
        assert got.scan_lens is None and want.scan_lens is None
    for lo, hi in ((0, None), (100, 1700)):
        for w, g in zip(ref_ycsb.engine_lanes(want, lo, hi),
                        t_ycsb.engine_lanes(got, lo, hi)):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)


def test_ycsb_e_mix_and_lengths():
    ds = _dataset(2000, seed=3)
    wl = t_ycsb.generate("ycsb-e", ds, 5000, seed=4, scan_len=100,
                         scan_len_dist="uniform")
    frac_scan = float(np.mean(wl.ops == t_ycsb.OP_SCAN))
    assert 0.9 < frac_scan < 1.0
    assert np.mean(wl.ops == t_ycsb.OP_INSERT) > 0.01
    ops, keys, vals = t_ycsb.engine_lanes(wl)
    scn = ops == t_ycsb.OP_SCAN
    np.testing.assert_array_equal(vals[scn], wl.scan_lens[scn])
    np.testing.assert_array_equal(vals[ops == t_ycsb.OP_INSERT],
                                  keys[ops == t_ycsb.OP_INSERT])


def test_bad_scan_len_dist_rejected():
    with pytest.raises(ValueError):
        t_ycsb.generate("ycsb-e", _dataset(100, seed=5), 10, scan_len_dist="pareto")


@pytest.mark.parametrize("name,hotspot", [("read-only", 0.2), ("read-only", 0.8),
                                          ("ycsb-a", 0.0), ("insert-intensive", 0.5)])
def test_hotspot_matches_reference(name, hotspot):
    """The localized Zipfian: the same ops and keys as the reference, the
    hot keys one contiguous range around the hotspot."""
    ds = _dataset(4000, seed=6)
    want = ref_ycsb.generate(name, ds, 6000, seed=7, hotspot=hotspot)
    got = t_ycsb.generate(name, ds, 6000, seed=7, hotspot=hotspot)
    np.testing.assert_array_equal(want.ops, got.ops)
    np.testing.assert_array_equal(want.keys, got.keys)
    reads = got.ops != t_ycsb.OP_INSERT
    centre = ds[int(hotspot * ds.size)]
    d = np.abs(np.searchsorted(ds, got.keys[reads]) - np.searchsorted(ds, centre))
    near = np.minimum(d, ds.size - d)  # the ranks wrap around the dataset
    assert np.median(near) < ds.size // 20


def test_bad_hotspot_rejected():
    with pytest.raises(ValueError):
        t_ycsb.generate("read-only", _dataset(100, seed=5), 10, hotspot=1.0)
