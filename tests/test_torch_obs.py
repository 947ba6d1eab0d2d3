"""The port's copies of the stat-slot registry, the latency schema and the
YCSB generator against the reference modules."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fleet_cache as ref_fleet_cache  # noqa: E402
from repro.data import ycsb as ref_ycsb  # noqa: E402
from repro.obs import latency as ref_latency  # noqa: E402
from repro.obs import registry as ref_registry  # noqa: E402
from repro_torch.core import fleet_cache as t_fleet_cache  # noqa: E402
from repro_torch.data import ycsb as t_ycsb  # noqa: E402
from repro_torch.obs import latency as t_latency  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402


def test_stat_slots_match_registry():
    assert t_registry.stat_constants() == ref_registry.stat_constants()
    assert t_registry.N_STATS == ref_registry.N_STATS
    assert t_fleet_cache.P_ADMIT_LEAF_PCT == ref_fleet_cache.P_ADMIT_LEAF_PCT


def test_latency_constants_match():
    for name in ("N_BUCKETS", "T0", "N_CLASSES", "N_PATHS", "T_CACHED", "T_READ",
                 "T_WRITE", "T_RPC", "T_MEM", "T_LOCAL", "PATHS", "OP_CLASSES"):
        assert getattr(t_latency, name) == getattr(ref_latency, name), name


def test_bucket_index_matches_reference_at_every_edge():
    """Costs land exactly on bucket edges (sums of the price constants), so
    the bucket of every float32 near an edge must be the reference's."""
    f = jax.jit(lambda x: ref_latency.bucket_index(x, xp=jnp))
    near = []
    for k in range(ref_latency.N_BUCKETS + 1):
        e = np.float32(ref_latency.T0 * 2.0**k)
        bits = np.array([e], np.float32).view(np.int32)[0]
        near.append(np.arange(bits - 64, bits + 64, dtype=np.int32).view(np.float32))
    grid = np.geomspace(1e-9, 1.0, 200_000).astype(np.float32)
    x = np.concatenate(near + [grid, np.float32([0.0, 1e-30, 3e38])])
    np.testing.assert_array_equal(
        np.asarray(f(jnp.asarray(x))).astype(np.int64),
        t_latency.bucket_index(torch.from_numpy(x)).numpy(),
    )


@pytest.mark.parametrize("name", ["read-only", "ycsb-a", "insert-intensive"])
def test_ycsb_generate_matches_reference(name):
    rng = np.random.default_rng(3)
    data = np.sort(rng.choice(10**6, size=20_000, replace=False).astype(np.int64))
    want = ref_ycsb.generate(name, data, 5000, seed=4)
    got = t_ycsb.generate(name, data, 5000, seed=4)
    np.testing.assert_array_equal(want.ops, got.ops)
    np.testing.assert_array_equal(want.keys, got.keys)
    reads = got.idx >= 0
    np.testing.assert_array_equal(data[got.idx[reads]], got.keys[reads])
    only_idx = t_ycsb.generate(name, data.size, 5000, seed=4)
    np.testing.assert_array_equal(only_idx.idx, got.idx)
