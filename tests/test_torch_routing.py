"""The port's routing layer against ``repro.core.routing``: the int64
emulation of the uint64 hash and modulo, the admission dice (salts and keys
with the top bit set), route owners, bucketing with overflow, and coalesced
row fetches on a 1x1 mesh."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import routing as ref_routing  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import routing as t_routing  # noqa: E402

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max


def _words(n, seed):
    """int64 bit patterns over the whole range, top bit set in half."""
    rng = np.random.default_rng(seed)
    x = rng.integers(KEY_MIN, KEY_MAX, size=n, dtype=np.int64, endpoint=True)
    x[:6] = [0, 1, -1, KEY_MIN, KEY_MAX, 0x9E3779B9]
    return x


def test_hash64_matches_uint64_reference():
    x = _words(4096, 0)
    want = np.asarray(ref_routing.hash64(jnp.asarray(x))).view(np.int64)
    np.testing.assert_array_equal(want, t_routing.hash64(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("m", [1, 7, 100, 128, 65536, 1000003])
def test_unsigned_modulo(m):
    x = _words(4096, m)
    want = (x.view(np.uint64) % np.uint64(m)).astype(np.int64)
    np.testing.assert_array_equal(want, t_routing.umod(torch.from_numpy(x), m).numpy())


@pytest.mark.parametrize("pct", [10, 50])
def test_leaf_admit_dice_with_salts(pct):
    gid = _words(2048, pct)
    salt = _words(2048, pct + 1) + np.arange(2048)
    for s in (None, salt):
        want = ref_routing.leaf_admit_dice(
            jnp.asarray(gid), pct, salt=None if s is None else jnp.asarray(s)
        )
        got = t_routing.leaf_admit_dice(
            torch.from_numpy(gid), pct, salt=None if s is None else torch.from_numpy(s)
        )
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_route_owners_and_demand():
    bounds = np.array([KEY_MIN, -100, 0, 500, KEY_MAX], np.int64)
    keys = np.array([KEY_MIN, -101, -100, -1, 0, 499, 500, KEY_MAX, 7], np.int64)
    owner, dem = ref_routing.route_owners(jnp.asarray(bounds), jnp.asarray(keys), 4)
    t_owner, t_dem = t_routing.route_owners(
        torch.from_numpy(bounds), torch.from_numpy(keys)[None], 4
    )
    np.testing.assert_array_equal(np.asarray(owner), t_owner[0].numpy())
    np.testing.assert_array_equal(np.asarray(dem), t_dem.numpy())


@pytest.mark.parametrize("cap", [1, 3, 64])
def test_pack_by_dest_with_overflow(cap):
    rng = np.random.default_rng(cap)
    n_dev, b, n_dest = 3, 40, 4
    dest = rng.integers(0, n_dest + 1, size=(n_dev, b)).astype(np.int32)
    payload = rng.integers(-(2**40), 2**40, size=(n_dev, b, 3)).astype(np.int64)
    t_buf, t_lane, t_drop = t_routing.pack_by_dest(
        torch.from_numpy(payload), torch.from_numpy(dest).long(), n_dest, cap
    )
    for d in range(n_dev):
        buf, lane, drop = ref_routing.pack_by_dest(
            jnp.asarray(payload[d]), jnp.asarray(dest[d]), n_dest, cap
        )
        np.testing.assert_array_equal(np.asarray(buf), t_buf[d].numpy())
        np.testing.assert_array_equal(np.asarray(lane), t_lane[d].numpy())
        np.testing.assert_array_equal(np.asarray(drop), t_drop[d].numpy())
        back = ref_routing.unpack_to_lanes(buf, lane, b, 0)
        t_back = t_routing.unpack_to_lanes(t_buf, t_lane, b, 0)
        np.testing.assert_array_equal(np.asarray(back), t_back[d].numpy())


@pytest.mark.parametrize("factor", [2.0, 0.25])
def test_fetch_rows_coalesces_like_reference(factor):
    """Duplicate gids share one read; a small bucket sheds every lane of a
    dropped representative."""
    rng = np.random.default_rng(int(factor * 4))
    keys = np.sort(rng.choice(40_000, size=5000, replace=False).astype(np.int64))
    pool, meta = ref_pool.build_pool(keys, keys * 3, level_m=1)
    t_pool_, t_meta = t_pool.build_pool(keys, keys * 3, level_m=1, device="cpu")
    cfg = ref_dex.DexMeshConfig(route_capacity_factor=factor)
    t_cfg = t_dex.DexMeshConfig(route_capacity_factor=factor)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    hot = rng.integers(0, meta.n_subtrees * meta.subtree_cap, size=12)
    gid = rng.choice(hot, size=96).astype(np.int64)
    want = rng.random(96) < 0.8

    def local(pool, gid, want):
        return ref_routing.fetch_rows(pool, meta, cfg, gid, want)

    fn = ref_routing.shard_map_compat(
        local, mesh=mesh, in_specs=(P(), P(), P()), out_specs=(P(),) * 5
    )
    ref_out = jax.jit(fn)(pool, jnp.asarray(gid), jnp.asarray(want))
    t_mesh.reset_counts()
    t_gid, t_want = torch.from_numpy(gid)[None], torch.from_numpy(want)[None]
    t_out = t_routing.fetch_rows(t_pool_, t_meta, t_cfg, t_gid, t_want)
    assert t_mesh.collective_counts() == {"all_to_all": 4, "route_exchange": 0}
    for a, b in zip(ref_out, t_out):
        np.testing.assert_array_equal(np.asarray(a).reshape(-1), b.numpy().reshape(-1))
    assert int(t_out[4][0]) < int(want.sum())
