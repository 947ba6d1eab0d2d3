"""The port's scan path against the reference, bit for bit on the CPU:

* ``leaf_scan_ref`` against the reference's Pallas ``leaf_scan``
  (interpret mode) and its jnp oracle, on the cases of tests/test_scan.py
  (realistic windows, edge cases, counts clipped to ``max_count``) and on
  the contract cases of tests/test_torch_cuda.py;
* ``make_dex_scan`` against ``repro.core.scan.make_dex_scan`` at 1x1 on the
  tests/test_scan.py cases (uniform and Zipfian starts, empty and boundary
  scans, subtree-crossing long scans, shedding buckets): results, every
  state plane and the collective counts, and the results against
  ``HostBTree.scan``;
* the ``ALL_OPS`` engine reproducing tests/test_engine.py's ``GOLDEN_SYNC``
  digests on that file's trace, and matching the reference under
  ``offload`` and ``auto``;
* the ``ALL_OPS`` and scan-only engines at 2x4 (the reference in a
  subprocess on a forced 8-device CPU mesh, ``tests/torch_mesh_ref.py``).
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import routing as ref_routing  # noqa: E402
from repro.core import scan as ref_scan  # noqa: E402
from repro.core.sim import HostBTree  # noqa: E402
from repro.data import ycsb as ref_ycsb  # noqa: E402
from repro.kernels import leaf_scan as ref_leaf_scan  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import scan as t_scan  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from test_engine import GOLDEN_SYNC, MC, _digest, _mixed_batches  # noqa: E402
from test_engine import _dataset as _engine_dataset  # noqa: E402
from test_torch_cuda import scan_case  # noqa: E402
from torch_mesh_group import MeshGroup  # noqa: E402

#: the reference runs its jnp kernels (``repro/kernels/ref.py``), bit for bit
#: its Pallas ones (``tests/test_kernels.py``), which hold the port's kernels in
#: ``tests/test_torch_{kernels,write,scan,smo}.py``: interpret mode's trace and
#: compile were most of a reference run's time
PLAIN = dict(use_kernel=False)

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
FANOUT = 64
SCAN_RESULTS = ("found", "values", "status", "shed", "scan_keys", "scan_values",
                "taken")


def _flat(state):
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(p.name for p in path): np.asarray(x) for path, x in leaves}


def _assert_state_equal(want: dict, state, where):
    got = t_dex.state_to_numpy(state)
    assert sorted(got) == sorted(want), where
    for k, a in want.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {k}")


def _dataset(n, seed=0, space=None):
    rng = np.random.default_rng(seed)
    space = space or 8 * n
    return np.sort(rng.choice(space, size=n, replace=False).astype(np.int64) + 1)


def _window(b, hops, seed, per_leaf=44):
    """tests/test_scan.py's realistic leaf windows."""
    rng = np.random.default_rng(seed)
    w = hops * FANOUT
    k = np.full((b, w), KEY_MAX, np.int64)
    v = np.zeros((b, w), np.int64)
    for i in range(b):
        base = rng.integers(1, 1 << 40)
        keys = base + np.cumsum(rng.integers(1, 9, size=hops * per_leaf))
        for h in range(hops):
            seg = keys[h * per_leaf : (h + 1) * per_leaf]
            k[i, h * FANOUT : h * FANOUT + per_leaf] = seg
            v[i, h * FANOUT : h * FANOUT + per_leaf] = seg * 3
    return k, v


def _scan_window_case(name):
    if name.startswith("window"):
        b = int(name[len("window"):])
        rng = np.random.default_rng(b)
        k, v = _window(b, 3, b)
        valid = k != KEY_MAX
        start = np.array(
            [row[va][rng.integers(0, va.sum())] for row, va in zip(k, valid)],
            np.int64,
        )
        start[::2] += 1
        cnt = rng.integers(0, 70, size=b).astype(np.int32)
        return k, v, start, cnt, 48
    if name == "edges":
        k = np.full((4, FANOUT), KEY_MAX, np.int64)
        k[0, :5] = [-9, -3, 0, 4, 7]
        k[1, :3] = [10, 20, 30]
        v = np.arange(4 * FANOUT, dtype=np.int64).reshape(4, FANOUT)
        start = np.array([-10, 25, 1, KEY_MAX - 1], np.int64)
        return k, v, start, np.array([3, 9, 5, 5], np.int32), 8
    if name == "clipped":
        k, v = _window(2, 2, 9)
        return k, v, k[:, 0].copy(), np.array([500, 500], np.int32), 16
    b, hops, mc = {"contract37": (37, 3, 48), "contract300": (300, 5, 100)}[name]
    return (*scan_case(b, hops, b, mc), mc)


@pytest.mark.parametrize(
    "name",
    ["window1", "window7", "window64", "window130", "edges", "clipped",
     "contract37", "contract300"],
)
def test_leaf_scan_ref_matches_reference(name):
    k, v, start, cnt, mc = _scan_window_case(name)
    jargs = tuple(map(jnp.asarray, (k, v, start, cnt)))
    want = ref_leaf_scan.leaf_scan(*jargs, max_count=mc, interpret=True)
    oracle = ref_ref.leaf_scan_ref(*jargs, max_count=mc)
    got = t_ops.leaf_scan(*map(torch.from_numpy, (k, v, start, cnt)), max_count=mc)
    assert t_ops.LAUNCHES["leaf_scan"] == 0
    assert got[2].dtype == torch.int32 and got[0].shape == (k.shape[0], mc)
    for w, o, g in zip(want, oracle, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(np.asarray(o), g.numpy())
    if name == "edges":
        assert got[2].tolist() == [3, 1, 0, 0]
    if name == "clipped":
        assert (got[2] == 16).all()


def _scan_setup(keys, *, level_m=1, max_count=48, factor=2.0):
    vals = keys * 5
    pool, meta = ref_pool.build_pool(keys, vals, level_m=level_m, fill=0.7,
                                     n_shards=1)
    _, t_meta = t_pool.build_pool(keys, vals, level_m=level_m, fill=0.7,
                                  device="cpu")
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    kw = dict(n_route=1, n_memory=1, cache_sets=128, cache_ways=4,
              route_capacity_factor=factor)
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    fn = ref_scan.make_dex_scan(meta, cfg, mesh, max_count=max_count, **PLAIN)
    t_fn = t_scan.make_dex_scan(t_meta, t_cfg, max_count=max_count, device="cpu")
    return state, fn, t_state, t_fn


def _scan_inputs(name):
    """(keys, [(starts, counts) per batch], level_m, max_count, factor) of
    the tests/test_scan.py cases."""
    if name.startswith("uniform"):
        level_m = int(name[-1])
        keys = _dataset(4000, seed=level_m)
        rng = np.random.default_rng(level_m + 10)
        starts = rng.choice(keys, size=220).astype(np.int64)
        starts[::4] += 1
        counts = rng.integers(0, 49, size=220).astype(np.int64)
        # a second batch re-reads the warmed cache
        return keys, [(starts, counts), (starts[::-1].copy(), counts)], level_m, 48, 2.0
    if name == "zipfian":
        keys = _dataset(4000, seed=3)
        z = ref_ycsb.ZipfianGenerator(keys.size, theta=0.99, seed=5)
        starts = keys[ref_ycsb.scramble(z.draw_ranks(220), keys.size)]
        return keys, [(starts, np.full(220, 37, np.int64))], 1, 48, 2.0
    if name == "boundary":
        keys = _dataset(2000, seed=4)
        starts = np.array(
            [keys[-1], keys[-1] + 1, KEY_MAX - 1, 1, keys[0] - 1, KEY_MIN,
             keys[0], keys[0]],
            np.int64,
        )
        counts = np.array([10, 10, 10, 10, 10, 10, 0, 200], np.int64)
        return keys, [(starts, counts)], 1, 48, 2.0
    if name == "long":
        keys = _dataset(3000, seed=6)
        rng = np.random.default_rng(7)
        starts = rng.choice(keys, size=120).astype(np.int64)
        return keys, [(starts, np.full(120, 128, np.int64))], 1, 128, 2.0
    assert name == "shedding"
    keys = _dataset(3000, seed=20)
    rng = np.random.default_rng(21)
    starts = rng.choice(keys, size=128).astype(np.int64)
    return keys, [(starts, np.full(128, 20, np.int64))], 1, 32, 0.5


def _host_scan(host, start, count):
    if count <= 0:
        return []
    return [k for _, ks in host.scan(int(start), int(count)) for k in ks][:count]


@pytest.mark.parametrize(
    "name",
    ["uniform0", "uniform1", "uniform2", "zipfian", "boundary", "long", "shedding"],
)
def test_make_dex_scan_matches_reference(name):
    keys, batches, level_m, mc, factor = _scan_inputs(name)
    state, fn, t_state, t_fn = _scan_setup(
        keys, level_m=level_m, max_count=mc, factor=factor
    )
    scan = jax.jit(fn)
    host = HostBTree(keys, keys * 5, fill=0.7)
    counts_ref = None
    for i, (starts, counts) in enumerate(batches):
        args = (jnp.asarray(starts), jnp.asarray(counts))
        if counts_ref is None:
            # JAX caches the trace: count once, on the first batch
            counts_ref = ref_routing.trace_collective_counts(fn, state, *args)
        state, rk, rv, rt = scan(state, *args)
        t_mesh.reset_counts()
        t_state, tk, tv, tt = t_fn(t_state, starts, counts)
        assert t_mesh.collective_counts() == counts_ref
        for w, g in ((rk, tk), (rv, tv), (rt, tt)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        _assert_state_equal(_flat(state), t_state, f"{name} batch {i}")
        tk, tv, tt = tk.numpy(), tv.numpy(), tt.numpy()
        for j in range(starts.size):
            if tt[j] < 0:
                assert (tk[j] == KEY_MAX).all() and (tv[j] == 0).all()
                continue
            exp = _host_scan(host, starts[j], min(int(counts[j]), mc))
            assert tk[j][: tt[j]].tolist() == exp, (j, int(starts[j]))
            np.testing.assert_array_equal(tv[j][: tt[j]], np.asarray(exp) * 5)
    shed = t_state.stats.numpy()[:, t_registry.STAT_DROPS].sum()
    if factor < 1:
        assert shed > 0 and (tt >= 0).any()
    else:
        assert shed == 0


def _golden_engine(policy):
    keys = _engine_dataset(4000, seed=31)
    vals = keys * 5
    pool, meta = ref_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=1)
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, device="cpu")
    kw = dict(n_route=1, n_memory=1, cache_sets=128, cache_ways=4,
              p_admit_leaf_pct=10, route_capacity_factor=2.0, policy=policy)
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    t_eng = t_engine.make_dex_engine(
        t_meta, t_cfg, ops=t_engine.ALL_OPS, max_count=MC, device="cpu"
    )
    batches = _mixed_batches(keys, np.random.default_rng(32), 4, 256,
                             with_scan=True, hot=keys[40:48])
    return keys, state, meta, cfg, t_state, t_eng, batches


def test_all_ops_engine_reproduces_golden_sync():
    """tests/test_engine.py's ``GOLDEN_SYNC``: the ALL_OPS engine under
    ``fetch`` on that file's trace, hashed the same way (dtypes, shapes and
    bytes of the result planes; pool, versions and occupancy; the first 12
    stat slots)."""
    _, _, _, _, t_state, t_eng, batches = _golden_engine("fetch")
    res_h = hashlib.sha256()
    for opc, kk, vals in batches:
        t_state, r = t_eng(t_state, opc, kk, vals)
        res_h.update(_digest(*(getattr(r, k).numpy() for k in SCAN_RESULTS)).encode())
    s = t_dex.state_to_numpy(t_state)
    got = {
        "results": res_h.hexdigest()[:16],
        "state": _digest(s["pool.pool_keys"], s["pool.pool_values"],
                         s["versions"], s["occupancy"]),
        "stats12": _digest(s["stats"][:, :12]),
    }
    assert got == GOLDEN_SYNC, got


@pytest.mark.parametrize("policy", ["offload", "auto"])
def test_all_ops_engine_1x1_matches_reference(policy):
    """The golden trace under ``offload`` and ``auto``: scans keep their
    descent and never offload, lookups and writes do."""
    _, state, meta, cfg, t_state, t_eng, batches = _golden_engine(policy)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    fn = ref_engine.make_dex_engine(meta, cfg, mesh, ops=ref_engine.ALL_OPS,
                                    max_count=MC, **PLAIN)
    for k in ("route_rounds", "fused_pairs", "descent_levels", "scan_hops"):
        assert t_eng.plan[k] == fn.plan[k], k
    eng = jax.jit(fn)
    counts = None
    for i, (opc, kk, vals) in enumerate(batches):
        args = tuple(map(jnp.asarray, (opc, kk, vals)))
        if counts is None:
            counts = ref_routing.trace_collective_counts(fn, state, *args)
        state, res = eng(state, *args)
        t_mesh.reset_counts()
        t_state, t_res = t_eng(t_state, opc, kk, vals)
        assert t_mesh.collective_counts() == counts
        for k in SCAN_RESULTS:
            np.testing.assert_array_equal(
                np.asarray(getattr(res, k)), getattr(t_res, k).numpy(), err_msg=k
            )
        _assert_state_equal(_flat(state), t_state, f"{policy} batch {i}")
    assert t_state.stats.numpy()[:, t_registry.STAT_OFFLOADS].sum() > 0


def test_scan_only_engine_plan_prunes_the_fused_round():
    """A scan-only engine offloads nothing under any policy, so it runs the
    descent and no fused round, as the reference's plan says."""
    keys = _dataset(500, seed=6)
    pool, meta = ref_pool.build_pool(keys, keys, level_m=1, fill=0.7, n_shards=1)
    _, t_meta = t_pool.build_pool(keys, keys, device="cpu")
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    for policy in ("fetch", "offload", "auto"):
        cfg = ref_dex.DexMeshConfig(policy=policy)
        t_cfg = t_dex.DexMeshConfig(policy=policy)
        want = ref_engine.make_dex_engine(meta, cfg, mesh, ops=("scan",),
                                          max_count=64).plan
        got = t_engine.make_dex_engine(t_meta, t_cfg, ops=("scan",), max_count=64,
                                       device="cpu").plan
        for k in ("route_rounds", "fused_pairs", "descent_levels", "scan_hops"):
            assert got[k] == want[k], (policy, k)
        assert got["fused_pairs"] == 0


@pytest.fixture(scope="module")
def scan_group(tmp_path_factory):
    """The reference's ``scan`` group, run once for the module
    (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory, "scan") as group:
        yield group


@pytest.fixture(scope="module")
def scan_ref(scan_group):
    return scan_group.arrays()


@pytest.mark.parametrize(
    "name",
    ["scan_fetch", "scan_fetch_tight", "scan_offload", "scan_auto",
     "scan_only_offload"],
)
def test_scan_engine_2x4_matches_reference(scan_ref, name):
    arrays = scan_ref
    policy, factor = str(arrays[f"{name}/policy"]), float(arrays[f"{name}/factor"])
    ops = tuple(str(arrays[f"{name}/ops"]).split(","))
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    t_cfg = t_dex.DexMeshConfig(
        n_route=2, n_memory=4, cache_sets=64, cache_ways=4, policy=policy,
        route_capacity_factor=factor,
    )

    def planes(tag):
        pre = f"{name}/{tag}/"
        return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}

    t_state = t_dex.state_from_numpy(planes("init"), t_meta, t_cfg, "cpu")
    t_eng = t_engine.make_dex_engine(t_meta, t_cfg, ops=ops, max_count=32,
                                     device="cpu")
    counts = arrays[f"{name}/counts"]
    for i in range(3):
        args = [arrays[f"scanmix/{i}/{f}"] for f in ("opcodes", "keys", "values")]
        t_mesh.reset_counts()
        t_state, t_res = t_eng(t_state, *args)
        assert t_mesh.collective_counts() == {
            "all_to_all": int(counts[0]), "route_exchange": int(counts[1])
        }
        want = planes(str(i))
        for k in SCAN_RESULTS:
            np.testing.assert_array_equal(
                want.pop(f"result.{k}"), getattr(t_res, k).numpy(), err_msg=k
            )
        _assert_state_equal(want, t_state, f"{name} batch {i}")
    stats = t_state.stats.numpy()
    if factor < 1:
        assert stats[:, t_registry.STAT_DROPS].sum() > 0
    if ops == ("scan",):
        assert stats[:, t_registry.STAT_OFFLOADS].sum() == 0
        assert (t_res.taken.numpy() > 0).any()
