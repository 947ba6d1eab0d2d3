"""The port's lookup engine against ``repro.core.engine.make_dex_engine(
ops=("lookup",))``: lane results, every state plane and the per-batch
collective counts are bit-identical after each of three batches, at 1x1
(inline) and at 2x4 (the reference in a subprocess on a forced 8-device
CPU mesh, ``tests/torch_mesh_ref.py``); at 2x4 also the mixed lookup,
update and insert engine.  The 1x1 mixed engine is in
tests/test_torch_write.py."""


import dataclasses

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
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import fleet_cache as t_fleet_cache  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from torch_mesh_group import MeshGroup  # noqa: E402

#: the reference runs its jnp kernels (``repro/kernels/ref.py``), bit for bit
#: its Pallas ones (``tests/test_kernels.py``), which hold the port's kernels in
#: ``tests/test_torch_{kernels,write,scan,smo}.py``: interpret mode's trace and
#: compile were most of a reference run's time
PLAIN = dict(use_kernel=False)

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
RESULTS = ("found", "values", "status", "shed")


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


def _dataset(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(16 * n, size=n, replace=False).astype(np.int64) + 1)


@pytest.mark.parametrize(
    "policy,factor",
    [("fetch", 2.0), ("offload", 2.0), ("auto", 2.0), ("auto", 0.4)],
)
def test_engine_1x1_matches_reference(policy, factor):
    """tests/test_engine.py's 1x1 setup (4,000 keys), three batches."""
    keys = _dataset(4000, seed=1)
    vals = keys * 5
    pool, meta = ref_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=1)
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, device="cpu")
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    kw = dict(
        n_route=1,
        n_memory=1,
        cache_sets=128,
        cache_ways=4,
        p_admit_leaf_pct=10,
        route_capacity_factor=factor,
        policy=policy,
    )
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    fn = ref_engine.make_dex_engine(meta, cfg, mesh, ops=("lookup",), **PLAIN)
    eng = jax.jit(fn)
    t_eng = t_engine.make_dex_engine(t_meta, t_cfg, device="cpu")
    for k in ("route_rounds", "fused_pairs", "descent_levels", "scan_hops"):
        assert t_eng.plan[k] == fn.plan[k], k
    rng = np.random.default_rng(2)
    counts = None
    for i in range(3):
        q = rng.choice(keys, size=400).astype(np.int64)
        q[::7] += 1
        q[::31] = KEY_MAX
        q[5] = KEY_MIN
        opc = np.zeros(q.shape, np.int32)
        args = (jnp.asarray(opc), jnp.asarray(q), jnp.zeros(q.shape, jnp.int64))
        if counts is None:
            counts = ref_routing.trace_collective_counts(fn, state, *args)
        state, res = eng(state, *args)
        t_mesh.reset_counts()
        t_state, t_res = t_eng(t_state, opc, q, np.zeros(q.shape, np.int64))
        assert t_mesh.collective_counts() == counts
        for k in RESULTS:
            np.testing.assert_array_equal(
                np.asarray(getattr(res, k)), getattr(t_res, k).numpy(), err_msg=k
            )
        _assert_state_equal(_flat(state), t_state, f"{policy} batch {i}")
    stats = t_state.stats.numpy()
    if policy == "offload":
        assert stats[:, t_registry.STAT_OFFLOADS].sum() > 0
    if factor < 1:
        assert stats[:, t_registry.STAT_DROPS].sum() > 0


def test_make_dex_lookup_wrapper_matches_engine():
    keys = _dataset(3000, seed=4)
    t_pool_, t_meta = t_pool.build_pool(keys, keys * 3, device="cpu")
    t_cfg = t_dex.DexMeshConfig(n_route=2, n_memory=2, cache_sets=32)
    bounds = np.array([KEY_MIN, int(keys[1500]), KEY_MAX])
    q = np.concatenate([keys[::10], keys[::10] + 1])[:296]
    lookup = t_dex.make_dex_lookup(t_meta, t_cfg, device="cpu")
    s1, f, v, sh = lookup(t_dex.init_state(t_pool_, t_meta, t_cfg, bounds,
                                           device="cpu"), q)
    assert not bool(sh.any())
    np.testing.assert_array_equal(f.numpy(), np.isin(q, keys))
    np.testing.assert_array_equal(v.numpy()[f.numpy()], q[f.numpy()] * 3)
    eng = t_engine.make_dex_engine(
        t_meta, t_cfg, cache_policy=t_fleet_cache.uniform_policy(t_cfg), device="cpu"
    )
    s2, r = eng(
        t_dex.init_state(t_pool_, t_meta, t_cfg, bounds, device="cpu"),
        np.zeros(q.shape, np.int32),
        q,
        np.zeros(q.shape, np.int64),
    )
    np.testing.assert_array_equal(r.found.numpy(), f.numpy())
    a, b = t_dex.state_to_numpy(s1), t_dex.state_to_numpy(s2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def mesh_group(tmp_path_factory):
    """The reference's ``engine`` group, run once for the module
    (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory) as group:
        yield group


@pytest.fixture(scope="module")
def mesh_ref(mesh_group):
    return mesh_group.arrays()


@pytest.mark.parametrize("name", ["fetch", "offload", "auto", "auto_tight"])
def test_engine_2x4_matches_reference(mesh_ref, name):
    arrays = mesh_ref
    policy, factor = str(arrays[f"{name}/policy"]), float(arrays[f"{name}/factor"])
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    t_cfg = t_dex.DexMeshConfig(
        n_route=2,
        n_memory=4,
        cache_sets=64,
        cache_ways=4,
        policy=policy,
        route_capacity_factor=factor,
    )

    def planes(tag):
        pre = f"{name}/{tag}/"
        return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}

    t_state = t_dex.state_from_numpy(planes("init"), t_meta, t_cfg, "cpu")
    t_eng = t_engine.make_dex_engine(t_meta, t_cfg, device="cpu")
    counts = arrays[f"{name}/counts"]
    for i in range(3):
        q = arrays[f"batch/{i}"]
        t_mesh.reset_counts()
        t_state, t_res = t_eng(
            t_state, np.zeros(q.shape, np.int32), q, np.zeros(q.shape, np.int64)
        )
        assert t_mesh.collective_counts() == {
            "all_to_all": int(counts[0]), "route_exchange": int(counts[1])
        }
        want = planes(str(i))
        for k in RESULTS:
            np.testing.assert_array_equal(
                want.pop(f"result.{k}"), getattr(t_res, k).numpy(), err_msg=k
            )
        _assert_state_equal(want, t_state, f"{name} batch {i}")
    if factor < 1:
        assert t_state.stats.numpy()[:, t_registry.STAT_DROPS].sum() > 0


@pytest.mark.parametrize("name", ["mixed_fetch", "mixed_offload", "mixed_auto"])
def test_mixed_engine_2x4_matches_reference(mesh_ref, name):
    """Lookups, updates and inserts at 2x4: every route replica of a memory
    column applies the same gathered batch in the reference; the port applies
    it once to its one pool and must end in the same planes."""
    arrays = mesh_ref
    policy = str(arrays[f"{name}/policy"])
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    t_cfg = t_dex.DexMeshConfig(
        n_route=2,
        n_memory=4,
        cache_sets=64,
        cache_ways=4,
        policy=policy,
        route_capacity_factor=float(arrays[f"{name}/factor"]),
    )

    def planes(tag):
        pre = f"{name}/{tag}/"
        return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}

    t_state = t_dex.state_from_numpy(planes("init"), t_meta, t_cfg, "cpu")
    t_eng = t_engine.make_dex_engine(
        t_meta, t_cfg, ops=("lookup", "update", "insert"), device="cpu"
    )
    counts = arrays[f"{name}/counts"]
    for i in range(3):
        args = [arrays[f"mixed/{i}/{f}"] for f in ("opcodes", "keys", "values")]
        t_mesh.reset_counts()
        t_state, t_res = t_eng(t_state, *args)
        assert t_mesh.collective_counts() == {
            "all_to_all": int(counts[0]), "route_exchange": int(counts[1])
        }
        want = planes(str(i))
        for k in RESULTS:
            np.testing.assert_array_equal(
                want.pop(f"result.{k}"), getattr(t_res, k).numpy(), err_msg=k
            )
        _assert_state_equal(want, t_state, f"{name} batch {i}")
    stats = t_state.stats.numpy()
    assert stats[:, t_registry.STAT_SPLITS].sum() > 0
    assert stats[:, t_registry.STAT_WRITES].sum() + stats[
        :, t_registry.STAT_OFFLOADS
    ].sum() > 0


def test_state_to_numpy_is_a_snapshot():
    """The engine updates cache planes in place; a flattened state must not
    change with them."""
    keys = _dataset(500, seed=5)
    t_pool_, t_meta = t_pool.build_pool(keys, device="cpu")
    t_cfg = t_dex.DexMeshConfig(cache_sets=16)
    state = t_dex.init_state(
        t_pool_, t_meta, t_cfg, np.array([KEY_MIN, KEY_MAX]), device="cpu"
    )
    before = t_dex.state_to_numpy(state)
    state.cache.tags.fill_(7)
    assert (before["cache.tags"] == -1).all()
    again = t_dex.state_from_numpy(before, t_meta, t_cfg, "cpu")
    for k, v in t_dex.state_to_numpy(again).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


@pytest.mark.parametrize("ops", [("lookup",), t_engine.ALL_OPS])
def test_two_route_axes_equal_one_axis_of_their_product(ops):
    """A 2x2 pair of route axes over 2 memory columns routes as one route
    axis of 4 does (route index ``d0 * 2 + d1``): the same lanes and planes
    batch by batch; each route exchange counts one ``all_to_all`` more.
    ``tests/test_torch_route_axes.py`` holds the two-axis engines to the
    reference's."""
    keys = _dataset(3000, seed=6)
    _, t_meta = t_pool.build_pool(keys, keys * 3, n_shards=2, device="cpu")
    bounds = np.array([KEY_MIN, 12_000, 24_000, 36_000, KEY_MAX])
    kw = dict(n_route=4, n_memory=2, cache_sets=32, policy="auto",
              route_capacity_factor=1.0)
    cfgs = [t_dex.DexMeshConfig(**kw),
            t_dex.DexMeshConfig(route_axes=("data", "pod"), route_shape=(2, 2), **kw)]
    states = [t_dex.init_state(t_pool.build_pool(keys, keys * 3, n_shards=2,
                                                 device="cpu")[0],
                               t_meta, c, bounds, device="cpu") for c in cfgs]
    engs = [t_engine.make_dex_engine(t_meta, c, ops=ops, max_count=8, device="cpu")
            for c in cfgs]
    rng = np.random.default_rng(7)
    for _ in range(2):
        opc = rng.integers(0, len(ops), size=512).astype(np.int32)
        kk = rng.choice(keys, size=512) + rng.integers(0, 2, size=512)
        vv = np.where(opc == 3, rng.integers(1, 12, size=512), kk * 5)
        got = []
        for i in range(2):
            t_mesh.reset_counts()
            states[i], r = engs[i](states[i], opc, kk, vv)
            got.append((r, t_mesh.collective_counts()))
        (r0, c0), (r1, c1) = got
        assert c1 == {"all_to_all": c0["all_to_all"] + c0["route_exchange"],
                      "route_exchange": c0["route_exchange"]}
        for k in r0._fields:
            a, b = getattr(r0, k), getattr(r1, k)
            assert (a is None and b is None) or torch.equal(a, b), k
        a, b = (t_dex.state_to_numpy(s) for s in states)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert states[0].stats.numpy()[:, t_registry.STAT_DROPS].sum() > 0


@pytest.mark.parametrize(
    "kw",
    [
        dict(ops=("lookup", "scan"), pipeline=True),
        dict(ops=("scan",), divergent="demand"),
        dict(cfg=dict(route_table_slots=8), pipeline=True),
        dict(divergent="demand"),
        dict(divergent="peek", cfg=dict(n_route=2, n_memory=2, policy="fetch")),
        dict(ops=t_engine.ALL_OPS, divergent="peek", pipeline=True,
             cfg=dict(n_route=2, n_memory=2, policy="fetch")),
        dict(ops=("lookup", "update"), divergent="peek", pipeline=True,
             cfg=dict(n_route=2, n_memory=2, policy="fetch")),
    ],
)
def test_pipeline_and_divergent_engines_run_one_batch(kw):
    """The pipelined engine and divergent cache policies build and run a
    batch of lookups (plus a scan lane where the engine scans) whose answers
    match the keys; the last two cases peek."""
    keys = _dataset(500, seed=6)
    t_cfg = t_dex.DexMeshConfig(cache_sets=16, **kw.get("cfg", {}))
    t_pool_, t_meta = t_pool.build_pool(keys, keys * 3, n_shards=t_cfg.n_memory,
                                        device="cpu")
    bounds = np.array([KEY_MIN] + [int(keys[250])] * (t_cfg.n_route - 1) + [KEY_MAX])
    state = t_dex.init_state(t_pool_, t_meta, t_cfg, bounds, device="cpu")
    policy = None
    if kw.get("divergent") == "demand":
        policy = t_fleet_cache.uniform_policy(t_cfg)._replace(demand_beta=2.0)
    elif kw.get("divergent") == "peek":
        policy = t_fleet_cache.divergent_policy(t_cfg, peek_budget=32)
    ops = kw.get("ops", ("lookup",))
    eng = t_engine.make_dex_engine(
        t_meta, t_cfg, ops=ops, max_count=8, cache_policy=policy,
        pipeline=kw.get("pipeline", False), device="cpu",
    )
    q = np.concatenate([keys[::5], keys[:20] + 1])[:112]
    opc = np.full(q.shape, t_engine.OP_LOOKUP, np.int32)
    if ops == ("scan",):
        opc[:] = t_engine.OP_SCAN
    vals = np.full(q.shape, 4, np.int64)
    if kw.get("pipeline"):
        assert eng.plan["pipeline"] is True
        state, (r,) = eng.run(state, [(opc, q, vals)])
    else:
        state, r = eng(state, opc, q, vals)
    assert not r.shed.any()
    if "lookup" in ops:
        np.testing.assert_array_equal(r.found.numpy(), np.isin(q, keys))
        np.testing.assert_array_equal(r.values.numpy()[r.found.numpy()],
                                      q[r.found.numpy()] * 3)
    if ops == ("scan",):
        assert (r.taken.numpy() == 4).all()
    stats = state.stats.numpy().sum(0)
    assert stats[t_registry.STAT_OPS] == q.size
    peeks = stats[t_registry.STAT_PEER_HITS] + stats[t_registry.STAT_PEER_MISSES]
    assert (peeks > 0) == (kw.get("divergent") == "peek")


def test_offloaded_update_leaves_a_stale_cached_row_stale():
    from repro_torch.core.write import STATUS_OK

    """ROADMAP.md queue 3, entry 22: an offloaded update on a device whose
    cached copy of the leaf went stale under an insert from another device
    must not refresh that copy's values and stamp it current (the
    reference's write-through does, which stitches the old keys plane to
    the new values row; the port refreshes only where the cached keys equal
    the leaf's post-batch keys row).  On a 1x2 mesh: device 0 caches a leaf, device 1
    inserts a key below ``k`` into it, device 0 updates ``k`` offloaded,
    then device 0 looks up every key of the leaf through the cache: each
    reads its own value."""
    from repro_torch.core.write import STATUS_OK

    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(300_000, size=6000, replace=False).astype(np.int64)) + 1
    vals = keys * 7
    cfg = t_dex.DexMeshConfig(n_route=1, n_memory=2, cache_sets=64, cache_ways=4,
                              policy="fetch", p_admit_leaf_pct=100)
    pool, meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=2,
                                   device="cpu")
    bounds = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max], np.int64)
    state = t_dex.init_state(pool, meta, cfg, bounds, device="cpu")
    leaf = keys[4:12]  # keys of the first leaf
    k = leaf[-1]
    fresh = next(int(x) for x in range(int(leaf[0]) + 1, int(k)) if x not in set(leaf))
    b = 16
    lanes = np.full(2 * b, np.iinfo(np.int64).max, np.int64)
    opc = np.zeros(2 * b, np.int32)

    def run(eng, state, dev, kk, op, vv):
        q, o, v = lanes.copy(), opc.copy(), np.zeros(2 * b, np.int64)
        q[dev * b : dev * b + len(kk)] = kk
        o[dev * b : dev * b + len(kk)] = op
        v[dev * b : dev * b + len(kk)] = vv
        return eng(state, o, q, v)

    mk = lambda policy, ops: t_engine.make_dex_engine(  # noqa: E731
        meta, dataclasses.replace(cfg, policy=policy), ops=ops, device="cpu")
    lookup, insert = mk("fetch", ("lookup",)), mk("fetch", ("insert",))
    update = mk("offload", ("lookup", "update"))
    state, _ = run(lookup, state, 0, leaf, t_engine.OP_LOOKUP, 0)
    state, r = run(insert, state, 1, [fresh], t_engine.OP_INSERT, fresh * 7)
    assert r.status[b] == STATUS_OK
    state, r = run(update, state, 0, [k], t_engine.OP_UPDATE, 12345)
    assert r.status[0] == STATUS_OK
    stats = state.stats.numpy().sum(0)
    assert stats[t_registry.STAT_OFFLOADS] >= 1
    state, r = run(lookup, state, 0, leaf, t_engine.OP_LOOKUP, 0)
    want = np.where(leaf == k, 12345, leaf * 7)
    assert r.found[: len(leaf)].all()
    np.testing.assert_array_equal(r.values[: len(leaf)].numpy(), want)
    assert state.stats.numpy()[0, t_registry.STAT_HITS] > 0
