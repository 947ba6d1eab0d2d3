"""The port's leaf-direct route table against the reference's, bit for bit
on the CPU:

* ``train_route_table`` (every table array) with full slots, with scarce
  slots and a demand signal, and on a pool after on-mesh splits;
  ``poison_route_table``, ``route_table_active``, ``leaf_ranges``;
* ``routing.rt_predict`` and ``fleet_cache.rt_accept`` on seeded probes;
* the engine with a trained table at 1x1 under ``fetch``, ``offload`` and
  ``auto`` (lane results, every state plane, ``STAT_RT_SKIPS`` /
  ``STAT_RT_MISPREDICTS`` and the collective counts);
* a poisoned table gives the descent-only answers
  (tests/test_route_table.py::TestPoisonedBitIdentity's synchronous cases);
* at 2x4, the mixed engine with a trained table under the three policies
  and a poisoned one (the reference in a subprocess on a forced 8-device
  CPU mesh, ``tests/torch_mesh_ref.py rt``).

The pipelined engine's poisoned case is in tests/test_torch_pipeline.py.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import fleet_cache as ref_fleet_cache  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import route_table as ref_rt  # noqa: E402
from repro.core import routing as ref_routing  # noqa: E402
from repro.core import smo as ref_smo  # noqa: E402
from repro.core import write as ref_write  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import fleet_cache as t_fleet_cache  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import route_table as t_rt  # noqa: E402
from repro_torch.core import routing as t_routing  # noqa: E402
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
OPS = ("lookup", "update", "insert")


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


def _setup(n_keys=4000, *, rt_slots=0, seed=0, policy="fetch", n_route=1,
           bounds=None):
    """tests/test_route_table.py's ``_setup`` in both packages."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(16 * n_keys, size=n_keys, replace=False).astype(np.int64) + 1)
    pool, meta = ref_pool.build_pool(keys, keys * 5, level_m=1, fill=0.7, n_shards=1)
    _, t_meta = t_pool.build_pool(keys, keys * 5, level_m=1, fill=0.7, device="cpu")
    kw = dict(
        n_route=n_route, n_memory=1, cache_sets=128, cache_ways=4,
        p_admit_leaf_pct=10, route_capacity_factor=2.0, policy=policy,
        route_table_slots=rt_slots,
    )
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    if bounds is None:
        bounds = np.array([KEY_MIN, KEY_MAX], np.int64)
    state = ref_dex.init_state(pool, meta, cfg, bounds)
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    return keys, meta, t_meta, cfg, t_cfg, state, t_state


def _mixed_batches(keys, rng, n, b):
    """tests/test_route_table.py's ``_mixed_batches``, as numpy arrays."""
    out = []
    for _ in range(n):
        opc = rng.integers(0, 3, size=b).astype(np.int32)
        kk = rng.choice(keys, size=b).astype(np.int64)
        ins = opc == ref_engine.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=b)
        ok_f = ~np.isin(fresh, keys)
        kk[ins & ok_f] = fresh[ins & ok_f]
        vals = np.zeros(b, np.int64)
        upd = opc == ref_engine.OP_UPDATE
        vals[upd] = kk[upd] ^ 0x5A5A
        vals[ins] = kk[ins] * 7
        out.append((opc, kk, vals))
    return out


def test_train_with_full_slots_matches_reference():
    keys, meta, t_meta, _, _, state, t_state = _setup(rt_slots=1024)
    assert not t_rt.route_table_active(t_state)
    state = ref_rt.train_route_table(state, meta)
    t_state = t_rt.train_route_table(t_state, t_meta)
    assert t_rt.route_table_active(t_state)
    _assert_state_equal(_flat(state), t_state, "trained")
    for w, g in zip(ref_rt.leaf_ranges(state, meta), t_rt.leaf_ranges(t_state, t_meta)):
        np.testing.assert_array_equal(w, g.numpy())
    live = t_state.rt_ver.numpy() >= 0
    assert t_state.rt_keys.numpy()[live][0] == KEY_MIN
    assert t_state.rt_hi.numpy()[live][-1] == KEY_MAX


@pytest.mark.parametrize("slots,hot", [(8, 1), (40, 0), (33, None), (40, 1), (64, 1)])
def test_train_with_scarce_slots_matches_reference(slots, hot):
    """Fewer slots than leaves: the demand-hottest partition's leaves are
    kept (tests/test_route_table.py::test_scarce_slots_keep_demand_hot_partition),
    ties broken by key order."""
    keys = np.arange(1, 4001, dtype=np.int64) * 10
    pool, meta = ref_pool.build_pool(keys, keys * 3, level_m=1, fill=0.7, n_shards=1)
    _, t_meta = t_pool.build_pool(keys, keys * 3, level_m=1, fill=0.7, device="cpu")
    kw = dict(n_route=2, n_memory=1, route_table_slots=64)
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    mid = int(keys[2000])
    bounds = np.array([KEY_MIN, mid, KEY_MAX], np.int64)
    state = ref_dex.init_state(pool, meta, cfg, bounds)
    demand = np.zeros_like(np.asarray(state.route_demand))
    if hot is not None:
        demand[..., hot] = 1000
        demand[..., 1 - hot] = 3
    state = state._replace(route_demand=jnp.asarray(demand))
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    state = ref_rt.train_route_table(state, meta, slots=slots)
    t_state = t_rt.train_route_table(t_state, t_meta, slots=slots)
    _assert_state_equal(_flat(state), t_state, f"slots {slots}")
    live = t_state.rt_ver.numpy() >= 0
    assert 0 < live.sum() <= slots
    if hot == 1 and slots <= 40:
        # fewer slots than the hot partition's leaves: only hot leaves kept
        assert (t_state.rt_keys.numpy()[live] >= mid).all()


def test_train_after_smo_splits_matches_reference():
    """Siblings in free-list rows and merged parents (whose 0-padded
    children mark the block root a leaf in both packages)."""
    keys, meta, t_meta, cfg, t_cfg, state, _ = _setup(rt_slots=256, seed=5)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    rng = np.random.default_rng(6)
    burst = []
    for leaf in (3, 30, 60):
        lo, hi = keys[leaf * 44], keys[leaf * 44 + 43]
        burst.append(rng.choice(np.setdiff1d(np.arange(lo + 1, hi), keys), 30,
                                replace=False))
    kk = np.concatenate(burst)
    state, st = jax.jit(ref_write.make_dex_insert(meta, cfg, mesh, **PLAIN))(
        state, jnp.asarray(kk), jnp.asarray(kk * 5)
    )
    shed = np.asarray(st) == ref_write.STATUS_SPLIT
    state, _, _ = ref_smo.run_smo(
        jax.jit(ref_smo.make_dex_smo(meta, cfg, mesh, **PLAIN)),
        state, np.where(shed, kk, KEY_MAX), np.where(shed, kk * 5, 0),
    )
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    state = ref_rt.train_route_table(state, meta)
    t_state = t_rt.train_route_table(t_state, t_meta)
    _assert_state_equal(_flat(state), t_state, "trained after splits")
    assert (t_state.rt_ver.numpy() > 0).any()


def test_poison_matches_reference():
    _, meta, t_meta, _, _, state, t_state = _setup(rt_slots=1024)
    state = ref_rt.poison_route_table(ref_rt.train_route_table(state, meta))
    before = t_rt.train_route_table(t_state, t_meta)
    t_state = t_rt.poison_route_table(before)
    _assert_state_equal(_flat(state), t_state, "poisoned")
    live = before.rt_ver.numpy() >= 0
    np.testing.assert_array_equal(
        t_state.rt_ver.numpy()[live], before.rt_ver.numpy()[live] + (1 << 20)
    )
    assert t_rt.route_table_active(t_state)


def test_rt_predict_and_accept_match_reference():
    keys, meta, t_meta, _, _, state, t_state = _setup(rt_slots=1024, seed=2)
    state = ref_rt.train_route_table(state, meta)
    t_state = t_rt.train_route_table(t_state, t_meta)
    rng = np.random.default_rng(3)
    probe = rng.choice(keys, size=300).astype(np.int64)
    probe[::5] += 1
    probe[::17] = KEY_MIN
    probe[::23] = KEY_MAX
    probe[7] = -5
    want = ref_routing.rt_predict(
        state.rt_keys, state.rt_sub, state.rt_local, jnp.asarray(probe)
    )
    got = t_routing.rt_predict(
        t_state.rt_keys, t_state.rt_sub, t_state.rt_local, torch.from_numpy(probe)
    )
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # versions moved on some leaves, wrong subtrees, ineligible lanes
    vers = np.zeros(np.asarray(state.versions).shape, np.int32)
    vers[:, rng.choice(vers.shape[1], 40)] = 3
    subtree = np.zeros(probe.shape, np.int32)
    subtree[::11] = 1
    elig = rng.random(probe.size) < 0.8
    idx = np.array(want[0])
    w_out = ref_fleet_cache.rt_accept(
        meta, state.rt_keys, state.rt_hi, state.rt_sub, state.rt_local,
        state.rt_ver, jnp.asarray(vers[0]), jnp.asarray(idx), jnp.asarray(subtree),
        jnp.asarray(probe), jnp.asarray(elig),
    )
    g_out = t_fleet_cache.rt_accept(
        t_meta, t_state.rt_keys, t_state.rt_hi, t_state.rt_sub, t_state.rt_local,
        t_state.rt_ver, torch.from_numpy(vers), torch.from_numpy(idx)[None],
        torch.from_numpy(subtree)[None].long(), torch.from_numpy(probe)[None],
        torch.from_numpy(elig)[None],
    )
    for w, g in zip(w_out, g_out):
        np.testing.assert_array_equal(np.asarray(w), g[0].numpy())
    assert g_out[1].any() and (g_out[0] & ~g_out[1]).any()


@pytest.mark.parametrize("policy", ["fetch", "offload", "auto"])
def test_engine_with_trained_table_1x1_matches_reference(policy):
    keys, meta, t_meta, cfg, t_cfg, state, t_state = _setup(
        rt_slots=512, seed=41, policy=policy
    )
    state = ref_rt.train_route_table(state, meta)
    t_state = t_rt.train_route_table(t_state, t_meta)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    fn = ref_engine.make_dex_engine(meta, cfg, mesh, ops=OPS, max_count=1, **PLAIN)
    eng = jax.jit(fn)
    t_eng = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, max_count=1, device="cpu")
    for k in ("route_rounds", "fused_pairs", "descent_levels", "scan_hops"):
        assert t_eng.plan[k] == fn.plan[k], k
    rng = np.random.default_rng(43)
    counts = None
    for b, (opc, kk, vv) in enumerate(_mixed_batches(keys, rng, 4, 128)):
        args = tuple(map(jnp.asarray, (opc, kk, vv)))
        if counts is None:
            counts = ref_routing.trace_collective_counts(fn, state, *args)
        state, res = eng(state, *args)
        t_mesh.reset_counts()
        t_state, t_res = t_eng(t_state, opc, kk, vv)
        assert t_mesh.collective_counts() == counts
        for k in RESULTS:
            np.testing.assert_array_equal(
                np.asarray(getattr(res, k)), getattr(t_res, k).numpy(), err_msg=k
            )
        _assert_state_equal(_flat(state), t_state, f"{policy} batch {b}")
    stats = t_state.stats.numpy().sum(0)
    if policy == "fetch":
        assert stats[t_registry.STAT_RT_SKIPS] > 0
        assert stats[t_registry.STAT_RT_MISPREDICTS] > 0


def test_poisoned_table_matches_descent_only():
    """TestPoisonedBitIdentity.test_sync_engine_poisoned_matches_descent in
    the port: every plane but the mispredict counter equals the
    descent-only engine's, and the poisoned arm equals the reference's."""
    keys, meta, t_meta, _, t_cfg0, _, t_de = _setup(seed=41)
    _, _, _, cfg, t_cfg, state, t_rt_state = _setup(seed=41, rt_slots=512)
    state = ref_rt.poison_route_table(ref_rt.train_route_table(state, meta))
    t_rt_state = t_rt.poison_route_table(t_rt.train_route_table(t_rt_state, t_meta))
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    eng = jax.jit(ref_engine.make_dex_engine(meta, cfg, mesh, ops=OPS, max_count=1,
                                             **PLAIN))
    e_de = t_engine.make_dex_engine(t_meta, t_cfg0, ops=OPS, device="cpu")
    e_rt = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, device="cpu")
    rng = np.random.default_rng(42)
    for b, (opc, kk, vv) in enumerate(_mixed_batches(keys, rng, 4, 128)):
        state, res = eng(state, *map(jnp.asarray, (opc, kk, vv)))
        t_de, r_de = e_de(t_de, opc, kk, vv)
        t_rt_state, r_rt = e_rt(t_rt_state, opc, kk, vv)
        for k in RESULTS:
            np.testing.assert_array_equal(getattr(r_de, k).numpy(),
                                          getattr(r_rt, k).numpy(), err_msg=k)
        _assert_state_equal(_flat(state), t_rt_state, f"poisoned batch {b}")
    a, b_ = t_dex.state_to_numpy(t_de), t_dex.state_to_numpy(t_rt_state)
    st_de, st_rt = a.pop("stats"), b_.pop("stats")
    for k in a:
        if not k.startswith("rt_"):
            np.testing.assert_array_equal(a[k], b_[k], err_msg=k)
    mis = t_registry.STAT_RT_MISPREDICTS
    np.testing.assert_array_equal(np.delete(st_de, mis, 1), np.delete(st_rt, mis, 1))
    assert st_de[:, [t_registry.STAT_RT_SKIPS, mis]].sum() == 0
    assert st_rt[:, t_registry.STAT_RT_SKIPS].sum() == 0
    assert st_rt[:, mis].sum() > 0


def test_trained_table_changes_traffic_never_results():
    """TestPoisonedBitIdentity.test_sync_engine_trained_table_matches_descent
    in the port."""
    keys, meta, t_meta, _, t_cfg0, _, t_de = _setup(seed=41)
    _, _, _, _, t_cfg, _, t_live = _setup(seed=41, rt_slots=512)
    t_live = t_rt.train_route_table(t_live, t_meta)
    e_de = t_engine.make_dex_engine(t_meta, t_cfg0, ops=OPS, device="cpu")
    e_rt = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, device="cpu")
    rng = np.random.default_rng(43)
    for opc, kk, vv in _mixed_batches(keys, rng, 3, 128):
        t_de, r_de = e_de(t_de, opc, kk, vv)
        t_live, r_rt = e_rt(t_live, opc, kk, vv)
        for k in RESULTS:
            np.testing.assert_array_equal(getattr(r_de, k).numpy(),
                                          getattr(r_rt, k).numpy(), err_msg=k)
    for k in ("pool_values", "pool_keys"):
        np.testing.assert_array_equal(getattr(t_de.pool, k).numpy(),
                                      getattr(t_live.pool, k).numpy())
    np.testing.assert_array_equal(t_de.versions.numpy(), t_live.versions.numpy())
    skips = t_live.stats.numpy()[:, t_registry.STAT_RT_SKIPS].sum()
    fetch = t_registry.STAT_FETCHES
    assert skips > 0
    assert t_live.stats.numpy()[:, fetch].sum() < t_de.stats.numpy()[:, fetch].sum()


def test_trained_table_on_two_route_axes_changes_traffic_never_results():
    """A trained table on a 2x2 pair of route axes (4 route partitions, one
    memory column): the same lanes, pool and versions as the descent-only
    engine batch by batch, with some inner fetch rounds skipped."""
    rng = np.random.default_rng(44)
    keys = np.sort(rng.choice(64_000, size=4000, replace=False).astype(np.int64) + 1)
    _, t_meta = t_pool.build_pool(keys, keys * 5, level_m=1, fill=0.7, device="cpu")
    bounds = np.array([KEY_MIN, 16_000, 32_000, 48_000, KEY_MAX], np.int64)
    kw = dict(route_axes=("data", "pod"), route_shape=(2, 2), n_route=4, n_memory=1,
              cache_sets=128, p_admit_leaf_pct=10, policy="fetch")
    cfg0 = t_dex.DexMeshConfig(**kw)
    cfg = t_dex.DexMeshConfig(route_table_slots=512, **kw)

    def state(c):
        pool = t_pool.build_pool(keys, keys * 5, level_m=1, fill=0.7, device="cpu")[0]
        return t_dex.init_state(pool, t_meta, c, bounds, device="cpu")

    t_de, t_live = state(cfg0), t_rt.train_route_table(state(cfg), t_meta)
    e_de = t_engine.make_dex_engine(t_meta, cfg0, ops=OPS, device="cpu")
    e_rt = t_engine.make_dex_engine(t_meta, cfg, ops=OPS, device="cpu")
    for opc, kk, vv in _mixed_batches(keys, rng, 3, 128):
        t_de, r_de = e_de(t_de, opc, kk, vv)
        t_live, r_rt = e_rt(t_live, opc, kk, vv)
        for k in RESULTS:
            np.testing.assert_array_equal(getattr(r_de, k).numpy(),
                                          getattr(r_rt, k).numpy(), err_msg=k)
    for k in ("pool_values", "pool_keys"):
        np.testing.assert_array_equal(getattr(t_de.pool, k).numpy(),
                                      getattr(t_live.pool, k).numpy())
    np.testing.assert_array_equal(t_de.versions.numpy(), t_live.versions.numpy())
    assert t_live.stats.numpy()[:, t_registry.STAT_RT_SKIPS].sum() > 0


@pytest.mark.parametrize(
    "kw",
    [dict(pipeline=True), dict(divergent=True), dict(pipeline=True, divergent=True)],
)
def test_route_table_with_pipeline_or_divergent_policy_runs(kw):
    """A trained table under the pipeline or a divergent policy: one mixed
    batch, its lookups answered as the keys say, some guesses accepted."""
    keys, _, t_meta, _, t_cfg, _, t_state = _setup(n_keys=500, rt_slots=64)
    t_state = t_rt.train_route_table(t_state, t_meta)
    policy = None
    if kw.get("divergent"):
        policy = t_fleet_cache.uniform_policy(t_cfg)._replace(demand_beta=2.0)
    eng = t_engine.make_dex_engine(
        t_meta, t_cfg, ops=OPS, cache_policy=policy,
        pipeline=kw.get("pipeline", False), device="cpu",
    )
    opc, kk, vv = _mixed_batches(keys, np.random.default_rng(45), 1, 128)[0]
    if kw.get("pipeline"):
        t_state, (r,) = eng.run(t_state, [(opc, kk, vv)])
    else:
        t_state, r = eng(t_state, opc, kk, vv)
    lk = (opc == t_engine.OP_LOOKUP) & ~r.shed.numpy()
    np.testing.assert_array_equal(r.found.numpy()[lk], np.isin(kk[lk], keys))
    assert t_state.stats.numpy()[:, t_registry.STAT_RT_SKIPS].sum() > 0


@pytest.fixture(scope="module")
def rt_group(tmp_path_factory):
    """The reference's ``rt`` group, run once for the module
    (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory, "rt") as group:
        yield group


@pytest.fixture(scope="module")
def rt_ref(rt_group):
    return rt_group.arrays()


@pytest.mark.parametrize("name", ["rt_fetch", "rt_offload", "rt_auto", "rt_poison_fetch"])
def test_engine_with_route_table_2x4_matches_reference(rt_ref, name):
    arrays = rt_ref
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    t_cfg = t_dex.DexMeshConfig(
        n_route=2, n_memory=4, cache_sets=64, cache_ways=4,
        policy=str(arrays[f"{name}/policy"]),
        route_capacity_factor=float(arrays[f"{name}/factor"]),
        route_table_slots=512,
    )

    def planes(tag):
        pre = f"{name}/{tag}/"
        return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}

    t_state = t_rt.train_route_table(
        t_dex.state_from_numpy(planes("untrained"), t_meta, t_cfg, "cpu"), t_meta
    )
    if str(arrays[f"{name}/table"]) == "poisoned":
        t_state = t_rt.poison_route_table(t_state)
    _assert_state_equal(planes("init"), t_state, f"{name} trained")
    t_eng = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, device="cpu")
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
    if name == "rt_fetch":
        assert stats[:, t_registry.STAT_RT_SKIPS].sum() > 0
    if name == "rt_poison_fetch":
        assert stats[:, t_registry.STAT_RT_SKIPS].sum() == 0
        assert stats[:, t_registry.STAT_RT_MISPREDICTS].sum() > 0
