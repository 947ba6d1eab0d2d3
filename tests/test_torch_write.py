"""The port's write path against the reference, bit for bit on the CPU:

* ``leaf_write_ref`` against the reference's Pallas ``leaf_write`` (interpret
  mode, as tests/test_kernels.py runs it) and its jnp oracle;
* ``write._apply_leaf_writes`` against the reference's, with duplicate keys,
  an update and an insert of one key, and an overflowing leaf;
* the mixed lookup/update/insert engine at 1x1 against
  ``repro.core.engine.make_dex_engine(ops=("lookup", "update", "insert"))``
  under ``fetch``, ``offload``, ``auto`` and shedding buckets: lane results,
  every state plane and the per-batch collective counts;
* the ``make_dex_update`` / ``make_dex_insert`` wrappers.

The 2x4 mesh case is in tests/test_torch_engine.py."""

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
from repro.core import write as ref_write  # noqa: E402
from repro.kernels import leaf_write as ref_leaf_write  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import write as t_write  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from test_torch_cuda import leaf_case  # noqa: E402

#: the reference runs its jnp kernels (``repro/kernels/ref.py``), bit for bit
#: its Pallas ones (``tests/test_kernels.py``), which hold the port's kernels in
#: ``tests/test_torch_{kernels,write,scan,smo}.py``: interpret mode's trace and
#: compile were most of a reference run's time
PLAIN = dict(use_kernel=False)

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
OPS = ("lookup", "update", "insert")
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


@pytest.mark.parametrize("q,seed", [(1, 0), (37, 1), (256, 2)])
def test_leaf_write_ref_matches_reference_kernel(q, seed):
    case = leaf_case(q, seed)
    want = ref_leaf_write.leaf_write(*map(jnp.asarray, case), interpret=True)
    oracle = ref_ref.leaf_write_ref(*map(jnp.asarray, case))
    got = t_ops.leaf_write(*map(torch.from_numpy, case))
    assert t_ops.LAUNCHES["leaf_write"] == 0
    assert got[2].dtype == torch.int32
    for w, o, g in zip(want, oracle, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(np.asarray(o), g.numpy())
    direct = t_ref.leaf_write_ref(*map(torch.from_numpy, case))
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


def _leaf_of(pool, meta, keys):
    """Global leaf gid of each key (the port's walk on the CPU)."""
    q = torch.from_numpy(keys)
    st = t_pool.top_walk(pool, meta, q)
    _, _, loc = t_ref.subtree_walk_ref(
        pool.pool_keys,
        pool.pool_children,
        pool.pool_values,
        st.to(torch.int32),
        q,
        levels=meta.levels_in_subtree,
    )
    return (st * meta.subtree_cap + loc.long()).numpy()


def test_apply_leaf_writes_matches_reference():
    keys = _dataset(3000, seed=7)
    vals = keys * 5
    pool, meta = ref_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=1)
    t_pool_, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, device="cpu")
    cfg = ref_dex.DexMeshConfig(n_route=1, n_memory=1)
    rng = np.random.default_rng(8)
    n = 640
    k = rng.choice(keys, size=n).astype(np.int64)
    fresh = k + 1
    ins = rng.random(n) < 0.5
    ins &= ~np.isin(fresh, keys)
    k[ins] = fresh[ins]
    allow = ins | (rng.random(n) < 0.3)
    # an overflowing leaf: 30 fresh keys into the leaf of keys[440:470]
    k[:30] = keys[440:470] + 1
    allow[:30] = True
    # duplicates, and an update and an insert of one key (the insert wins)
    k[30:34] = keys[1000]
    allow[30:34] = [False, True, False, True]
    k[34:36] = keys[2000] + 1
    allow[34:36] = True
    k[36] = keys[2500] + 1  # an update of an absent key: a no-op
    allow[36] = False
    gid = _leaf_of(t_pool_, t_meta, k)
    gid[::23] = KEY_MAX  # inactive lanes
    v = rng.integers(-(2**40), 2**40, size=n)
    prio = rng.permutation(n).astype(np.int64) + np.where(allow, n, 0)
    occ = (np.asarray(pool.pool_keys) != KEY_MAX).sum(-1).astype(np.int32)
    want = ref_write._apply_leaf_writes(
        pool.pool_keys, pool.pool_values, jnp.asarray(occ), meta, cfg,
        jnp.asarray(gid), jnp.asarray(k), jnp.asarray(v), jnp.asarray(prio),
        jnp.asarray(allow), use_kernel=True, interpret=True,
    )
    t_occ = torch.from_numpy(occ.copy())
    got = t_write._apply_leaf_writes(
        t_pool_.pool_keys, t_pool_.pool_values, t_occ, t_meta,
        torch.from_numpy(gid), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(prio), torch.from_numpy(allow),
    )
    assert got[0] is t_pool_.pool_keys and got[2] is t_occ  # written in place
    for name, w, g in zip(
        ("keys", "values", "occupancy", "status", "rows_v", "ins_in_leaf"), want, got
    ):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
    status = got[3].numpy()
    assert (status == t_write.STATUS_SPLIT).sum() > 0
    assert set(status[30:34]) == {t_write.STATUS_OK}
    assert status[36] == t_write.STATUS_MISS


def mixed_batches(keys, rng, n, b, hot):
    """tests/test_engine.py's interleaved mixed batches without scans (hot
    keys written on even batches, read on odd), plus: batch 1 drives one leaf
    past its slack (``STATUS_SPLIT``), batch 2 holds duplicate inserts of a
    fresh key and an update and an insert of one existing key."""
    out = []
    for bi in range(n):
        opc = rng.integers(0, 3, size=b).astype(np.int32)
        kk = rng.choice(keys, size=b).astype(np.int64)
        ins = opc == t_engine.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=b)
        ok_f = ~np.isin(fresh, keys)
        kk[ins & ok_f] = fresh[ins & ok_f]
        vals = np.zeros(b, np.int64)
        upd = opc == t_engine.OP_UPDATE
        vals[upd] = kk[upd] ^ 0x5A5A
        vals[ins] = kk[ins] * 7
        h = len(hot)
        if bi % 2 == 0:
            opc[:h] = t_engine.OP_UPDATE
            kk[:h] = hot
            vals[:h] = (hot ^ (100 + bi)).astype(np.int64)
        else:
            opc[:h] = t_engine.OP_LOOKUP
            kk[:h] = hot
            vals[:h] = 0
        if bi == 1:
            opc[h : h + 30] = t_engine.OP_INSERT
            kk[h : h + 30] = keys[440:470] + 1
            vals[h : h + 30] = kk[h : h + 30] * 3
        if bi == 2:
            opc[h : h + 4] = t_engine.OP_INSERT
            kk[h : h + 4] = keys[900] + 1
            vals[h : h + 4] = np.arange(4) + 11
            opc[h + 4 : h + 6] = [t_engine.OP_INSERT, t_engine.OP_UPDATE]
            kk[h + 4 : h + 6] = keys[1200]
            vals[h + 4 : h + 6] = [222, 333]
        out.append((opc, kk, vals))
    return out


def _setup(policy, factor, keys):
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
    return state, meta, cfg, mesh, t_state, t_meta, t_cfg


@pytest.mark.parametrize(
    "policy,factor",
    [("fetch", 2.0), ("offload", 2.0), ("auto", 2.0), ("fetch", 0.5), ("auto", 0.5)],
)
def test_mixed_engine_1x1_matches_reference(policy, factor):
    """4,000 keys, cache_sets=128, 4 batches x 256 lanes with hot keys."""
    keys = _dataset(4000, seed=31)
    state, meta, cfg, mesh, t_state, t_meta, t_cfg = _setup(policy, factor, keys)
    fn = ref_engine.make_dex_engine(meta, cfg, mesh, ops=OPS, **PLAIN)
    eng = jax.jit(fn)
    t_eng = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, device="cpu")
    for k in ("route_rounds", "fused_pairs", "descent_levels", "scan_hops"):
        assert t_eng.plan[k] == fn.plan[k], k
    rng = np.random.default_rng(32)
    counts = None
    for i, (opc, kk, vals) in enumerate(
        mixed_batches(keys, rng, 4, 256, hot=keys[40:48])
    ):
        args = (jnp.asarray(opc), jnp.asarray(kk), jnp.asarray(vals))
        if counts is None:
            counts = ref_routing.trace_collective_counts(fn, state, *args)
        state, res = eng(state, *args)
        t_mesh.reset_counts()
        t_state, t_res = t_eng(t_state, opc, kk, vals)
        assert t_mesh.collective_counts() == counts
        for k in RESULTS:
            np.testing.assert_array_equal(
                np.asarray(getattr(res, k)), getattr(t_res, k).numpy(), err_msg=k
            )
        _assert_state_equal(_flat(state), t_state, f"{policy} x{factor} batch {i}")
    stats = t_state.stats.numpy()
    assert stats[:, t_registry.STAT_SPLITS].sum() > 0
    if factor < 1:
        assert stats[:, t_registry.STAT_DROPS].sum() > 0
    else:
        assert stats[:, t_registry.STAT_WRITES].sum() + stats[
            :, t_registry.STAT_OFFLOADS
        ].sum() > 0


@pytest.mark.parametrize("policy", ["fetch", "auto"])
def test_update_and_insert_wrappers_match_reference(policy):
    keys = _dataset(3000, seed=41)
    state, meta, cfg, mesh, t_state, t_meta, t_cfg = _setup(policy, 2.0, keys)
    rng = np.random.default_rng(42)
    up_k = rng.choice(keys, size=200).astype(np.int64)
    up_k[::9] += 1  # absent keys: no-ops
    up_v = rng.integers(0, 2**40, size=200)
    in_k = np.concatenate([keys[440:470] + 1, rng.choice(keys, 170) + 2])
    in_v = rng.integers(0, 2**40, size=200)
    for maker, t_maker, kk, vv in (
        (ref_write.make_dex_update, t_write.make_dex_update, up_k, up_v),
        (ref_write.make_dex_insert, t_write.make_dex_insert, in_k, in_v),
    ):
        state, status = jax.jit(maker(meta, cfg, mesh, **PLAIN))(
            state, jnp.asarray(kk), jnp.asarray(vv)
        )
        t_state, t_status = t_maker(t_meta, t_cfg, device="cpu")(t_state, kk, vv)
        np.testing.assert_array_equal(np.asarray(status), t_status.numpy())
        _assert_state_equal(_flat(state), t_state, maker.__name__)
    assert (t_status.numpy() == t_write.STATUS_SPLIT).any()
