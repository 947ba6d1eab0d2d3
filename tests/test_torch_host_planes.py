"""The port's host planes against the reference's, on the CPU.

* ``core/sim.py``: ``HostBTree`` planes after the same loads, inserts (with
  splits and a root split) and deletes; seeded ``Simulator`` runs under
  every ``core/baselines.py`` config (``totals``, ``cache_stats``,
  ``lat_hist``) with ``core/cost_model.py``'s ``analyze`` and
  ``throughput_curve``; the leaf-direct table (``train_route_table``) and
  ``repartition``; ``core/cache.py`` through them.
* The SMO's host fallback at 1x1: the reference's own cases of
  ``tests/test_smo.py`` (an exhausted free list that drains, the zero-shed
  no-op) and ``tests/test_write.py`` (shed inserts that drain), plus a
  ``settle_splits`` that settles some lanes on the mesh and drains the
  rest.  Every state plane, ``meta``, ``info`` and the mirror's planes
  equal the reference's, and the rebuilt ops answer as the mirror does.
* ``btree.bulk_update`` and ``bulk_scan``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core import btree as ref_btree  # noqa: E402
from repro.core import cost_model as ref_cost  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import sim as ref_sim  # noqa: E402
from repro.core import smo as ref_smo  # noqa: E402
from repro.core import write as ref_write  # noqa: E402
from repro.core.partition import LogicalPartitions as RefParts  # noqa: E402
from repro.data import ycsb as ref_ycsb  # noqa: E402
from repro_torch.core import baselines as t_baselines  # noqa: E402
from repro_torch.core import btree as t_btree  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import sim as t_sim  # noqa: E402
from repro_torch.core import smo as t_smo  # noqa: E402
from repro_torch.core import write as t_write  # noqa: E402
from repro_torch.core.partition import LogicalPartitions as TParts  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
HOST_PLANES = ("K", "C", "V", "NK", "LV", "FLO", "FHI", "parent", "server")


def _assert_host_equal(a, b, where=""):
    for p in HOST_PLANES:
        np.testing.assert_array_equal(getattr(a, p), getattr(b, p), err_msg=f"{where} {p}")
    for f in ("root", "height", "num_nodes", "splits", "merges", "_next_free"):
        assert getattr(a, f) == getattr(b, f), (where, f)


# ---------------------------------------------------------------------------
# HostBTree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(level_m=2, n_mem_servers=4),
        dict(level_m=1, n_mem_servers=3, placement="blocked"),
        dict(level_m=1, n_mem_servers=4, placement="blocked", subtrees_per_server=5),
        dict(level_m=6, n_mem_servers=2),
        dict(fill=1.0, level_m=1, n_mem_servers=2),
    ],
)
def test_host_btree_planes_match_reference(kw):
    """Build, then inserts that split leaves, inner nodes and the root, then
    deletes that empty whole leaves: every plane equal after each step."""
    data = ref_ycsb.make_dataset(6000, seed=1)
    a, b = ref_sim.HostBTree(data, data * 3, **kw), t_sim.HostBTree(data, data * 3, **kw)
    _assert_host_equal(a, b, "build")
    rng = np.random.default_rng(2)
    fresh = np.unique(np.concatenate([
        rng.choice(data, 1500) + 1, np.arange(1, 3000) + int(data.max())
    ]))
    for k in fresh.tolist():
        assert a.insert(k, k ^ 77) == b.insert(k, k ^ 77)
    _assert_host_equal(a, b, "inserts")
    assert b.splits > 0
    gone = np.concatenate([data[:900], fresh[fresh < data[900]]])
    for k in gone.tolist():
        assert a.delete(k) == b.delete(k)
    _assert_host_equal(a, b, "deletes")
    assert b.merges > 0
    for k in rng.choice(fresh[fresh >= data[900]], 50).tolist():
        assert a.get(k) == b.get(k) == k ^ 77
        assert a.scan(k, 70) == b.scan(k, 70)


# ---------------------------------------------------------------------------
# Simulator, baselines and the cost model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_data():
    data = ref_ycsb.make_dataset(8000, seed=0)
    wl = ref_ycsb.generate("ycsb-a", data, 1500, seed=3)
    ops, keys = wl.ops.copy(), wl.keys.copy()
    rng = np.random.default_rng(4)
    # a few scans and deletes as well
    ops[rng.choice(ops.size, 60, replace=False)] = 3
    ops[rng.choice(ops.size, 30, replace=False)] = 4
    lens = rng.integers(1, 120, size=ops.size)
    return data, ops, keys, lens


def _run_sim(mod, base, name, data, ops, keys, lens, **cfg_kw):
    tree = mod.HostBTree(data, level_m=3, n_mem_servers=4)
    cfg = base.ALL[name](cache_bytes=(tree.num_nodes // 3) * 1024, **cfg_kw)
    sim = mod.Simulator(tree, cfg, seed=7)
    sim.run(ops, keys, scan_lens=lens)
    return sim


def _assert_sim_equal(a, b):
    assert dataclasses.asdict(a.totals()) == dataclasses.asdict(b.totals())
    ca, cb = a.cache_stats(), b.cache_stats()
    assert [dataclasses.asdict(x) for x in ca] == [dataclasses.asdict(x) for x in cb]
    np.testing.assert_array_equal(a.lat_hist, b.lat_hist)


@pytest.mark.parametrize("name", sorted(ref_baselines.ALL))
def test_simulator_under_each_baseline_matches_reference(sim_data, name):
    data, ops, keys, lens = sim_data
    assert sorted(t_baselines.ALL) == sorted(ref_baselines.ALL)
    assert t_baselines.ALL[name]() == t_sim.SimConfig(
        **dataclasses.asdict(ref_baselines.ALL[name]())
    )
    a = _run_sim(ref_sim, ref_baselines, name, data, ops, keys, lens)
    b = _run_sim(t_sim, t_baselines, name, data, ops, keys, lens)
    _assert_sim_equal(a, b)
    assert b.lat_hist.sum() > 0
    ra = ref_cost.analyze(a, threads_total=72, hot_leaf_write_fraction=0.01)
    rb = t_cost.analyze(b, threads_total=72, hot_leaf_write_fraction=0.01)
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)


def test_throughput_curve_matches_reference(sim_data):
    data, ops, keys, _ = sim_data
    curves = []
    for mod, base, cost in ((ref_sim, ref_baselines, ref_cost),
                            (t_sim, t_baselines, t_cost)):
        def make(mod=mod, base=base):
            tree = mod.HostBTree(data, level_m=3, n_mem_servers=4)
            return mod.Simulator(tree, base.dex(), seed=1)
        curves.append(cost.throughput_curve(make, (ops[:600], keys[:600]), [18, 72, 144]))
    for t in (18, 72, 144):
        assert dataclasses.asdict(curves[0][t]) == dataclasses.asdict(curves[1][t])


def test_simulator_route_table_and_repartition_match_reference(sim_data):
    """The leaf-direct table trained, used, poisoned and retrained around a
    repartition, under a grouped-offload config with divergent caches."""
    data, ops, keys, lens = sim_data
    sims = []
    for mod, base, parts in ((ref_sim, ref_baselines, RefParts),
                             (t_sim, t_baselines, TParts)):
        tree = mod.HostBTree(data, level_m=1, n_mem_servers=2, placement="blocked")
        cfg = base.dex(route_table_slots=64, group_offload=True, coherence_batch=256)
        sim = mod.Simulator(tree, cfg, seed=5)
        n = sim.train_route_table()
        sim.run(ops[:700], keys[:700], scan_lens=lens[:700], group_policy="fetch")
        sim.poison_route_table()
        sim.run(ops[700:900], keys[700:900], scan_lens=lens[700:900])
        b = np.quantile(data, [0.3, 0.5, 0.8]).astype(np.int64)
        cost = sim.repartition(parts(np.concatenate([[KEY_MIN], b, [KEY_MAX]])))
        sim.train_route_table()
        sim.run(ops[900:], keys[900:], scan_lens=lens[900:], group_policy="offload")
        sims.append((sim, n, cost))
    (a, na, ca), (b, nb, cb) = sims
    assert na == nb > 0 and ca == cb
    _assert_sim_equal(a, b)
    assert b.totals().rt_skips > 0


# ---------------------------------------------------------------------------
# the SMO's host fallback at 1x1
# ---------------------------------------------------------------------------


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(p.name for p in path): np.asarray(x) for path, x in leaves}


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(16 * n, size=n, replace=False).astype(np.int64) + 1)


class _Pair:
    """The reference's and the port's index at 1x1 over the same keys, each
    with its ``HostBTree`` mirror."""

    def __init__(self, keys, *, headroom=0.5):
        vals = keys * 5
        kw = dict(n_route=1, n_memory=1, cache_sets=128, cache_ways=4,
                  p_admit_leaf_pct=10, route_capacity_factor=2.0, policy="fetch")
        self.cfg, self.t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
        self.mesh = make_mesh_compat((1, 1), ("data", "model"))
        self.bounds = np.array([KEY_MIN, KEY_MAX], np.int64)
        pool, self.meta = ref_pool.build_pool(keys, vals, level_m=1, fill=0.7,
                                              n_shards=1, headroom=headroom)
        t_pool_, self.t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7,
                                                 headroom=headroom, device="cpu")
        self.state = ref_dex.init_state(pool, self.meta, self.cfg, self.bounds)
        self.t_state = t_dex.init_state(t_pool_, self.t_meta, self.t_cfg, self.bounds,
                                        device="cpu")
        self.host = ref_sim.HostBTree(keys, vals, fill=0.7)
        self.t_host = t_sim.HostBTree(keys, vals, fill=0.7)
        self.check("init")

    def check(self, where):
        assert dataclasses.asdict(self.meta) == dataclasses.asdict(self.t_meta), where
        want, got = _flat(self.state), t_dex.state_to_numpy(self.t_state)
        assert sorted(want) == sorted(got), where
        for k, a in want.items():
            np.testing.assert_array_equal(a, got[k], err_msg=f"{where}: {k}")
        _assert_host_equal(self.host, self.t_host, where)

    def insert(self, kk, vv):
        """One insert batch on both sides; returns the status lanes."""
        # the plain jnp forms of the write kernels, which tests/test_kernels.py
        # holds bit-equal to the Pallas kernels (their interpret mode is slow)
        ins = jax.jit(ref_write.make_dex_insert(self.meta, self.cfg, self.mesh,
                                                use_kernel=False))
        self.state, st = ins(self.state, jnp.asarray(kk), jnp.asarray(vv))
        t_ins = t_write.make_dex_insert(self.t_meta, self.t_cfg, device="cpu")
        self.t_state, t_st = t_ins(self.t_state, kk, vv)
        st = np.asarray(st)
        np.testing.assert_array_equal(st, t_st.numpy())
        self.check("insert")
        return st

    def settle(self, sk, sv):
        smo = jax.jit(ref_smo.make_dex_smo(self.meta, self.cfg, self.mesh,
                                           use_kernel=False))
        self.state, self.meta, info = ref_smo.settle_splits(
            self.state, self.meta, self.cfg, smo, self.host, sk, sv, self.bounds
        )
        t_smo_ = t_smo.make_dex_smo(self.t_meta, self.t_cfg, device="cpu")
        self.t_state, self.t_meta, t_info = t_smo.settle_splits(
            self.t_state, self.t_meta, self.t_cfg, t_smo_, self.t_host, sk, sv,
            self.bounds,
        )
        assert info == t_info
        self.check("settle_splits")
        return t_info

    def drain(self, sk, sv):
        self.state, self.meta = ref_write.drain_splits(
            self.state, self.meta, self.cfg, self.host, sk, sv, self.bounds
        )
        self.t_state, self.t_meta = t_write.drain_splits(
            self.t_state, self.t_meta, self.t_cfg, self.t_host, sk, sv, self.bounds
        )
        self.check("drain_splits")

    def lookup(self, q):
        """A lookup batch through the port's ops built against the current
        meta, answered as the mirror answers (the planes it reads were
        compared with the reference's just before)."""
        t_look = t_dex.make_dex_lookup(self.t_meta, self.t_cfg, device="cpu")
        self.t_state, t_found, t_vals, shed = t_look(self.t_state, q)
        assert not shed.any()
        host = [self.t_host.get(int(k)) for k in q]
        assert t_found.numpy().tolist() == [h is not None for h in host]
        assert all(h is None or h == v for h, v in zip(host, t_vals.numpy().tolist()))


def _first_leaf_burst(keys):
    """tests/test_smo.py's ``_overflow_burst``: fresh keys all into the
    first leaf."""
    lo = int(keys[0])
    burst = np.arange(lo + 1, lo + 1 + 64, dtype=np.int64)
    return burst[~np.isin(burst, keys)][:56]


def test_exhausted_free_list_drains_as_the_reference():
    """tests/test_smo.py::test_exhausted_free_list_falls_back_to_drain."""
    keys = _dataset(3000, seed=5)
    p = _Pair(keys, headroom=0.0)
    burst = _first_leaf_burst(keys)
    shed = p.insert(burst, burst * 3) == t_write.STATUS_SPLIT
    assert shed.any()
    old_meta = p.t_meta
    info = p.settle(burst[shed], burst[shed] * 3)
    assert info["drained"] and info["onmesh"] == 0
    assert p.t_meta is not old_meta
    stats = p.t_state.stats.numpy().sum(0)
    assert stats[t_registry.STAT_DRAINS] == 1
    assert stats[t_registry.STAT_SMO_SPLITS] == 0
    p.lookup(np.concatenate([burst, keys[:200]]))


def test_settle_splits_on_the_mesh_and_drains_the_residue():
    """One batch of 30 fresh keys into each of six leaves of one block
    whose free list holds three rows: three leaves split on the mesh (their
    lanes go into the mirror), the other three's lanes drain."""
    keys = _dataset(3000, seed=9)
    p = _Pair(keys, headroom=0.05)
    assert p.t_meta.subtree_cap - p.t_meta.base_cap == 3
    rng = np.random.default_rng(3)
    burst = []
    for leaf in range(6):
        lo, hi = keys[leaf * 44], keys[leaf * 44 + 43]
        burst.append(rng.choice(np.setdiff1d(np.arange(lo + 1, hi), keys), 30,
                                replace=False))
    kk = np.full(256, KEY_MAX, np.int64)
    kk[:180] = rng.permutation(np.concatenate(burst))
    vv = np.where(kk != KEY_MAX, kk * 11, 0)
    st = p.insert(kk, vv)
    shed = st == t_write.STATUS_SPLIT
    assert shed.sum() == 180
    info = p.settle(np.where(shed, kk, KEY_MAX), np.where(shed, vv, 0))
    assert info["onmesh"] == info["residual"] == 90 and info["drained"]
    assert p.t_state.stats.numpy()[:, t_registry.STAT_DRAINS].sum() == 1
    p.lookup(np.concatenate([kk[:180], keys[:300:3]]))


def test_zero_shed_drain_is_a_noop():
    """tests/test_smo.py::test_zero_shed_drain_is_a_noop in the port."""
    keys = _dataset(2000, seed=6)
    p = _Pair(keys)
    empty = np.zeros((0,), np.int64)
    state2, meta2 = t_write.drain_splits(p.t_state, p.t_meta, p.t_cfg, p.t_host, empty,
                                         empty, p.bounds)
    assert state2 is p.t_state and meta2 is p.t_meta
    assert p.t_state.stats.numpy()[:, t_registry.STAT_DRAINS].sum() == 0
    smo = t_smo.make_dex_smo(p.t_meta, p.t_cfg, device="cpu")
    state3, meta3, info = t_smo.settle_splits(p.t_state, p.t_meta, p.t_cfg, smo, p.t_host,
                                              empty, empty, p.bounds)
    assert state3 is p.t_state and meta3 is p.t_meta
    assert info == {"onmesh": 0, "residual": 0, "rounds": 0, "drained": False}


@pytest.mark.parametrize("case", ["fresh_and_duplicates", "first_leaf_overflow"])
def test_shed_inserts_drain_as_the_reference(case):
    """tests/test_write.py's two drains: inserts with duplicates whose
    acknowledged lanes go into the mirror and whose shed lanes drain (here
    with one leaf driven past its slack, so that the drain fires), and a
    burst into the first leaf that sheds whole and drains."""
    keys = _dataset(4000 if case == "fresh_and_duplicates" else 3000,
                    seed=4 if case == "fresh_and_duplicates" else 6)
    p = _Pair(keys)
    if case == "fresh_and_duplicates":
        rng = np.random.default_rng(5)
        ik = (rng.choice(keys[:-1], size=256) + rng.integers(1, 3, size=256)).astype(np.int64)
        ik[:40] = rng.choice(keys, size=40)
        # and 30 fresh keys into one leaf (its slack is 20), so a drain fires
        ik[40:70] = rng.choice(np.setdiff1d(np.arange(keys[440] + 1, keys[483]), keys),
                               30, replace=False)
        iv = rng.integers(0, 1 << 40, size=256).astype(np.int64)
    else:
        ik = _first_leaf_burst(keys)
        iv = ik * 3
    st = p.insert(ik, iv)
    for k, v, s in zip(ik, iv, st):
        if s == t_write.STATUS_OK:
            p.host.insert(int(k), int(v))
            p.t_host.insert(int(k), int(v))
    shed = st == t_write.STATUS_SPLIT
    if case == "first_leaf_overflow":
        assert shed.all()
    assert shed.any()
    p.drain(ik[shed], iv[shed])
    assert p.t_host.splits > 0
    assert p.t_state.stats.numpy()[:, t_registry.STAT_DRAINS].sum() == 1
    p.lookup(np.concatenate([ik, keys[:256]]))


def test_host_items_matches_reference():
    data = _dataset(5000, seed=8)
    a, b = ref_sim.HostBTree(data, data * 2), t_sim.HostBTree(data, data * 2)
    for k in (np.arange(2000) * 7 + 3).tolist():
        a.insert(k, k)
        b.insert(k, k)
    for k in data[::3].tolist():
        a.delete(k)
        b.delete(k)
    for x, y in zip(ref_write.host_items(a), t_write.host_items(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# btree.bulk_update / bulk_scan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(10**6, 5000, replace=False)).astype(np.int64) + 1
    rt, rm = ref_btree.bulk_build(keys, keys * 3)
    tt, tm = t_btree.bulk_build(keys, keys * 3, device="cpu")
    return keys, rt, rm, tt, tm


def test_bulk_update_matches_reference(trees):
    keys, rt, rm, tt, tm = trees
    rng = np.random.default_rng(1)
    q = rng.choice(keys, 300)
    q[::7] += 1  # misses
    q[5] = q[6]  # a duplicate: the last lane wins
    nv = rng.integers(0, 1 << 40, 300)
    r2, rf = ref_btree.bulk_update(rt, jnp.asarray(q), jnp.asarray(nv), height=rm.height)
    t2, tf = t_btree.bulk_update(tt, q, nv, height=tm.height)
    np.testing.assert_array_equal(np.asarray(rf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(r2.values), t2.values.numpy())
    np.testing.assert_array_equal(np.asarray(r2.version), t2.version.numpy())
    assert torch.equal(tt.values, torch.from_numpy(np.asarray(rt.values)))  # functional


@pytest.mark.parametrize("count", [1, 30, 100])
def test_bulk_scan_matches_reference(trees, count):
    keys, rt, rm, tt, tm = trees
    rng = np.random.default_rng(count)
    s = rng.choice(keys, 200)
    s[::3] += 1  # starts between keys
    s[0] = keys[-1]
    s[1] = KEY_MIN + 1
    rk, rv = ref_btree.bulk_scan(rt, jnp.asarray(s), height=rm.height, count=count)
    tk, tv = t_btree.bulk_scan(tt, s, height=tm.height, count=count)
    np.testing.assert_array_equal(np.asarray(rk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
