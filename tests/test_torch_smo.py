"""The port's on-mesh SMO against the reference, bit for bit on the CPU:

* ``leaf_split_ref`` against the reference's Pallas ``leaf_split``
  (interpret mode) and its jnp oracle, on the contract cases of
  tests/test_torch_cuda.py (nothing staged, m = 65, m = 128, m = 64);
* ``make_dex_smo`` / ``run_smo`` against ``repro.core.smo``'s at 1x1 on the
  tests/test_smo.py cases without the host drain: a split without a
  rebuild, a scan across the split, unrelated cached rows surviving, the
  inner split at ``level_m = 2``, and the exhausted free list returning its
  lanes ``STATUS_SPLIT``.  Every plane and status is compared, and lookups
  and scans afterwards are held to ``repro.core.sim.HostBTree``;
* ``_dense_parents`` against the reference's;
* one SMO round, ``run_smo`` and a scan across the split leaves at 2x4 (the
  reference in a subprocess on a forced 8-device CPU mesh,
  ``tests/torch_mesh_ref.py``).
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import scan as ref_scan  # noqa: E402
from repro.core import smo as ref_smo  # noqa: E402
from repro.core import write as ref_write  # noqa: E402
from repro.core.sim import HostBTree  # noqa: E402
from repro.kernels import leaf_split as ref_leaf_split  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import scan as t_scan  # noqa: E402
from repro_torch.core import smo as t_smo  # noqa: E402
from repro_torch.core import write as t_write  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from test_torch_cuda import split_case  # noqa: E402
from torch_mesh_group import MeshGroup  # noqa: E402

#: the reference runs its jnp kernels (``repro/kernels/ref.py``), bit for bit
#: its Pallas ones (``tests/test_kernels.py``), which hold the port's kernels in
#: ``tests/test_torch_{kernels,write,scan,smo}.py``: interpret mode's trace and
#: compile were most of a reference run's time
PLAIN = dict(use_kernel=False)

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
FANOUT = 64


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


@pytest.mark.parametrize("q,seed", [(1, 0), (37, 1), (130, 2)])
def test_leaf_split_ref_matches_reference_kernel(q, seed):
    case = split_case(q, seed)
    want = ref_leaf_split.leaf_split(*map(jnp.asarray, case), interpret=True)
    oracle = ref_ref.leaf_split_ref(*map(jnp.asarray, case))
    got = t_ops.leaf_split(*map(torch.from_numpy, case))
    assert t_ops.LAUNCHES["leaf_split"] == 0
    assert [g.dtype for g in got[4:]] == [torch.int32, torch.int32, torch.int64,
                                          torch.int32]
    for w, o, g in zip(want, oracle, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(np.asarray(o), g.numpy())
    if q > 2:
        did = got[7].numpy()
        assert did[1::6].all() and did[2::6].all() and not did[3::6].any()


def _dataset(n, seed=0, space=None):
    rng = np.random.default_rng(seed)
    space = space or 16 * n
    return np.sort(rng.choice(space, size=n, replace=False).astype(np.int64) + 1)


def _ref_lookup(meta, cfg, mesh):
    """``repro.core.dex.make_dex_lookup`` (the lookup-only engine, its
    results as ``(state, found, values, shed)``) with ``PLAIN``, which the
    reference's wrapper does not take."""
    eng = ref_engine.make_dex_engine(meta, cfg, mesh, ops=("lookup",), **PLAIN)

    def lookup(state, keys):
        keys = keys.astype(jnp.int64)
        opcodes = jnp.full(keys.shape, ref_engine.OP_LOOKUP, jnp.int32)
        state, r = eng(state, opcodes, keys, jnp.zeros_like(keys))
        return state, r.found, r.values, r.shed

    return lookup


class Pair:
    """The reference and the port side by side on one 1x1 index
    (tests/test_smo.py's ``_setup``), with the host tree as the oracle."""

    def __init__(self, keys, *, level_m=1, headroom=0.5, p_admit_leaf_pct=10):
        vals = keys * 5
        pool, meta = ref_pool.build_pool(keys, vals, level_m=level_m, fill=0.7,
                                         n_shards=1, headroom=headroom)
        _, self.t_meta = t_pool.build_pool(keys, vals, level_m=level_m, fill=0.7,
                                           headroom=headroom, device="cpu")
        mesh = make_mesh_compat((1, 1), ("data", "model"))
        kw = dict(n_route=1, n_memory=1, cache_sets=128, cache_ways=4,
                  p_admit_leaf_pct=p_admit_leaf_pct, route_capacity_factor=2.0,
                  policy="fetch")
        cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
        self.meta = meta
        self.state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
        self.t_state = t_dex.state_from_numpy(_flat(self.state), self.t_meta,
                                              t_cfg, "cpu")
        self.host = HostBTree(keys, vals, fill=0.7)
        self.lookup = jax.jit(_ref_lookup(meta, cfg, mesh))
        self.insert = jax.jit(ref_write.make_dex_insert(meta, cfg, mesh, **PLAIN))
        self.smo = jax.jit(ref_smo.make_dex_smo(meta, cfg, mesh, **PLAIN))
        self.scan = jax.jit(ref_scan.make_dex_scan(meta, cfg, mesh, max_count=64, **PLAIN))
        self.t_lookup = t_dex.make_dex_lookup(self.t_meta, t_cfg, device="cpu")
        self.t_insert = t_write.make_dex_insert(self.t_meta, t_cfg, device="cpu")
        self.t_smo = t_smo.make_dex_smo(self.t_meta, t_cfg, device="cpu")
        self.t_scan = t_scan.make_dex_scan(self.t_meta, t_cfg, max_count=64,
                                           device="cpu")

    def check(self, where):
        _assert_state_equal(_flat(self.state), self.t_state, where)

    def insert_burst(self, kk, vv):
        """Both sides insert; returns the lanes shed ``STATUS_SPLIT``.  The
        host takes the applied keys."""
        self.state, res = self.insert(self.state, jnp.asarray(kk), jnp.asarray(vv))
        self.t_state, t_res = self.t_insert(self.t_state, kk, vv)
        res = np.asarray(res)
        np.testing.assert_array_equal(res, t_res.numpy())
        for k, v in zip(kk[res == ref_write.STATUS_OK], vv[res == ref_write.STATUS_OK]):
            self.host.insert(int(k), int(v))
        self.check("insert")
        return res == ref_write.STATUS_SPLIT

    def settle(self, kk, vv, shed):
        """``run_smo`` on both sides over the shed lanes (the batch's
        layout); the host takes the settled keys.  Returns the statuses."""
        sk = np.where(shed, kk, KEY_MAX)
        sv = np.where(shed, vv, 0)
        self.state, st, rounds = ref_smo.run_smo(
            self.smo, self.state, sk, sv, levels=self.meta.levels_in_subtree
        )
        self.t_state, t_st, t_rounds = t_smo.run_smo(
            self.t_smo, self.t_state, sk, sv, levels=self.t_meta.levels_in_subtree
        )
        np.testing.assert_array_equal(st, t_st)
        assert rounds == t_rounds
        self.check("run_smo")
        for k, v in zip(kk[t_st == t_write.STATUS_OK], vv[t_st == t_write.STATUS_OK]):
            self.host.insert(int(k), int(v))
        return t_st

    def check_lookups(self, probe):
        self.state, f, v, _ = self.lookup(self.state, jnp.asarray(probe))
        self.t_state, tf, tv, _ = self.t_lookup(self.t_state, probe)
        np.testing.assert_array_equal(np.asarray(f), tf.numpy())
        np.testing.assert_array_equal(np.asarray(v), tv.numpy())
        self.check("lookup")
        tf, tv = tf.numpy(), tv.numpy()
        for i, k in enumerate(probe):
            hv = self.host.get(int(k))
            assert bool(tf[i]) == (hv is not None), (i, int(k))
            if hv is not None:
                assert int(tv[i]) == hv

    def check_scans(self, starts, counts):
        self.state, sk, sv, tk = self.scan(
            self.state, jnp.asarray(starts), jnp.asarray(counts)
        )
        self.t_state, t_sk, t_sv, t_tk = self.t_scan(self.t_state, starts, counts)
        for w, g in ((sk, t_sk), (sv, t_sv), (tk, t_tk)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        self.check("scan")
        t_sk, t_sv, t_tk = t_sk.numpy(), t_sv.numpy(), t_tk.numpy()
        for i in range(starts.size):
            exp = [k for _, ks in self.host.scan(int(starts[i]), int(counts[i]))
                   for k in ks][: int(counts[i])]
            assert t_sk[i][: t_tk[i]].tolist() == exp, i
            assert [int(x) for x in t_sv[i][: t_tk[i]]] == [
                self.host.get(int(k)) for k in exp
            ]


def _overflow_burst(keys, width=FANOUT):
    """tests/test_smo.py's burst: fresh keys all in the first leaf."""
    lo = int(keys[0])
    burst = np.arange(lo + 1, lo + 1 + width, dtype=np.int64)
    return burst[~np.isin(burst, keys)][: width - 8]


def test_smo_split_without_rebuild_matches_reference():
    keys = _dataset(3000, seed=1)
    p = Pair(keys)
    burst = _overflow_burst(keys)
    shed = p.insert_burst(burst, burst * 3)
    assert shed.all()
    st = p.settle(burst, burst * 3, shed)
    assert (st == t_write.STATUS_OK).all()
    stats = p.t_state.stats.numpy().sum(0)
    assert stats[t_registry.STAT_SMO_SPLITS] >= 1
    n_alloc = p.t_state.n_alloc.numpy()
    assert int((n_alloc - p.t_meta.base_cap).sum()) == int(
        stats[t_registry.STAT_SMO_SPLITS]
    )
    p.check_lookups(burst)
    p.check_lookups(keys[:256])


def test_smo_one_round_matches_reference():
    """One round, by hand, with duplicate writers and a key that already
    exists (it becomes a value update)."""
    keys = _dataset(3000, seed=11)
    p = Pair(keys)
    burst = _overflow_burst(keys)
    kk = np.concatenate([burst, burst[:3], keys[:2], [KEY_MAX] * 3])
    vv = np.where(kk != KEY_MAX, kk * 3 + np.arange(kk.size), 0)
    shed = p.insert_burst(kk, vv)
    sk = np.where(shed | (np.arange(kk.size) >= burst.size), kk, KEY_MAX)
    p.state, st = p.smo(p.state, jnp.asarray(sk), jnp.asarray(np.where(sk != KEY_MAX, vv, 0)))
    p.t_state, t_st = p.t_smo(p.t_state, sk, np.where(sk != KEY_MAX, vv, 0))
    np.testing.assert_array_equal(np.asarray(st), t_st.numpy())
    p.check("one round")
    t_st = t_st.numpy()
    assert (t_st[: burst.size] == t_write.STATUS_OK).all()
    assert (t_st[-3:] == t_write.STATUS_MISS).all()


def test_scan_follows_successor_chain_across_split():
    keys = _dataset(3000, seed=2)
    p = Pair(keys)
    burst = _overflow_burst(keys)
    shed = p.insert_burst(burst, burst * 3)
    p.settle(burst, burst * 3, shed)
    lo = int(keys[0])
    starts = np.array([lo, lo + 3, int(burst[-1]), int(keys[50])], np.int64)
    p.check_scans(starts, np.array([64, 64, 40, 30], np.int64))


def test_unrelated_cached_rows_survive_split():
    keys = _dataset(3000, seed=3)
    p = Pair(keys, p_admit_leaf_pct=100)
    probe = keys[-256:]
    p.check_lookups(probe)
    burst = _overflow_burst(keys)
    shed = p.insert_burst(burst, burst * 3)
    p.settle(burst, burst * 3, shed)
    vers = p.t_state.versions.numpy()[0]
    assert 0 < int((vers > 0).sum()) <= 4 * p.t_meta.levels_in_subtree
    before = p.t_state.stats.numpy().sum(0)
    p.check_lookups(probe)
    after = p.t_state.stats.numpy().sum(0)
    assert after[t_registry.STAT_HITS] - before[t_registry.STAT_HITS] >= probe.size


def test_inner_split_at_level_m2_matches_reference():
    rng = np.random.default_rng(4)
    keys = _dataset(30_000, seed=4, space=4_000_000)
    p = Pair(keys, level_m=2)
    lo, hi = int(keys[500]), int(keys[900])
    smo_before = int(p.t_state.stats.numpy().sum(0)[t_registry.STAT_SMO_SPLITS])
    for _ in range(8):
        fresh = np.unique(rng.integers(lo, hi, size=256).astype(np.int64))
        fresh = fresh[~np.isin(fresh, keys)]
        ik = np.concatenate([fresh, np.full(256 - fresh.size, KEY_MAX, np.int64)])
        iv = np.where(ik != KEY_MAX, ik * 3, 0)
        shed = p.insert_burst(ik, iv)
        st = p.settle(ik, iv, shed)
        assert not (st == t_write.STATUS_SPLIT).any()
        keys = np.union1d(keys, ik[ik != KEY_MAX])
    stats = p.t_state.stats.numpy().sum(0)
    assert int(stats[t_registry.STAT_SMO_SPLITS]) - smo_before > 1
    assert p.t_state.n_alloc.dtype == torch.int64  # as the reference's sweep
    probe = rng.choice(keys, size=512, replace=False)
    p.check_lookups(probe)
    np.testing.assert_array_equal(
        np.asarray(ref_smo._dense_parents(jnp.asarray(p.t_state.pool.pool_children.numpy()))),
        t_smo._dense_parents(p.t_state.pool.pool_children).numpy(),
    )


def test_exhausted_free_list_returns_the_reference_residue():
    keys = _dataset(3000, seed=5)
    p = Pair(keys, headroom=0.0)
    assert p.t_meta.subtree_cap == p.t_meta.base_cap
    burst = _overflow_burst(keys)
    shed = p.insert_burst(burst, burst * 3)
    assert shed.any()
    st = p.settle(burst, burst * 3, shed)
    assert (st[shed] == t_write.STATUS_SPLIT).all()
    stats = p.t_state.stats.numpy().sum(0)
    assert stats[t_registry.STAT_SMO_SPLITS] == 0
    p.check_lookups(keys[:200])


@pytest.fixture(scope="module")
def smo_group(tmp_path_factory):
    """The reference's ``smo`` group, run once for the module
    (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory, "smo") as group:
        yield group


@pytest.fixture(scope="module")
def smo_ref(smo_group):
    return smo_group.arrays()


def test_smo_2x4_matches_reference(smo_ref):
    """An insert batch overflowing five leaves, one SMO round, ``run_smo``
    for the rest and a scan across the split leaves, on a 2x4 mesh: each
    column's gathered round is applied once to the port's one pool."""
    arrays = smo_ref
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    t_cfg = t_dex.DexMeshConfig(
        n_route=2, n_memory=4, cache_sets=64, cache_ways=4, policy="fetch",
        route_capacity_factor=4.0,
    )

    def planes(tag):
        pre = f"smo/{tag}/"
        return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}

    t_state = t_dex.state_from_numpy(planes("init"), t_meta, t_cfg, "cpu")
    kk, vv = arrays["smo/keys"], arrays["smo/values"]
    t_state, st = t_write.make_dex_insert(t_meta, t_cfg, device="cpu")(t_state, kk, vv)
    np.testing.assert_array_equal(arrays["smo/insert_status"], st.numpy())
    _assert_state_equal(planes("insert"), t_state, "insert")
    shed = st.numpy() == t_write.STATUS_SPLIT
    assert shed.sum() >= 150
    sk = np.where(shed, kk, KEY_MAX)
    sv = np.where(shed, vv, 0)
    smo = t_smo.make_dex_smo(t_meta, t_cfg, device="cpu")
    t_state, st1 = smo(t_state, sk, sv)
    np.testing.assert_array_equal(arrays["smo/round_status"], st1.numpy())
    _assert_state_equal(planes("round"), t_state, "round")
    t_state, st2, rounds = t_smo.run_smo(smo, t_state, sk, sv)
    np.testing.assert_array_equal(arrays["smo/run_status"], st2)
    assert rounds == int(arrays["smo/run_rounds"])
    _assert_state_equal(planes("run"), t_state, "run_smo")
    assert (st2[shed] == t_write.STATUS_OK).all()
    stats = t_state.stats.numpy()
    assert stats[:, t_registry.STAT_SMO_SPLITS].sum() >= 5
    # split counts land once per column, on route row 0
    assert (stats[4:, t_registry.STAT_SMO_SPLITS] == 0).all()
    scan = t_scan.make_dex_scan(t_meta, t_cfg, max_count=64, device="cpu")
    starts = arrays["smo/scan_starts"]
    t_state, sk_, sv_, tk = scan(t_state, starts, np.full(starts.size, 64))
    np.testing.assert_array_equal(arrays["smo/scan_keys"], sk_.numpy())
    np.testing.assert_array_equal(arrays["smo/scan_values"], sv_.numpy())
    np.testing.assert_array_equal(arrays["smo/taken"], tk.numpy())
    _assert_state_equal(planes("scan"), t_state, "scan")
    assert (tk.numpy() == 64).all()
