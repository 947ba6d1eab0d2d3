"""The port's ``core/repartition.py`` against ``repro.core.repartition``, bit
for bit on the CPU:

* ``node_key_ranges`` on bulk pools and on pools after on-mesh splits (with
  levels), at ``level_m`` 1 and 2;
* ``moved_intervals``;
* ``install_boundaries``: the boundary table, the versions plane and the
  three counts, including a no-op install;
* the controller over seeded traces (``observe``, ``imbalance``,
  ``should_repartition``, ``propose``, ``maybe_repartition`` and its
  reports), following tests/test_repartition.py, with and without an
  active route table;
* at 2x4, skewed mixed batches with a controller installing boundaries
  between them (the reference in a subprocess on a forced 8-device CPU
  mesh, ``tests/torch_mesh_ref.py repart``).
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import repartition as ref_rep  # noqa: E402
from repro.core import route_table as ref_rt  # noqa: E402
from repro.core import smo as ref_smo  # noqa: E402
from repro.core import write as ref_write  # noqa: E402
from repro.core.partition import LogicalPartitions as RefParts  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import fleet_cache as t_fleet_cache  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import repartition as t_rep  # noqa: E402
from repro_torch.core import route_table as t_rt  # noqa: E402
from repro_torch.core.partition import LogicalPartitions  # noqa: E402
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


def _pool_pair(level_m, n_keys, seed, n_shards=1):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(16 * n_keys, size=n_keys, replace=False)).astype(np.int64)
    keys = keys * 1000 - 2**40
    pool, meta = ref_pool.build_pool(
        keys, keys * 3, level_m=level_m, fill=0.7, n_shards=n_shards
    )
    _, t_meta = t_pool.build_pool(
        keys, keys * 3, level_m=level_m, fill=0.7, n_shards=n_shards, device="cpu"
    )
    return keys, pool, meta, t_meta


def _split_pool(level_m, n_keys, seed):
    """A 1x1 reference state after an insert burst that overflows several
    leaves and the SMO rounds that settle it (siblings in free-list rows,
    separators merged into parents)."""
    keys, pool, meta, t_meta = _pool_pair(level_m, n_keys, seed)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    cfg = ref_dex.DexMeshConfig(n_route=1, n_memory=1, cache_sets=64, policy="fetch")
    state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
    rng = np.random.default_rng(seed + 1)
    per = meta.per_node
    burst = []
    for leaf in rng.choice(keys.size // per - 1, size=6, replace=False):
        lo, hi = keys[leaf * per], keys[leaf * per + per - 1]
        cand = np.setdiff1d(np.arange(lo + 1, hi, 7), keys)
        burst.append(rng.choice(cand, size=40, replace=False))
    kk = np.concatenate(burst)
    vv = kk * 3
    insert = jax.jit(ref_write.make_dex_insert(meta, cfg, mesh, **PLAIN))
    state, st = insert(state, jnp.asarray(kk), jnp.asarray(vv))
    shed = np.asarray(st) == ref_write.STATUS_SPLIT
    assert shed.any()
    smo = jax.jit(ref_smo.make_dex_smo(meta, cfg, mesh, **PLAIN))
    state, _, _ = ref_smo.run_smo(
        smo, state, np.where(shed, kk, KEY_MAX), np.where(shed, vv, 0)
    )
    return state, meta, t_meta


def _check_ranges(pool_keys, meta, t_meta, children):
    want = ref_rep.node_key_ranges(pool_keys, meta, children, with_levels=True)
    got = t_rep.node_key_ranges(
        torch.tensor(pool_keys),
        t_meta,
        None if children is None else torch.tensor(children),
        with_levels=True,
    )
    for w, g in zip(want, got):
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())
    short = t_rep.node_key_ranges(torch.tensor(pool_keys), t_meta)
    assert len(short) == 3
    return want


@pytest.mark.parametrize("level_m,n_keys", [(1, 3000), (2, 4000), (0, 300)])
def test_node_key_ranges_on_bulk_pool(level_m, n_keys):
    _, pool, meta, t_meta = _pool_pair(level_m, n_keys, seed=level_m)
    pk = np.asarray(pool.pool_keys)
    # the dense-layout path and the children-graph walk
    _check_ranges(pk, meta, t_meta, None)
    _check_ranges(pk, meta, t_meta, np.asarray(pool.pool_children))


@pytest.mark.parametrize("level_m,n_keys", [(1, 3000), (2, 6000)])
def test_node_key_ranges_after_smo_splits(level_m, n_keys):
    state, meta, t_meta = _split_pool(level_m, n_keys, seed=3 + level_m)
    gids, lo, hi, lvl = _check_ranges(
        np.asarray(state.pool.pool_keys),
        meta,
        t_meta,
        np.asarray(state.pool.pool_children),
    )
    # the siblings the splits placed in free-list rows are leaves there
    free = (gids % meta.subtree_cap) >= meta.base_cap
    assert (lvl[free] == 0).any()


@pytest.mark.parametrize(
    "old,new",
    [
        ([KEY_MIN, 100, 200, KEY_MAX], [KEY_MIN, 150, 200, KEY_MAX]),
        ([KEY_MIN, 100, KEY_MAX], [KEY_MIN, 500, KEY_MAX]),
        ([KEY_MIN, 100, 200, 300, KEY_MAX], [KEY_MIN, 50, 250, 260, KEY_MAX]),
        ([KEY_MIN, -(2**62), 2**62, KEY_MAX], [KEY_MIN, -(2**62), 2**62, KEY_MAX]),
    ],
)
def test_moved_intervals_match_reference(old, new):
    o, n = (np.array(b, np.int64) for b in (old, new))
    want = ref_rep.moved_intervals(RefParts(o), RefParts(n))
    got = t_rep.moved_intervals(LogicalPartitions(o), LogicalPartitions(n))
    assert got == want
    assert all(type(a) is int and type(b) is int for a, b in got)


def _small_pair(n_route=2, n_memory=1, n_keys=2000, rt_slots=0):
    """tests/test_repartition.py's ``_small_state`` in both packages."""
    keys = np.arange(1, n_keys + 1, dtype=np.int64) * 10
    pool, meta = ref_pool.build_pool(keys, keys * 3, level_m=1, fill=0.7,
                                     n_shards=n_memory)
    _, t_meta = t_pool.build_pool(keys, keys * 3, level_m=1, fill=0.7,
                                  n_shards=n_memory, device="cpu")
    kw = dict(n_route=n_route, n_memory=n_memory, route_table_slots=rt_slots)
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    bounds = np.array([KEY_MIN, int(keys[n_keys // 2]), KEY_MAX], np.int64)
    state = ref_dex.init_state(pool, meta, cfg, bounds)
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    return keys, meta, t_meta, state, t_state, bounds


@pytest.mark.parametrize(
    "loads",
    [[3.0, 1.0], [1.0, 4.0], None],
)
def test_install_boundaries_matches_reference(loads):
    keys, meta, t_meta, state, t_state, bounds = _small_pair()
    old = RefParts(bounds)
    new = old if loads is None else old.rebalance(
        loads, key_range=(int(keys[0]), int(keys[-1]))
    )
    s2, n_inval, sb, sa = ref_rep.install_boundaries(state, meta, old, new)
    t2, t_inval, tsb, tsa = t_rep.install_boundaries(
        t_state, t_meta, LogicalPartitions(bounds), LogicalPartitions(new.boundaries)
    )
    assert (t_inval, tsb, tsa) == (n_inval, sb, sa)
    assert all(type(x) is int for x in (t_inval, tsb, tsa))
    _assert_state_equal(_flat(s2), t2, f"install {loads}")
    if loads is None:
        assert t_inval == 0 and int(t2.versions.sum()) == 0
    else:
        assert t_inval > 0
    # the state it was given keeps its planes
    assert int(t_state.versions.sum()) == 0


def test_install_after_smo_splits_matches_reference():
    state, meta, t_meta = _split_pool(1, 3000, seed=9)
    cfg = t_dex.DexMeshConfig(n_route=1, n_memory=1, cache_sets=64, policy="fetch")
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, cfg, "cpu")
    gids, lo, hi = ref_rep.node_key_ranges(
        np.asarray(state.pool.pool_keys), meta, np.asarray(state.pool.pool_children)
    )
    mid = int(np.median(lo[lo > KEY_MIN]))
    # boundary tables of two partitions over the split pool's key range
    ref_old = RefParts(np.array([KEY_MIN, mid, KEY_MAX], np.int64))
    ref_new = RefParts(np.array([KEY_MIN, mid + 10_000_000, KEY_MAX], np.int64))
    want = ref_rep.install_boundaries(state, meta, ref_old, ref_new)
    got = t_rep.install_boundaries(
        t_state,
        t_meta,
        LogicalPartitions(ref_old.boundaries),
        LogicalPartitions(ref_new.boundaries),
    )
    assert got[1:] == want[1:] and got[1] > 0
    np.testing.assert_array_equal(got[0].versions.numpy(), np.asarray(want[0].versions))


def _stats(served, drops=0, n_memory=1):
    n_route = len(served)
    s = np.zeros((n_route * n_memory, t_registry.N_STATS), np.int64)
    s[:, t_registry.STAT_OPS] = np.repeat(served, n_memory)
    s[0, t_registry.STAT_DROPS] = drops
    return s


def _report_equal(want, got):
    assert (want is None) == (got is None)
    if want is None:
        return
    for k, v in vars(want).items():
        g = getattr(got, k)
        np.testing.assert_array_equal(np.asarray(v), np.asarray(g), err_msg=k)
        assert type(g) is type(v), k


@pytest.mark.parametrize("with_demand", [True, False])
def test_controller_matches_reference_over_seeded_trace(with_demand):
    """Counters, demand and keys of a seeded trace fed to both controllers:
    every decision, proposal, install and report agrees."""
    keys, meta, t_meta, state, t_state, bounds = _small_pair(n_route=2, n_memory=1)
    rcfg = ref_rep.RepartitionConfig(
        imbalance_threshold=1.25, min_ops=300, cooldown_batches=1
    )
    tcfg = t_rep.RepartitionConfig(
        imbalance_threshold=1.25, min_ops=300, cooldown_batches=1
    )
    assert vars(rcfg) == vars(tcfg)
    ref = ref_rep.RepartitionController(RefParts(bounds), n_memory=1, cfg=rcfg)
    port = t_rep.RepartitionController(LogicalPartitions(bounds), n_memory=1, cfg=tcfg)
    rng = np.random.default_rng(11)
    served = np.zeros(2, np.int64)
    demand = np.zeros((2, 2), np.int64)
    installs = 0
    for step in range(10):
        served += rng.integers(0, 400, size=2) * np.array([3 if step < 5 else 1, 1])
        demand[0, 0] += rng.integers(0, 500)
        demand[1, 1] += rng.integers(0, 150 if step < 5 else 900)
        kk = rng.choice(keys, size=64)
        kk[::9] = KEY_MAX
        st = _stats(served, drops=int(rng.integers(0, 30)))
        d = demand.copy() if with_demand else None
        ref.observe(st, kk, demand=d)
        port.observe(torch.from_numpy(st), torch.from_numpy(kk),
                     demand=None if d is None else torch.from_numpy(d))
        assert port.imbalance == ref.imbalance
        assert port.should_repartition() == ref.should_repartition()
        if ref.should_repartition():
            np.testing.assert_array_equal(
                port.propose().boundaries, ref.propose().boundaries
            )
        state, r_rep = ref.maybe_repartition(state, meta)
        t_state, t_report = port.maybe_repartition(t_state, t_meta)
        _report_equal(r_rep, t_report)
        installs += r_rep is not None
        _assert_state_equal(_flat(state), t_state, f"step {step}")
        np.testing.assert_array_equal(port.parts.boundaries, ref.parts.boundaries)
    assert installs >= 1
    assert len(port.reports) == len(ref.reports) == installs


def test_controller_cases_of_reference_tests():
    """tests/test_repartition.py::TestController's triggers."""
    parts = LogicalPartitions.equal_width(2, 0, 1000)
    ctl = t_rep.RepartitionController(
        parts, n_memory=1, cfg=t_rep.RepartitionConfig(min_ops=1000)
    )
    ctl.observe(_stats([400, 10]))
    assert not ctl.should_repartition()
    ctl.observe(_stats([1200, 30]))
    assert ctl.should_repartition()
    ctl = t_rep.RepartitionController(
        parts, n_memory=1,
        cfg=t_rep.RepartitionConfig(imbalance_threshold=10.0, min_ops=100),
    )
    ctl.observe(_stats([300, 290], drops=50))
    assert ctl.should_repartition()
    ctl = t_rep.RepartitionController(
        parts, n_memory=1, cfg=t_rep.RepartitionConfig(min_ops=100)
    )
    ctl.observe(_stats([500, 500]))
    assert not ctl.should_repartition()
    ctl = t_rep.RepartitionController(
        parts, n_memory=1, cfg=t_rep.RepartitionConfig(min_ops=100)
    )
    ctl.observe(_stats([100, 100]), np.array([5, 400, 800, KEY_MAX]),
                demand=np.array([[900, 0], [0, 100]]))
    assert ctl.should_repartition()
    assert 5 <= int(ctl.propose().boundaries[1]) <= 800
    # a telemetry batch (obs=) records no phase when the trigger does not fire
    from repro_torch.obs.timeline import BatchTimeline

    quiet = t_rep.RepartitionController(
        parts, n_memory=1, cfg=t_rep.RepartitionConfig(min_ops=100)
    )
    tl = BatchTimeline("controller")
    with tl.batch("quiet") as b:
        assert quiet.maybe_repartition("state", None, obs=b) == ("state", None)
    assert tl.batches[0].phases == []


def test_maybe_repartition_retrains_an_active_table_as_reference():
    keys, meta, t_meta, state, t_state, bounds = _small_pair(rt_slots=256)
    state = ref_rt.train_route_table(state, meta)
    t_state = t_rt.train_route_table(t_state, t_meta)
    _assert_state_equal(_flat(state), t_state, "trained")
    kw = dict(imbalance_threshold=1.25, min_ops=100, cooldown_batches=2)
    ref = ref_rep.RepartitionController(
        RefParts(bounds), n_memory=1, cfg=ref_rep.RepartitionConfig(**kw)
    )
    port = t_rep.RepartitionController(
        LogicalPartitions(bounds), n_memory=1, cfg=t_rep.RepartitionConfig(**kw)
    )
    demand = np.array([[950, 0], [0, 50]], np.int64)
    for ctl in (ref, port):
        ctl.observe(_stats([500, 50]), keys, demand=demand)
    s2, r_rep = ref.maybe_repartition(state, meta)
    t2, t_report = port.maybe_repartition(t_state, t_meta)
    assert r_rep is not None and r_rep.nodes_invalidated > 0
    _report_equal(r_rep, t_report)
    _assert_state_equal(_flat(s2), t2, "after install")
    # the retrained stamps follow the bumped versions
    assert not np.array_equal(t2.rt_ver.numpy(), t_state.rt_ver.numpy())
    for ctl in (ref, port):
        ctl.observe(_stats([500, 50]), keys, demand=demand + demand)
        assert not ctl.should_repartition()  # cooldown


@pytest.fixture(scope="module")
def repart_group(tmp_path_factory):
    """The reference's ``repart`` group, run once for the module
    (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory, "repart") as group:
        yield group


@pytest.fixture(scope="module")
def repart_ref(repart_group):
    return repart_group.arrays()


def test_repartition_2x4_matches_reference(repart_ref):
    arrays = repart_ref
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    t_cfg = t_dex.DexMeshConfig(
        n_route=2, n_memory=4, cache_sets=64, cache_ways=4, policy="fetch",
        route_capacity_factor=1.25, route_table_slots=512,
    )

    def planes(tag):
        pre = f"repart/{tag}/"
        return {
            k[len(pre):]: v
            for k, v in arrays.items()
            if k.startswith(pre) and "/" not in k[len(pre):]
        }

    init = planes("init")
    bounds = init["boundaries"]
    t_state = t_dex.state_from_numpy(init, t_meta, t_cfg, "cpu")
    eng = t_engine.make_dex_engine(
        t_meta, t_cfg, ops=("lookup", "update", "insert"), device="cpu"
    )
    ctl = t_rep.RepartitionController(
        LogicalPartitions(bounds),
        n_memory=4,
        cfg=t_rep.RepartitionConfig(
            imbalance_threshold=1.2, min_ops=256, cooldown_batches=0
        ),
    )
    installs = 0
    for i in range(3):
        args = [arrays[f"repart/{i}/{f}"] for f in ("opcodes", "keys", "values")]
        t_state, t_res = eng(t_state, *args)
        want = planes(str(i))
        for k in ("opcodes", "keys", "values", "installed"):
            want.pop(k)
        for k in RESULTS:
            np.testing.assert_array_equal(
                want.pop(f"result.{k}"), getattr(t_res, k).numpy(), err_msg=k
            )
        for k in [k for k in want if k.startswith("report.")]:
            want.pop(k)
        _assert_state_equal(want, t_state, f"repart batch {i}")
        ctl.observe(t_state.stats, args[1], demand=t_state.route_demand)
        t_state, report = ctl.maybe_repartition(t_state, t_meta)
        assert bool(arrays[f"repart/{i}/installed"]) == (report is not None)
        if report is not None:
            installs += 1
            for k, v in vars(report).items():
                np.testing.assert_array_equal(
                    arrays[f"repart/{i}/report.{k}"], np.asarray(v), err_msg=k
                )
        _assert_state_equal(
            {
                k[len(f"repart/{i}/after/"):]: v
                for k, v in arrays.items()
                if k.startswith(f"repart/{i}/after/")
            },
            t_state,
            f"repart after {i}",
        )
    assert installs >= 2
    assert t_state.stats.numpy()[:, t_registry.STAT_DROPS].sum() > 0
    assert t_state.stats.numpy()[:, t_registry.STAT_RT_SKIPS].sum() > 0


def test_invalidate_nodes_bumps_each_distinct_gid_once():
    vers = torch.zeros((3, 10), dtype=torch.int32)
    vers[1, 4] = 7
    out = t_fleet_cache.invalidate_nodes(vers, torch.tensor([4, 4, 2, 9, 2]))
    want = vers.numpy().copy()
    want[:, [2, 4, 9]] += 1
    np.testing.assert_array_equal(out.numpy(), want)
    assert out.dtype == torch.int32 and int(vers.sum()) == 7
