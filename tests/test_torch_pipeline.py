"""The port's pipelined engine (``make_dex_engine(pipeline=True)``) against
the reference's, bit for bit on the CPU:

* at 1x1 on tests/test_engine.py's interleaved traffic, under ``fetch``,
  ``offload`` and ``auto``: every result of every push and every state
  plane after every push and after the drain (pool, occupancy, versions,
  the cache planes, ``stats`` with ``STAT_PIPE_STALLS``, ``lat_hist``,
  ``lat_audit``), and the collective counts of a step by phase; and the
  port's pipeline against its synchronous engine;
* the ``ALL_OPS`` pipeline with scans, some of them stall-shed;
* ``GOLDEN_PIPE`` of tests/test_engine.py;
* the push / drain protocol, results that stay valid over later pushes,
  and a poisoned route table under the pipeline;
* at 2x4, tests/mesh_check.py's pipelined traffic (the reference in a
  subprocess on a forced 8-device CPU mesh, ``tests/torch_mesh_ref.py
  pipe``), synchronous and pipelined, with the per-phase counts; and the
  same pipeline over 4 gloo ranks (``launch/mesh.py::spawn_ranks``, the
  world started beside the reference's subprocess): every push's lanes,
  every gathered plane and each rank's counts by phase against the
  reference's arrays.
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
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import route_table as t_rt  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
import torch_rank_cases as C  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from test_engine import GOLDEN_PIPE, MC, _dataset, _digest, _mixed_batches  # noqa: E402
from torch_mesh_group import MeshGroup  # noqa: E402

#: the reference runs its jnp kernels (``repro/kernels/ref.py``), bit for bit
#: its Pallas ones (``tests/test_kernels.py``), which hold the port's kernels in
#: ``tests/test_torch_{kernels,write,scan,smo}.py``: interpret mode's trace and
#: compile were most of a reference run's time
PLAIN = dict(use_kernel=False)

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
RESULTS = ("found", "values", "status", "shed")
SCAN_RESULTS = RESULTS + ("scan_keys", "scan_values", "taken")
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


def _assert_results_equal(want, got, fields, where):
    assert (want is None) == (got is None), where
    if want is None:
        return
    for k in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, k)), getattr(got, k).numpy(), err_msg=f"{where}: {k}"
        )


def _setup(seed, policy="fetch", rt_slots=0):
    """tests/test_engine.py's 1x1 ``_setup`` in both packages; the port's
    state is built from the reference's."""
    keys = _dataset(4000, seed=seed)
    vals = keys * 5
    pool, meta = ref_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=1)
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, device="cpu")
    kw = dict(n_route=1, n_memory=1, cache_sets=128, cache_ways=4,
              p_admit_leaf_pct=10, route_capacity_factor=2.0, policy=policy,
              route_table_slots=rt_slots)
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    return keys, state, meta, cfg, t_state, t_meta, t_cfg


def _run_both(policy, ops, max_count, seed, rng_seed, n_batches, with_scan,
              counts=True):
    """Push the same batches through both pipelines, comparing every
    result and every plane after every push and after the drain; with
    ``counts`` the collective counts of the second (steady-state) step by
    phase too.  Returns the port's initial state (a snapshot), engine
    pieces, batches and results."""
    keys, state, meta, cfg, t_state, t_meta, t_cfg = _setup(seed, policy)
    init = t_dex.state_to_numpy(t_state)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    pipe = ref_engine.make_dex_engine(meta, cfg, mesh, ops=ops, max_count=max_count,
                                      pipeline=True, **PLAIN)
    t_pipe = t_engine.make_dex_engine(t_meta, t_cfg, ops=ops, max_count=max_count,
                                      pipeline=True, device="cpu")
    assert t_pipe.plan == {k: v for k, v in pipe.plan.items() if k != "phases"}
    batches = _mixed_batches(keys, np.random.default_rng(rng_seed), n_batches, 128,
                             with_scan=with_scan, hot=keys[40:48])
    fields = SCAN_RESULTS if with_scan else RESULTS
    pipe.start(state)
    t_pipe.start(t_state)
    t_res = []
    for i, (opc, kk, vv) in enumerate(batches):
        args = tuple(map(jnp.asarray, (opc, kk, vv)))
        if counts and i == 0:
            # traced before the first push: the trace is cached after it
            want_counts = ref_routing.trace_collective_counts(
                pipe.step_fn, pipe.state, pipe.init_carry(128), *args, by_phase=True
            )
        r = pipe.push(*args)
        t_mesh.reset_counts()
        tr = t_pipe.push(opc, kk, vv)
        if counts and i == 1:
            assert t_mesh.collective_counts(by_phase=True) == want_counts
            assert set(want_counts["phases"]) == {"pipe/front", "pipe/back"}
        _assert_results_equal(r, tr, fields, f"{policy} push {i}")
        _assert_state_equal(_flat(pipe.state), t_pipe.state, f"{policy} push {i}")
        if tr is not None:
            t_res.append(tr)
    r = pipe.drain()
    tr = t_pipe.drain()
    _assert_results_equal(r, tr, fields, f"{policy} drain")
    _assert_state_equal(_flat(pipe.state), t_pipe.state, f"{policy} drain")
    t_res.append(tr)
    assert t_pipe.drain() is None
    return init, t_meta, t_cfg, batches, t_res, t_pipe.state


@pytest.mark.parametrize("policy", ["fetch", "offload", "auto"])
def test_pipeline_1x1_matches_reference(policy):
    """TestPipelinedEngine.test_pipelined_matches_synchronous_mixed's
    traffic; then the port's synchronous engine from the same snapshot gives
    the same results, pool, occupancy and versions, with no stall."""
    init, t_meta, t_cfg, batches, t_res, s_pipe = _run_both(
        policy, OPS, 1, 21, 22, 5, False, counts=policy != "offload"
    )
    stats = s_pipe.stats.numpy().sum(0)
    # under offload every lane is two-sided already: nothing to force
    assert (stats[t_registry.STAT_PIPE_STALLS] > 0) == (policy == "fetch")
    assert stats[t_registry.STAT_OPS] == s_pipe.lat_hist.numpy().sum()
    sync = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, max_count=1, device="cpu")
    s_sync = t_dex.state_from_numpy(init, t_meta, t_cfg, "cpu")
    for b, ((opc, kk, vv), rp) in enumerate(zip(batches, t_res)):
        s_sync, rs = sync(s_sync, opc, kk, vv)
        for k in RESULTS:
            assert torch.equal(getattr(rs, k), getattr(rp, k)), (b, k)
    a, p = t_dex.state_to_numpy(s_sync), t_dex.state_to_numpy(s_pipe)
    for k in ("pool.pool_keys", "pool.pool_values", "versions", "occupancy"):
        np.testing.assert_array_equal(a[k], p[k], err_msg=k)
    assert a["stats"][:, t_registry.STAT_PIPE_STALLS].sum() == 0


def test_all_ops_pipeline_with_stall_shed_scans():
    """TestPipelinedEngine.test_pipelined_scans_stall_shed_conservatively:
    the ALL_OPS pipeline equals the reference's plane for plane; against the
    port's synchronous engine it only adds sheds (stall-shed scans, ``taken
    == -1``), agrees on every other lane, and writes the same pool."""
    init, t_meta, t_cfg, batches, t_res, s_pipe = _run_both(
        "fetch", t_engine.ALL_OPS, MC, 23, 24, 4, True
    )
    sync = t_engine.make_dex_engine(t_meta, t_cfg, ops=t_engine.ALL_OPS, max_count=MC,
                                    device="cpu")
    s_sync = t_dex.state_from_numpy(init, t_meta, t_cfg, "cpu")
    stalled_any = False
    for b, ((opc, kk, vv), rp) in enumerate(zip(batches, t_res)):
        s_sync, rs = sync(s_sync, opc, kk, vv)
        shed_s, shed_p = rs.shed.numpy(), rp.shed.numpy()
        assert not (shed_s & ~shed_p).any(), b
        stalled = shed_p & ~shed_s
        stalled_any = stalled_any or stalled.any()
        assert (rp.taken.numpy()[stalled] == -1).all(), b
        assert (opc[stalled] == t_engine.OP_SCAN).all(), b
        ok = ~shed_p
        for k in SCAN_RESULTS:
            np.testing.assert_array_equal(
                getattr(rs, k).numpy()[ok], getattr(rp, k).numpy()[ok], err_msg=f"{b} {k}"
            )
    assert stalled_any
    a, p = t_dex.state_to_numpy(s_sync), t_dex.state_to_numpy(s_pipe)
    for k in ("pool.pool_values", "versions"):
        np.testing.assert_array_equal(a[k], p[k], err_msg=k)


def test_pipeline_reproduces_golden_pipe():
    """tests/test_engine.py's ``GOLDEN_PIPE``: the mixed pipeline under
    ``fetch`` on that file's trace, hashed the same way."""
    keys = _dataset(4000, seed=33)
    vals = keys * 5
    pool, meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, device="cpu")
    cfg = t_dex.DexMeshConfig(n_route=1, n_memory=1, cache_sets=128, cache_ways=4,
                              p_admit_leaf_pct=10, route_capacity_factor=2.0,
                              policy="fetch")
    state = t_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]), device="cpu")
    pipe = t_engine.make_dex_engine(meta, cfg, ops=OPS, max_count=1, pipeline=True,
                                    device="cpu")
    batches = _mixed_batches(keys, np.random.default_rng(34), 5, 128, hot=keys[40:48])
    s, results = pipe.run(state, batches)
    assert len(results) == len(batches)
    res_h = hashlib.sha256()
    for r in results:
        res_h.update(_digest(*(getattr(r, k).numpy() for k in RESULTS)).encode())
    d = t_dex.state_to_numpy(s)
    got = {
        "results": res_h.hexdigest()[:16],
        "state": _digest(d["pool.pool_keys"], d["pool.pool_values"], d["versions"],
                         d["occupancy"]),
        "stats12": _digest(d["stats"][:, :12]),
    }
    assert got == GOLDEN_PIPE, got


def test_pipeline_protocol():
    """TestPipelinedEngine.test_pipeline_protocol in the port."""
    keys, _, _, _, t_state, t_meta, t_cfg = _setup(25)
    pipe = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, max_count=1, pipeline=True,
                                    device="cpu")
    b = 64
    opc = np.full(b, t_engine.OP_LOOKUP, np.int32)
    kk = keys[:b]
    vv = np.zeros(b, np.int64)
    with pytest.raises(RuntimeError):
        pipe.push(opc, kk, vv)
    pipe.start(t_state)
    assert pipe.drain() is None
    with pytest.raises(ValueError):
        pipe.push(opc[:0], kk[:0], vv[:0])
    assert pipe.push(opc, kk, vv) is None
    with pytest.raises(ValueError):
        pipe.push(opc[: b // 2], kk[: b // 2], vv[: b // 2])
    r1 = pipe.push(opc, kk, vv)
    assert r1 is not None and r1.found.all()
    rd = pipe.drain()
    assert rd is not None and rd.found.all()
    np.testing.assert_array_equal(rd.values.numpy(), kk * 5)
    assert pipe.drain() is None
    assert pipe.push(opc, kk, vv) is None
    assert pipe.plan["pipeline"] is True
    assert pipe.plan["stages"] == ("front", "back")
    assert pipe.plan["overlap_phases"] == ("pipe/front", "pipe/back")
    carry = pipe.init_carry(b)
    assert (carry["q"] == KEY_MAX).all() and not carry["found"].any()


def test_result_stays_valid_after_later_pushes():
    """A result ``push`` returned keeps its values over two further pushes
    and the drain."""
    keys, _, _, _, t_state, t_meta, t_cfg = _setup(27)
    pipe = t_engine.make_dex_engine(t_meta, t_cfg, ops=OPS, max_count=1, pipeline=True,
                                    device="cpu")
    batches = _mixed_batches(keys, np.random.default_rng(28), 4, 128, hot=keys[40:48])
    pipe.start(t_state)
    assert pipe.push(*batches[0]) is None
    r = pipe.push(*batches[1])
    saved = {k: getattr(r, k).clone() for k in RESULTS}
    pipe.push(*batches[2])
    pipe.push(*batches[3])
    pipe.drain()
    for k in RESULTS:
        assert torch.equal(saved[k], getattr(r, k)), k


def test_pipelined_engine_poisoned_matches_descent():
    """tests/test_route_table.py's
    TestPoisonedBitIdentity.test_pipelined_engine_poisoned_matches_descent:
    under the pipeline a poisoned route table gives the descent-only
    answers and planes, with no skip and with mispredicts."""
    keys, _, _, _, s_de, t_meta, cfg_de = _setup(41)
    _, _, _, _, s_rt, _, cfg_rt = _setup(41, rt_slots=512)
    pipe_de = t_engine.make_dex_engine(t_meta, cfg_de, ops=OPS, max_count=1,
                                       pipeline=True, device="cpu")
    pipe_rt = t_engine.make_dex_engine(t_meta, cfg_rt, ops=OPS, max_count=1,
                                       pipeline=True, device="cpu")
    s_rt = t_rt.poison_route_table(t_rt.train_route_table(s_rt, t_meta))
    rng = np.random.default_rng(44)
    batches = []
    for _ in range(4):
        opc = rng.integers(0, 3, size=128).astype(np.int32)
        kk = rng.choice(keys, size=128).astype(np.int64)
        ins = opc == t_engine.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=128)
        ok_f = ~np.isin(fresh, keys)
        kk[ins & ok_f] = fresh[ins & ok_f]
        vals = np.zeros(128, np.int64)
        upd = opc == t_engine.OP_UPDATE
        vals[upd] = kk[upd] ^ 0x5A5A
        vals[ins] = kk[ins] * 7
        batches.append((opc, kk, vals))
    s_de, res_de = pipe_de.run(s_de, batches)
    s_rt, res_rt = pipe_rt.run(s_rt, batches)
    assert len(res_de) == len(res_rt) == len(batches)
    for b, (rd, rr) in enumerate(zip(res_de, res_rt)):
        for k in RESULTS:
            assert torch.equal(getattr(rd, k), getattr(rr, k)), (b, k)
    for k in ("pool_keys", "pool_values"):
        assert torch.equal(getattr(s_de.pool, k), getattr(s_rt.pool, k)), k
    assert torch.equal(s_de.versions, s_rt.versions)
    stats = s_rt.stats.numpy().sum(0)
    assert stats[t_registry.STAT_RT_SKIPS] == 0
    assert stats[t_registry.STAT_RT_MISPREDICTS] > 0


@pytest.fixture(scope="module")
def pipe_group(tmp_path_factory):
    """The reference's ``pipe`` group (its ``pipe`` case), run once for the
    module (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory, "pipe", "pipe") as group:
        yield group


@pytest.fixture(scope="module")
def pipe_ref(pipe_group, pipe_ranks):
    """The reference's arrays, read once the ranks (``pipe_ranks``), which
    run while the reference does, are done."""
    return pipe_group.arrays()


def mesh_cfg(arrays, name, t_meta):
    return t_dex.DexMeshConfig(
        n_route=2, n_memory=4, cache_sets=int(arrays[f"{name}/sets"]), cache_ways=4,
        policy=str(arrays[f"{name}/policy"]),
        p_admit_leaf_pct=int(arrays[f"{name}/admit"]),
        route_capacity_factor=4.0,
    )


def planes(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def test_pipeline_2x4_matches_reference(pipe_ref):
    """tests/mesh_check.py's pipelined round trip (4 batches of 512, mixed
    lookups, updates and inserts, one hot lane a device written on even
    batches and read on odd ones): the synchronous engine batch by batch and
    the pipeline push by push, every result and plane, the pipeline's
    per-phase collective counts of a steady-state step; stalls counted by
    the pipeline only."""
    arrays = pipe_ref
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    cfg = mesh_cfg(arrays, "pipe", t_meta)
    n = int(arrays["pipe/batches"])
    batches = [
        tuple(arrays[f"pipe/{i}/{f}"] for f in ("opcodes", "keys", "values"))
        for i in range(n)
    ]
    sync = t_engine.make_dex_engine(t_meta, cfg, ops=OPS, max_count=1, device="cpu")
    state = t_dex.state_from_numpy(planes(arrays, "pipe/init/"), t_meta, cfg, "cpu")
    for i, (opc, kk, vv) in enumerate(batches):
        state, r = sync(state, opc, kk, vv)
        want = planes(arrays, f"pipe/sync/{i}/")
        for k in RESULTS:
            np.testing.assert_array_equal(want.pop(f"result.{k}"), getattr(r, k).numpy(),
                                          err_msg=f"sync {i} {k}")
        _assert_state_equal(want, state, f"sync batch {i}")
    pipe = t_engine.make_dex_engine(t_meta, cfg, ops=OPS, max_count=1, pipeline=True,
                                    device="cpu")
    pipe.start(t_dex.state_from_numpy(planes(arrays, "pipe/init/"), t_meta, cfg, "cpu"))
    counts = arrays["pipe/phase_counts"]
    for i in range(n + 1):
        t_mesh.reset_counts()
        r = pipe.push(*batches[i]) if i < n else pipe.drain()
        if i == 1:
            got = t_mesh.collective_counts(by_phase=True)
            assert [got["all_to_all"], got["route_exchange"]] == counts[0].tolist()
            for j, ph in enumerate(("pipe/front", "pipe/back")):
                per = got["phases"][ph]
                assert [per["all_to_all"], per["route_exchange"]] == counts[j + 1].tolist()
        want = planes(arrays, f"pipe/pipe/{i}/")
        assert (r is None) == (f"result.found" not in want), i
        for k in RESULTS if r is not None else ():
            np.testing.assert_array_equal(want.pop(f"result.{k}"), getattr(r, k).numpy(),
                                          err_msg=f"push {i} {k}")
        _assert_state_equal(want, pipe.state, f"push {i}")
    stats = pipe.state.stats.numpy().sum(0)
    assert stats[t_registry.STAT_PIPE_STALLS] > 0
    assert state.stats.numpy()[:, t_registry.STAT_PIPE_STALLS].sum() == 0


#: the world of gloo ranks the 2x4 pipeline runs on (2 devices a rank)
PIPE_WORLD = 4


@pytest.fixture(scope="module")
def pipe_ranks(pipe_group, tmp_path_factory):
    """The ``pipe`` case over ``PIPE_WORLD`` ranks
    (``tests/torch_rank_cases.py``), run while the reference's group runs."""
    return spawn_ranks(C.world, PIPE_WORLD, "gloo", ["pipe"],
                       init=tmp_path_factory.mktemp("pipe_ranks"))


def test_pipeline_2x4_on_ranks_matches_reference(pipe_ref, pipe_ranks):
    """The 2x4 pipeline over 4 gloo ranks against the reference's ``pipe``
    arrays: the batches, the initial planes, every push's and the drain's
    lanes and gathered planes, and each rank's collective counts of every
    step, by phase too, equal to the reference's traced step."""
    for i, planes_ in enumerate(C.pipe_batches()):
        for f, a in zip(("opcodes", "keys", "values"), planes_):
            np.testing.assert_array_equal(pipe_ref[f"pipe/{i}/{f}"], a)
    C.check_pipeline(pipe_ranks, pipe_ref, PIPE_WORLD, "pipe")
    stats = pipe_ranks[0]["pipe"]["steps"][-1]["planes"]["stats"]
    assert stats[:, t_registry.STAT_PIPE_STALLS].sum() > 0
