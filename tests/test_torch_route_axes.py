"""Two route axes: the port's engines on a 2x2x2 virtual mesh against the
reference's on a forced 8-device CPU mesh of ``("data", "pod", "model")``
(``tests/torch_mesh_ref.py OUT axes``, one subprocess for the module).

Routing runs over ``("data", "pod")`` of 2 x 2 (four route partitions) and
the pool over ``"model"`` of 2.  The lookup engine under ``fetch`` and under
``auto`` with shedding buckets, the mixed and scan engines under ``auto``,
the SMO burst round and the pipelined engine: every lane result, every state
plane, the stats and the collective counts (a route exchange over two axes
counts two ``all_to_all``) are bit-identical after each batch.  The same
engines, the SMO case and the pipeline run over 2, 4 and 8 gloo ranks
(``launch/mesh.py::spawn_ranks``, each world started beside the reference's
subprocess) and are held to the reference's arrays the same way: lanes,
gathered planes, each rank's counts (by phase for the pipeline).  Also the
exchange over each axis against the formula it implements, on the virtual
mesh and over ranks (where a block crosses ranks), and the check of
``DexMeshConfig.route_shape``."""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import routing as t_routing  # noqa: E402
from repro_torch.core import smo as t_smo  # noqa: E402
from repro_torch.core import write as t_write  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
import torch_rank_cases as C  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from torch_mesh_group import MeshGroup  # noqa: E402

KEY_MAX = np.iinfo(np.int64).max
RESULTS = ("found", "values", "status", "shed")
SCAN_RESULTS = RESULTS + ("scan_keys", "scan_values", "taken")
MIXED = ("lookup", "update", "insert")
ALL_OPS = ("lookup", "update", "insert", "scan")


@pytest.fixture(scope="module")
def axes_group(tmp_path_factory):
    """The reference's ``axes`` group, run once for the module
    (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory, "axes") as group:
        yield group


#: the 2x2x2 cases each world of gloo ranks runs: 2 ranks (a route row
#: pair a rank: an exchange over "pod" stays on a rank, one over "data"
#: crosses), 4 (one route row a rank) and 8 (one device a rank)
AXES_ENGINES = ("axes_fetch", "axes_auto_tight", "axes_mixed_auto", "axes_scan_auto")
AXES_WORLD = AXES_ENGINES + ("axes_smo", "axes_pipe", "exchanges")
WORLDS = (2, 4, 8)


@pytest.fixture(scope="module")
def axes_ranks(axes_group, tmp_path_factory):
    """``{P: [each rank's results]}`` of ``AXES_WORLD`` over each world of
    ``WORLDS``, run while the reference's group runs."""
    return {p: spawn_ranks(C.world, p, "gloo", AXES_WORLD,
                           init=tmp_path_factory.mktemp(f"axes{p}"))
            for p in WORLDS}


@pytest.fixture(scope="module")
def axes_ref(axes_group, axes_ranks):
    """The reference's arrays, read once the worlds are done."""
    return axes_group.arrays()


def _cfg(policy, factor, sets=64, admit=None):
    kw = {} if admit is None else dict(p_admit_leaf_pct=admit)
    return t_dex.DexMeshConfig(
        route_axes=("data", "pod"), route_shape=(2, 2), n_route=4, n_memory=2,
        cache_sets=sets, cache_ways=4, policy=policy, route_capacity_factor=factor,
        **kw,
    )


def _meta(arrays):
    _, meta = t_pool.build_pool(arrays["keys"], arrays["values"], level_m=1, fill=0.7,
                                n_shards=2, device="cpu")
    return meta


def _planes(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _assert_state_equal(want: dict, state, where):
    got = t_dex.state_to_numpy(state)
    assert sorted(got) == sorted(want), where
    for k, a in want.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {k}")


def _assert_results(want: dict, res, fields, where):
    for k in fields:
        np.testing.assert_array_equal(want.pop(f"result.{k}"), getattr(res, k).numpy(),
                                      err_msg=f"{where}: {k}")


@pytest.mark.parametrize(
    "name", ["axes_fetch", "axes_auto_tight", "axes_mixed_auto", "axes_scan_auto"]
)
def test_engine_2x2x2_matches_reference(axes_ref, name):
    arrays = axes_ref
    ops = tuple(str(arrays[f"{name}/ops"]).split(","))
    factor = float(arrays[f"{name}/factor"])
    meta = _meta(arrays)
    cfg = _cfg(str(arrays[f"{name}/policy"]), factor)
    has_scan = "scan" in ops
    kw = dict(max_count=32) if has_scan else {}
    eng = t_engine.make_dex_engine(meta, cfg, ops=ops, device="cpu", **kw)
    state = t_dex.state_from_numpy(_planes(arrays, f"{name}/init/"), meta, cfg, "cpu")
    counts = arrays[f"{name}/counts"]
    for i in range(3):
        if has_scan:
            args = [arrays[f"scanmix/{i}/{f}"] for f in ("opcodes", "keys", "values")]
        elif ops == MIXED:
            args = [arrays[f"mixed/{i}/{f}"] for f in ("opcodes", "keys", "values")]
        else:
            q = arrays[f"batch/{i}"]
            args = [np.zeros(q.shape, np.int32), q, np.zeros(q.shape, np.int64)]
        t_mesh.reset_counts()
        state, res = eng(state, *args)
        assert t_mesh.collective_counts() == {
            "all_to_all": int(counts[0]), "route_exchange": int(counts[1])
        }
        want = _planes(arrays, f"{name}/{i}/")
        _assert_results(want, res, SCAN_RESULTS if has_scan else RESULTS, f"{name} {i}")
        _assert_state_equal(want, state, f"{name} batch {i}")
    stats = state.stats.numpy()
    assert stats[:, t_registry.STAT_OPS].sum() > 0
    if factor < 1:
        assert stats[:, t_registry.STAT_DROPS].sum() > 0


def test_smo_2x2x2_matches_reference(axes_ref):
    """The SMO burst on two route axes: an insert batch that sheds five
    overflowing leaves, one round (its collective counts too) and
    ``run_smo`` for the rest."""
    arrays = axes_ref
    meta = _meta(arrays)
    cfg = _cfg("fetch", 4.0)
    state = t_dex.state_from_numpy(_planes(arrays, "smo/init/"), meta, cfg, "cpu")
    kk, vv = arrays["smo/keys"], arrays["smo/values"]
    state, st = t_write.make_dex_insert(meta, cfg, device="cpu")(state, kk, vv)
    np.testing.assert_array_equal(arrays["smo/insert_status"], st.numpy())
    _assert_state_equal(_planes(arrays, "smo/insert/"), state, "insert")
    shed = st.numpy() == t_write.STATUS_SPLIT
    assert shed.sum() >= 150
    sk = np.where(shed, kk, KEY_MAX)
    sv = np.where(shed, vv, 0)
    smo = t_smo.make_dex_smo(meta, cfg, device="cpu")
    t_mesh.reset_counts()
    state, st1 = smo(state, sk, sv)
    c = arrays["smo/round_counts"]
    assert t_mesh.collective_counts() == {"all_to_all": int(c[0]), "route_exchange": int(c[1])}
    np.testing.assert_array_equal(arrays["smo/round_status"], st1.numpy())
    _assert_state_equal(_planes(arrays, "smo/round/"), state, "round")
    state, st2, rounds = t_smo.run_smo(smo, state, sk, sv)
    np.testing.assert_array_equal(arrays["smo/run_status"], st2)
    assert rounds == int(arrays["smo/run_rounds"])
    _assert_state_equal(_planes(arrays, "smo/run/"), state, "run_smo")
    assert (st2[shed] == t_write.STATUS_OK).all()
    assert state.stats.numpy()[:, t_registry.STAT_SMO_SPLITS].sum() >= 5


def test_pipeline_2x2x2_matches_reference(axes_ref):
    """The pipelined round trip on two route axes: the pipeline push by
    push, every result and plane, and a steady-state step's collective
    counts by phase."""
    arrays = axes_ref
    meta = _meta(arrays)
    cfg = _cfg(str(arrays["pipe/policy"]), 4.0, sets=int(arrays["pipe/sets"]),
               admit=int(arrays["pipe/admit"]))
    n = int(arrays["pipe/batches"])
    batches = [tuple(arrays[f"pipe/{i}/{f}"] for f in ("opcodes", "keys", "values"))
               for i in range(n)]
    pipe = t_engine.make_dex_engine(meta, cfg, ops=MIXED, max_count=1, pipeline=True,
                                    device="cpu")
    pipe.start(t_dex.state_from_numpy(_planes(arrays, "pipe/init/"), meta, cfg, "cpu"))
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
        want = _planes(arrays, f"pipe/pipe/{i}/")
        assert (r is None) == ("result.found" not in want), i
        if r is not None:
            _assert_results(want, r, RESULTS, f"push {i}")
        _assert_state_equal(want, pipe.state, f"push {i}")
    assert pipe.state.stats.numpy()[:, t_registry.STAT_PIPE_STALLS].sum() > 0


@pytest.mark.parametrize("axis", [0, 1])
def test_route_axis_exchange_matches_its_formula(axis):
    """``mesh.a2a`` over one of two route axes swaps the buffer's index along
    that axis with the device's (route index ``r = d0 * s1 + d1``); the two
    commute, and either composition is ``route_exchange`` in both
    directions, which counts two ``all_to_all`` a call."""
    cfg = t_dex.DexMeshConfig(route_axes=("data", "pod"), route_shape=(2, 3),
                              n_route=6, n_memory=2)
    s0, s1 = cfg.route_sizes
    x = torch.arange(cfg.n_devices * cfg.n_route * 5).reshape(cfg.n_devices, cfg.n_route, 5)
    y = t_mesh.a2a(x, cfg, cfg.route_axes[axis])
    for d in range(cfg.n_devices):
        (d0, d1), m = divmod(d // cfg.n_memory, s1), d % cfg.n_memory
        for i in range(cfg.n_route):
            i0, i1 = divmod(i, s1)
            if axis == 0:
                src, j = (i0 * s1 + d1) * cfg.n_memory + m, d0 * s1 + i1
            else:
                src, j = (d0 * s1 + i1) * cfg.n_memory + m, i0 * s1 + d1
            assert torch.equal(y[d, i], x[src, j]), (d, i)
    a0, a1 = cfg.route_axes
    both = t_mesh.a2a(t_mesh.a2a(x, cfg, a0), cfg, a1)
    assert torch.equal(both, t_mesh.a2a(t_mesh.a2a(x, cfg, a1), cfg, a0))
    for reverse in (False, True):
        t_mesh.reset_counts()
        assert torch.equal(t_routing.route_exchange(x, cfg, reverse=reverse), both)
        assert t_mesh.collective_counts() == {"all_to_all": 2, "route_exchange": 1}


@pytest.mark.parametrize(
    "kw",
    [
        dict(route_axes=("data", "pod"), n_route=4),
        dict(route_axes=("data", "pod"), route_shape=(2, 3), n_route=4),
        dict(route_axes=("data",), route_shape=(2, 2), n_route=4),
        dict(route_axes=("data", "pod", "x"), route_shape=(1, 2, 2), n_route=4),
    ],
)
def test_route_shape_must_fit_the_route_axes(kw):
    with pytest.raises(ValueError):
        t_dex.DexMeshConfig(**kw)


@pytest.mark.parametrize("p,name", [(p, n) for n in AXES_ENGINES for p in WORLDS])
def test_engine_2x2x2_on_ranks_matches_reference(axes_ref, axes_ranks, p, name):
    """A 2x2x2 engine over ``p`` gloo ranks against the reference's arrays:
    the initial planes, every batch's lanes and gathered planes, each
    rank's counts (two ``all_to_all`` a route exchange)."""
    C.check_reference(axes_ranks[p], axes_ref, p, name)


@pytest.mark.parametrize("p", WORLDS)
def test_smo_2x2x2_on_ranks_matches_reference(axes_ref, axes_ranks, p):
    """The SMO burst on two route axes over ``p`` ranks: the insert's, the
    round's and ``run_smo``'s lanes and gathered planes, the round's
    counts on every rank, the rounds ``run_smo`` ran (recorded as phases of
    a telemetry batch on every rank)."""
    ranks = axes_ranks[p]
    got = ranks[0]["axes_smo"]
    np.testing.assert_array_equal(axes_ref["smo/keys"], C.smo_burst()[0])
    for k in ("insert_status", "round_status", "run_status"):
        np.testing.assert_array_equal(
            axes_ref[f"smo/{k}"], C.rank_lanes(ranks, lambda r: r["axes_smo"][k]), k)
    for tag in ("insert", "round", "run"):
        C.equal(C.prefixed(axes_ref, f"smo/{tag}/"), got[tag], f"{p} ranks smo {tag}")
    c = axes_ref["smo/round_counts"]
    rounds = int(axes_ref["smo/run_rounds"])
    for r in ranks:
        assert r["axes_smo"]["round_counts"] == {
            "all_to_all": int(c[0]), "route_exchange": int(c[1])}
        assert r["axes_smo"]["run_rounds"] == rounds
        assert r["axes_smo"]["run_phases"] == [f"smo/round{i}" for i in range(rounds)]


@pytest.mark.parametrize("p", WORLDS)
def test_pipeline_2x2x2_on_ranks_matches_reference(axes_ref, axes_ranks, p):
    """The pipelined round trip on two route axes over ``p`` ranks: every
    push's lanes and gathered planes, each rank's counts by phase."""
    C.check_pipeline(axes_ranks[p], axes_ref, p, "axes_pipe", ref="pipe")


@pytest.mark.parametrize("p", WORLDS)
def test_route_axis_exchange_on_ranks_matches_virtual_mesh(axes_ranks, p):
    """``mesh.a2a`` over each of the two route axes and ``route_transpose``
    over ``p`` ranks equal the virtual mesh's, with the same counts; which
    exchanges cross ranks follows the blocks: over 2 ranks (two route rows
    a rank) "pod" stays on a rank and "data" crosses, over 4 (one route row
    a rank) and 8 (one device a rank) both cross, and the memory axis
    crosses only over 8."""
    ranks = axes_ranks[p]
    want = C.exchanges()
    for k in ("data", "pod", "route"):
        np.testing.assert_array_equal(
            want[k], C.rank_lanes(ranks, lambda r: r["exchanges"][k]), k)
    for r in ranks:
        assert r["exchanges"]["counts"] == want["counts"] == {
            "all_to_all": 2, "route_exchange": 0}
    remote = {k: any(r["exchanges"]["remote"][k] for r in ranks)
              for k in ("memory", "route", 0, 1)}
    assert remote == {"memory": p == 8, "route": True, 0: True, 1: p > 2}
