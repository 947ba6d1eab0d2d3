"""The index mesh over ranks (``core/mesh.py``'s rank backend, gloo on the
CPU): worlds of 2, 4 and 8 processes that ``launch/mesh.py::spawn_ranks``
starts, each holding its block of the mesh's devices and its share of
the ``DexState``.

* The 2x4 engine's ``fetch``, ``auto_tight`` and ``mixed_auto``
  configurations over 2, 4 and 8 ranks against the reference's saved
  arrays (``tests/torch_mesh_ref.py``'s ``engine`` group in a subprocess,
  started first so that it runs beside the worlds): every lane, every
  gathered plane after every batch and each rank's collective counts, bit
  for bit.
* A 1x4 mesh over 4 ranks (one memory column a rank: the disaggregated
  layout) and a 4x2 mesh over 2 ranks, both started from
  ``build_pool(columns=)`` and ``init_state(mesh=)``, on lookups,
  updates, inserts and scans, against the reference on those layouts
  (``tests/torch_mesh_ref_layouts.py`` in a second subprocess), bit for
  bit as the 2x4 cases, and against the port's virtual mesh.
* Against the port's virtual mesh, run here in the test's process: the
  2x4 ``scan_auto`` engine and the SMO round, ``run_smo`` and a scan
  across the split leaves over 4 ranks.
* The route replicas of each column are equal after writes and splits;
  ``psum`` of float32 counts near 2**24 is exact.
* The refusals: a world that does not divide the mesh, every path left to
  a later slice (entries 3 and 4 of ROADMAP.md's queue "Across ranks"),
  ``"nccl"`` on CPU tensors, and a rank that raises.

The pipeline and the fleet-cache policy over ranks are held to the
reference in ``tests/test_torch_pipeline.py`` and
``tests/test_torch_fleet_policy.py``, two route axes in
``tests/test_torch_route_axes.py``, beside those files' reference groups.

Each world runs all of its cases in one go (``tests/torch_rank_cases.py``,
which imports the port and numpy only), through a module-scoped fixture.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_rank_cases as C  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.launch.mesh import RankError, spawn_ranks  # noqa: E402
from repro_torch.obs.registry import STAT_OPS, STAT_SMO_SPLITS  # noqa: E402
from torch_mesh_group import MeshGroup  # noqa: E402

REF_CASES = ("fetch", "auto_tight", "mixed_auto")
#: each world's cases, run in one spawn; ``offload`` goes through
#: ``make_dex_lookup``
WORLDS = {
    2: REF_CASES + ("scan_fetch_4x2", "refusals"),
    4: REF_CASES + ("offload", "scan_auto", "scan_auto_1x4", "smo"),
    8: REF_CASES + ("reductions",),
}
VIRTUAL_CASES = [(4, "scan_auto"), (4, "scan_auto_1x4"), (2, "scan_fetch_4x2")]
#: the cases ``tests/torch_mesh_ref_layouts.py`` runs on the reference
LAYOUT_CASES = [(4, "scan_auto_1x4"), (2, "scan_fetch_4x2")]


@pytest.fixture(scope="module")
def mesh_group(tmp_path_factory):
    """The reference's ``engine`` group, started before the worlds."""
    with MeshGroup(tmp_path_factory) as group:
        yield group


@pytest.fixture(scope="module")
def layout_group(tmp_path_factory):
    """The reference on the 1x4 and 4x2 layouts, started before the worlds."""
    with MeshGroup(tmp_path_factory, script="torch_mesh_ref_layouts.py") as group:
        yield group


@pytest.fixture(scope="module")
def worlds(mesh_group, layout_group, tmp_path_factory):
    """``{P: [each rank's results]}`` of every world in ``WORLDS``."""
    return {
        p: spawn_ranks(C.world, p, "gloo", names, init=tmp_path_factory.mktemp(f"w{p}"))
        for p, names in WORLDS.items()
    }


@pytest.fixture(scope="module")
def mesh_ref(mesh_group, worlds):
    """The reference's arrays, read once the worlds, which run while the
    reference does, are done."""
    return mesh_group.arrays()


def test_rank_batches_are_the_reference_batches(mesh_ref):
    keys, vals = C.dataset()
    np.testing.assert_array_equal(mesh_ref["keys"], keys)
    np.testing.assert_array_equal(mesh_ref["values"], vals)
    for i, (opc, q, v) in enumerate(C.lookup_batches()):
        np.testing.assert_array_equal(mesh_ref[f"batch/{i}"], q)
    for tag, batches in (("mixed", C.mixed_batches()), ("scanmix", C.scan_batches())):
        for i, planes in enumerate(batches):
            for f, a in zip(("opcodes", "keys", "values"), planes):
                np.testing.assert_array_equal(mesh_ref[f"{tag}/{i}/{f}"], a)


@pytest.mark.parametrize(
    "p,name", [(p, n) for n in REF_CASES for p in sorted(WORLDS)] + [(4, "offload")]
)
def test_2x4_engine_on_ranks_matches_reference(worlds, mesh_ref, p, name):
    C.check_reference(worlds[p], mesh_ref, p, name)


@pytest.mark.parametrize("p,name", LAYOUT_CASES)
def test_layout_on_ranks_matches_reference(worlds, layout_group, p, name):
    """1x4 over 4 ranks and 4x2 over 2 ranks against the reference on the
    same layout, on the same scan batches as the 2x4 files replay."""
    ref = layout_group.arrays()
    batches = C.scan_batches()
    for i, planes in enumerate(batches):
        for f, a in zip(("opcodes", "keys", "values"), planes):
            np.testing.assert_array_equal(ref[f"scanmix/{i}/{f}"], a)
    assert set(np.concatenate([b[0] for b in batches])) == {0, 1, 2, 3}
    C.check_reference(worlds[p], ref, p, name)
    assert ref[f"{name}/{len(batches) - 1}/stats"][:, STAT_OPS].sum() > 0

@pytest.mark.parametrize("p,name", VIRTUAL_CASES)
def test_engine_on_ranks_matches_virtual_mesh(worlds, p, name):
    want = C.engine_case(name)
    got = C.merged(worlds[p], name)
    for q, r in enumerate(worlds[p]):
        for i, step in enumerate(r[name]["steps"]):
            assert step["counts"] == want["steps"][i]["counts"], (name, q, i)
    want.pop("replicas"), got.pop("replicas")
    C.equal(want, got, f"{p} ranks {name}")
    assert want["steps"][-1]["planes"]["stats"][:, STAT_OPS].sum() > 0


def test_smo_on_ranks_matches_virtual_mesh(worlds):
    """The 2x4 SMO case over 4 ranks: the insert burst, one round (its
    collective counts on every rank), ``run_smo`` and the scan across the
    split leaves, every lane and every gathered plane."""
    ranks = worlds[4]
    want = C.smo_case()
    got = dict(ranks[0]["smo"])
    for k in ("insert_status", "round_status", "run_status"):
        got[k] = C.rank_lanes(ranks, lambda r: r["smo"][k])
    got["scan"] = {k: C.rank_lanes(ranks, lambda r: r["smo"]["scan"][k]) for k in want["scan"]}
    for r in ranks:
        assert r["smo"]["round_counts"] == want["round_counts"]
        assert r["smo"]["run_rounds"] == want["run_rounds"]
    want.pop("replicas"), got.pop("replicas")
    C.equal(want, got, "4 ranks smo")
    assert (want["insert_status"] == 2).sum() > 0  # STATUS_SPLIT lanes
    assert want["run"]["stats"][:, STAT_SMO_SPLITS].sum() > 0


@pytest.mark.parametrize("p,name", [(2, "mixed_auto"), (4, "mixed_auto"),
                                    (8, "mixed_auto"), (4, "smo")])
def test_route_replicas_are_equal(worlds, p, name):
    """Every column's shard (pool rows, ``occupancy``, ``n_alloc``) is the
    same on every rank that holds it, after writes and splits."""
    by_col = {}
    for r in worlds[p]:
        for col, digest in r[name]["replicas"].items():
            by_col.setdefault(col, set()).add(digest)
    assert sorted(by_col) == [0, 1, 2, 3]
    assert all(len(d) == 1 for d in by_col.values()), by_col
    # each column on the ranks of both route rows
    assert sum(len(r[name]["replicas"]) for r in worlds[p]) == 8


def test_psum_of_float_counts_is_exact(worlds):
    """``psum`` over 8 ranks of float32 counts summing to just below 2**24,
    of int64 planes, and ``pmax`` of int32 planes: each rank's block equals
    the exact sum (maximum) of the gathered inputs, and the virtual mesh's."""
    ranks = worlds[8]
    red = {k: C.rank_lanes(ranks, lambda r: r["reductions"][k]) for k in ranks[0]["reductions"]}
    exact = red["f32"].astype(np.int64).sum(0)
    assert exact.max() == 2**24 - 8
    np.testing.assert_array_equal(red["psum_f32"], np.broadcast_to(exact, red["f32"].shape))
    np.testing.assert_array_equal(
        red["psum_i64"], np.broadcast_to(red["i64"].sum(0), red["i64"].shape)
    )
    np.testing.assert_array_equal(
        red["pmax_i32"], np.broadcast_to(red["i32"].max(0), red["i32"].shape)
    )
    virt = C.reductions()
    for k in ("psum_f32", "psum_i64", "pmax_i32"):
        np.testing.assert_array_equal(virt[k], red[k])


def test_out_of_scope_paths_raise_on_ranks(worlds):
    """The paths left to entries 3 (the route table, repartitioning, the
    separator planes) and 4 (the host drain) of ROADMAP.md's queue "Across
    ranks" raise, each naming its entry."""
    seen = worlds[2][0]["refusals"]
    refused = [m for m in seen if m.startswith("NotImplementedError")]
    assert len(refused) == 8
    entries = [m.rsplit("entry ", 1)[1].rstrip(")") for m in refused]
    assert entries == ["3"] * 6 + ["4"] * 2, refused
    for m in refused:
        assert 'ROADMAP.md, queue "Across ranks", entry' in m
    assert seen[-1] == "ValueError: 2 ranks do not divide the mesh's 3 devices"
    # every rank refuses the same
    assert worlds[2][1]["refusals"] == seen


def test_world_must_divide_the_mesh():
    cfg = C.config((2, 4))
    for world in (3, 5, 16):
        rm = t_mesh.RankMesh(None, world, 0, "gloo")
        with pytest.raises(ValueError):
            t_mesh.local_devices(cfg, rm)
    # a block that would straddle route rows
    with pytest.raises(ValueError, match="straddles"):
        t_mesh.local_devices(C.config((4, 3)), t_mesh.RankMesh(None, 6, 0, "gloo"))
    assert t_mesh.local_columns(cfg, t_mesh.RankMesh(None, 4, 3, "gloo")) == (2, 2)
    assert t_mesh.local_columns(cfg, t_mesh.RankMesh(None, 2, 1, "gloo")) == (0, 4)


def test_nccl_refuses_cpu_tensors(tmp_path):
    cfg = C.config((1, 1))
    x = torch.zeros((1, 1, 3), dtype=torch.int64)
    with t_mesh.use(t_mesh.RankMesh(None, 1, 0, "nccl")):
        with pytest.raises(ValueError, match="nccl"):
            t_mesh.a2a(x, cfg, cfg.memory_axis)
        with pytest.raises(ValueError, match="nccl"):
            t_mesh.psum(x)
        with pytest.raises(ValueError, match="nccl"):
            t_mesh.gather_route(x[0], cfg)
    assert t_mesh.current() is None
    with pytest.raises(ValueError):
        t_mesh.RankMesh(None, 1, 0, "mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            spawn_ranks(C.fail, 1, "nccl", init=tmp_path)


def test_a_failing_rank_fails_the_world(tmp_path):
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        spawn_ranks(C.fail, 2, "gloo", init=tmp_path)


def test_shard_state_equals_split_build():
    """``shard_state`` of the whole state and ``init_state(mesh=)`` over
    ``build_pool(columns=)`` give every rank the same planes, and the
    columns' pool rows are the whole build's."""
    keys, vals = C.dataset()
    for shape, world in (((2, 4), 4), ((2, 4), 8), ((4, 2), 2), ((1, 4), 4)):
        cfg = C.config(shape)
        whole, meta = t_pool.build_pool(
            keys, vals, level_m=1, fill=0.7, n_shards=cfg.n_memory, device="cpu"
        )
        state = t_dex.init_state(whole, meta, cfg, C.bounds(shape[0]), device="cpu")
        for rank in range(world):
            rm = t_mesh.RankMesh(None, world, rank, "gloo")
            a = t_dex.state_to_numpy(t_dex.shard_state(state, cfg, rm))
            part, _ = t_pool.build_pool(
                keys, vals, level_m=1, fill=0.7, n_shards=cfg.n_memory,
                columns=t_mesh.local_columns(cfg, rm), device="cpu",
            )
            b = t_dex.state_to_numpy(
                t_dex.init_state(part, meta, cfg, C.bounds(shape[0]), device="cpu", mesh=rm)
            )
            C.equal(a, b, f"{shape} rank {rank}/{world}")
            dl = cfg.n_devices // world
            assert a["stats"].shape[0] == dl and a["succ"].shape[0] == dl
            c0, n_cols = t_mesh.local_columns(cfg, rm)
            per = meta.n_subtrees_padded // cfg.n_memory
            np.testing.assert_array_equal(
                a["pool.pool_keys"], whole.pool_keys[c0 * per : (c0 + n_cols) * per]
            )
