"""The port's fleet-cache policy layer (``core/fleet_cache.py``) and the
engine's divergent paths against the reference, bit for bit on the CPU:

* ``divergent_policy``, ``is_uniform``, ``peeks_enabled``;
  ``leaf_admit`` on built inputs, salts whose ``evict_salt * phi64``
  product and whose sum wrap included; ``demand_boost``; ``peer_answer``;
  the per-device rank of the peek budget in ``cached_fetch_level``;
* a divergent engine at 1x1 (no peeks there: one column) on mixed traffic,
  every plane after every batch;
* at 2x4, the reference in a subprocess on a forced 8-device CPU mesh
  (``tests/torch_mesh_ref.py pipe divergent,divergent_pipe,uniform``):
  tests/mesh_check.py's divergent ``fetch`` engine over 6 hot lookup
  batches, every cached value poisoned and every version bumped, one more
  batch (every plane, peer hits before the poison and misses after, the
  collective counts equal to the uniform arm's); the uniform arm; and the
  divergent policy under the pipeline on hot lookups and updates;
* the same three cases over 4 gloo ranks (``launch/mesh.py::
  spawn_ranks``, the world started beside the reference's subprocess),
  every lane, gathered plane and rank's counts against the reference's
  arrays; a poisoned, version-bumped row on one rank's devices failing
  the peeks another rank's devices send; and the telemetry plane over the
  ranks (snapshots, the timeline's summary and trace export, the latency
  ledger's conservation) against the virtual mesh's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as ref_dex  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import fleet_cache as ref_fc  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import fleet_cache as t_fc  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from test_engine import _dataset, _mixed_batches  # noqa: E402
from test_torch_pipeline import (  # noqa: E402
    _assert_state_equal,
    _flat,
    planes,
)
import torch_rank_cases as C  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from torch_mesh_group import MeshGroup  # noqa: E402

#: the reference runs its jnp kernels (``repro/kernels/ref.py``), bit for bit
#: its Pallas ones (``tests/test_kernels.py``), which hold the port's kernels in
#: ``tests/test_torch_{kernels,write,scan,smo}.py``: interpret mode's trace and
#: compile were most of a reference run's time
PLAIN = dict(use_kernel=False)

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
RESULTS = ("found", "values", "status", "shed")
DIV_OPS = ("lookup", "update")
I64 = np.iinfo(np.int64)


def _cfgs(**kw):
    base = dict(n_route=2, n_memory=4, cache_sets=64, cache_ways=4, policy="fetch")
    base.update(kw)
    return ref_dex.DexMeshConfig(**base), t_dex.DexMeshConfig(**base)


def _policies(cfg, t_cfg):
    """(name, reference policy, port policy) pairs."""
    out = [("none", None, None)]
    for name, kw in (
        ("divergent", {}),
        ("divergent_wide", dict(col_affinity=8.0, demand_beta=3.0, peek_budget=0)),
        ("divergent_flat", dict(col_affinity=1.0, demand_beta=1.0, peek_budget=5)),
    ):
        out.append((name, ref_fc.divergent_policy(cfg, **kw),
                    t_fc.divergent_policy(t_cfg, **kw)))
    u, tu = ref_fc.uniform_policy(cfg), t_fc.uniform_policy(t_cfg)
    out.append(("uniform", u, tu))
    out.append(("uniform_peek", u._replace(peek_budget=np.full(8, 3, np.int32)),
                tu._replace(peek_budget=np.full(8, 3, np.int32))))
    out.append(("uniform_beta", u._replace(demand_beta=2.0), tu._replace(demand_beta=2.0)))
    return out


def test_policies_match_reference():
    cfg, t_cfg = _cfgs()
    for name, pol, t_pol in _policies(cfg, t_cfg):
        assert t_fc.is_uniform(t_pol) == ref_fc.is_uniform(pol), name
        assert t_fc.peeks_enabled(t_pol) == ref_fc.peeks_enabled(pol), name
        if pol is None:
            continue
        for f in ("admit_bias", "evict_salt", "peek_budget"):
            a, b = np.asarray(getattr(pol, f)), np.asarray(getattr(t_pol, f))
            assert a.dtype == b.dtype, (name, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {f}")
        assert float(pol.demand_beta) == float(t_pol.demand_beta), name
    # a uniform policy with a peek budget still peeks
    u = t_fc.uniform_policy(t_cfg)._replace(peek_budget=np.ones(8, np.int32))
    assert t_fc.is_uniform(u) and t_fc.peeks_enabled(u)


def test_wrapping_add_wraps_like_int64():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.integers(I64.min, I64.max, 500, dtype=np.int64),
                        [I64.max, I64.min, -1, 0, 1, I64.max, I64.min]])
    c = np.concatenate([rng.integers(I64.min, I64.max, 500, dtype=np.int64),
                        [I64.max, I64.min, I64.min, I64.max, I64.max, 1, -1]])
    want = [((int(x) + int(y) + 2**63) % 2**64) - 2**63 for x, y in zip(a, c)]
    got = t_fc.wrapping_add(torch.from_numpy(a), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.int64))


def _meta_2x4():
    keys = _dataset(6000, seed=3)
    pool, meta = ref_pool.build_pool(keys, keys * 7, level_m=1, fill=0.7, n_shards=4)
    t_pool_, t_meta = t_pool.build_pool(keys, keys * 7, level_m=1, fill=0.7, n_shards=4,
                                        device="cpu")
    return keys, pool, meta, t_pool_, t_meta


@pytest.mark.parametrize("salt_kind", ["ops", "large"])
def test_leaf_admit_matches_reference(salt_kind):
    """Every device's dice on gids over all four columns, with and without
    a demand boost.  ``divergent_policy``'s salts 2..8 overflow the product;
    a policy with salts near the int64 range wraps the sum too."""
    _, _, meta, _, t_meta = _meta_2x4()
    cfg, t_cfg = _cfgs(p_admit_leaf_pct=37)
    rng = np.random.default_rng(7 if salt_kind == "ops" else 8)
    n = 400
    gid = rng.integers(0, t_meta.n_nodes, n).astype(np.int64)
    if salt_kind == "ops":
        salt = rng.integers(0, 5_000_000, n).astype(np.int64)
    else:
        salt = rng.integers(2**62, I64.max, n).astype(np.int64)
    pols = [p for p in _policies(cfg, t_cfg) if p[0] != "none"]
    big = np.array([I64.max, I64.min + 3, -1, 2**62 + 5, 3, -(2**61), 12345, 0], np.int64)
    pols.append(("salted", pols[0][1]._replace(evict_salt=big),
                 pols[0][2]._replace(evict_salt=big)))
    boosts = (None, np.array([0.5, 1.0, 1.25, 2.0, 0.75, 1.5, 0.6, 1.9], np.float32))
    for name, pol, t_pol in pols:
        for boost in boosts:
            got = t_fc.leaf_admit(
                t_meta, t_cfg, t_pol,
                torch.from_numpy(gid)[None].expand(8, n).contiguous(),
                torch.from_numpy(salt)[None],
                boost=None if boost is None else torch.from_numpy(boost),
            ).numpy()
            for d in range(8):
                want = ref_fc.leaf_admit(
                    meta, cfg, pol, jnp.asarray(gid), jnp.asarray(salt),
                    dev=jnp.int32(d),
                    boost=None if boost is None else jnp.float32(boost[d]),
                )
                np.testing.assert_array_equal(np.asarray(want), got[d],
                                              err_msg=f"{name} boost {boost} dev {d}")


def test_demand_boost_matches_reference():
    cfg, t_cfg = _cfgs()
    rng = np.random.default_rng(9)
    demands = [np.zeros((8, 2), np.int64), rng.integers(0, 10**6, (8, 2)),
               rng.integers(0, 3, (8, 2)), np.array([[7, 0]] * 8),
               rng.integers(0, 2**40, (8, 2))]
    r_lin = t_mesh.route_linear_index(t_cfg, "cpu")
    assert r_lin.tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    for name, pol, t_pol in _policies(cfg, t_cfg):
        for dem in demands:
            dem = np.asarray(dem, np.int64)
            got = t_fc.demand_boost(t_pol, t_cfg, torch.from_numpy(dem), r_lin)
            for d in range(8):
                want = ref_fc.demand_boost(pol, cfg, jnp.asarray(dem[d : d + 1]),
                                           jnp.int32(d // 4))
                if want is None:
                    assert got is None, name
                    continue
                assert float(np.asarray(want)) == float(got[d]), (name, d, dem[d])
                assert got.dtype == torch.float32


def test_peer_answer_matches_reference():
    """Each device probes its own cache: fresh rows answer (found or not),
    stale, absent and unwanted ones do not."""
    cfg, t_cfg = _cfgs(cache_sets=16)
    rng = np.random.default_rng(11)
    n_nodes = 300
    cache = ref_fc.init_cache(cfg)
    tags = np.full((8, 16, 4), -1, np.int64)
    ver = rng.integers(0, 3, (8, 16, 4)).astype(np.int32)
    keys = np.sort(rng.integers(-1000, 1000, (8, 16, 4, 64)), -1).astype(np.int64)
    vals = rng.integers(-(2**40), 2**40, (8, 16, 4, 64)).astype(np.int64)
    versions = rng.integers(0, 3, (8, n_nodes)).astype(np.int32)
    import repro.core.routing as ref_routing

    cached = rng.choice(n_nodes, size=40, replace=False)
    for d in range(8):
        sets = np.asarray(ref_routing.hash64(jnp.asarray(cached)) % np.uint64(16))
        for j, (g, s) in enumerate(zip(cached, sets)):
            tags[d, int(s), j % 4] = g
    cache = cache._replace(tags=jnp.asarray(tags), ver=jnp.asarray(ver),
                           keys=jnp.asarray(keys), values=jnp.asarray(vals))
    t_cache = t_fc.DexCache(*(torch.from_numpy(np.array(a)) for a in cache))
    gid = rng.choice(np.concatenate([cached, rng.integers(0, n_nodes, 40)]), (8, 200))
    key = np.where(rng.random((8, 200)) < 0.5,
                   keys[0].reshape(-1)[rng.integers(0, 16 * 4 * 64, (8, 200))],
                   rng.integers(-1000, 1000, (8, 200)))
    want = rng.random((8, 200)) < 0.8
    got = t_fc.peer_answer(t_cache, t_cfg, torch.from_numpy(versions),
                           torch.from_numpy(gid), torch.from_numpy(key),
                           torch.from_numpy(want))
    for d in range(8):
        c_d = jax.tree.map(lambda a: a[d : d + 1], cache)
        ref = ref_fc.peer_answer(c_d, cfg, jnp.asarray(versions[d]), jnp.asarray(gid[d]),
                                 jnp.asarray(key[d]), jnp.asarray(want[d]))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), g[d].numpy(), err_msg=f"dev {d}")
    assert got[0].any() and not got[0].all()


def test_peek_budget_ranks_each_devices_own_lanes():
    """``cached_fetch_level``: device d peeks its first ``budget[d]``
    eligible misses in its own lane order, and fetches the rest."""
    keys, _, _, t_pool_, t_meta = _meta_2x4()
    _, t_cfg = _cfgs()
    state = t_dex.init_state(t_pool_, t_meta, t_cfg,
                             np.array([KEY_MIN, keys[3000], KEY_MAX]), device="cpu")
    rng = np.random.default_rng(13)
    gid = torch.from_numpy(rng.integers(0, t_meta.n_nodes, (8, 64)))
    want = torch.from_numpy(rng.random((8, 64)) < 0.9)
    elig = torch.from_numpy(rng.random((8, 64)) < 0.5)
    budget = torch.tensor([0, 1, 2, 3, 5, 8, 64, 7], dtype=torch.int32)
    out = t_fc.cached_fetch_level(state.pool, t_meta, t_cfg, state.cache, state.versions,
                                  gid, want, torch.ones_like(want), elig, budget)
    peeked, miss = out[8], out[4]
    for d in range(8):
        cand = np.flatnonzero((miss & elig)[d].numpy())
        np.testing.assert_array_equal(np.flatnonzero(peeked[d].numpy()),
                                      cand[: int(budget[d])], err_msg=f"dev {d}")
    assert (out[0][peeked] == KEY_MAX).all()


def test_divergent_engine_1x1_matches_reference():
    """The divergent policy at 1x1 (its bias, salt and demand boost; one
    column, so no peek) on tests/test_engine.py's mixed traffic: every
    result and plane after each batch."""
    keys = _dataset(4000, seed=35)
    pool, meta = ref_pool.build_pool(keys, keys * 5, level_m=1, fill=0.7, n_shards=1)
    _, t_meta = t_pool.build_pool(keys, keys * 5, level_m=1, fill=0.7, device="cpu")
    kw = dict(n_route=1, n_memory=1, cache_sets=128, cache_ways=4, p_admit_leaf_pct=30,
              route_capacity_factor=2.0, policy="fetch")
    cfg, t_cfg = ref_dex.DexMeshConfig(**kw), t_dex.DexMeshConfig(**kw)
    state = ref_dex.init_state(pool, meta, cfg, np.array([KEY_MIN, KEY_MAX]))
    t_state = t_dex.state_from_numpy(_flat(state), t_meta, t_cfg, "cpu")
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    ops = ("lookup", "update", "insert")
    eng = jax.jit(ref_engine.make_dex_engine(
        meta, cfg, mesh, ops=ops, max_count=1,
        cache_policy=ref_fc.divergent_policy(cfg, col_affinity=2.0), **PLAIN,
    ))
    t_eng = t_engine.make_dex_engine(
        t_meta, t_cfg, ops=ops, max_count=1,
        cache_policy=t_fc.divergent_policy(t_cfg, col_affinity=2.0), device="cpu",
    )
    for i, (opc, kk, vv) in enumerate(
        _mixed_batches(keys, np.random.default_rng(36), 3, 256, hot=keys[40:48])
    ):
        state, r = eng(state, *map(jnp.asarray, (opc, kk, vv)))
        t_state, tr = t_eng(t_state, opc, kk, vv)
        for k in RESULTS:
            np.testing.assert_array_equal(np.asarray(getattr(r, k)), getattr(tr, k).numpy(),
                                          err_msg=f"{i} {k}")
        _assert_state_equal(_flat(state), t_state, f"batch {i}")
    assert t_state.stats.numpy()[:, t_registry.STAT_HITS].sum() > 0


@pytest.fixture(scope="module")
def div_group(tmp_path_factory):
    """The reference's ``pipe`` group over its fleet-cache cases, run once
    for the module (``tests/torch_mesh_group.py``)."""
    with MeshGroup(tmp_path_factory, "pipe", "divergent,divergent_pipe,uniform") as group:
        yield group


#: the world of gloo ranks the 2x4 fleet-cache cases run on (2 devices a
#: rank: route row 0 is ranks 0 and 1)
DIV_WORLD = 4
RANK_CASES = ("divergent", "uniform", "divergent_pipe", "peek_poison")


@pytest.fixture(scope="module")
def div_ranks(div_group, tmp_path_factory):
    """``(each rank's results, the folder of their trace files)`` of
    ``RANK_CASES`` over ``DIV_WORLD`` ranks (``tests/torch_rank_cases.py``),
    run while the reference's group runs."""
    out = tmp_path_factory.mktemp("div_traces")
    ranks = spawn_ranks(C.world, DIV_WORLD, "gloo", RANK_CASES, str(out),
                        init=tmp_path_factory.mktemp("div_ranks"))
    return ranks, out


@pytest.fixture(scope="module")
def div_virtual(tmp_path_factory):
    """The virtual mesh's runs of the rank cases the ranks are held to
    (``peek_poison``, and the telemetry of ``divergent`` and
    ``divergent_pipe``), each once, on one torch thread: the cases' small
    ops run faster on one thread than on many beside the other test
    workers."""
    out = tmp_path_factory.mktemp("div_virtual")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"peek_poison": C.div_case("peek_poison"),
                "divergent": C.div_case("divergent", str(out)),
                "divergent_pipe": C.pipe_case("divergent_pipe", str(out))}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def div_ref(div_group, div_ranks):
    """The reference's arrays, read once the ranks are done."""
    return div_group.arrays()


def _div_setup(arrays):
    keys, vals = arrays["keys"], arrays["values"]
    _, t_meta = t_pool.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4,
                                  device="cpu")
    t_cfg = t_dex.DexMeshConfig(n_route=2, n_memory=4, cache_sets=128, cache_ways=4,
                                policy="fetch", p_admit_leaf_pct=50,
                                route_capacity_factor=4.0)
    return t_meta, t_cfg


@pytest.mark.parametrize("arm", ["divergent", "uniform"])
def test_fleet_cache_2x4_matches_reference(div_ref, arm):
    """tests/mesh_check.py's cooperative fleet caching: 6 hot lookup
    batches, every cached value poisoned and every version bumped, one more
    batch; every lane equals the keys' values, every plane the reference's.
    The divergent arm peeks: peer hits before the poison and peer misses in
    the batch after it; both arms count the same collectives."""
    arrays = div_ref
    t_meta, t_cfg = _div_setup(arrays)
    policy = t_fc.divergent_policy(t_cfg, peek_budget=512) if arm == "divergent" else None
    eng = t_engine.make_dex_engine(t_meta, t_cfg, ops=DIV_OPS, max_count=1,
                                   cache_policy=policy, device="cpu")
    state = t_dex.state_from_numpy(planes(arrays, f"{arm}/init/"), t_meta, t_cfg, "cpu")
    n = sum(1 for k in arrays if k.startswith("div/") and k.endswith("/keys"))
    counts = arrays[f"{arm}/counts"].tolist()
    assert counts == arrays["uniform/counts"].tolist()
    peer = []
    for i in range(n):
        opc, kk, vv = (arrays[f"div/{i}/{f}"] for f in ("opcodes", "keys", "values"))
        if i == n - 1:
            state.cache.values.fill_(-777_777)
            state = state._replace(versions=t_fc.invalidate_nodes(
                state.versions, torch.arange(t_meta.n_nodes)))
            _assert_state_equal(planes(arrays, f"{arm}/poisoned/"), state, "poisoned")
        before = state.stats.numpy().sum(0)
        t_mesh.reset_counts()
        state, r = eng(state, opc, kk, vv)
        assert t_mesh.collective_counts() == {"all_to_all": counts[0],
                                              "route_exchange": counts[1]}
        delta = state.stats.numpy().sum(0) - before
        peer.append((delta[t_registry.STAT_PEER_HITS], delta[t_registry.STAT_PEER_MISSES]))
        assert r.found.all() and torch.equal(r.values, torch.from_numpy(kk * 7)), i
        want = planes(arrays, f"{arm}/{i}/")
        for k in RESULTS:
            np.testing.assert_array_equal(want.pop(f"result.{k}"), getattr(r, k).numpy(),
                                          err_msg=f"{arm} {i} {k}")
        _assert_state_equal(want, state, f"{arm} batch {i}")
    if arm == "divergent":
        assert peer[n - 2][0] > 0 and peer[n - 1][1] > 0, peer
    else:
        assert all(h == 0 and m == 0 for h, m in peer)


def test_divergent_pipeline_2x4_matches_reference(div_ref):
    """The divergent policy under the pipeline on hot lookups and updates:
    every result and plane after each push and the drain, the counts of a
    step by phase; stale lanes forced and peers asked."""
    arrays = div_ref
    t_meta, t_cfg = _div_setup(arrays)
    pipe = t_engine.make_dex_engine(
        t_meta, t_cfg, ops=DIV_OPS, max_count=1, pipeline=True,
        cache_policy=t_fc.divergent_policy(t_cfg, peek_budget=512), device="cpu",
    )
    name = "divergent_pipe"
    n = sum(1 for k in arrays if k.startswith(f"{name}/") and k.endswith("/keys")
            and k.count("/") == 2)
    pipe.start(t_dex.state_from_numpy(planes(arrays, f"{name}/init/"), t_meta, t_cfg,
                                      "cpu"))
    counts = arrays[f"{name}/phase_counts"]
    for i in range(n + 1):
        t_mesh.reset_counts()
        if i < n:
            r = pipe.push(*(arrays[f"{name}/{i}/{f}"] for f in ("opcodes", "keys", "values")))
        else:
            r = pipe.drain()
        if i == 1:
            got = t_mesh.collective_counts(by_phase=True)
            assert [got["all_to_all"], got["route_exchange"]] == counts[0].tolist()
            for j, ph in enumerate(("pipe/front", "pipe/back")):
                per = got["phases"][ph]
                assert [per["all_to_all"], per["route_exchange"]] == counts[j + 1].tolist()
        want = planes(arrays, f"{name}/pipe/{i}/")
        assert (r is None) == ("result.found" not in want), i
        for k in RESULTS if r is not None else ():
            np.testing.assert_array_equal(want.pop(f"result.{k}"), getattr(r, k).numpy(),
                                          err_msg=f"push {i} {k}")
        _assert_state_equal(want, pipe.state, f"push {i}")
    stats = pipe.state.stats.numpy().sum(0)
    assert stats[t_registry.STAT_PIPE_STALLS] > 0
    assert stats[t_registry.STAT_PEER_HITS] + stats[t_registry.STAT_PEER_MISSES] > 0


@pytest.mark.parametrize("arm", ["divergent", "uniform"])
def test_fleet_cache_2x4_on_ranks_matches_reference(div_ref, div_ranks, arm):
    """The fleet-cache arms over 4 gloo ranks against the reference's
    arrays: the batches, the initial and the poisoned planes, every batch's
    lanes and gathered planes, each rank's counts; the divergent arm's
    peeks cross ranks (devices 2 and 3, rank 1, peek leaves of columns 0
    and 1, rank 0's) and land as peer hits before the poison and peer
    misses after it."""
    ranks, _ = div_ranks
    for i, planes_ in enumerate(C.div_batches(C.DIV_WARM + 1, mixed=False)):
        for f, a in zip(("opcodes", "keys", "values"), planes_):
            np.testing.assert_array_equal(div_ref[f"div/{i}/{f}"], a)
    C.check_reference(ranks, div_ref, DIV_WORLD, arm)
    c = div_ref[f"{arm}/counts"]
    for r in ranks:  # registry.collectives_per_batch on every rank
        assert r[arm]["collectives"] == {"all_to_all": c[0], "route_exchange": c[1]}
    C.equal(C.prefixed(div_ref, f"{arm}/poisoned/"), ranks[0][arm]["poisoned"], arm)
    peer = [C.rank_lanes(ranks, lambda r: r[arm]["steps"][i]["peer"])
            for i in range(C.DIV_WARM + 1)]
    if arm == "divergent":
        assert peer[-2][:, 0].sum() > 0 and peer[-1][:, 1].sum() > 0
    else:
        assert all(not p.any() for p in peer)


def test_divergent_pipeline_2x4_on_ranks_matches_reference(div_ref, div_ranks):
    """The divergent pipeline over 4 gloo ranks against the reference's
    ``divergent_pipe`` arrays: every push's and the drain's lanes and
    gathered planes, each rank's counts of every step by phase."""
    ranks, _ = div_ranks
    C.check_pipeline(ranks, div_ref, DIV_WORLD, "divergent_pipe")
    stats = ranks[0]["divergent_pipe"]["steps"][-1]["planes"]["stats"]
    assert stats[:, t_registry.STAT_PIPE_STALLS].sum() > 0
    assert stats[:, [t_registry.STAT_PEER_HITS, t_registry.STAT_PEER_MISSES]].sum() > 0


def test_poisoned_peer_row_fails_the_peek_across_ranks(div_ranks, div_virtual):
    """tests/mesh_check.py's peer-peek version check across ranks: after 6
    warm batches, the cached rows of devices 0 and 1 (rank 0) are poisoned
    and their nodes' versions bumped; a ``peer_answer`` probe of those rows
    hits before and never after; in the next batch the peeks that devices
    2 and 3 (rank 1) send them fail the version check and count as peer
    misses, and every lane still reads its key's value.  Lanes, planes,
    counts and peer counts equal the virtual mesh's."""
    ranks, _ = div_ranks
    want = div_virtual["peek_poison"]
    got = C.merged(ranks, "peek_poison")
    for i, step in enumerate(want["steps"]):
        for q, r in enumerate(ranks):
            assert r["peek_poison"]["steps"][i]["counts"] == step["counts"], (i, q)
        C.equal(step["result"], got["steps"][i]["result"], f"batch {i}")
        C.equal(step["planes"], got["steps"][i]["planes"], f"batch {i} planes")
        C.equal(step["peer"], C.rank_lanes(
            ranks, lambda r: r["peek_poison"]["steps"][i]["peer"]), f"batch {i} peer")
    C.equal(want["poisoned"], got["poisoned"], "poisoned")
    for r in ranks:
        assert r["peek_poison"]["probe_fresh"] == want["probe_fresh"]
        assert r["peek_poison"]["probe_stale"] == want["probe_stale"]
    fresh_hits, rows = want["probe_fresh"]
    stale_hits, stale_rows = want["probe_stale"]
    assert rows > 0 and fresh_hits > 0 and stale_hits == 0 and stale_rows == rows
    peer_before, peer_after = (C.rank_lanes(
        ranks, lambda r: r["peek_poison"]["steps"][i]["peer"]) for i in (-2, -1))
    senders = [d for d in range(8) if d // 2 == 1]  # rank 1's devices
    assert peer_after[senders, 1].sum() > peer_before[senders, 1].sum()
    keys = C.div_batches(C.DIV_WARM + 1, mixed=False)[-1][1]
    last = got["steps"][-1]["result"]
    assert last["found"].all() and (last["values"] == keys * 7).all()


def _untimed(events):
    """Trace events without their timestamps and durations."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


@pytest.mark.parametrize("name", ["divergent", "divergent_pipe"])
def test_telemetry_on_ranks_matches_virtual_mesh(div_ranks, div_virtual, name):
    """The telemetry plane over 4 ranks: each step's fleet snapshot
    (``registry.snapshot``, gathered over the ranks), the timeline's
    ``summary()`` and trace export are equal on every rank; the counters,
    latency ledger, cost audit, batches and phases equal the virtual
    mesh's; the ledger holds as many lanes as the ops counted (the
    pipeline's after the drain); only rank 0 wrote its trace file."""
    import json

    ranks, folder = div_ranks
    want = div_virtual[name]
    mine = [r[name] for r in ranks]
    for q, r in enumerate(mine):
        C.equal(mine[0]["summary"], r["summary"], f"rank {q} summary")
        C.equal(mine[0]["trace"], r["trace"], f"rank {q} trace")
        assert r["ledger"] == want["ledger"], q
        assert r["ledger"]["hist"] == r["ledger"]["ops"] > 0
        for i, step in enumerate(want["steps"]):
            if "snapshot" in step:
                C.equal(step["snapshot"], r["steps"][i]["snapshot"], f"rank {q} snap {i}")
    ws, gs = want["summary"], mine[0]["summary"]
    for k in ("counters", "latency", "cost_audit", "n_batches", "retry_latency"):
        C.equal(ws.get(k), gs.get(k), k)
    assert {k: v["count"] for k, v in ws["phases"].items()} == {
        k: v["count"] for k, v in gs["phases"].items()}
    C.equal(_untimed(want["trace"]["traceEvents"]),
            _untimed(mine[0]["trace"]["traceEvents"]), "trace")
    files = sorted(p.name for p in folder.glob(f"{name}_trace*.json"))
    assert files == [f"{name}_trace0.json"]
    with open(folder / files[0]) as f:
        assert json.load(f) == json.loads(json.dumps(mine[0]["trace"]))
