"""The cases of ``tests/test_torch_ranks.py``, run on the port's virtual
mesh in the test's process or on a world of ranks that
``repro_torch.launch.mesh.spawn_ranks`` starts.  This module imports the
port and numpy only, so a rank never loads JAX.

The data and batches are those of ``tests/torch_mesh_ref.py`` (the same
seeds and the same steps), rebuilt here; the test holds them equal to the
arrays the reference saved.  A case returns, for each step, the lane
results (a rank's own lanes; concatenated in rank order they are the
batch's lanes), the collective counts, and the state planes: the whole
state on the virtual mesh, the state gathered on rank 0
(``core/dex.py::gather_state``, which also checks the route replicas bit
for bit) on ranks.
"""

import numpy as np
import torch

from repro_torch.core import dex, engine, mesh, pool, smo, write
from repro_torch.core.nodes import KEY_MAX, KEY_MIN
from repro_torch.core.scan import make_dex_scan

N_KEYS = 6000
LANES = 512
BATCHES = 3
MIXED_OPS = ("lookup", "update", "insert")
SCAN_MAX_COUNT = 32
RESULTS = ("found", "values", "status", "shed")
SCAN_RESULTS = RESULTS + ("scan_keys", "scan_values", "taken")
SMO_LEAVES = (3, 20, 45, 77, 120)

#: name: ((n_route, n_memory), policy, route_capacity_factor, ops, traffic)
CASES = {
    "fetch": ((2, 4), "fetch", 4.0, ("lookup",), "lookup"),
    "auto_tight": ((2, 4), "auto", 0.75, ("lookup",), "lookup"),
    # through the make_dex_lookup wrapper (found, values, shed)
    "offload": ((2, 4), "offload", 4.0, ("lookup",), "lookup"),
    "mixed_auto": ((2, 4), "auto", 4.0, MIXED_OPS, "mixed"),
    "scan_auto": ((2, 4), "auto", 4.0, engine.ALL_OPS, "scan"),
    # one memory column a rank at four ranks: the disaggregated layout
    "scan_auto_1x4": ((1, 4), "auto", 4.0, engine.ALL_OPS, "scan"),
    "scan_fetch_4x2": ((4, 2), "fetch", 4.0, engine.ALL_OPS, "scan"),
}


def dataset():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(300_000, size=N_KEYS, replace=False).astype(np.int64))
    return keys + 1, (keys + 1) * 7


def lookup_batches():
    keys, _ = dataset()
    rng = np.random.default_rng(1)
    out = []
    for _ in range(BATCHES):
        q = rng.choice(keys, size=LANES).astype(np.int64)
        q[::13] += 1
        q[::29] = KEY_MAX
        out.append((np.zeros(q.shape, np.int32), q, np.zeros(q.shape, np.int64)))
    return out


def _write_batches(seed, n_ops, scans):
    keys, _ = dataset()
    hot = keys[40:48]
    rng = np.random.default_rng(seed)
    out = []
    for bi in range(BATCHES):
        opc = rng.integers(0, n_ops, size=LANES).astype(np.int32)
        kk = rng.choice(keys, size=LANES).astype(np.int64)
        ins = opc == engine.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=LANES)
        ok = ~np.isin(fresh, keys)
        kk[ins & ok] = fresh[ins & ok]
        vals = np.where(opc == engine.OP_UPDATE, kk ^ 0x5A5A, kk * 7)
        if scans:
            scn = opc == engine.OP_SCAN
            vals[scn] = rng.integers(1, SCAN_MAX_COUNT + 9, size=int(scn.sum()))
            kk[scn & (rng.random(LANES) < 0.25)] += 1
            opc[:8] = engine.OP_SCAN if bi % 2 else engine.OP_UPDATE
            vals[:8] = 8 if bi % 2 else hot ^ (100 + bi)
        else:
            opc[:8] = engine.OP_LOOKUP if bi % 2 else engine.OP_UPDATE
            vals[:8] = hot ^ (100 + bi)
        kk[:8] = hot
        if bi == 1:
            opc[8:38] = engine.OP_INSERT
            kk[8:38] = keys[1980:2010] + 1
        kk[::29] = KEY_MAX
        out.append((opc, kk, vals.astype(np.int64)))
    return out


def mixed_batches():
    return _write_batches(2, 3, scans=False)


def scan_batches():
    return _write_batches(3, 4, scans=True)


def smo_burst():
    keys, _ = dataset()
    rng = np.random.default_rng(4)
    burst = []
    for leaf in SMO_LEAVES:
        lo, hi = keys[leaf * 44], keys[leaf * 44 + 43]
        cand = np.setdiff1d(np.arange(lo + 1, hi), keys)
        burst.append(rng.choice(cand, size=30, replace=False))
    kk = np.full(LANES, KEY_MAX, np.int64)
    kk[:150] = np.concatenate(burst)
    kk[150:152] = kk[10:12]
    fresh = rng.choice(keys, size=200) + 1
    kk[200:400] = np.where(np.isin(fresh, keys), KEY_MAX, fresh)
    vals = np.where(kk != KEY_MAX, kk * 3 + np.arange(LANES), 0)
    return kk, vals.astype(np.int64)


TRAFFIC = {"lookup": lookup_batches, "mixed": mixed_batches, "scan": scan_batches}


def config(shape, policy="fetch", factor=4.0):
    nr, nm = shape
    return dex.DexMeshConfig(
        n_route=nr, n_memory=nm, cache_sets=64, cache_ways=4, policy=policy,
        route_capacity_factor=factor,
    )


def bounds(n_route):
    inner = [300_000 * i // n_route for i in range(1, n_route)]
    return np.array([KEY_MIN] + inner + [KEY_MAX], np.int64)


def lanes(x):
    """This process's lanes of a batch: all of it on the virtual mesh, the
    rank's block of devices' lanes on ranks."""
    rm = mesh.current()
    if rm is None:
        return x
    w = len(x) // rm.world
    return x[rm.rank * w : (rm.rank + 1) * w]


def _fresh_state(cfg, *, split_build=False):
    """The case's initial state: the whole state on the virtual mesh; on
    ranks, ``shard_state`` of the whole state or, with ``split_build``,
    ``init_state(mesh=)`` over the rank's columns of the pool only."""
    keys, vals = dataset()
    rm = mesh.current()
    b = bounds(cfg.n_route)
    if rm is not None and split_build:
        cols = mesh.local_columns(cfg)
        p, meta = pool.build_pool(
            keys, vals, level_m=1, fill=0.7, n_shards=cfg.n_memory, columns=cols,
            device="cpu",
        )
        return dex.init_state(p, meta, cfg, b, device="cpu", mesh=rm), meta
    p, meta = pool.build_pool(
        keys, vals, level_m=1, fill=0.7, n_shards=cfg.n_memory, device="cpu"
    )
    state = dex.init_state(p, meta, cfg, b, device="cpu")
    if rm is not None:
        state = dex.shard_state(state, cfg, rm)
    return state, meta


def planes(state, meta, cfg):
    """The whole state's planes as numpy (gathered to rank 0 on ranks;
    None on the other ranks)."""
    rm = mesh.current()
    if rm is not None:
        state = dex.gather_state(state, cfg, rm)
        if state is None:
            return None
    return dex.state_to_numpy(state)


def replicas(state, cfg):
    """``{column: digest}`` of the column's shard as this process holds it
    (its pool rows, ``occupancy`` and ``n_alloc``), so that the route
    replicas of a column, held by different ranks, can be compared."""
    import hashlib

    c0, n_cols = mesh.local_columns(cfg)
    out = {}
    for j in range(n_cols):
        h = hashlib.sha256()
        for t in (*state.pool[2:], state.occupancy, state.n_alloc):
            per = t.shape[0] // n_cols
            h.update(t[j * per : (j + 1) * per].contiguous().numpy().tobytes())
        out[c0 + j] = h.hexdigest()
    return out


def _results(res, names):
    return {k: getattr(res, k).numpy().copy() for k in names}


def engine_case(name):
    shape, policy, factor, ops, traffic = CASES[name]
    cfg = config(shape, policy, factor)
    state, meta = _fresh_state(cfg, split_build=shape != (2, 4))
    kw = dict(max_count=SCAN_MAX_COUNT) if "scan" in ops else {}
    if name == "offload":
        lookup = dex.make_dex_lookup(meta, cfg, device="cpu")

        def eng(state, opc, kk, vv):
            state, found, values, shed = lookup(state, kk)
            return state, {"found": found, "values": values, "shed": shed}
    else:
        eng = engine.make_dex_engine(meta, cfg, ops=ops, device="cpu", **kw)
    names = SCAN_RESULTS if "scan" in ops else RESULTS
    out = {"init": planes(state, meta, cfg), "steps": []}
    for opc, kk, vv in TRAFFIC[traffic]():
        mesh.reset_counts()
        state, res = eng(state, lanes(opc), lanes(kk), lanes(vv))
        if isinstance(res, dict):
            res = {k: t.numpy().copy() for k, t in res.items()}
        else:
            res = _results(res, names)
        out["steps"].append(
            {
                "counts": mesh.collective_counts(),
                "result": res,
                "planes": planes(state, meta, cfg),
            }
        )
    out["replicas"] = replicas(state, cfg)
    return out


def smo_case():
    """tests/torch_mesh_ref.py's ``smo`` case at 2x4: an insert burst that
    overflows five leaves, one SMO round, ``run_smo`` for the rest, then a
    scan across the split leaves (``make_dex_scan``)."""
    cfg = config((2, 4), "fetch", 4.0)
    state, meta = _fresh_state(cfg)
    insert = write.make_dex_insert(meta, cfg, device="cpu")
    round_ = smo.make_dex_smo(meta, cfg, device="cpu")
    scan = make_dex_scan(meta, cfg, max_count=64, device="cpu")
    kk, vv = smo_burst()
    out = {}
    state, st = insert(state, lanes(kk), lanes(vv))
    out["insert_status"] = st.numpy().copy()
    out["insert"] = planes(state, meta, cfg)
    # the shed lanes of the whole batch, each rank keeping its own
    shed = np.concatenate(_all_lanes(out["insert_status"])) == write.STATUS_SPLIT
    sk, sv = np.where(shed, kk, KEY_MAX), np.where(shed, vv, 0)
    mesh.reset_counts()
    state, st1 = round_(state, lanes(sk), lanes(sv))
    out["round_counts"] = mesh.collective_counts()
    out["round_status"] = st1.numpy().copy()
    out["round"] = planes(state, meta, cfg)
    state, st2, rounds = smo.run_smo(round_, state, lanes(sk), lanes(sv))
    out["run_status"], out["run_rounds"] = st2, rounds
    out["run"] = planes(state, meta, cfg)
    keys, _ = dataset()
    starts = np.concatenate([keys[np.array(SMO_LEAVES) * 44], kk[:150:5]])
    starts = np.resize(starts, LANES).astype(np.int64)
    counts = np.full(LANES, 64, np.int64)
    state, sk, sv, tk = scan(state, lanes(starts), lanes(counts))
    out["scan"] = {"scan_keys": sk.numpy().copy(), "scan_values": sv.numpy().copy(),
                   "taken": tk.numpy().copy()}
    out["scan_planes"] = planes(state, meta, cfg)
    out["replicas"] = replicas(state, cfg)
    return out


def reductions():
    """``psum`` of integer-valued float32 planes whose sums reach just
    below 2**24 (the f32 ``want_cl`` / ``miss_cl`` counts of the engine),
    of int64 planes, and ``pmax`` of int32 planes, over a 2x4 mesh: this
    process's block of each result, and of each input."""
    cfg = config((2, 4))
    rng = np.random.default_rng(7)
    f = rng.integers(0, 2**24 // 8, size=(8, 4, 2)).astype(np.float32)
    f[:, 0, 0] = 2**24 // 8 - 1  # a sum of 2**24 - 8
    i = rng.integers(-(2**40), 2**40, size=(8, 5)).astype(np.int64)
    v = rng.integers(0, 2**31 - 1, size=(8, 6)).astype(np.int32)
    d = mesh.device_linear_index(cfg, "cpu").numpy()
    return {
        "f32": f[d], "i64": i[d], "i32": v[d],
        "psum_f32": mesh.psum(torch.from_numpy(f[d])).numpy().copy(),
        "psum_i64": mesh.psum(torch.from_numpy(i[d])).numpy().copy(),
        "pmax_i32": mesh.pmax(torch.from_numpy(v[d])).numpy().copy(),
    }


def _all_lanes(x):
    """Every rank's ``x`` (numpy), in rank order; ``[x]`` on the virtual
    mesh."""
    rm = mesh.current()
    if rm is None:
        return [x]
    import torch.distributed as dist

    parts = [None] * rm.world
    dist.all_gather_object(parts, x, group=rm.group)
    return parts


def refusals(rm):
    """Each out-of-scope path raises ``NotImplementedError`` on ranks, and a
    world that does not divide the mesh raises ``ValueError``.  Returns
    the messages, in order."""
    from repro_torch.core import fleet_cache, route_table
    from repro_torch.core.partition import LogicalPartitions
    from repro_torch.core.repartition import RepartitionController, install_boundaries
    from repro_torch.core.sim import HostBTree
    from repro_torch.obs import registry

    cfg = config((2, 4))
    state, meta = _fresh_state(cfg)
    seen = []

    def expect(exc, fn):
        try:
            fn()
        except exc as e:
            seen.append(f"{type(e).__name__}: {e}")
            return
        raise AssertionError(f"expected {exc.__name__}")

    expect(NotImplementedError, lambda: engine.make_dex_engine(
        meta, cfg, ops=("lookup",), pipeline=True, device="cpu"))
    expect(NotImplementedError, lambda: engine.make_dex_engine(
        meta, cfg, cache_policy=fleet_cache.divergent_policy(cfg), device="cpu"))
    axes = dex.DexMeshConfig(route_axes=("data", "pod"), route_shape=(2, 1),
                             n_route=2, n_memory=4, cache_sets=64)
    expect(NotImplementedError, lambda: engine.make_dex_engine(
        meta, axes, device="cpu"))
    rt = dex.DexMeshConfig(n_route=2, n_memory=4, cache_sets=64, route_table_slots=64)
    expect(NotImplementedError, lambda: engine.make_dex_engine(meta, rt, device="cpu"))
    ctl = RepartitionController.__new__(RepartitionController)
    expect(NotImplementedError, lambda: ctl.maybe_repartition(state, meta))
    parts = LogicalPartitions(bounds(2))
    expect(NotImplementedError, lambda: install_boundaries(state, meta, parts, parts))
    expect(NotImplementedError, lambda: route_table.train_route_table(state, meta))
    expect(NotImplementedError, lambda: pool.compress_separators(state.pool, meta))
    expect(NotImplementedError, lambda: smo.refresh_sep_planes(
        None, state, meta, state.versions.clone()))
    keys, vals = dataset()
    host = HostBTree(keys, vals)
    round_ = smo.make_dex_smo(meta, cfg, device="cpu")
    one = np.array([keys[0] + 1] * 4, np.int64)
    expect(NotImplementedError, lambda: smo.settle_splits(
        state, meta, cfg, round_, host, one, one, bounds(2)))
    expect(NotImplementedError, lambda: write.drain_splits(
        state, meta, cfg, host, one, one, bounds(2)))
    expect(NotImplementedError, lambda: registry.snapshot(state))
    odd = dex.DexMeshConfig(n_route=3, n_memory=1, cache_sets=64)
    expect(ValueError, lambda: engine.make_dex_engine(meta, odd, device="cpu"))
    return seen


def world(rm, case_names):
    """Every case of ``case_names`` on this rank, in one go (``"smo"`` is
    :func:`smo_case`, ``"refusals"`` :func:`refusals`, ``"reductions"``
    :func:`reductions`).  Runs on a world of
    ``spawn_ranks``; one torch thread a rank."""
    torch.set_num_threads(1)
    out = {}
    for name in case_names:
        if name == "smo":
            out[name] = smo_case()
        elif name == "refusals":
            out[name] = refusals(rm)
        elif name == "reductions":
            out[name] = reductions()
        else:
            out[name] = engine_case(name)
    return out


def fail(rm):
    """A rank that raises (rank 1 of its world)."""
    if rm.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rm.rank
