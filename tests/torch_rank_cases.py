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
for bit) on ranks.  The cases cover ``tests/torch_mesh_ref.py``'s
``engine``, ``smo``, ``pipe`` and ``axes`` groups (``engine_case``,
``smo_case``, ``pipe_case``, ``div_case``), the 1x4 and 4x2 layouts, the
exchanges of two route axes, the reductions and the refusals; the
fleet-cache and pipelined cases also read the telemetry plane over the
ranks.  The last section is the test side: a world's results held to the
reference's saved arrays (``check_reference``, ``check_pipeline``).
"""

import numpy as np
import torch

from repro_torch.core import dex, engine, fleet_cache, mesh, pool, smo, write
from repro_torch.core.nodes import KEY_MAX, KEY_MIN
from repro_torch.core.scan import make_dex_scan
from repro_torch.obs import registry, timeline, trace

N_KEYS = 6000
LANES = 512
BATCHES = 3
MIXED_OPS = ("lookup", "update", "insert")
SCAN_MAX_COUNT = 32
RESULTS = ("found", "values", "status", "shed")
SCAN_RESULTS = RESULTS + ("scan_keys", "scan_values", "taken")
SMO_LEAVES = (3, 20, 45, 77, 120)
#: the ``axes`` group's mesh: route axes ("data", "pod") of 2 x 2 over 2
#: memory columns
AXES = (2, 2, 2)
PIPE_BATCHES = 4
DIV_WARM = 6  # hot lookup batches before the poison
DIV_OPS = ("lookup", "update")
#: the devices whose cached rows the ``peek_poison`` case poisons: route
#: row 0's columns 0 and 1, which hold every key that row routes, so that
#: its devices 2 and 3 peek them (rank 0's block over 4 ranks, peeked by
#: rank 1's)
POISONED = (0, 1)

#: name: (mesh shape: (n_route, n_memory) or AXES, policy,
#: route_capacity_factor, ops, traffic)
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
    # tests/torch_mesh_ref.py's ``axes`` group
    "axes_fetch": (AXES, "fetch", 4.0, ("lookup",), "lookup"),
    "axes_auto_tight": (AXES, "auto", 0.75, ("lookup",), "lookup"),
    "axes_mixed_auto": (AXES, "auto", 4.0, MIXED_OPS, "mixed"),
    "axes_scan_auto": (AXES, "auto", 4.0, engine.ALL_OPS, "scan"),
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


def pipe_batches():
    """``(opcodes, keys, values)`` of tests/torch_mesh_ref.py's ``pipe``
    case: lookups, updates (unique in a batch) and inserts of fresh keys in
    disjoint key regions; eight hot keys, one lane a device, updated on
    even batches and read on odd ones."""
    keys, _ = dataset()
    rng = np.random.default_rng(6)
    hot = keys[300:308]
    hot_lanes = np.arange(8) * (LANES // 8) + 7
    fresh = np.unique(rng.choice(keys[:-1], size=8 * PIPE_BATCHES * LANES) + 1)
    fresh = fresh[~np.isin(fresh, keys)]
    out, fi = [], 0
    for bi in range(PIPE_BATCHES):
        pick = rng.integers(0, 3, size=LANES)
        opc = pick.astype(np.int32)
        kk = np.empty(LANES, np.int64)
        kk[pick == 0] = rng.choice(keys[3600:4800], size=int((pick == 0).sum()))
        kk[pick == 1] = rng.choice(
            keys[2400:3600], size=int((pick == 1).sum()), replace=False
        )
        n_ins = int((pick == 2).sum())
        kk[pick == 2] = fresh[fi : fi + n_ins]
        fi += n_ins
        vv = rng.integers(1, 1 << 40, size=LANES).astype(np.int64)
        opc[hot_lanes] = engine.OP_LOOKUP if bi % 2 else engine.OP_UPDATE
        kk[hot_lanes] = hot
        vv[hot_lanes] = hot ^ (1000 + bi)
        out.append((opc, kk, vv))
    return out


def div_batches(n, mixed):
    """``n`` batches of the ``pipe`` group's fleet-cache cases over the hot
    set (every 40th key, all four columns): lookups, or with ``mixed``
    lookups and updates."""
    keys, _ = dataset()
    hot = keys[::40]
    rng = np.random.default_rng(77 if not mixed else 78)
    out = []
    for _ in range(n):
        kk = rng.choice(hot, size=LANES).astype(np.int64)
        opc = np.zeros(LANES, np.int32)
        vv = np.zeros(LANES, np.int64)
        if mixed:
            upd = rng.random(LANES) < 0.3
            opc[upd] = engine.OP_UPDATE
            vv[upd] = kk[upd] ^ rng.integers(1, 1 << 40, size=int(upd.sum()))
        out.append((opc, kk, vv))
    return out


TRAFFIC = {"lookup": lookup_batches, "mixed": mixed_batches, "scan": scan_batches}


def config(shape, policy="fetch", factor=4.0, sets=64, admit=None):
    """The case's mesh: ``(n_route, n_memory)``, or ``(s0, s1, n_memory)``
    for two route axes ("data", "pod") of ``s0 x s1``."""
    kw = {} if admit is None else dict(p_admit_leaf_pct=admit)
    if len(shape) == 3:
        kw.update(route_axes=("data", "pod"), route_shape=tuple(shape[:2]))
    return dex.DexMeshConfig(
        n_route=int(np.prod(shape[:-1])), n_memory=shape[-1], cache_sets=sets,
        cache_ways=4, policy=policy, route_capacity_factor=factor, **kw,
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


def smo_case(shape=(2, 4), scan=True):
    """tests/torch_mesh_ref.py's ``smo`` case: an insert burst that
    overflows five leaves, one SMO round, ``run_smo`` for the rest, then
    (with ``scan``) a scan across the split leaves (``make_dex_scan``).
    ``run_smo`` records its rounds as phases of a telemetry batch."""
    cfg = config(shape, "fetch", 4.0)
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
    tl = timeline.BatchTimeline("smo")
    with tl.batch("smo") as b:
        state, st2, rounds = smo.run_smo(round_, state, lanes(sk), lanes(sv), obs=b)
    out["run_status"], out["run_rounds"] = st2, rounds
    out["run_phases"] = [p.name for p in tl.records()[0].phases]
    out["run"] = planes(state, meta, cfg)
    if not scan:
        out["replicas"] = replicas(state, cfg)
        return out
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


def _snap(state):
    """The fleet's counters (``registry.snapshot``: on ranks gathered over
    every rank) as plain numbers."""
    s = registry.snapshot(state)
    return {"per_device": {k: v.copy() for k, v in s.per_device.items()},
            "fleet": dict(s.fleet), "derived": dict(s.derived)}


def _telemetry(tl, out_dir, tag):
    """A timeline's summary and trace export (equal on every rank on
    ranks), written by ``write_trace`` under ``out_dir`` to a file that
    names this process's rank, which only rank 0 writes."""
    out = {"summary": tl.summary(), "trace": trace.to_trace_events(tl)}
    if out_dir is not None:
        rm = mesh.current()
        trace.write_trace(tl, f"{out_dir}/{tag}_trace{0 if rm is None else rm.rank}.json")
    return out


def pipe_case(name, out_dir=None):
    """A pipelined case of tests/torch_mesh_ref.py's ``pipe`` group: each
    push's and the drain's collective counts by phase, lanes and planes.
    ``"pipe"`` (2x4) and ``"axes_pipe"`` (2x2x2) run the mixed pipeline on
    :func:`pipe_batches`; ``"divergent_pipe"`` the divergent policy's on
    mixed hot batches, recorded by a ``BatchTimeline`` (one batch a step,
    its counter delta read after the step), with the fleet's snapshot after
    every step and the latency ledger's total against the ops counted."""
    if name == "divergent_pipe":
        cfg = config((2, 4), "fetch", 4.0, sets=128, admit=50)
        ops, batches = DIV_OPS, div_batches(PIPE_BATCHES, mixed=True)
        policy = fleet_cache.divergent_policy(cfg, peek_budget=512)
    else:
        cfg = config(AXES if name == "axes_pipe" else (2, 4), "fetch", 4.0, sets=256,
                     admit=100)
        ops, batches, policy = MIXED_OPS, pipe_batches(), None
    state, meta = _fresh_state(cfg)
    pipe = engine.make_dex_engine(meta, cfg, ops=ops, max_count=1, pipeline=True,
                                  cache_policy=policy, device="cpu")
    tl = timeline.BatchTimeline(name) if name == "divergent_pipe" else None
    out = {"init": planes(state, meta, cfg), "steps": []}
    if tl is not None:
        tl.prime(state)
        tl.prime_latency(state)
        before = _snap(state)
    pipe.start(state)
    for i in range(len(batches) + 1):
        mesh.reset_counts()
        b = tl.open_batch("push" if i < len(batches) else "drain") if tl else None
        if i < len(batches):
            r = pipe.push(*(lanes(a) for a in batches[i]))
        else:
            r = pipe.drain()
        step = {"counts": mesh.collective_counts(by_phase=True),
                "result": None if r is None else _results(r, RESULTS),
                "planes": planes(pipe.state, meta, cfg)}
        if tl is not None:
            b.counters(pipe.state)
            b.close()
            step["snapshot"] = _snap(pipe.state)
        out["steps"].append(step)
    if tl is not None:
        hist = tl.capture_latency(pipe.state)
        after = out["steps"][-1]["snapshot"]
        out["ledger"] = {"hist": int(hist.sum()),
                         "ops": after["fleet"]["ops"] - before["fleet"]["ops"]}
        out.update(_telemetry(tl, out_dir, name))
    out["replicas"] = replicas(pipe.state, cfg)
    return out


def _poison(state, meta, cfg, devices):
    """Every cached value of ``devices`` (global device indices; None: all
    of them) set to -777,777, and the version of every node those devices
    cache bumped on every device, so that their rows fail the version
    check; on ranks each rank writes its own block."""
    held = mesh.device_linear_index(cfg, "cpu").numpy()
    if devices is None:
        state.cache.values.fill_(-777_777)
        gids = torch.arange(meta.n_nodes)
    else:
        mine = torch.from_numpy(np.isin(held, devices))
        state.cache.values[mine] = -777_777
        tags = mesh.gather_devices(state.cache.tags)[list(devices)]
        gids = torch.unique(tags[tags >= 0])
    return state._replace(versions=fleet_cache.invalidate_nodes(state.versions, gids))


def _probe(state, cfg, devices):
    """``(peer hits, rows)``: every tagged row of the held devices among
    ``devices`` asked of its own device through ``peer_answer``, as a
    sibling's peek would ask it; summed over the ranks."""
    held = mesh.device_linear_index(cfg, "cpu").tolist()
    hits = rows = 0
    for j, d in enumerate(held):
        if d not in devices:
            continue
        gids = torch.unique(state.cache.tags[j][state.cache.tags[j] >= 0])
        one = fleet_cache.DexCache(*(t[j : j + 1] for t in state.cache))
        ph, _, _ = fleet_cache.peer_answer(
            one, cfg, state.versions[j : j + 1], gids[None], torch.zeros_like(gids)[None],
            torch.ones_like(gids, dtype=torch.bool)[None],
        )
        hits, rows = hits + int(ph.sum()), rows + int(gids.numel())
    return mesh.host_sum([hits, rows]).tolist()


def div_case(arm, out_dir=None):
    """The ``pipe`` group's fleet-cache cases at 2x4 (128 sets, admission
    50%): ``"divergent"`` (``divergent_policy(peek_budget=512)``) or
    ``"uniform"`` over ``DIV_WARM`` hot lookup batches, every cached value
    poisoned and every version bumped, one more batch: each batch's counts,
    lanes, planes and peer counts.  ``"peek_poison"``: the divergent arm
    whose last batch follows a poison of ``POISONED``'s devices only, with
    a ``peer_answer`` probe of their rows before and after.  The divergent
    arms run through a ``BatchTimeline``'s instrumented engine."""
    cfg = config((2, 4), "fetch", 4.0, sets=128, admit=50)
    policy = None if arm == "uniform" else fleet_cache.divergent_policy(
        cfg, peek_budget=512)
    state, meta = _fresh_state(cfg)
    eng = engine.make_dex_engine(meta, cfg, ops=DIV_OPS, max_count=1,
                                 cache_policy=policy, device="cpu")
    warm = div_batches(DIV_WARM + 1, mixed=False)
    # one batch's counts on a copy of the state (every rank runs it)
    counted = registry.collectives_per_batch(eng, state, *(lanes(a) for a in warm[0]))
    tl = None
    if arm != "uniform":
        tl = timeline.BatchTimeline(arm)
        eng = tl.instrument(eng, label=arm)
        tl.prime(state)
        tl.prime_latency(state)
    out = {"init": planes(state, meta, cfg), "steps": [], "collectives": counted}
    for i, batch in enumerate(warm):
        if i == DIV_WARM:
            if arm == "peek_poison":
                out["probe_fresh"] = _probe(state, cfg, POISONED)
                state = _poison(state, meta, cfg, POISONED)
                out["probe_stale"] = _probe(state, cfg, POISONED)
            else:
                state = _poison(state, meta, cfg, None)
            out["poisoned"] = planes(state, meta, cfg)
        mesh.reset_counts()
        stats0 = state.stats.clone()
        state, r = eng(state, *(lanes(a) for a in batch))
        out["steps"].append({
            "counts": mesh.collective_counts(),
            "result": _results(r, RESULTS),
            "planes": planes(state, meta, cfg),
            # [Dl, 2] peer hits and misses of this process's devices
            "peer": (state.stats - stats0)[:, [registry.STAT_PEER_HITS,
                                               registry.STAT_PEER_MISSES]].numpy(),
        })
    if tl is not None:
        hist = tl.capture_latency(state)
        out["ledger"] = {"hist": int(hist.sum()),
                         "ops": int(tl.counter_totals()["ops"])}
        out.update(_telemetry(tl, out_dir, arm))
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


def exchanges():
    """The 2x2x2 mesh's exchanges on a numbered ``[Dev, n_route, 5]``
    buffer: over each route axis (``mesh.a2a``) and over the whole route
    index (``mesh.route_transpose``), this process's block of each, with
    the counts of the three calls and, on ranks, whether each exchange
    crosses ranks."""
    cfg = config(AXES)
    held = mesh.device_linear_index(cfg, "cpu")
    x = torch.arange(cfg.n_devices * cfg.n_route * 5).reshape(
        cfg.n_devices, cfg.n_route, 5)[held]
    mesh.reset_counts()
    out = {a: mesh.a2a(x, cfg, a).numpy().copy() for a in cfg.route_axes}
    out["route"] = mesh.route_transpose(x, cfg).numpy().copy()
    out["counts"] = mesh.collective_counts()
    rm = mesh.current()
    if rm is not None:
        out["remote"] = {k: mesh._a2a_plan(rm, cfg, k)["remote"]
                         for k in ("memory", "route", 0, 1)}
    return out


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
    from repro_torch.core import route_table
    from repro_torch.core.partition import LogicalPartitions
    from repro_torch.core.repartition import RepartitionController, install_boundaries
    from repro_torch.core.sim import HostBTree

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
    odd = dex.DexMeshConfig(n_route=3, n_memory=1, cache_sets=64)
    expect(ValueError, lambda: engine.make_dex_engine(meta, odd, device="cpu"))
    return seen


def world(rm, case_names, out_dir=None):
    """Every case of ``case_names`` on this rank, in one go (``"smo"`` and
    ``"axes_smo"`` are :func:`smo_case`, the ``pipe`` group's cases
    :func:`pipe_case` and :func:`div_case`, ``"refusals"``
    :func:`refusals`, ``"reductions"`` :func:`reductions`; ``out_dir``
    takes the timelines' trace files).  Runs on a world of
    ``spawn_ranks``; one torch thread a rank."""
    torch.set_num_threads(1)
    out = {}
    for name in case_names:
        if name == "smo":
            out[name] = smo_case()
        elif name == "axes_smo":
            out[name] = smo_case(AXES, scan=False)
        elif name in ("pipe", "axes_pipe", "divergent_pipe"):
            out[name] = pipe_case(name, out_dir)
        elif name in ("divergent", "uniform", "peek_poison"):
            out[name] = div_case(name, out_dir)
        elif name == "exchanges":
            out[name] = exchanges()
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


# ---------------------------------------------------------------------------
# the test side: a world's results against saved arrays
# ---------------------------------------------------------------------------


def equal(want, got, where):
    """``want == got`` bit for bit, through dicts, lists and arrays."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), where
        for k in want:
            equal(want[k], got[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            equal(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert want.dtype == got.dtype and want.shape == got.shape, where
        np.testing.assert_array_equal(want, got, err_msg=where)
    else:
        assert want == got, where


def rank_lanes(ranks, get):
    """One lane plane of every rank, concatenated in rank order."""
    return np.concatenate([get(r) for r in ranks])


def merged(ranks, name):
    """A world's case with every step's lanes of all ranks and the planes
    rank 0 gathered."""
    out = ranks[0][name]
    steps = []
    for i, step in enumerate(out["steps"]):
        res = step["result"]
        if res is not None:
            res = {k: rank_lanes(ranks, lambda r: r[name]["steps"][i]["result"][k])
                   for k in res}
        steps.append(dict(step, result=res))
    return dict(out, steps=steps)


def prefixed(arrays, prefix):
    """The saved arrays under ``prefix``, keyed by the rest of their name."""
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _check_step(arrays, prefix, step, where):
    want = prefixed(arrays, prefix)
    results = {k[len("result."):]: want.pop(k) for k in list(want)
               if k.startswith("result.")}
    assert (step["result"] is None) == (not results), where
    for k, lanes_ in (step["result"] or {}).items():
        equal(results[k], lanes_, f"{where} {k}")
    equal(want, step["planes"], where)


def check_reference(ranks, arrays, p, name, ref=None):
    """A world's engine case ``name`` against the reference's saved
    ``arrays`` under ``ref`` (default ``name``): the initial planes, every
    step's lanes and planes, and each rank's collective counts."""
    ref = ref or name
    got = merged(ranks, name)
    equal(prefixed(arrays, f"{ref}/init/"), got["init"], f"{p} ranks {name} init")
    c = arrays[f"{ref}/counts"]
    want_counts = {"all_to_all": int(c[0]), "route_exchange": int(c[1])}
    for i, step in enumerate(got["steps"]):
        assert "found" in step["result"], (p, name, i)
        _check_step(arrays, f"{ref}/{i}/", step, f"{p} ranks {name} batch {i}")
        for q, r in enumerate(ranks):
            assert r[name]["steps"][i]["counts"] == want_counts, (p, name, i, q)


def check_pipeline(ranks, arrays, p, name, ref=None):
    """A world's pipelined case against the reference's: the initial
    planes; every push's and the drain's lanes (none for the priming push)
    and planes; each rank's counts of every step, by phase too, equal to
    the reference's traced step (``phase_counts``)."""
    ref = ref or name
    got = merged(ranks, name)
    equal(prefixed(arrays, f"{ref}/init/"), got["init"], f"{p} ranks {name} init")
    c = arrays[f"{ref}/phase_counts"].tolist()
    want_counts = {"all_to_all": c[0][0], "route_exchange": c[0][1], "phases": {
        ph: {"all_to_all": c[j + 1][0], "route_exchange": c[j + 1][1]}
        for j, ph in enumerate(("pipe/front", "pipe/back"))}}
    assert len(got["steps"]) == sum(1 for k in arrays if k.startswith(f"{ref}/pipe/")
                                    and k.endswith("/stats"))
    for i, step in enumerate(got["steps"]):
        _check_step(arrays, f"{ref}/pipe/{i}/", step, f"{p} ranks {name} push {i}")
        for q, r in enumerate(ranks):
            assert r[name]["steps"][i]["counts"] == want_counts, (p, name, i, q)
