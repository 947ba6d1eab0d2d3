"""Reference side of the port's 2x4 mesh parity check.

Runs ``repro``'s engine on a forced 8-device CPU mesh (route 2 x memory 4)
for each configuration of a group, three batches each, and saves the
initial state, every state plane and lane result after each batch, and the
traced collective counts to one ``.npz``.

* ``engine`` (the default): the lookup configurations run
  ``ops=("lookup",)`` on lookup batches; the ``mixed_*`` ones run
  ``ops=("lookup", "update", "insert")`` on mixed batches with hot keys
  written in every other batch and one leaf driven past its slack
  (``tests/test_torch_engine.py``);
* ``scan``: ``ops=ALL_OPS`` with ``max_count=32`` on mixed batches with
  scans (counts up to 40, so some clip), under ``fetch``, shedding
  ``fetch``, ``offload`` and ``auto``, and a scan-only engine under
  ``offload`` (``tests/test_torch_scan.py``);
* ``smo``: an insert batch that overflows five leaves, one SMO round,
  ``run_smo`` for the rest, then a scan batch across the split leaves
  (``tests/test_torch_smo.py``);
* ``rt``: the mixed engine with a leaf-direct route table of 512 slots,
  trained on the initial state, under ``fetch``, ``offload`` and ``auto``,
  and a poisoned table under ``fetch``; the untrained state is saved too
  (``tests/test_torch_route_table.py``);
* ``repart``: the mixed engine with a trained table under tight buckets on
  skewed batches, a ``RepartitionController`` observing each batch and
  installing new boundaries (retraining the table) when it fires; every
  plane and report saved (``tests/test_torch_repartition.py``);
* ``pipe``: the pipelined engine and the divergent fleet-cache policy, in
  four cases (a comma list may pick some): ``pipe``, tests/mesh_check.py's
  pipelined traffic (4 batches of 512 lookups, updates and inserts, one
  hot lane a device updated on even batches and read on odd ones) through
  the synchronous engine and the pipeline, every plane after each batch
  and push and a steady-state step's collective counts by phase
  (``tests/test_torch_pipeline.py``); ``divergent``, tests/mesh_check.py's
  divergent ``fetch`` engine (128 sets, ``p_admit_leaf_pct`` 50,
  ``divergent_policy(peek_budget=512)``, lookups and updates): 6 batches of
  hot lookups, every cached value poisoned and every version bumped, one
  more batch; ``divergent_pipe``, the same policy pipelined on mixed hot
  lookups and updates; ``uniform``, the ``divergent`` traffic with the
  uniform policy, for its collective counts
  (``tests/test_torch_fleet_policy.py``).

* ``axes``: two route axes, a 2x2x2 mesh (``("data", "pod")`` of 2 x 2
  routing over ``"model"`` of 2, four route partitions): the lookup engine
  under ``fetch`` and under ``auto`` with shedding buckets, the mixed
  engine and the scan engine under ``auto`` (``AXES_CONFIGS``), the
  ``smo`` case without its scan and the ``pipe`` case without its
  synchronous run, with the same key names as their 2x4 groups
  (``tests/test_torch_route_axes.py``).

The test files run this in a subprocess (the device count locks when JAX
starts) and replay the same batches through the port's virtual mesh.

    python tests/torch_mesh_ref.py OUT.npz [engine|scan|smo|rt|repart|pipe|axes] [CASES]
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as dex_mod  # noqa: E402
from repro.core import engine as engine_mod  # noqa: E402
from repro.core import fleet_cache  # noqa: E402
from repro.core import pool as pool_mod  # noqa: E402
from repro.core import route_table  # noqa: E402
from repro.core import routing  # noqa: E402
from repro.core import scan as scan_mod  # noqa: E402
from repro.core import smo as smo_mod  # noqa: E402
from repro.core import write as write_mod  # noqa: E402
from repro.core.nodes import KEY_MAX, KEY_MIN  # noqa: E402
from repro.core.partition import LogicalPartitions  # noqa: E402
from repro.core.repartition import (  # noqa: E402
    RepartitionConfig,
    RepartitionController,
)

N_KEYS = 6000
LANES = 512
BATCHES = 3
MIXED_OPS = ("lookup", "update", "insert")
#: (name, policy, route_capacity_factor, ops); auto_tight sheds lanes
CONFIGS = (
    ("fetch", "fetch", 4.0, ("lookup",)),
    ("offload", "offload", 4.0, ("lookup",)),
    ("auto", "auto", 4.0, ("lookup",)),
    ("auto_tight", "auto", 0.75, ("lookup",)),
    ("mixed_fetch", "fetch", 4.0, MIXED_OPS),
    ("mixed_offload", "offload", 4.0, MIXED_OPS),
    ("mixed_auto", "auto", 4.0, MIXED_OPS),
)
SCAN_MAX_COUNT = 32
ALL_OPS = engine_mod.ALL_OPS
SCAN_CONFIGS = (
    ("scan_fetch", "fetch", 4.0, ALL_OPS),
    ("scan_fetch_tight", "fetch", 0.75, ALL_OPS),
    ("scan_offload", "offload", 4.0, ALL_OPS),
    ("scan_auto", "auto", 4.0, ALL_OPS),
    ("scan_only_offload", "offload", 4.0, ("scan",)),
)
RT_SLOTS = 512
#: (name, policy, route_capacity_factor, table): the mixed engine with a
#: trained or poisoned route table
RT_CONFIGS = (
    ("rt_fetch", "fetch", 4.0, "trained"),
    ("rt_offload", "offload", 4.0, "trained"),
    ("rt_auto", "auto", 4.0, "trained"),
    ("rt_poison_fetch", "fetch", 4.0, "poisoned"),
)
REPART_FACTOR = 1.25
#: the ``axes`` group's engines on the 2x2x2 mesh
AXES_CONFIGS = (
    ("axes_fetch", "fetch", 4.0, ("lookup",)),
    ("axes_auto_tight", "auto", 0.75, ("lookup",)),
    ("axes_mixed_auto", "auto", 4.0, MIXED_OPS),
    ("axes_scan_auto", "auto", 4.0, ALL_OPS),
)
#: route axes, their mesh shape and the memory columns of the two layouts
LAYOUTS = {
    "2x4": (("data",), (2, 4), 4),
    "2x2x2": (("data", "pod"), (2, 2, 2), 2),
}
LAYOUT = ["2x4"]  # the layout this run builds its configurations for
#: keyword arguments of every ``make_dex_*`` call: every group runs the
#: plain jnp forms of the index kernels (``use_kernel=False``), which
#: tests/test_kernels.py holds bit-equal to the Pallas kernels (every
#: group's saved arrays are the same either way); their interpret mode
#: costs most of a run's CPU time
KERNEL = {"use_kernel": False}
RESULTS = ("found", "values", "status", "shed")
SCAN_RESULTS = RESULTS + ("scan_keys", "scan_values", "taken")


def dataset():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(300_000, size=N_KEYS, replace=False).astype(np.int64))
    return keys + 1, (keys + 1) * 7


def batches():
    keys, _ = dataset()
    rng = np.random.default_rng(1)
    out = []
    for _ in range(BATCHES):
        q = rng.choice(keys, size=LANES).astype(np.int64)
        q[::13] += 1
        q[::29] = KEY_MAX
        out.append(q)
    return out


def mixed_batches():
    """``(opcodes, keys, values)`` per batch: random lookups, updates and
    inserts of fresh keys; eight hot keys updated on even batches and read on
    odd ones; in batch 1, 30 fresh keys into one leaf (its slack is 20)."""
    keys, _ = dataset()
    hot = keys[40:48]
    rng = np.random.default_rng(2)
    out = []
    for bi in range(BATCHES):
        opc = rng.integers(0, 3, size=LANES).astype(np.int32)
        kk = rng.choice(keys, size=LANES).astype(np.int64)
        ins = opc == engine_mod.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=LANES)
        ok = ~np.isin(fresh, keys)
        kk[ins & ok] = fresh[ins & ok]
        vals = np.where(opc == engine_mod.OP_UPDATE, kk ^ 0x5A5A, kk * 7)
        opc[:8] = engine_mod.OP_LOOKUP if bi % 2 else engine_mod.OP_UPDATE
        kk[:8] = hot
        vals[:8] = hot ^ (100 + bi)
        if bi == 1:
            opc[8:38] = engine_mod.OP_INSERT
            kk[8:38] = keys[1980:2010] + 1
        kk[::29] = KEY_MAX
        out.append((opc, kk, vals.astype(np.int64)))
    return out


def scan_batches():
    """``(opcodes, keys, values)`` per batch: lookups, updates, inserts of
    fresh keys and scans (counts 1 to 40, above ``SCAN_MAX_COUNT`` in
    some); eight hot keys updated on even batches and scanned on odd ones;
    in batch 1, 30 fresh keys into one leaf."""
    keys, _ = dataset()
    hot = keys[40:48]
    rng = np.random.default_rng(3)
    out = []
    for bi in range(BATCHES):
        opc = rng.integers(0, 4, size=LANES).astype(np.int32)
        kk = rng.choice(keys, size=LANES).astype(np.int64)
        ins = opc == engine_mod.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=LANES)
        ok = ~np.isin(fresh, keys)
        kk[ins & ok] = fresh[ins & ok]
        vals = np.where(opc == engine_mod.OP_UPDATE, kk ^ 0x5A5A, kk * 7)
        scn = opc == engine_mod.OP_SCAN
        vals[scn] = rng.integers(1, SCAN_MAX_COUNT + 9, size=int(scn.sum()))
        kk[scn & (rng.random(LANES) < 0.25)] += 1  # starts between keys
        opc[:8] = engine_mod.OP_SCAN if bi % 2 else engine_mod.OP_UPDATE
        kk[:8] = hot
        vals[:8] = 8 if bi % 2 else hot ^ (100 + bi)
        if bi == 1:
            opc[8:38] = engine_mod.OP_INSERT
            kk[8:38] = keys[1980:2010] + 1
        kk[::29] = KEY_MAX
        out.append((opc, kk, vals.astype(np.int64)))
    return out


def repart_batches():
    """``(opcodes, keys, values)`` per batch of the ``repart`` group: mixed
    lookups, updates and inserts on keys below 100,000 (all in route
    partition 0 of the initial table, which splits at 150,000), then on
    keys above 200,000 (all in partition 1)."""
    keys, _ = dataset()
    rng = np.random.default_rng(5)
    out = []
    for bi, sel in enumerate((keys < 100_000, keys < 100_000, keys > 200_000)):
        pick = keys[sel]
        opc = rng.integers(0, 3, size=LANES).astype(np.int32)
        kk = rng.choice(pick, size=LANES).astype(np.int64)
        ins = opc == engine_mod.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=LANES)
        ok = ~np.isin(fresh, keys)
        kk[ins & ok] = fresh[ins & ok]
        vals = np.where(opc == engine_mod.OP_UPDATE, kk ^ (0x5A5A + bi), kk * 7)
        kk[::31] = KEY_MAX
        out.append((opc, kk, vals.astype(np.int64)))
    return out


SMO_LEAVES = (3, 20, 45, 77, 120)  # leaf indices (44 keys each) to overflow


def smo_burst():
    """``(keys, values)`` of one insert batch: 30 fresh keys into each leaf
    of ``SMO_LEAVES`` (20 slots of slack each), two of them duplicated,
    plus random fresh keys and inactive lanes."""
    keys, _ = dataset()
    rng = np.random.default_rng(4)
    burst = []
    for leaf in SMO_LEAVES:
        lo, hi = keys[leaf * 44], keys[leaf * 44 + 43]
        cand = np.setdiff1d(np.arange(lo + 1, hi), keys)
        burst.append(rng.choice(cand, size=30, replace=False))
    kk = np.full(LANES, KEY_MAX, np.int64)
    kk[:150] = np.concatenate(burst)
    kk[150:152] = kk[10:12]  # duplicate writers: the later lane wins
    fresh = rng.choice(keys, size=200) + 1
    kk[200:400] = np.where(np.isin(fresh, keys), KEY_MAX, fresh)
    vals = np.where(kk != KEY_MAX, kk * 3 + np.arange(LANES), 0)
    return kk, vals.astype(np.int64)


def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(p.name for p in path): np.asarray(x) for path, x in leaves}


def layout():
    """``(route_axes, n_route, n_memory)`` of this run's layout."""
    axes, shape, nm = LAYOUTS[LAYOUT[0]]
    return axes, int(np.prod(shape)) // nm, nm


def config(policy, factor, rt_slots=0):
    axes, nr, nm = layout()
    return dex_mod.DexMeshConfig(
        route_table_slots=rt_slots,
        route_axes=axes,
        memory_axis="model",
        n_route=nr,
        n_memory=nm,
        cache_sets=64,
        cache_ways=4,
        policy=policy,
        route_capacity_factor=factor,
    )


def sharded_state(pool, meta, cfg, bounds, mesh):
    state = dex_mod.init_state(pool, meta, cfg, bounds)
    return jax.tree.map(
        lambda x,
        s: jax.device_put(x, s),
        state,
        dex_mod.state_shardings(mesh, cfg),
    )


def run_engines(out, configs, pool, meta, bounds, mesh, lanes):
    for name, policy, factor, ops in configs:
        out[f"{name}/policy"] = np.array(policy)
        out[f"{name}/factor"] = np.array(factor)
        out[f"{name}/ops"] = np.array(",".join(ops))
        cfg = config(policy, factor)
        state = sharded_state(pool, meta, cfg, bounds, mesh)
        for k, v in flat(state).items():
            out[f"{name}/init/{k}"] = v
        has_scan = "scan" in ops
        kw = dict(max_count=SCAN_MAX_COUNT) if has_scan else {}
        fn = engine_mod.make_dex_engine(meta, cfg, mesh, ops=ops, **kw, **KERNEL)
        eng = jax.jit(fn)
        if has_scan:
            trace = scan_batches()
        elif ops == MIXED_OPS:
            trace = mixed_batches()
        else:
            trace = [(np.zeros(q.shape, np.int32), q, np.zeros(q.shape, np.int64))
                     for q in batches()]
        for i, planes in enumerate(trace):
            args = tuple(jax.device_put(jnp.asarray(a), lanes) for a in planes)
            if i == 0:
                counts = routing.trace_collective_counts(fn, state, *args)
                out[f"{name}/counts"] = np.array(
                    [counts["all_to_all"], counts["route_exchange"]]
                )
            state, res = eng(state, *args)
            for k, v in flat(state).items():
                out[f"{name}/{i}/{k}"] = v
            for k in SCAN_RESULTS if has_scan else RESULTS:
                out[f"{name}/{i}/result.{k}"] = np.asarray(getattr(res, k))


def run_rt_engines(out, pool, meta, bounds, mesh, lanes):
    """The mixed engine with a trained (or poisoned) route table, three
    mixed batches per configuration."""
    for name, policy, factor, table in RT_CONFIGS:
        out[f"{name}/policy"] = np.array(policy)
        out[f"{name}/factor"] = np.array(factor)
        out[f"{name}/table"] = np.array(table)
        cfg = config(policy, factor, RT_SLOTS)
        state = sharded_state(pool, meta, cfg, bounds, mesh)
        for k, v in flat(state).items():
            out[f"{name}/untrained/{k}"] = v
        state = route_table.train_route_table(state, meta, mesh=mesh)
        if table == "poisoned":
            state = route_table.poison_route_table(state)
        for k, v in flat(state).items():
            out[f"{name}/init/{k}"] = v
        fn = engine_mod.make_dex_engine(meta, cfg, mesh, ops=MIXED_OPS, **KERNEL)
        eng = jax.jit(fn)
        for i, planes in enumerate(mixed_batches()):
            args = tuple(jax.device_put(jnp.asarray(a), lanes) for a in planes)
            if i == 0:
                counts = routing.trace_collective_counts(fn, state, *args)
                out[f"{name}/counts"] = np.array(
                    [counts["all_to_all"], counts["route_exchange"]]
                )
            state, res = eng(state, *args)
            for k, v in flat(state).items():
                out[f"{name}/{i}/{k}"] = v
            for k in RESULTS:
                out[f"{name}/{i}/result.{k}"] = np.asarray(getattr(res, k))


def run_repart_case(out, pool, meta, bounds, mesh, lanes):
    """Skewed mixed batches under tight buckets with a trained route table;
    after each batch the controller observes the counters and may install
    new boundaries (and retrain the table)."""
    cfg = config("fetch", REPART_FACTOR, RT_SLOTS)
    state = route_table.train_route_table(
        sharded_state(pool, meta, cfg, bounds, mesh), meta, mesh=mesh
    )
    for k, v in flat(state).items():
        out[f"repart/init/{k}"] = v
    eng = jax.jit(engine_mod.make_dex_engine(meta, cfg, mesh, ops=MIXED_OPS, **KERNEL))
    ctl = RepartitionController(
        LogicalPartitions(bounds),
        n_memory=cfg.n_memory,
        cfg=RepartitionConfig(
            imbalance_threshold=1.2, min_ops=LANES // 2, cooldown_batches=0
        ),
    )
    for i, planes in enumerate(repart_batches()):
        for field, a in zip(("opcodes", "keys", "values"), planes):
            out[f"repart/{i}/{field}"] = a
        args = tuple(jax.device_put(jnp.asarray(a), lanes) for a in planes)
        state, res = eng(state, *args)
        for k, v in flat(state).items():
            out[f"repart/{i}/{k}"] = v
        for k in RESULTS:
            out[f"repart/{i}/result.{k}"] = np.asarray(getattr(res, k))
        ctl.observe(
            np.asarray(state.stats), planes[1], demand=np.asarray(state.route_demand)
        )
        state, report = ctl.maybe_repartition(state, meta)
        out[f"repart/{i}/installed"] = np.array(report is not None)
        if report is not None:
            for k, v in vars(report).items():
                out[f"repart/{i}/report.{k}"] = np.asarray(v)
        for k, v in flat(state).items():
            out[f"repart/{i}/after/{k}"] = v


def run_smo_case(out, pool, meta, bounds, mesh, lanes, scan=True):
    """An insert batch that sheds five overflowing leaves, one SMO round,
    ``run_smo`` for what is left, and (with ``scan``) a scan batch across
    the split leaves; every plane saved after each step."""
    cfg = config("fetch", 4.0)
    state = sharded_state(pool, meta, cfg, bounds, mesh)
    for k, v in flat(state).items():
        out[f"smo/init/{k}"] = v
    insert = jax.jit(write_mod.make_dex_insert(meta, cfg, mesh, **KERNEL))
    smo_fn = smo_mod.make_dex_smo(meta, cfg, mesh, **KERNEL)
    smo = jax.jit(smo_fn)
    kk, vv = smo_burst()
    out["smo/keys"], out["smo/values"] = kk, vv
    state, st = insert(state, jax.device_put(jnp.asarray(kk), lanes),
                       jax.device_put(jnp.asarray(vv), lanes))
    st = np.asarray(st)
    out["smo/insert_status"] = st
    for k, v in flat(state).items():
        out[f"smo/insert/{k}"] = v
    shed = st == write_mod.STATUS_SPLIT
    sk = np.where(shed, kk, KEY_MAX)
    sv = np.where(shed, vv, 0)
    sk_d, sv_d = (jax.device_put(jnp.asarray(a), lanes) for a in (sk, sv))
    c = routing.trace_collective_counts(smo_fn, state, sk_d, sv_d)
    out["smo/round_counts"] = np.array([c["all_to_all"], c["route_exchange"]])
    state, st1 = smo(state, sk_d, sv_d)
    out["smo/round_status"] = np.asarray(st1)
    for k, v in flat(state).items():
        out[f"smo/round/{k}"] = v
    state, st2, rounds = smo_mod.run_smo(smo, state, sk, sv)
    out["smo/run_status"] = st2
    out["smo/run_rounds"] = np.array(rounds)
    for k, v in flat(state).items():
        out[f"smo/run/{k}"] = v
    if not scan:
        return
    scan = jax.jit(scan_mod.make_dex_scan(meta, cfg, mesh, max_count=64, **KERNEL))
    keys, _ = dataset()
    starts = np.concatenate([keys[np.array(SMO_LEAVES) * 44], kk[:150:5]])
    starts = np.resize(starts, LANES).astype(np.int64)
    counts = np.full(LANES, 64, np.int64)
    out["smo/scan_starts"] = starts
    state, sk_, sv_, tk = scan(state, jax.device_put(jnp.asarray(starts), lanes),
                               jax.device_put(jnp.asarray(counts), lanes))
    out["smo/scan_keys"] = np.asarray(sk_)
    out["smo/scan_values"] = np.asarray(sv_)
    out["smo/taken"] = np.asarray(tk)
    for k, v in flat(state).items():
        out[f"smo/scan/{k}"] = v


PIPE_BATCHES = 4
PIPE_CASES = ("pipe", "divergent", "divergent_pipe", "uniform")
DIV_WARM = 6  # hot lookup batches before the poison


def pipe_batches():
    """``(opcodes, keys, values)`` of tests/mesh_check.py's pipelined round
    trip on this dataset: disjoint key regions for lookups, updates (unique
    in a batch) and inserts of fresh keys; eight hot keys, one lane a
    device, updated on even batches and read on odd ones."""
    keys, _ = dataset()
    rng = np.random.default_rng(6)
    hot = keys[300:308]
    hot_lanes = np.arange(8) * (LANES // 8) + 7
    fresh = np.unique(rng.choice(keys[:-1], size=8 * PIPE_BATCHES * LANES) + 1)
    fresh = fresh[~np.isin(fresh, keys)]
    out, fi = [], 0
    for bi in range(PIPE_BATCHES):
        pick = rng.integers(0, 3, size=LANES)
        opc = pick.astype(np.int32)  # OP_LOOKUP, OP_UPDATE, OP_INSERT
        kk = np.empty(LANES, np.int64)
        kk[pick == 0] = rng.choice(keys[3600:4800], size=int((pick == 0).sum()))
        kk[pick == 1] = rng.choice(
            keys[2400:3600], size=int((pick == 1).sum()), replace=False
        )
        n_ins = int((pick == 2).sum())
        kk[pick == 2] = fresh[fi : fi + n_ins]
        fi += n_ins
        vv = rng.integers(1, 1 << 40, size=LANES).astype(np.int64)
        opc[hot_lanes] = engine_mod.OP_LOOKUP if bi % 2 else engine_mod.OP_UPDATE
        kk[hot_lanes] = hot
        vv[hot_lanes] = hot ^ (1000 + bi)
        out.append((opc, kk, vv))
    return out


def div_batches(n, mixed):
    """``n`` batches over tests/mesh_check.py's hot set (every 40th key, all
    four columns): lookups, or with ``mixed`` lookups and updates."""
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
            opc[upd] = engine_mod.OP_UPDATE
            vv[upd] = kk[upd] ^ rng.integers(1, 1 << 40, size=int(upd.sum()))
        out.append((opc, kk, vv))
    return out


def pipe_config(sets, admit):
    axes, nr, nm = layout()
    return dex_mod.DexMeshConfig(
        route_axes=axes,
        memory_axis="model",
        n_route=nr,
        n_memory=nm,
        cache_sets=sets,
        cache_ways=4,
        policy="fetch",
        p_admit_leaf_pct=admit,
        route_capacity_factor=4.0,
    )


def save_planes(out, prefix, state, res=None):
    for k, v in flat(state).items():
        out[f"{prefix}{k}"] = v
    if res is not None:
        for k in RESULTS:
            out[f"{prefix}result.{k}"] = np.asarray(getattr(res, k))


def phase_counts(pipe, args):
    """A step's collective counts, total and by phase, traced before the
    first push (the trace is cached after it)."""
    c = routing.trace_collective_counts(
        pipe.step_fn, pipe.state, pipe.init_carry(LANES), *args, by_phase=True
    )
    rows = [[c["all_to_all"], c["route_exchange"]]]
    for ph in ("pipe/front", "pipe/back"):
        p = c["phases"].get(ph, {})
        rows.append([p.get("all_to_all", 0), p.get("route_exchange", 0)])
    return np.array(rows)


def run_pipeline(out, name, pipe, state, batches, lanes):
    """Push ``batches`` then drain, saving every plane and result after
    each step and a step's counts by phase."""
    pipe.start(state)
    for i in range(len(batches) + 1):
        if i < len(batches):
            args = tuple(jax.device_put(jnp.asarray(a), lanes) for a in batches[i])
            if i == 0:
                out[f"{name}/phase_counts"] = phase_counts(pipe, args)
            r = pipe.push(*args)
        else:
            r = pipe.drain()
        save_planes(out, f"{name}/pipe/{i}/", pipe.state, r)


def run_pipe_cases(out, pool, meta, bounds, mesh, lanes, cases, sync=True):
    for case in cases:
        if case not in PIPE_CASES:
            raise SystemExit(f"unknown pipe case {case!r}")
    if "pipe" in cases:
        cfg = pipe_config(256, 100)
        out["pipe/sets"], out["pipe/admit"] = np.array(256), np.array(100)
        out["pipe/policy"] = np.array("fetch")
        batches = pipe_batches()
        out["pipe/batches"] = np.array(len(batches))
        for i, planes in enumerate(batches):
            for field, a in zip(("opcodes", "keys", "values"), planes):
                out[f"pipe/{i}/{field}"] = a
        state = sharded_state(pool, meta, cfg, bounds, mesh)
        save_planes(out, "pipe/init/", state)
        eng = jax.jit(engine_mod.make_dex_engine(meta, cfg, mesh, ops=MIXED_OPS,
                                                 max_count=1, **KERNEL))
        for i, planes in enumerate(batches if sync else ()):
            args = tuple(jax.device_put(jnp.asarray(a), lanes) for a in planes)
            state, res = eng(state, *args)
            save_planes(out, f"pipe/sync/{i}/", state, res)
        pipe = engine_mod.make_dex_engine(meta, cfg, mesh, ops=MIXED_OPS, max_count=1,
                                          pipeline=True, **KERNEL)
        run_pipeline(out, "pipe", pipe, sharded_state(pool, meta, cfg, bounds, mesh),
                     batches, lanes)
    cfg = pipe_config(128, 50)
    policy = fleet_cache.divergent_policy(cfg, peek_budget=512)
    div_ops = ("lookup", "update")
    warm = div_batches(DIV_WARM + 1, mixed=False)
    for i, planes in enumerate(warm):
        for field, a in zip(("opcodes", "keys", "values"), planes):
            out[f"div/{i}/{field}"] = a
    for case, pol in (("divergent", policy), ("uniform", None)):
        if case not in cases:
            continue
        state = sharded_state(pool, meta, cfg, bounds, mesh)
        save_planes(out, f"{case}/init/", state)
        fn = engine_mod.make_dex_engine(meta, cfg, mesh, ops=div_ops, max_count=1,
                                        cache_policy=pol, **KERNEL)
        eng = jax.jit(fn)
        for i, planes in enumerate(warm):
            args = tuple(jax.device_put(jnp.asarray(a), lanes) for a in planes)
            if i == 0:
                c = routing.trace_collective_counts(fn, state, *args)
                out[f"{case}/counts"] = np.array([c["all_to_all"], c["route_exchange"]])
            if i == DIV_WARM:
                # every cached value poisoned, every version bumped
                sh = dex_mod.state_shardings(mesh, cfg)
                state = state._replace(
                    cache=state.cache._replace(values=jax.device_put(
                        jnp.full(state.cache.values.shape, -777_777, jnp.int64),
                        sh.cache.values,
                    )),
                    versions=jax.device_put(jnp.asarray(state.versions) + 1,
                                            sh.versions),
                )
                save_planes(out, f"{case}/poisoned/", state)
            state, res = eng(state, *args)
            save_planes(out, f"{case}/{i}/", state, res)
    if "divergent_pipe" in cases:
        batches = div_batches(PIPE_BATCHES, mixed=True)
        for i, planes in enumerate(batches):
            for field, a in zip(("opcodes", "keys", "values"), planes):
                out[f"divergent_pipe/{i}/{field}"] = a
        state = sharded_state(pool, meta, cfg, bounds, mesh)
        save_planes(out, "divergent_pipe/init/", state)
        pipe = engine_mod.make_dex_engine(meta, cfg, mesh, ops=div_ops, max_count=1,
                                          pipeline=True, cache_policy=policy, **KERNEL)
        run_pipeline(out, "divergent_pipe", pipe, state, batches, lanes)


def main(out_path, group="engine", cases=",".join(PIPE_CASES)):
    LAYOUT[0] = "2x2x2" if group == "axes" else "2x4"
    axes, shape, nm = LAYOUTS[LAYOUT[0]]
    mesh = make_mesh_compat(shape, axes + ("model",))
    keys, vals = dataset()
    pool, meta = pool_mod.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=nm)
    # route partitions of equal width over the key range
    n_route = int(np.prod(shape)) // nm
    inner = [300_000 * i // n_route for i in range(1, n_route)]
    bounds = np.array([KEY_MIN] + inner + [KEY_MAX], np.int64)
    lanes = NamedSharding(mesh, P(axes + ("model",)))
    out = {"keys": keys, "values": vals}
    for i, q in enumerate(batches()):
        out[f"batch/{i}"] = q
    for i, planes in enumerate(mixed_batches()):
        for field, a in zip(("opcodes", "keys", "values"), planes):
            out[f"mixed/{i}/{field}"] = a
    for i, planes in enumerate(scan_batches()):
        for field, a in zip(("opcodes", "keys", "values"), planes):
            out[f"scanmix/{i}/{field}"] = a
    if group == "engine":
        run_engines(out, CONFIGS, pool, meta, bounds, mesh, lanes)
    elif group == "scan":
        run_engines(out, SCAN_CONFIGS, pool, meta, bounds, mesh, lanes)
    elif group == "smo":
        run_smo_case(out, pool, meta, bounds, mesh, lanes)
    elif group == "rt":
        run_rt_engines(out, pool, meta, bounds, mesh, lanes)
    elif group == "repart":
        run_repart_case(out, pool, meta, bounds, mesh, lanes)
    elif group == "pipe":
        run_pipe_cases(out, pool, meta, bounds, mesh, lanes, cases.split(","))
    elif group == "axes":
        # the scan after the SMO burst and the pipe case's synchronous run
        # are left out: the scan and mixed engines above cover both
        run_engines(out, AXES_CONFIGS, pool, meta, bounds, mesh, lanes)
        run_smo_case(out, pool, meta, bounds, mesh, lanes, scan=False)
        run_pipe_cases(out, pool, meta, bounds, mesh, lanes, ["pipe"], sync=False)
    else:
        raise SystemExit(f"unknown group {group!r}")
    np.savez(out_path, **out)
    print("MESH_REF_OK")


if __name__ == "__main__":
    main(*sys.argv[1:4])
