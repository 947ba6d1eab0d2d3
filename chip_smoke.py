#!/usr/bin/env python3
"""Drive the PyTorch port's lookup and write paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--seed 0] [--n-keys 200000000]

Phases, in order; any failure exits non-zero:

  1. device: the card's name and power limit (``nvidia-smi``), CUDA version;
  2. build: compile the CUDA kernels from ``src/repro_torch/csrc``;
  3. kernels: ``node_search``, ``subtree_walk`` and ``leaf_write`` at the
     main path's shapes (65,536-lane batches on a 2x4 virtual mesh) on
     seeded inputs with misses, KEY_MIN / KEY_MAX, negative keys and
     queries below a row's first key (for ``leaf_write``: rows with only
     updates, only inserts, both and nothing staged, rows filled to
     exactly 64, staged keys below and above a row's keys), bit-equal to
     their plain PyTorch versions, and timed beside the plain version and a
     PyTorch yardstick where one exists;
  4. the port on the CPU and on the card give the same lane results and
     state planes (20k keys, 2x4 mesh, 3 batches): lookups under ``fetch``,
     ``fetch`` with shedding buckets and ``auto``; mixed lookups, updates
     and inserts (hot keys written in every batch, one leaf driven past its
     slack) under ``fetch``, ``fetch`` with shedding buckets, ``offload``
     and ``auto``, every plane compared, the pool's included;
  5. the main path at full size: 200M sorted int64 keys made on the card
     from ``--seed``, level-M = 1 subtree blocks at fill 0.7, a 2x4 virtual
     mesh split at the median key, 65,536 sets x 4 ways of cache per
     virtual device, 65,536-lane batches of YCSB workload C (100% reads)
     under ``offload``, ``fetch`` and ``auto``, then on the same index YCSB
     workload A (50% reads, 50% updates) under ``offload``, ``fetch`` and
     ``auto`` and the paper's insert-intensive mix (50% inserts, 50% reads)
     under ``fetch`` and ``offload``, all scrambled Zipfian, theta 0.99.
     A host oracle carries the applied writes forward; every lane that is
     not shed must match it;
  6. one JSON line of per-kernel launches (summed over phase 5's paths,
     each counted from 0 just before it), errors and times.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FULL_KEYS = 200_000_000  # the paper's bulk load (YCSB, §8.1)
BATCH = 65_536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# The least a search of one sorted 64-key row must read: a binary search
# over its sixteen 32-byte sectors (4 keys each), ceil(log2(16 + 1)) reads.
ROW_SEARCH_BYTES = 32 * 5
# The least leaf_write must move per row: its 64 keys and 64 values read and
# written once (4 x 512 B), its occupancy written (4 B), and one probe of each
# staged list (an update slot, 4 B, and an insert key, 8 B) to find it
# empty; each active staged update adds its slot and value (12 B), each
# active staged insert its key and value (16 B).
LEAF_ROW_BYTES = 4 * 64 * 8 + 4 + 4 + 8
STAGED_UPDATE_BYTES = 4 + 8
STAGED_INSERT_BYTES = 8 + 8
VALUE_XOR = 0x5DEECE66D
# (workload, policy, warm-up batches, timed batches) of phase 5, in order
MAIN_RUNS = (
    ("read-only", "offload", 1, 10),
    ("read-only", "fetch", 2, 10),
    ("read-only", "auto", 3, 20),
    ("ycsb-a", "offload", 1, 5),
    ("ycsb-a", "fetch", 1, 5),
    ("ycsb-a", "auto", 1, 5),
    ("insert-intensive", "fetch", 1, 5),
    ("insert-intensive", "offload", 1, 5),
)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-keys", type=int, default=FULL_KEYS)
    return p.parse_args(argv)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want):
    return max(
        float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
        for g, w in zip(got, want)
    )


def mesh_config(policy, cache_sets, factor=4.0):
    from repro_torch.core.dex import DexMeshConfig

    return DexMeshConfig(
        n_route=2,
        n_memory=4,
        cache_sets=cache_sets,
        cache_ways=4,
        policy=policy,
        route_capacity_factor=factor,
    )


def make_index(n_keys, seed, device):
    """``n_keys`` sorted unique int64 keys spanning negative and positive
    values (a cumulative sum of seeded random gaps), values a fixed function
    of the key, and the blocked pool over them."""
    import torch

    from repro_torch.core import pool as pool_mod

    g = torch.Generator(device=device).manual_seed(seed)
    gaps = torch.randint(1, 2**32, (n_keys,), generator=g, device=device)
    keys = torch.cumsum(gaps, 0) - 2**61
    del gaps
    values = keys ^ VALUE_XOR
    pool, meta = pool_mod.build_pool(
        keys, values, level_m=1, fill=0.7, n_shards=4, device=device
    )
    del values
    return keys, pool, meta


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    print(ops.build(verbose=True)[1], end="")
    ops.library()
    took = time.perf_counter() - t0
    print(f"build: {took:.1f} s (nvcc {ops.BUILD_SECONDS[0]:.1f} s)")


def node_search_inputs(pool, keys, n, seed):
    """Rows of the real pool (inner and leaf rows) with queries that hit,
    miss, fall below the row's first key, or are KEY_MIN / KEY_MAX /
    negative."""
    import torch

    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    dev = keys.device
    g = torch.Generator(device=dev).manual_seed(seed)
    flat_k = pool.pool_keys.view(-1, 64)
    flat_v = pool.pool_values.view(-1, 64)
    occupied = torch.nonzero(flat_k[:, 0] != KEY_MAX)[:, 0]
    which = torch.randint(0, occupied.numel(), (n,), generator=g, device=dev)
    rows_id = occupied[which]
    rows = flat_k[rows_id]
    vals = flat_v[rows_id]
    occ = (rows != KEY_MAX).sum(1)
    pick = (torch.rand(n, generator=g, device=dev) * occ).long()
    q = rows.gather(1, pick[:, None])[:, 0].clone()
    lane = torch.arange(n, device=dev)
    q = torch.where(lane % 4 == 1, q + 1, q)
    q = torch.where(lane % 4 == 2, rows[:, 0] - 1, q)
    q = torch.where(lane % 16 == 3, KEY_MAX, q)
    q = torch.where(lane % 16 == 7, KEY_MIN, q)
    q = torch.where(lane % 16 == 11, -3, q)
    return rows.contiguous(), q.contiguous(), vals.contiguous()


def walk_bytes(pool, st, q, levels, found):
    """Least bytes a walk must move: a binary search of each distinct row it
    reads (``ROW_SEARCH_BYTES``), each distinct child id read (4 B), the
    matched values (8 B), the per-lane inputs (subtree 4 B, query 8 B) and
    outputs (9 B)."""
    import torch

    cap = pool.pool_keys.shape[1]
    local = torch.zeros_like(q)
    rows, kids = [], []
    stl = st.long()
    for _ in range(levels - 1):
        gid = stl * cap + local
        rows.append(gid)
        r = pool.pool_keys[stl, local]
        slot = ((r <= q[:, None]).sum(1) - 1).clamp(min=0)
        kids.append(gid * 64 + slot)
        local = pool.pool_children[stl, local, slot].long()
        local = torch.where(local < 0, local + cap, local)
    rows.append(stl * cap + local)
    n_rows = torch.unique(torch.cat(rows)).numel()
    n_kids = torch.unique(torch.cat(kids)).numel() if kids else 0
    n = q.numel()
    return (
        ROW_SEARCH_BYTES * n_rows
        + 4 * n_kids
        + 8 * int(found.sum())
        + 12 * n
        + 13 * n
    )


def leaf_write_inputs(q, seed, dev):
    """Contract inputs of ``leaf_write`` made on the card from ``seed``:
    sorted rows with KEY_MAX padding, KEY_MIN and negative keys; rows with
    only updates, only inserts, both, and nothing staged (by ``row % 4``);
    rows filled to exactly 64 (every eighth from row 1); staged keys below a
    row's first key and above its last; in every third row the active staged
    inserts spread among inactive entries, elsewhere a prefix."""
    import torch

    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    f = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    big = 2**62

    def ints(shape):
        return torch.randint(-big, big, shape, generator=g, device=dev)

    def counts(high):
        return torch.randint(0, high, (q,), generator=g, device=dev)

    col = torch.arange(f, device=dev)[None, :]
    row = torch.arange(q, device=dev)
    pool = ints((q, 2 * f)).sort(1).values + torch.arange(2 * f, device=dev)
    pool[::5, 0] = KEY_MIN
    inv = torch.rand((q, 2 * f), generator=g, device=dev).argsort(1).argsort(1)
    occ = counts(f + 1)
    kind = row % 4
    n_ins = torch.where((kind == 1) | (kind == 2), counts(f + 1), 0)
    n_ins = torch.minimum(n_ins, f - occ)
    n_ins[1::8] = f - occ[1::8]

    def pick(mask, n):
        idx = (~mask).to(torch.int8).argsort(dim=1, stable=True)[:, :f]
        return torch.where(col < n[:, None], pool.gather(1, idx), KEY_MAX)

    rows_k = pick(inv < occ[:, None], occ)
    staged = pick((inv >= occ[:, None]) & (inv < (occ + n_ins)[:, None]), n_ins)
    rows_v = torch.where(rows_k != KEY_MAX, ints((q, f)), 0)
    # every third row: the active entries at random ascending positions
    rank = torch.rand((q, f), generator=g, device=dev).argsort(1).argsort(1)
    spot = rank < n_ins[:, None]
    nth = (spot.long().cumsum(1) - 1).clamp(min=0)
    spread = torch.where(spot, staged.gather(1, nth), KEY_MAX)
    ins_key = torch.where((row % 3 == 0)[:, None], spread, staged)
    ins_val = torch.where(ins_key != KEY_MAX, ints((q, f)), 0)
    n_upd = torch.where((kind == 0) | (kind == 2), counts(f + 1), 0)
    n_upd = torch.minimum(n_upd, occ)
    scores = torch.where(
        col < occ[:, None], torch.rand((q, f), generator=g, device=dev), 2.0
    )
    slots = scores.argsort(1)
    upd_slot = torch.where(col < n_upd[:, None], slots, -1).to(torch.int32)
    upd_val = torch.where(upd_slot >= 0, ints((q, f)), 0)
    return rows_k, rows_v, upd_slot, upd_val, ins_key, ins_val


def phase_kernels(pool, meta, keys, seed):
    """Each kernel at the main path's shapes, against its plain version."""
    import torch

    from repro_torch.core import pool as pool_mod
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.core.routing import route_capacity
    from repro_torch.kernels import ops, ref

    cfg = mesh_config("auto", 65_536)
    per_dev = BATCH // cfg.n_devices
    cap = route_capacity(per_dev, cfg.n_route, cfg.route_capacity_factor)
    n_ns = cfg.n_devices * cfg.n_route * cap  # descent rows
    wcap = route_capacity(cfg.n_route * cap, cfg.n_memory, cfg.route_capacity_factor)
    n_sw = cfg.n_devices * cfg.n_memory * wcap  # owner-walk lanes
    out = {}

    rows, q, vals = node_search_inputs(pool, keys, n_ns, seed)
    got = ops.node_search(rows, q, vals)
    want = ref.node_search_ref(rows, q, vals)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    if not equal:
        fail(f"node_search differs from its plain version (max abs err {err})")
    # a binary search per row, the query in, slot/found/value out, and the
    # one value read where the row holds the query
    matched = int((rows == q[:, None]).sum())
    nbytes = n_ns * (ROW_SEARCH_BYTES + 8 + 4 + 1 + 8) + 8 * matched
    out["node_search"] = dict(
        name="node_search",
        route="cuda",
        source="src/repro_torch/csrc/node_search.cu",
        replaces="src/repro/kernels/node_search.py:64",
        shape=f"rows [{n_ns}, 64] i64",
        bit_equal=True,
        max_abs_err=err,
        ms=cuda_ms(lambda: ops.node_search(rows, q, vals), 20),
        plain_ms=cuda_ms(lambda: ref.node_search_ref(rows, q, vals), 5),
        library_ms=cuda_ms(
            lambda: torch.searchsorted(rows, q[:, None], right=True), 20
        ),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )

    # owner walks: real subtrees from the top walk, plus random blocks
    g = torch.Generator(device=keys.device).manual_seed(seed + 1)
    n_real = n_sw // 2
    idx = torch.randint(0, keys.numel(), (n_sw,), generator=g, device=keys.device)
    qw = keys[idx].clone()
    lane = torch.arange(n_sw, device=keys.device)
    qw = torch.where(lane % 4 == 1, qw + 1, qw)
    qw = torch.where(lane % 16 == 3, KEY_MAX, qw)
    qw = torch.where(lane % 16 == 7, KEY_MIN, qw)
    qw = torch.where(lane % 16 == 11, -3, qw)
    st = pool_mod.top_walk(pool, meta, qw)
    rand_st = torch.randint(
        0, meta.n_subtrees, (n_sw,), generator=g, device=keys.device
    )
    st = torch.where(lane < n_real, st, rand_st).to(torch.int32)
    levels = meta.levels_in_subtree
    args = (pool.pool_keys, pool.pool_children, pool.pool_values, st, qw)
    got = ops.subtree_walk(*args, levels=levels)
    want = ref.subtree_walk_ref(*args, levels=levels)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    if not equal:
        fail(f"subtree_walk differs from its plain version (max abs err {err})")
    nbytes = walk_bytes(pool, st, qw, levels, got[0])
    out["subtree_walk"] = dict(
        name="subtree_walk",
        route="cuda",
        source="src/repro_torch/csrc/subtree_walk.cu",
        replaces="src/repro/kernels/subtree_walk.py:119",
        shape=f"{n_sw} lanes over pool {list(pool.pool_keys.shape)}",
        bit_equal=True,
        max_abs_err=err,
        ms=cuda_ms(lambda: ops.subtree_walk(*args, levels=levels), 20),
        plain_ms=cuda_ms(lambda: ref.subtree_walk_ref(*args, levels=levels), 3),
        library_ms=None,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    # leaf writes: one staged row per request slot of every column's
    # gathered batch, as the write path stages them
    n_lw = cfg.n_memory * cfg.n_route * cfg.n_memory * wcap
    args = leaf_write_inputs(n_lw, seed + 2, keys.device)
    got = ops.leaf_write(*args)
    want = ref.leaf_write_ref(*args)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    if not equal:
        fail(f"leaf_write differs from its plain version (max abs err {err})")
    n_upd = int((args[2] >= 0).sum())
    n_ins = int((args[4] != KEY_MAX).sum())
    nbytes = (
        n_lw * LEAF_ROW_BYTES
        + n_upd * STAGED_UPDATE_BYTES
        + n_ins * STAGED_INSERT_BYTES
    )
    out["leaf_write"] = dict(
        name="leaf_write",
        route="cuda",
        source="src/repro_torch/csrc/leaf_write.cu",
        replaces="src/repro/kernels/leaf_write.py:138",
        shape=f"rows [{n_lw}, 64] i64, {n_upd} updates, {n_ins} inserts staged",
        bit_equal=True,
        max_abs_err=err,
        ms=cuda_ms(lambda: ops.leaf_write(*args), 20),
        plain_ms=cuda_ms(lambda: ref.leaf_write_ref(*args), 3),
        library_ms=None,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    del args, got, want
    card = torch.cuda.get_device_name(keys.device)
    for k in out.values():
        print(
            f"kernel {k['name']}: {k['shape']}: bit-equal, kernel {k['ms']:.4f} ms,"
            f" plain {k['plain_ms']:.4f} ms, library {k['library_ms']} ms,"
            f" bound {k['bound_ms']:.4f} ms on {card}"
        )
    return out


def mixed_batch(rng, keys, lanes, hot, overflow):
    """One batch of random lookups, updates and inserts of fresh keys; the
    ``hot`` keys take the first lanes as updates; ``overflow`` keys (fresh
    keys of one leaf, more than its slack) follow as inserts."""
    from repro_torch.core.engine import OP_INSERT, OP_UPDATE
    from repro_torch.core.nodes import KEY_MAX

    opc = rng.integers(0, 3, size=lanes).astype("int32")
    kk = rng.choice(keys, size=lanes)
    fresh = kk + rng.integers(1, 4, size=lanes)
    ins = (opc == OP_INSERT) & ~np.isin(fresh, keys)
    kk[ins] = fresh[ins]
    h, o = len(hot), len(overflow)
    opc[:h] = OP_UPDATE
    kk[:h] = hot
    opc[h : h + o] = OP_INSERT
    kk[h : h + o] = overflow
    vals = kk ^ rng.integers(1, 2**40, size=lanes)
    kk[::29] = KEY_MAX
    return opc, kk, vals


def phase_cpu_vs_cuda(seed, devices=("cpu", "cuda")):
    """The port on the CPU (plain versions) and on the card (kernels) give
    the same lane results and state planes: lookups under ``fetch`` (the
    cache and its duplicate admissions), ``fetch`` with buckets small enough
    to shed, and ``auto``; mixed lookups, updates and inserts under
    ``fetch``, shedding ``fetch``, ``offload`` and ``auto``, comparing every
    plane (pool, occupancy and versions included)."""
    from repro_torch.core import dex, engine
    from repro_torch.core import pool as pool_mod
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.obs.registry import STAT_DROPS, STAT_SPLITS, STAT_WRITES

    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    keys -= 2**39
    bounds = np.array([KEY_MIN, keys[keys.size // 2], KEY_MAX], np.int64)
    lookups = []
    for _ in range(3):
        q = rng.choice(keys, size=4096).astype(np.int64)
        q[::13] += 1
        q[::29] = KEY_MAX
        z = np.zeros(q.shape, np.int64)
        lookups.append((z.astype(np.int32), q, z))
    # 30 fresh keys into one leaf (44 keys at fill 0.7, 20 slots of slack)
    overflow = keys[4400:4430] + 1
    mixed = [
        mixed_batch(rng, keys, 4096, keys[100:116], overflow if i == 1 else [])
        for i in range(3)
    ]
    look_planes = ("stats", "miss_ema", "lat_hist", "lat_audit", "route_demand")
    runs = [
        ("lookups", ("lookup",), lookups, "fetch", 4.0),
        ("lookups", ("lookup",), lookups, "fetch", 0.5),
        ("lookups", ("lookup",), lookups, "auto", 4.0),
        ("mixed", engine.PORTED_OPS, mixed, "fetch", 4.0),
        ("mixed", engine.PORTED_OPS, mixed, "fetch", 0.5),
        ("mixed", engine.PORTED_OPS, mixed, "offload", 4.0),
        ("mixed", engine.PORTED_OPS, mixed, "auto", 4.0),
    ]
    for label, ops_, batches, policy, factor in runs:
        cfg = mesh_config(policy, 64, factor)
        out = []
        for dev in devices:
            pool, meta = pool_mod.build_pool(
                keys, keys ^ VALUE_XOR, level_m=1, n_shards=4, device=dev
            )
            state = dex.init_state(pool, meta, cfg, bounds, device=dev)
            eng = engine.make_dex_engine(meta, cfg, ops=ops_, device=dev)
            out.append([])
            for opc, q, v in batches:
                state, r = eng(state, opc, q, v)
                got = dex.state_to_numpy(state)
                if label == "lookups":
                    got = {
                        k: a
                        for k, a in got.items()
                        if k.startswith("cache.") or k in look_planes
                    }
                for k, a in r._asdict().items():
                    got[k] = a.cpu().numpy()
                out[-1].append(got)
        for i, (a, b) in enumerate(zip(*out)):
            for k in a:
                if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                    fail(
                        f"{label} {policy} x{factor}: CPU and CUDA differ at"
                        f" batch {i}: {k}"
                    )
        stats = out[0][-1]["stats"].sum(0)
        print(
            f"cpu-vs-cuda {label} {policy} x{factor}: 3 batches of 4096 lanes,"
            f" 2x4 mesh, all {len(a)} planes and results equal"
            f" ({stats[STAT_DROPS]} shed, {stats[STAT_WRITES]} writes,"
            f" {stats[STAT_SPLITS]} splits)"
        )
        if label == "mixed" and factor >= 1 and stats[STAT_SPLITS] == 0:
            fail(f"mixed {policy} x{factor}: no insert was shed as a split")


def profile_batch(policy, eng, state, median_ms, *inputs):
    """Run one batch under ``torch.profiler``; print its device busy time,
    the idle share of ``median_ms`` (the policy's unprofiled median batch,
    since the profiler itself slows the host) and the kernels that took the
    most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the profiler's notice on event cycles
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            out = eng(state, *inputs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's row repeats its kernels' device time
    events = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    events = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    busy = sum(ms for _, ms, _ in events)
    top = "; ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, ms, n in events[:8])
    print(
        f"profile {policy}: wall {wall:.2f} ms under the profiler, device busy"
        f" {busy:.2f} ms, idle {1 - busy / median_ms:.1%} of the unprofiled"
        f" median {median_ms:.2f} ms; top: {top}"
    )
    return out


class HostOracle:
    """The index's contents on the host: the bulk-loaded keys (each value a
    fixed function of its key) and every write the engine acknowledged."""

    def __init__(self, host_keys):
        self.keys = host_keys
        self.written = {}  # key -> value of each acknowledged write

    def lookup(self, q):
        """``(found, value)`` of each key of ``q`` in the current contents."""
        n = self.keys.size
        # sorted queries let each search start from the last one's answer
        order = np.argsort(q, kind="stable")
        pos = np.empty_like(order)
        pos[order] = np.searchsorted(self.keys, q[order])
        found = (pos < n) & (self.keys[np.minimum(pos, n - 1)] == q)
        w = self.written
        in_w = np.fromiter((k in w for k in q.tolist()), bool, count=q.size)
        value = q ^ VALUE_XOR
        if in_w.any():
            value[in_w] = [w[k] for k in q[in_w].tolist()]
        return found | in_w, value

    def check(self, where, opc, kk, vals, r):
        """Hold one batch's results to the contents before it, then apply
        its acknowledged writes in lane order (the last lane of a key wins).
        Returns ``(lanes checked, lanes shed, splits)``."""
        from repro_torch.core.engine import OP_INSERT, OP_LOOKUP, OP_UPDATE
        from repro_torch.core.write import STATUS_MISS, STATUS_OK, STATUS_SPLIT

        found, values, status, shed = (t.cpu().numpy() for t in r)
        ok = ~shed
        exists, cur = self.lookup(kk)
        lk = ok & (opc == OP_LOOKUP)
        if not (found[lk] == exists[lk]).all():
            fail(f"{where}: found differs from the host oracle")
        if not (values[lk & exists] == cur[lk & exists]).all():
            fail(f"{where}: values differ from the host oracle")
        up = ok & (opc == OP_UPDATE)
        if not (status[up] == np.where(exists[up], STATUS_OK, STATUS_MISS)).all():
            fail(f"{where}: an update's status differs from the host oracle")
        ins = ok & (opc == OP_INSERT)
        if not np.isin(status[ins], (STATUS_OK, STATUS_SPLIT)).all():
            fail(f"{where}: an insert was neither applied nor shed as a split")
        done = (up | ins) & (status == STATUS_OK)
        self.written.update(zip(kk[done].tolist(), vals[done].tolist()))
        return int(ok.sum()), int(shed.sum()), int((status == STATUS_SPLIT).sum())


def phase_main(args, keys, pool, meta):
    """The full-size runs of ``MAIN_RUNS``, in order, on one index: the
    engine writes the pool in place, so each run starts from the contents
    the runs before it left, and so does the host oracle."""
    import torch

    from repro_torch.core import dex, engine
    from repro_torch.core.nodes import KEY_MIN, KEY_MAX
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    n = keys.numel()
    dev = keys.device
    host_keys = keys.cpu().numpy()
    bounds = np.array([KEY_MIN, host_keys[n // 2], KEY_MAX], np.int64)
    oracle = HostOracle(host_keys)
    engine_ops = {
        "read-only": ("lookup",),
        "ycsb-a": ("lookup", "update"),
        "insert-intensive": ("lookup", "insert"),
    }
    # the kernels each path must launch
    path_kernels = {
        "read-only": ("node_search", "subtree_walk"),
        "ycsb-a": ("node_search", "subtree_walk", "leaf_write"),
        "insert-intensive": ("node_search", "subtree_walk", "leaf_write"),
    }
    report, per_path = {}, {}
    batch_no = 0
    for w_i, workload in enumerate(dict.fromkeys(r[0] for r in MAIN_RUNS)):
        runs = [r for r in MAIN_RUNS if r[0] == workload]
        ops.reset_launches()
        total = sum(warm + timed + 1 for _, _, warm, timed in runs)
        wl = ycsb.generate(workload, host_keys, BATCH * total, seed=args.seed + 1 + w_i)
        off = 0
        for _, policy, warm, timed in runs:
            cfg = mesh_config(policy, 65_536)
            state = dex.init_state(pool, meta, cfg, bounds, device=dev)
            eng = engine.make_dex_engine(
                meta, cfg, ops=engine_ops[workload], device=dev
            )
            torch.cuda.reset_peak_memory_stats()
            times, batches = [], []
            for i in range(warm + timed + 1):
                opc = wl.ops[off : off + BATCH]
                kk = wl.keys[off : off + BATCH]
                off += BATCH
                batch_no += 1
                # a value no earlier write of the key has had
                stamp = (batch_no << 20) + np.arange(BATCH)
                vals = kk ^ VALUE_XOR ^ stamp
                inputs = [torch.from_numpy(a).to(dev) for a in (opc, kk, vals)]
                torch.cuda.synchronize()
                if i == warm + timed:
                    # one more batch under the profiler: where the time goes
                    med = float(np.median(times))
                    label = f"{workload} {policy}"
                    state, r = profile_batch(label, eng, state, med, *inputs)
                else:
                    t0 = time.perf_counter()
                    state, r = eng(state, *inputs)
                    torch.cuda.synchronize()
                    if i >= warm:
                        times.append((time.perf_counter() - t0) * 1e3)
                batches.append((opc, kk, vals, r))
            # the oracle's host work runs after the batches, not between them
            checked, shed, splits = 0, 0, 0
            for i, (opc, kk, vals, r) in enumerate(batches):
                where = f"{workload} {policy} batch {i}"
                c, s_, sp = oracle.check(where, opc, kk, vals, r)
                checked, shed, splits = checked + c, shed + s_, splits + sp
            del batches
            stats = state.stats.sum(0).cpu().numpy()
            med = float(np.median(times))
            run = f"{workload}/{policy}"
            report[run] = dict(
                median_ms=med,
                p25_ms=float(np.percentile(times, 25)),
                p75_ms=float(np.percentile(times, 75)),
                ops_per_s=BATCH / med * 1e3,
                batches=timed,
                checked_lanes=checked,
                shed_lanes=shed,
                split_lanes=splits,
                hits=int(stats[reg.STAT_HITS]),
                fetches=int(stats[reg.STAT_FETCHES]),
                offloads=int(stats[reg.STAT_OFFLOADS]),
                writes=int(stats[reg.STAT_WRITES]),
                splits=int(stats[reg.STAT_SPLITS]),
                drops=int(stats[reg.STAT_DROPS]),
                offload_groups=int(stats[reg.STAT_OFFLOAD_GROUPS]),
                fetch_groups=int(stats[reg.STAT_FETCH_GROUPS]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            )
            print(f"main {workload} {policy}: {json.dumps(report[run])}")
            del state, eng
        per_path[workload] = dict(ops.LAUNCHES)
        print(f"main {workload}: launches {per_path[workload]}")
        for k in path_kernels[workload]:
            if per_path[workload][k] <= 0:
                fail(f"kernel {k} was not launched on the {workload} path")
    launches = {k: sum(p[k] for p in per_path.values()) for k in ops.LAUNCHES}
    print(f"main: {len(oracle.written)} keys written; launches {launches}")
    return report, launches


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; no result", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    dev = torch.device("cuda")
    if args.n_keys != FULL_KEYS:
        print("reduced: " + json.dumps(
            {"n_keys": args.n_keys, "reason": "--n-keys set on the command line"}
        ))
    t0 = time.perf_counter()
    keys, pool, meta = make_index(args.n_keys, args.seed, dev)
    torch.cuda.synchronize()
    print(
        f"index: {args.n_keys} keys, {meta.n_subtrees_padded} subtrees x "
        f"{meta.subtree_cap} nodes, top height {meta.top_height}, "
        f"built in {time.perf_counter() - t0:.1f} s"
    )
    t0 = time.perf_counter()
    kernels = phase_kernels(pool, meta, keys, args.seed)
    t1 = time.perf_counter()
    phase_cpu_vs_cuda(args.seed)
    t2 = time.perf_counter()
    report, launches = phase_main(args, keys, pool, meta)
    t3 = time.perf_counter()
    print(f"phases: kernels {t1 - t0:.1f} s, cpu-vs-cuda {t2 - t1:.1f} s,"
          f" main {t3 - t2:.1f} s")
    rows = []
    for name, k in kernels.items():
        rows.append(dict(
            name=name,
            route=k["route"],
            source=k["source"],
            replaces=k["replaces"],
            launches=launches[name],
            max_abs_err=k["max_abs_err"],
            ms=k["ms"],
            plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"],
            bound_by=k["bound_by"],
            library_ms=k["library_ms"],
            bit_equal=k["bit_equal"],
        ))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
