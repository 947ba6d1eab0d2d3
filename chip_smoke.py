#!/usr/bin/env python3
"""Drive the PyTorch port's lookup path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--n-keys 200000000]

Phases, in order; any failure exits non-zero:

  1. device: the card's name and power limit (``nvidia-smi``), CUDA version;
  2. build: compile the CUDA kernels from ``src/repro_torch/csrc``;
  3. kernels: ``node_search`` and ``subtree_walk`` at the main path's shapes
     (65,536-lane batches on a 2x4 virtual mesh) on seeded inputs with
     misses, KEY_MIN / KEY_MAX, negative keys and queries below a row's
     first key, bit-equal to their plain PyTorch versions, and timed beside
     the plain version and a PyTorch yardstick;
  4. the port on the CPU and on the card give the same lane results and
     state planes (20k keys, 2x4 mesh, 3 batches under ``fetch``, ``fetch``
     with shedding buckets, and ``auto``);
  5. the main path at full size: 200M sorted int64 keys made on the card
     from ``--seed``, level-M = 1 subtree blocks at fill 0.7, a 2x4 virtual
     mesh split at the median key, 65,536 sets x 4 ways of cache per
     virtual device, and YCSB workload C traffic (100% reads, scrambled
     Zipfian, theta 0.99) in 65,536-lane batches under ``offload``,
     ``fetch`` and ``auto``; every lane that is not shed must match a host
     oracle (``np.searchsorted`` on the sorted keys);
  6. one JSON line of per-kernel launches, errors and times.

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

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FULL_KEYS = 200_000_000  # the paper's bulk load (YCSB, §8.1)
BATCH = 65_536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# The least a search of one sorted 64-key row must read: a binary search
# over its sixteen 32-byte sectors (4 keys each), ceil(log2(16 + 1)) reads.
ROW_SEARCH_BYTES = 32 * 5
VALUE_XOR = 0x5DEECE66D
POLICY_BATCHES = (("offload", 1, 10), ("fetch", 2, 10), ("auto", 3, 20))


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
        + 9 * n
    )


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
    card = torch.cuda.get_device_name(keys.device)
    for k in out.values():
        print(
            f"kernel {k['name']}: {k['shape']}: bit-equal, kernel {k['ms']:.4f} ms,"
            f" plain {k['plain_ms']:.4f} ms, library {k['library_ms']} ms,"
            f" bound {k['bound_ms']:.4f} ms on {card}"
        )
    return out


def phase_cpu_vs_cuda(seed, devices=("cpu", "cuda")):
    """The port on the CPU (plain versions) and on the card (kernels) give
    the same lane results and state planes: under ``fetch`` (the cache and
    its duplicate admissions), ``fetch`` with buckets small enough to shed,
    and ``auto``."""
    import numpy as np

    from repro_torch.core import dex, engine
    from repro_torch.core import pool as pool_mod
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.obs.registry import STAT_DROPS

    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    keys -= 2**39
    bounds = np.array([KEY_MIN, keys[keys.size // 2], KEY_MAX], np.int64)
    batches = []
    for _ in range(3):
        q = rng.choice(keys, size=4096).astype(np.int64)
        q[::13] += 1
        q[::29] = KEY_MAX
        batches.append(q)
    planes = ("stats", "miss_ema", "lat_hist", "lat_audit", "route_demand")
    for policy, factor in (("fetch", 4.0), ("fetch", 0.5), ("auto", 4.0)):
        cfg = mesh_config(policy, 64, factor)
        runs = []
        for dev in devices:
            pool, meta = pool_mod.build_pool(
                keys, keys ^ VALUE_XOR, level_m=1, n_shards=4, device=dev
            )
            state = dex.init_state(pool, meta, cfg, bounds, device=dev)
            eng = engine.make_dex_engine(meta, cfg, device=dev)
            out = []
            for q in batches:
                z = np.zeros(q.shape, np.int64)
                state, r = eng(state, z.astype(np.int32), q, z)
                got = {
                    k: v
                    for k, v in dex.state_to_numpy(state).items()
                    if k.startswith("cache.") or k in planes
                }
                for k, v in r._asdict().items():
                    got[k] = v.cpu().numpy()
                out.append(got)
            runs.append(out)
        for i, (a, b) in enumerate(zip(*runs)):
            for k in a:
                if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                    fail(f"{policy} x{factor}: CPU and CUDA differ at batch {i}: {k}")
        shed = int(runs[0][-1]["stats"][:, STAT_DROPS].sum())
        print(
            f"cpu-vs-cuda {policy} x{factor}: 3 batches of 4096 lanes, 2x4 mesh,"
            f" all planes equal ({shed} shed)"
        )


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


def phase_main(args, keys, pool, meta):
    """The full-size YCSB-C run under each policy."""
    import numpy as np
    import torch

    from repro_torch.core import dex, engine
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    n = keys.numel()
    host_keys = keys.cpu().numpy()
    bounds = np.array([KEY_MIN, host_keys[n // 2], KEY_MAX], np.int64)
    total = sum(w + t + 1 for _, w, t in POLICY_BATCHES)
    wl = ycsb.generate("read-only", n, BATCH * total, seed=args.seed + 1)
    if not (wl.ops == ycsb.OP_LOOKUP).all():
        fail("YCSB-C traffic must be all reads")
    idx = torch.from_numpy(wl.idx).to(keys.device)
    zero64 = torch.zeros(BATCH, dtype=torch.int64, device=keys.device)
    zero32 = torch.zeros(BATCH, dtype=torch.int32, device=keys.device)
    report = {}
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    off = 0
    for policy, warm, timed in POLICY_BATCHES:
        cfg = mesh_config(policy, 65_536)
        state = dex.init_state(pool, meta, cfg, bounds, device=keys.device)
        eng = engine.make_dex_engine(meta, cfg, device=keys.device)
        times, shed_total, checked = [], 0, 0
        for i in range(warm + timed + 1):
            q = keys[idx[off : off + BATCH]]
            off += BATCH
            torch.cuda.synchronize()
            if i == warm + timed:
                # one more batch under the profiler: where the time goes
                med = float(np.median(times))
                state, r = profile_batch(policy, eng, state, med, zero32, q, zero64)
            else:
                t0 = time.perf_counter()
                state, r = eng(state, zero32, q, zero64)
                torch.cuda.synchronize()
                if i >= warm:
                    times.append((time.perf_counter() - t0) * 1e3)
            qh = q.cpu().numpy()
            found = r.found.cpu().numpy()
            vals = r.values.cpu().numpy()
            shed = r.shed.cpu().numpy()
            pos = np.searchsorted(host_keys, qh)
            hit = (pos < n) & (host_keys[np.minimum(pos, n - 1)] == qh)
            ok = ~shed
            if not (found[ok] == hit[ok]).all():
                fail(f"{policy} batch {i}: found differs from the host oracle")
            if not (vals[ok & hit] == (qh[ok & hit] ^ VALUE_XOR)).all():
                fail(f"{policy} batch {i}: values differ from the host oracle")
            shed_total += int(shed.sum())
            checked += int(ok.sum())
        stats = state.stats.sum(0).cpu().numpy()
        med = float(np.median(times))
        report[policy] = dict(
            median_ms=med,
            p25_ms=float(np.percentile(times, 25)),
            p75_ms=float(np.percentile(times, 75)),
            lookups_per_s=BATCH / med * 1e3,
            batches=timed,
            checked_lanes=checked,
            shed_lanes=shed_total,
            hits=int(stats[reg.STAT_HITS]),
            fetches=int(stats[reg.STAT_FETCHES]),
            offloads=int(stats[reg.STAT_OFFLOADS]),
            offload_groups=int(stats[reg.STAT_OFFLOAD_GROUPS]),
            fetch_groups=int(stats[reg.STAT_FETCH_GROUPS]),
            drops=int(stats[reg.STAT_DROPS]),
        )
        print(f"main {policy}: " + json.dumps(report[policy]))
        del state
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"main: peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
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
    kernels = phase_kernels(pool, meta, keys, args.seed)
    phase_cpu_vs_cuda(args.seed)
    report, launches = phase_main(args, keys, pool, meta)
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
