#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s index phases alone on one NVIDIA GPU, on
the 200M-key index, without the rest of the script: a quicker check of a
change to those phases.

    python3 tools/index_phases.py [--phases route_axes,telemetry,drain,ranks]
                                  [--cpu-vs-cuda] [--n-keys N] [--seed S]

Prints the card's name and power limit, builds the kernels
(``chip_smoke.phase_build``) and the index (``chip_smoke.make_index``),
optionally runs phase 4 (``phase_cpu_vs_cuda``), then the named phases in
order on one host oracle of the load, with the successor table of a fresh
state (no phase before them split a leaf).  ``drain`` must come last: it
rebuilds the pool.  ``ranks`` (``phase_ranks``, the index mesh over ranks)
builds an index of its own; named alone, no shared index is built.  Any
failure exits non-zero.  The numbers to keep come
from ``chip_smoke.py`` itself, where earlier phases have written the index."""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="route_axes,telemetry,drain")
    p.add_argument("--cpu-vs-cuda", action="store_true")
    p.add_argument("--n-keys", type=int, default=cs.FULL_KEYS)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    from repro_torch.core import dex
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    if not torch.cuda.is_available():
        print("index_phases: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.phase_device())
    cs.phase_build()
    if args.cpu_vs_cuda:
        t0 = time.perf_counter()
        cs.phase_cpu_vs_cuda(args.seed)
        print(f"cpu-vs-cuda: {time.perf_counter() - t0:.1f} s")
    names = args.phases.split(",")
    if names == ["ranks"]:
        t0 = time.perf_counter()
        cs.phase_ranks(args)
        print(f"phase ranks: {time.perf_counter() - t0:.1f} s")
        return 0
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    keys, pool, meta = cs.make_index(args.n_keys, args.seed, dev)
    torch.cuda.synchronize()
    print(f"index: {args.n_keys} keys in {time.perf_counter() - t0:.1f} s")
    host = keys.cpu().numpy()
    oracle = cs.HostOracle(host)
    bounds = np.array([KEY_MIN, host[host.size // 2], KEY_MAX], np.int64)
    fresh = dex.init_state(pool, meta, cs.mesh_config("fetch", 64), bounds, device=dev)
    carried = (fresh.succ, fresh.n_alloc)
    del fresh
    for name in names:
        t0 = time.perf_counter()
        if name == "ranks":
            cs.phase_ranks(args)
        else:
            getattr(cs, f"phase_{name}")(args, keys, pool, meta, oracle, bounds, carried)
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
