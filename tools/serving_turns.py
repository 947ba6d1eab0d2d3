#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s decode loop (phase 6, ``phase_serving``: a model
at full width and depth, 64 slots, 640 steps through the DEX page table) of
this checkout and of another in turns on one NVIDIA GPU, to compare two
versions on one host.

    python3 tools/serving_turns.py --other DIR [--arch minitron-4b]
                                   [--turns ABBA] [--seed 0] [--log FILE]

``DIR`` is another checkout's root (say the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists).  Each turn
runs in a process of its own, with the checkout's ``chip_smoke.py`` and
package: it builds that checkout's kernels (``phase_build``, cached after
the first turn) and serves.  ``--turns`` names the order, ``A`` this
checkout and ``B`` the other.  Prints the card's name and power limit, one
line a turn (decode median and quartiles in ms, tokens/s, the profiled
step's device busy ms, the phase's seconds) and a JSON summary; each
turn's whole output goes to ``--log``.  Any failed turn exits non-zero."""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("median_ms", "p25_ms", "p75_ms", "tokens_per_s", "device_busy_ms", "kernels_per_step")


def child(root: pathlib.Path, arch: str, seed: int) -> int:
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs

    cs.phase_build()
    t0 = time.perf_counter()
    report = cs.phase_serving(seed, arch)[0]
    out = {k: report[k] for k in KEYS}
    out["phase_s"] = time.perf_counter() - t0
    print("TURN " + json.dumps(out))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", type=pathlib.Path, required=True)
    p.add_argument("--arch", default="minitron-4b")
    p.add_argument("--turns", default="ABBA")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log", type=pathlib.Path, default=None)
    p.add_argument("--child", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child is not None:
        return child(args.child.resolve(), args.arch, args.seed)
    import torch

    if not torch.cuda.is_available():
        print("serving_turns: CUDA is not available", file=sys.stderr)
        return 2
    roots = {"A": ROOT, "B": args.other.resolve()}
    if not (roots["B"] / "chip_smoke.py").is_file():
        print(f"serving_turns: {roots['B']} holds no chip_smoke.py", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    log = open(args.log, "w") if args.log else None
    turns = []
    for i, which in enumerate(args.turns):
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "--other", str(roots["B"]),
               "--arch", args.arch, "--seed", str(args.seed), "--child", str(roots[which])]
        done = subprocess.run(cmd, capture_output=True, text=True, cwd=roots[which])
        if log:
            log.write(f"==== turn {i} {which} {roots[which]} rc {done.returncode}\n")
            log.write(done.stdout + done.stderr)
            log.flush()
        lines = [x for x in done.stdout.splitlines() if x.startswith("TURN ")]
        if done.returncode or not lines:
            print(f"turn {i} ({which}) failed, rc {done.returncode}:\n{done.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        row = dict(turn=i, which=which, root=str(roots[which]), **json.loads(lines[-1][5:]))
        turns.append(row)
        print(f"turn {i} {which}: " + ", ".join(f"{k} {row[k]}" for k in (*KEYS, "phase_s")))
    print(json.dumps({"device": smi, "arch": args.arch, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
