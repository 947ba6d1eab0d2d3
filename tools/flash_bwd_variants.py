#!/usr/bin/env python3
"""Time design variants of the bf16 ``flash_attention`` backward on one
NVIDIA GPU, against the kernel the package builds.

    python3 tools/flash_bwd_variants.py [--variants default,hold1,...]

Each variant is ``csrc/flash_attention_bwd.cu`` (with ``tma.cuh`` and
``wgmma.cuh``) with some of its tile constants replaced (``VARIANTS``),
built alone with nvcc into ``build/variants/<name>/`` and called through
its C entry.  At each of ``chip_smoke.FLASH_BWD_SHAPES`` (bf16) every
variant is held bit-equal to the package's kernel, then timed cold and hot
(``chip_smoke.cold_and_hot``: 20 calls each) in turns, the variants in
order and then in reverse, so a drift of the card's clock falls on all of
them; the table gives both turns' mean.  The package's own launch is split
by kernel (pre-pass, dK / dV, dQ) from one profiled call of five.  Prints
each variant's ptxas spills and C75xx warnings, and the card's name and
power limit.  Needs the card and nvcc; builds in about 15 s."""

from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: name -> constants of csrc/flash_attention_bwd.cu replaced
VARIANTS = {
    "default": {},
    "hold1": {"kHold": 1},  # one buffer of an item's held tiles
    "stages2": {"kStages": 2},  # two ring slots
    "pipelined128": {"kPipelinedMaxD": 128},  # the pipelined dK / dV loop at 128 too
    "serial64": {"kPipelinedMaxD": 0},  # the one-tile-at-a-time loop at 64 too
}


def build(names):
    """Build each variant's library in parallel; returns name -> (CDLL,
    ptxas notes)."""
    from repro_torch.kernels import ops

    src = ROOT / "src" / "repro_torch" / "csrc"
    procs = {}
    for name in names:
        out = ROOT / "build" / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in ("tma.cuh", "wgmma.cuh"):
            (out / f).write_text((src / f).read_text())
        text = (src / "flash_attention_bwd.cu").read_text()
        for const, value in VARIANTS[name].items():
            text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                              text)
            if n != 1:
                raise SystemExit(f"{name}: no constant {const} in the source")
        (out / "bwd.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [ops._nvcc(), "-std=c++17", "-O3", *ops.ARCH_FLAGS, "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", "-o", str(out / "lib.so"), str(out / "bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise SystemExit(f"{name} failed to build:\n{log[-3000:]}")
        spills = sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores", log)})
        warns = sorted(set(re.findall(r"\(C75\d\d\)[^']*'[^']*wgmmaILi(\d+)", log)))
        lib = ctypes.CDLL(str(ROOT / "build" / "variants" / name / "lib.so"))
        lib.dex_flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.dex_flash_attention_bwd.restype = ctypes.c_int
        libs[name] = (lib, f"spill stores {spills} B; wgmma serialised at D {warns or 'none'}")
    return libs


def launch(lib, q, k, v, o, do, lse, causal):
    import torch

    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.dex_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), 1, b, h, hkv, sq, sk, d, 1.0 / math.sqrt(d), int(causal),
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return dq, dk, dv


def split(q, k, v, o, do, lse, causal):
    """Device ms a call of the pre-pass, dK / dV and dQ kernels."""
    import torch

    from repro_torch.kernels import ops

    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        torch.cuda.synchronize()
    ms = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for key in ("bwd_prepass", "bwd_dkdv", "bwd_dq"):
            if key in ev.key:
                ms[key] = ms.get(key, 0.0) + t / 5 / 1e3
    return ms


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ops

    smi = cs.phase_device()
    names = args.variants.split(",")
    libs = build(names)
    for name in names:
        print(f"variant {name} {VARIANTS[name]}: {libs[name][1]}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for label, (qs, ks, causal) in cs.FLASH_BWD_SHAPES.items():
        q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for s in (qs, ks, ks))
        do = torch.randn(qs, generator=g, device=dev).to(torch.bfloat16)
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        want = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        times = {n: [] for n in names}
        for name in names + names[::-1]:
            lib = libs[name][0]
            got = launch(lib, q, k, v, o, do, lse, causal)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise SystemExit(f"{name} differs from the package's kernel at {label}")
            times[name].append(cs.cold_and_hot(
                {"default": lambda lib=lib: launch(lib, q, k, v, o, do, lse, causal)}))
        parts = split(q, k, v, o, do, lse, causal)
        print(f"{label} {qs} over {ks}{', causal' if causal else ''}: " + "; ".join(
            f"{n} {sum(t['cold_ms'] for t in ts) / 2:.4f} cold, {sum(t['hot_ms'] for t in ts) / 2:.4f}"
            f" hot" for n, ts in times.items())
            + " | the package's split: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        del q, k, v, do, o, lse, want
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
