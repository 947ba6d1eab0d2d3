#!/usr/bin/env python3
"""Time design variants of the ``mamba_scan`` backward on one NVIDIA GPU.

    python3 tools/mamba_bwd_variants.py [--variants default,save16,...]
    python3 tools/mamba_bwd_variants.py --sass-of DIR [--runs 0.75,1]

Each variant is ``csrc/mamba_scan_bwd.cu`` and the forward
``csrc/mamba_scan.cu`` (with ``mamba_scan.cuh`` and ``cp_async.cuh``) with
some of their constants replaced (``VARIANTS``: the CTA's threads, the
cluster, the staging ring) or code patched in (``PATCHES``: a sparser save
cadence, which the forward's ``kSaveEvery`` sets and the backward then
restarts from; a full butterfly of each sum in place of the
reduce-scatter), built alone with nvcc into ``build/variants/mamba_<name>/`` and launched through
``kernels/mamba_scan.py`` with its mirrored constants set to the variant's.
At each of ``chip_smoke.MAMBA_BWD_SHAPES`` (bf16 operands, ``dh_last``
null, as the model's loss gives it) every variant runs its own forward
with states, then its backward twice: the two launches must be bit-equal
and within ``GRAD_TOL["float32"]`` of the plain backward.  Then each is
timed cold and hot (``chip_smoke.cold_and_hot``: 20 calls each), the
backward and the forward with its states, in turns, the variants in order
and then in reverse, so a drift of the card's clock falls on all of them;
the table gives both turns' mean.  Prints each variant's ptxas registers
and spills, its unrolled sub-block's SASS a state and step
(``chip_smoke.mamba_bwd_issue``) with the issue floor at each training
shape, and the card's name and power limit.

``--sass-of DIR`` builds only ``DIR/mamba_scan_bwd.cu`` (another tree's
``csrc``, e.g. an earlier commit unpacked with ``git archive``) and prints,
for its bf16 instantiations, the code a loop's iteration runs from each
basic block that holds an exponential (``chip_smoke.exp_regions``:
instructions, ``MUFU.EX2``, ``SHFL``, FP32 operations) and the issue floor
at the training shapes, each region weighed by ``--runs`` (its runs a
sub-block of 8 steps, in address order; 1 each by default).  Needs the
card and nvcc; builds in about a minute."""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: name -> constants of csrc/mamba_scan_bwd.cu and csrc/mamba_scan.cu replaced
VARIANTS = {
    "default": {},
    # sparser saves (and PATCHES): a sub-block off a saved state steps from
    # it through the interval's earlier steps, from device memory
    "save16": {"kSaveEvery": 16},
    "save32": {"kSaveEvery": 32},
    "threads512": {"kBwdThreads": 512, "kBwdCtas": 1},  # one CTA an SM
    # the most CTAs a cluster (the default takes the size by rounds)
    "cluster1": {"kBwdCluster": 1},  # no cluster: a partial a CTA
    "cluster2": {"kBwdCluster": 2},
    "cluster4": {"kBwdCluster": 4},
    "cluster8": {"kBwdCluster": 8},
    "cluster16": {"kBwdCluster": 16},  # non-portable
    "butterfly": {},  # a butterfly of each sum (PATCHES)
    "stages2": {"kBwdStages": 2},
    "stages4": {"kBwdStages": 4},
}
#: the names kernels/mamba_scan.py mirrors the constants by
MIRROR = {"kSaveEvery": "SAVE_EVERY", "kBwdThreads": "BWD_THREADS", "kBwdCtas": "BWD_CTAS",
          "kBwdCluster": "BWD_CLUSTER", "kBwdStages": "BWD_STAGES"}
HEADERS = ("mamba_scan.cuh", "cp_async.cuh")
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def sparse_saves(every):
    """Patches of the backward that restarts each sub-block from the state
    kept before its interval of ``every`` steps: it stages no state, and
    steps from the saved one through the interval's earlier steps, reading
    delta, x and B from device memory."""
    j = every // 8  # sub-blocks an interval (kBwdSub is 8)
    restart = f"""    float h[S];
    const int q = subs - 1 - i, q0 = q / {j} * {j};
#pragma unroll
    for (int s = 0; s < S; ++s) {{
      const int k = j * S + s;
      h[s] = c < d && k < n
                 ? p.saved[((static_cast<int64_t>(bi) * p.saves + q / {j}) * d + c) * n + k]
                 : 0.f;
    }}
#pragma unroll 1
    for (int t = q0 * kBwdSub; t < t0; ++t) {{
      const int64_t g = (row0 + t) * d + c;
      const float dt = c < d ? p.delta[g] : 0.f;
      const float dxt = __fmul_rn(dt, c < d ? to_f32(x[g]) : 0.f);
#pragma unroll
      for (int s = 0; s < S; ++s) {{
        const int k = j * S + s;
        const float bv = k < n ? to_f32(bmat[(row0 + t) * n + k]) : 0.f;
        h[s] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, am[s])), h[s]), __fmul_rn(dxt, bv));
      }}
    }}
"""
    copy = """      for (int e = 4 * tid; e < kCh * n; e += 4 * kBwdThreads) {
        copy4(st + e, p.saved + gs + e, p.saved, p.vec_st, max(0, min(4, len - e)));
      }
"""
    return [
        (copy, None, ""),
        ("    float h[S];\n    const float* st", "\n    sub_block<S, LPC>(", restart),
        ("                  (l + kBwdSub - 1) / kBwdSub,\n", None,
         f"                  (l + {every} - 1) / {every},\n"),
    ]


#: name -> patches of csrc/mamba_scan_bwd.cu: (start, end, new), the text
#: from start up to end (or start alone where end is None) replaced by new
PATCHES = {
    "save16": sparse_saves(16),
    "save32": sparse_saves(32),
    "butterfly": [
        ("    return kept<(H > 1) ? H / 2 : H, 2 * M, MEnd>();", None,
         "    return kept<H, 2 * M, MEnd>();"),
        ("  } else if constexpr (H > 1) {", None, "  } else if constexpr (false) {"),
    ],
}


def once(text, anchor, name, at=0):
    if text.count(anchor, at) != 1:
        raise SystemExit(f"{name}: {anchor!r} is not once in mamba_scan_bwd.cu")
    return text.index(anchor, at)


def patched(text, consts, name, patches=()):
    for const, value in consts.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        if n > 1:
            raise SystemExit(f"{name}: constant {const} twice in a source")
    for start, end, new in patches:
        i = once(text, start, name)
        j = i + len(start) if end is None else once(text, end, name, i)
        text = text[:i] + new + text[j:]
    return text


def build(names, src=CSRC, sources=("mamba_scan.cu", "mamba_scan_bwd.cu"), tag="mamba"):
    """Build each variant's library in parallel; returns name -> (path,
    ptxas log)."""
    from repro_torch.kernels import ops

    procs = {}
    for name in names:
        consts = VARIANTS.get(name, {})
        out = ROOT / "build" / "variants" / f"{tag}_{name}"
        out.mkdir(parents=True, exist_ok=True)
        for f in HEADERS:
            (out / f).write_text((src / f).read_text())
        found = set()
        for f in sources:
            text = (src / f).read_text()
            found |= {c for c in consts if f"constexpr int {c} = " in text}
            patches = PATCHES.get(name, ()) if f == "mamba_scan_bwd.cu" else ()
            (out / f).write_text(patched(text, consts, name, patches))
        if found != set(consts):
            raise SystemExit(f"{name}: no constant {set(consts) - found} in the sources")
        procs[name] = subprocess.Popen(
            [ops._nvcc(), "-std=c++17", "-O3", *ops.ARCH_FLAGS, "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", "-o", str(out / "lib.so"), *(str(out / f) for f in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise SystemExit(f"{name} failed to build:\n{log[-3000:]}")
        libs[name] = (ROOT / "build" / "variants" / f"{tag}_{name}" / "lib.so", log)
    return libs


def sass_of(lib):
    """``cuobjdump --dump-sass`` of a library: kernel name -> its lines."""
    from repro_torch.kernels import ops

    cuobjdump = pathlib.Path(ops._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    code, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            code[name] = []
        elif name:
            code[name].append(line)
    return code


@contextlib.contextmanager
def mirrored(consts):
    """kernels/mamba_scan.py's mirrored constants set to a variant's."""
    from repro_torch.kernels import mamba_scan as ms

    kept = {MIRROR[c]: getattr(ms, MIRROR[c]) for c in consts if c in MIRROR}
    for c, v in consts.items():
        if c in MIRROR:
            setattr(ms, MIRROR[c], v)
    try:
        yield
    finally:
        for k, v in kept.items():
            setattr(ms, k, v)


def floors(per_state_step, clock, sms):
    """The issue floor (ms) at each training shape for a count of
    instructions a state and step."""
    import chip_smoke as cs

    out = {}
    for label, (b, l, d, n) in cs.MAMBA_BWD_SHAPES.items():
        if label != "odd":
            out[label] = b * l * d * n * per_state_step / (4 * 32 * sms * clock) * 1e3
    return out


def other_source(src, runs):
    """``--sass-of``: the exponential blocks of another tree's backward."""
    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as ms

    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = cs.sm_clock_hz()
    lib, _ = build(["other"], src=pathlib.Path(src), sources=("mamba_scan_bwd.cu",),
                   tag="sass")["other"]
    for name, lines in sass_of(lib).items():
        inst = cs.mamba_instance(name, "mamba_scan_bwd_kernel")
        if not inst or inst[0] != "bfloat16":
            continue
        blocks = cs.exp_regions(lines)
        weights = runs or [1.0] * len(blocks)
        if len(weights) != len(blocks):
            print(f"sass-of {src} <bf16, {inst[1]}, {inst[2]}>: blocks {blocks}; {len(weights)}"
                  f" runs given for {len(blocks)} blocks: no floor")
            continue
        per = ms.BWD_SUB * inst[1]
        total = sum(w * b["instructions"] for w, b in zip(weights, blocks)) / per
        mufu = sum(w * b["MUFU.EX2"] for w, b in zip(weights, blocks)) / per
        shfl = sum(w * b["SHFL"] for w, b in zip(weights, blocks)) / per
        fl = floors(total, clock, sms)
        print(f"sass-of {src} <bf16, {inst[1]}, {inst[2]}>: blocks {blocks}, runs {weights}:"
              f" {total:.2f} instructions, {mufu:.3f} MUFU.EX2, {shfl:.3f} SHFL a state and step;"
              f" issue floor " + ", ".join(f"{k} {v:.4f} ms" for k, v in fl.items())
              + f" at {clock / 1e6:.0f} MHz")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sass-of", default=None)
    p.add_argument("--runs", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mamba_bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    smi = cs.phase_device()
    if args.sass_of:
        other_source(args.sass_of, args.runs and [float(x) for x in args.runs.split(",")])
        print(f"on {smi}")
        return 0
    names = args.variants.split(",")
    built = build(names)
    import ctypes

    libs = {}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = cs.sm_clock_hz()
    for name in names:
        path, log = built[name]
        libs[name] = ctypes.CDLL(str(path))
        ms.bind(libs[name])
        code = sass_of(path)
        notes = []
        for kernel, (regs, stores, loads) in sorted(cs.ptxas_usage(log).items()):
            inst = cs.mamba_instance(kernel, "mamba_scan_bwd_kernel")
            if inst and inst[0] == "bfloat16" and inst[1:] in ((4, 16), (2, 8)):
                hot = cs.mamba_hot_block(code[kernel])
                sub = cs.exp_regions(code[kernel])[-1]  # the sub-block's, not a variant's restart
                per = ms.BWD_SUB * inst[1]
                fl = floors(sub["instructions"] / per, clock, sms)
                notes.append(
                    f"<{inst[1]}, {inst[2]}> {regs} registers, spills {stores} / {loads} B;"
                    f" a state and step: MUFU.EX2 {hot['MUFU.EX2'] / per:.3f} in the block of"
                    f" exponentials, the sub-block SHFL {sub['SHFL'] / per:.3f},"
                    f" {sub['instructions'] / per:.2f} instructions; issue floor "
                    + ", ".join(f"{k} {v:.4f} ms" for k, v in fl.items()))
        print(f"variant {name} {VARIANTS[name]}: " + " | ".join(notes))
    tol = cs.GRAD_TOL["float32"]
    for i, (label, (b, l, d, n)) in enumerate(cs.MAMBA_BWD_SHAPES.items()):
        args_ = cs.mamba_inputs(b, l, d, n, torch.bfloat16, args.seed + 40 + i, dev)
        g = torch.Generator(device=dev).manual_seed(args.seed + 50 + i)
        dy = torch.randn((b, l, d), generator=g, device=dev)
        want = ref.mamba_scan_bwd_ref(*args_, dy)
        states, plans, times = {}, {}, {nm: [] for nm in names}
        for name in names:
            with mirrored(VARIANTS[name]):
                lib = libs[name]
                plans[name] = ms.device_plan_bwd(lib, dev, b, d, n, 2,
                                                 cluster=VARIANTS[name].get("kBwdCluster"))
                states[name] = ms.launch(lib, *args_, with_states=True)[2]
                got = ms.launch_bwd(lib, *args_, dy, None, states[name], plan=plans[name])
                again = ms.launch_bwd(lib, *args_, dy, None, states[name], plan=plans[name])
                if not all(torch.equal(x, z) for x, z in zip(got, again)):
                    raise SystemExit(f"{name}: two launches differ at {label}")
                err, _ = cs.grad_err(got, want)
                if not err <= tol:
                    raise SystemExit(f"{name} at {label}: {err} of the largest gradient (limit"
                                     f" {tol})")
                del got, again
        for name in names + names[::-1]:
            lib, st, pl = libs[name], states[name], plans[name]
            with mirrored(VARIANTS[name]):
                times[name].append(cs.cold_and_hot({
                    "default": lambda lib=lib, st=st, pl=pl: ms.launch_bwd(lib, *args_, dy, None,
                                                                         st, plan=pl),
                    "fwd": lambda lib=lib: ms.launch(lib, *args_, with_states=True),
                }))
        print(f"{label} [{b}, {l}, {d}], N = {n}: " + "; ".join(
            f"{nm} (clusters of {plans[nm].cluster}, {plans[nm].rounds} rounds of"
            f" {plans[nm].active}) {sum(t['cold_ms'] for t in ts) / 2:.4f} cold,"
            f" {sum(t['hot_ms'] for t in ts) / 2:.4f} hot (forward with states"
            f" {sum(t['fwd_cold_ms'] for t in ts) / 2:.4f}, {sum(t['fwd_hot_ms'] for t in ts) / 2:.4f})"
            for nm, ts in times.items()))
        del args_, dy, want, states
        torch.cuda.empty_cache()
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
