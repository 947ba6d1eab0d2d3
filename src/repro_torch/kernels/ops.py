"""Dispatch for the port's kernels: build, launch, count.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a tensor on the card launches the CUDA kernel or
raises; a tensor on the ``meta`` device gets the kernel's outputs, of the
shapes and dtypes the card's launch gives them, with nothing computed
(the dry-run, ``launch/dryrun.py``).  Nothing falls back.

While a step is counted (``COUNTER``, ``roofline/calibrate.py``), a
kernel's call on the CPU or the meta device adds the kernel's work
(``roofline/analysis.py``), its outputs and its scratch to the counter,
in place of the operations of its plain version.

The CUDA sources under ``repro_torch/csrc`` are compiled at first use with
``nvcc`` for ``sm_90a``, one ``nvcc`` per source started together, then
linked into one shared library with a plain C interface that ``ctypes``
loads.  The library goes to ``build/kernels/`` at the repository root,
named by a hash of the sources, so an edited source is rebuilt.

``LAUNCHES`` counts each kernel's launches: a wrapper adds one where it
launches its kernel and nowhere else.  Each launch runs inside a profiler
range named by ``launch_label`` (kernel and operand shapes).

``flash_attention`` and ``mamba_scan`` are differentiable: under grad
they run as the ``FlashAttention`` and ``MambaScan`` functions, whose
backwards are ``flash_attention_bwd`` and ``mamba_scan_bwd`` (the kernels
on the card, their plain versions on the CPU).  Every other kernel refuses
an input that requires grad while grad mode is on, on both devices, so
that no trainer gets a gradient that silently stops at it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import leaf_scan as _leaf_scan
from repro_torch.kernels import leaf_split as _leaf_split
from repro_torch.kernels import leaf_write as _leaf_write
from repro_torch.kernels import mamba_scan as _mamba_scan
from repro_torch.kernels import node_search as _node_search
from repro_torch.kernels import paged_attention as _paged_attention
from repro_torch.kernels import ref
from repro_torch.kernels import subtree_walk as _subtree_walk
from repro_torch.roofline import analysis as AN

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

LAUNCHES = {
    "node_search": 0,
    "node_search_prefix": 0,
    "subtree_walk": 0,
    "leaf_write": 0,
    "leaf_scan": 0,
    "leaf_split": 0,
    "paged_attention": 0,
    "flash_attention": 0,
    "flash_attention_bwd": 0,
    "mamba_scan": 0,
    "mamba_scan_bwd": 0,
}

#: where a kernel without a backward is said to get one, or why it has none
NO_BACKWARD = {
    "paged_attention": "it serves decode only, and no trainer calls it (ROADMAP.md queue 1,"
    " item 13.f)",
}
_INDEX_PLANE = "the index plane is not trained (ROADMAP.md queue 1, item 13.f)"
#: seconds the last build took (0.0 when the library came from the cache)
BUILD_SECONDS = [0.0]

_LIB: list = []
#: the counter (``roofline/calibrate.py::StepCounter``) of the step being
#: counted, or None
COUNTER: list = [None]


def _refuse_grad(kernel: str, *tensors) -> None:
    """Raise where grad mode is on and an input requires grad: ``kernel``
    has no backward."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{kernel} has no backward: {NO_BACKWARD.get(kernel, _INDEX_PLANE)}"
        )


def launch_label(kernel: str, *shapes, **flags) -> str:
    """The profiler range of one launch: the kernel's name, its operands'
    shapes and the flags that are set, e.g. ``"flash_attention [2, 40,
    4096, 96] [2, 40, 4096, 96] causal"``."""
    return " ".join([kernel, *(str(list(s)) for s in shapes), *(k for k, v in flags.items() if v)])


def launch_range(kernel: str, *tensors, **flags):
    """``record_function`` around one launch, named by ``launch_label``,
    while a profiler is on; otherwise nothing (no label is built), so a
    launch outside a profile pays one flag read.  Its span on the device
    is the launch's kernels, so a profile gives each launch's device time
    by name and shape (the profile links a ``ctypes`` launch to no
    operator, but to its range)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    label = launch_label(kernel, *(t.shape for t in tensors), **flags)
    return torch.autograd.profiler.record_function(label)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run_all(cmds) -> str:
    """Run the commands in parallel; returns their joined output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for c in cmds
    ]
    logs, errors = [], []
    for cmd, p in zip(cmds, procs):
        out = p.communicate()[0].decode(errors="replace")
        logs.append(out)
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return "".join(logs)


def build(verbose: bool = False):
    """Compile the CUDA sources into the shared library.  Returns ``(path,
    compiler output)``; ``verbose`` adds ptxas's register and spill report."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    out_dir = build_dir()
    lib = out_dir / f"libdex_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    flags = ["-std=c++17", "-O3", *ARCH_FLAGS, "-Xcompiler", "-fPIC"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    objs = [out_dir / f"{s.stem}.{os.getpid()}.o" for s in sources]
    log = _run_all(
        [[nvcc, *flags, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)]
    )
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    BUILD_SECONDS[0] = time.perf_counter() - t0
    return lib, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    if not _LIB:
        lib = ctypes.CDLL(str(build()[0]))
        _node_search.bind(lib)
        _subtree_walk.bind(lib)
        _leaf_write.bind(lib)
        _leaf_scan.bind(lib)
        _leaf_split.bind(lib)
        _paged_attention.bind(lib)
        _flash_attention.bind(lib)
        _mamba_scan.bind(lib)
        _LIB.append(lib)
    return _LIB[0]


def _nbytes(*trees) -> int:
    """Bytes of the tensors in ``trees`` (tuples nested, None skipped)."""
    n = 0
    for t in trees:
        if isinstance(t, (tuple, list)):
            n += _nbytes(*t)
        elif t is not None:
            n += t.numel() * t.element_size()
    return n


def _io_work(*inputs):
    """``work`` of a kernel counted by its operands alone: no flops, each
    input read once and each output written once (the index kernels', whose
    least bytes depend on the data; their most)."""
    return lambda out: (0, _nbytes(inputs, out), 0)


def _counted(kernel: str, work, run):
    """``run()``, the kernel's plain version on the CPU or its outputs on
    the meta device.  While a step is counted (``COUNTER``), the counter
    sees none of ``run``'s own operations: it adds the kernel's ``work(out)
    -> (flops, bytes, scratch bytes)`` (``roofline/analysis.py``), its
    outputs' storage and the scratch the card's launch holds for the
    call."""
    counter = COUNTER[0]
    if counter is None:
        return run()
    return counter.kernel(kernel, work, run)


def _meta(*shapes_dtypes, device):
    """Empty tensors of ``(shape, dtype)`` pairs on ``device`` (the meta
    device): a kernel's outputs, shapes and dtypes as the card's launch
    allocates them."""
    out = tuple(torch.empty(s, dtype=dt, device=device) for s, dt in shapes_dtypes)
    return out[0] if len(out) == 1 else out


I32, I64, F32 = torch.int32, torch.int64, torch.float32


def node_search(
    rows: torch.Tensor,
    queries: torch.Tensor,
    values: Optional[torch.Tensor] = None,
):
    """``(slot [B] int32, found [B] bool, value [B] int64)`` for rows
    ``[B, 64]`` int64 and queries ``[B]`` int64 (see ``ref.node_search_ref``).
    Each row must be sorted non-decreasing, KEY_MAX padding at its tail:
    the kernel searches it (``kernels/node_search.py``), and the CPU path
    raises ``ValueError`` on an unsorted row."""
    _refuse_grad("node_search", rows, queries, values)
    work = _io_work(rows, queries, values)
    if rows.device.type == "meta":
        b = queries.shape[0]
        return _counted("node_search", work, lambda: _meta(
            ((b,), I32), ((b,), torch.bool), ((b,), I64), device=rows.device))
    if rows.device.type == "cpu":
        _node_search.validate(rows, queries, values)
        return _counted("node_search", work,
                        lambda: ref.node_search_ref(rows, queries, values))
    with launch_range("node_search", rows, queries):
        out = _node_search.launch(library(), rows, queries, values)
    LAUNCHES["node_search"] += 1
    return out


def node_search_prefix(
    prefix: torch.Tensor,
    nbits: torch.Tensor,
    suffix: torch.Tensor,
    rows: torch.Tensor,
    queries: torch.Tensor,
) -> torch.Tensor:
    """``slot [B] int32``: the lower bound of each query over its
    prefix-compressed row (``prefix [B]``, ``nbits [B]``, ``suffix [B, 64]``
    int32), the canonical row ``rows [B, 64]`` where ``nbits < 0`` (see
    ``ref.node_search_prefix_ref``).  Each key row must be sorted
    non-decreasing, and so must a compressible lane's suffix row
    (``0x7FFFFFFF`` padding at its tail); the CPU path raises
    ``ValueError`` on one that is not."""
    args = (prefix, nbits, suffix, rows, queries)
    _refuse_grad("node_search_prefix", *args)
    work = _io_work(*args)
    if rows.device.type == "meta":
        return _counted("node_search_prefix", work,
                        lambda: _meta(((queries.shape[0],), I32), device=rows.device))
    if rows.device.type == "cpu":
        _node_search.validate_prefix(*args)
        return _counted("node_search_prefix", work, lambda: ref.node_search_prefix_ref(*args))
    with launch_range("node_search_prefix", suffix, queries):
        out = _node_search.launch_prefix(library(), *args)
    LAUNCHES["node_search_prefix"] += 1
    return out


def subtree_walk(
    pool_keys: torch.Tensor,
    pool_children: torch.Tensor,
    pool_values: torch.Tensor,
    subtree: torch.Tensor,
    queries: torch.Tensor,
    *,
    levels: int,
    active: Optional[torch.Tensor] = None,
):
    """``(found [B] bool, value [B] int64, leaf local id [B] int32)``: each
    query walks its subtree block of the pool (see ``ref.subtree_walk_ref``);
    where ``active`` [B] bool is given, only its lanes walk and the others
    return ``(False, 0, 0)``.  The pool's key rows must be sorted
    non-decreasing: the kernel searches them (``kernels/subtree_walk.py``),
    and the CPU path raises ``ValueError`` on an unsorted row."""
    args = (pool_keys, pool_children, pool_values, subtree, queries)
    _refuse_grad("subtree_walk", *args, active)
    work = _io_work(*args, active)
    if pool_keys.device.type == "meta":
        b = queries.shape[0]
        return _counted("subtree_walk", work, lambda: _meta(
            ((b,), torch.bool), ((b,), I64), ((b,), I32), device=pool_keys.device))
    if pool_keys.device.type == "cpu":
        _subtree_walk.validate(*args, levels, active)
        return _counted("subtree_walk", work,
                        lambda: ref.subtree_walk_ref(*args, levels=levels, active=active))
    with launch_range("subtree_walk", pool_keys, queries):
        out = _subtree_walk.launch(library(), *args, levels, active)
    LAUNCHES["subtree_walk"] += 1
    return out


def leaf_write(
    rows_k: torch.Tensor,
    rows_v: torch.Tensor,
    upd_slot: torch.Tensor,
    upd_val: torch.Tensor,
    ins_key: torch.Tensor,
    ins_val: torch.Tensor,
):
    """``(new_keys [Q, 64], new_values [Q, 64], occupancy [Q] int32)``: the
    staged updates and inserts applied to each leaf row (see
    ``ref.leaf_write_ref``)."""
    args = (rows_k, rows_v, upd_slot, upd_val, ins_key, ins_val)
    _refuse_grad("leaf_write", *args)
    work = _io_work(*args)
    if rows_k.device.type == "meta":
        return _counted("leaf_write", work, lambda: _meta(
            (rows_k.shape, rows_k.dtype), (rows_v.shape, rows_v.dtype),
            ((rows_k.shape[0],), I32), device=rows_k.device))
    if rows_k.device.type == "cpu":
        _leaf_write.validate(*args)
        return _counted("leaf_write", work, lambda: ref.leaf_write_ref(*args))
    with launch_range("leaf_write", rows_k, upd_slot, ins_key):
        out = _leaf_write.launch(library(), *args)
    LAUNCHES["leaf_write"] += 1
    return out


def leaf_scan(
    window_keys: torch.Tensor,
    window_values: torch.Tensor,
    start_keys: torch.Tensor,
    counts: torch.Tensor,
    *,
    max_count: int,
):
    """``(keys [B, max_count], values [B, max_count], taken [B] int32)``: up
    to ``counts[b]`` records with key >= ``start_keys[b]`` out of each lane's
    leaf window (see ``ref.leaf_scan_ref``)."""
    args = (window_keys, window_values, start_keys, counts)
    _refuse_grad("leaf_scan", *args)
    work = _io_work(*args)
    if window_keys.device.type == "meta":
        b = start_keys.shape[0]
        return _counted("leaf_scan", work, lambda: _meta(
            ((b, max_count), I64), ((b, max_count), I64), ((b,), I32),
            device=window_keys.device))
    if window_keys.device.type == "cpu":
        _leaf_scan.validate(*args, max_count)
        return _counted("leaf_scan", work,
                        lambda: ref.leaf_scan_ref(*args, max_count=max_count))
    with launch_range("leaf_scan", window_keys, start_keys):
        out = _leaf_scan.launch(library(), *args, max_count)
    LAUNCHES["leaf_scan"] += 1
    return out


def leaf_split(
    rows_k: torch.Tensor,
    rows_v: torch.Tensor,
    ins_key: torch.Tensor,
    ins_val: torch.Tensor,
):
    """``(left_k, left_v, right_k, right_v [Q, 64], occ_l, occ_r [Q] int32,
    sep [Q] int64, did_split [Q] int32)``: the staged inserts merged into
    each leaf row, split where the merge overflows (see
    ``ref.leaf_split_ref``)."""
    args = (rows_k, rows_v, ins_key, ins_val)
    _refuse_grad("leaf_split", *args)
    work = _io_work(*args)
    if rows_k.device.type == "meta":
        q = (rows_k.shape[0],)
        return _counted("leaf_split", work, lambda: _meta(
            *([(rows_k.shape, rows_k.dtype)] * 4), (q, I32), (q, I32), (q, I64), (q, I32),
            device=rows_k.device))
    if rows_k.device.type == "cpu":
        _leaf_split.validate(*args)
        return _counted("leaf_split", work, lambda: ref.leaf_split_ref(*args))
    with launch_range("leaf_split", rows_k, ins_key):
        out = _leaf_split.launch(library(), *args)
    LAUNCHES["leaf_split"] += 1
    return out


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    with_lse: bool = False,
):
    """``[B, H, D]``: each request's one query token attended over its
    tokens below ``seq_lens[b]``, stored in the pages ``page_table[b]``
    names (see ``ref.paged_attention_ref``); with ``with_lse`` also the
    log-sum-exp of its logits, ``[B, H]`` f32 (``-inf`` at length 0).
    Counted, its work is that of every page of the table full: the meta
    device has no lengths (``analysis.paged_bytes``)."""
    args = (q, k_pages, v_pages, page_table, seq_lens)
    _refuse_grad("paged_attention", *args)

    def work(out):
        _, h, d = q.shape
        pages = page_table.numel()
        tokens = pages * k_pages.shape[1]
        return (4 * d * h * tokens,
                AN.paged_bytes(q.shape, k_pages.shape[2], q.element_size(), tokens, pages), 0)

    if q.device.type == "meta":
        _paged_attention.validate(*args)
        b, h = q.shape[:2]
        return _counted("paged_attention", work, lambda: _meta(
            (q.shape, q.dtype), *([((b, h), F32)] if with_lse else []), device=q.device))
    if q.device.type == "cpu":
        _paged_attention.validate(*args)
        return _counted("paged_attention", work,
                        lambda: ref.paged_attention_ref(*args, with_lse=with_lse))
    with launch_range("paged_attention", q, k_pages, page_table):
        out = _paged_attention.launch(library(), *args, with_lse=with_lse)
    LAUNCHES["paged_attention"] += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``[B, H, Sq, D]``: attention of ``q`` over ``k``, ``v`` ``[B, HKV,
    Sk, D]`` (GQA), causal with offset ``Sk - Sq`` (see
    ``ref.flash_attention_ref``).  Where grad mode is on and an input
    requires grad it runs as ``FlashAttention`` (the forward keeps its
    log-sum-exp for the backward kernel); else the forward alone, without
    the log-sum-exp."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward keeps q, k, v, the
    output and its log-sum-exp; the backward is ``flash_attention_bwd``.
    Both are looked up in this module at each call, so a caller may hold
    them to, or swap them for, their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, do.contiguous(), lse, causal=ctx.causal, scale=ctx.scale
        )
        return dq, dk, dv, None, None


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    with_lse: bool = False,
):
    """The forward of ``flash_attention``: ``o``, or ``(o, lse [B, H, Sq]
    f32)`` ``with_lse`` (the natural log-sum-exp of each row's scaled
    logits, ``-inf`` where no key is reached).  On the CPU float64 is taken
    too, for ``gradcheck``."""
    def work(out):
        b, h, sq, d = q.shape
        lse = b * h * sq if with_lse else 0
        return (AN.flash_flops(b, h, sq, k.shape[2], d, v.shape[3], causal),
                AN.flash_bytes(q.numel(), k.numel(), v.numel(), q.numel(), q.element_size(),
                               lse), 0)

    if q.device.type == "meta":
        _flash_attention.validate(q, k, v)
        lse = [(q.shape[:3], F32)] if with_lse else []
        return _counted("flash_attention", work,
                        lambda: _meta((q.shape, q.dtype), *lse, device=q.device))
    if q.device.type == "cpu":
        _flash_attention.validate(q, k, v, dtypes=_flash_attention.CPU_DTYPES)
        return _counted("flash_attention", work, lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, scale=scale, with_lse=with_lse))
    with launch_range("flash_attention", q, k, causal=causal):
        out = _flash_attention.launch(library(), q, k, v, causal, scale, with_lse=with_lse)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
):
    """``(dq, dk, dv)``: the gradients of ``flash_attention``'s output ``o``
    for the output gradient ``do``, from the forward's inputs, ``o`` and its
    log-sum-exp ``lse`` [B, H, Sq] (see ``ref.flash_attention_bwd_ref``).
    The kernel takes head dims 64, 80, 96 and 128
    (``kernels/flash_attention.py``)."""
    args = (q, k, v, o, do, lse)

    def work(out):
        # the scratch of the backward's pre-pass: Delta and the base-2
        # log-sum-exp, [B, H, Sq] f32 each
        b, h, sq, d = q.shape
        return (AN.flash_bwd_flops(b, h, sq, k.shape[2], d, causal),
                AN.flash_bwd_bytes(q.numel(), k.numel(), lse.numel(), q.element_size()),
                2 * b * h * sq * 4)

    if q.device.type == "meta":
        _flash_attention.validate_bwd(*args)
        _flash_attention.plan_bwd(q.shape[3], q.dtype)  # raises where the card has no kernel
        return _counted("flash_attention_bwd", work, lambda: _meta(
            (q.shape, q.dtype), (k.shape, k.dtype), (v.shape, v.dtype), device=q.device))
    if q.device.type == "cpu":
        _flash_attention.validate_bwd(*args, dtypes=_flash_attention.CPU_DTYPES)
        return _counted("flash_attention_bwd", work, lambda: ref.flash_attention_bwd_ref(
            *args, causal=causal, scale=scale))
    with launch_range("flash_attention_bwd", q, k, causal=causal):
        out = _flash_attention.launch_bwd(library(), *args, causal, scale)
    LAUNCHES["flash_attention_bwd"] += 1
    return out


def mamba_scan(
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    x: torch.Tensor,
):
    """``(y [B, L, D] f32, h_last [B, D, N] f32)``: the selective scan of
    ``x`` [B, L, D] with steps ``delta`` [B, L, D], diagonal ``A`` [D, N]
    and ``Bmat``, ``C`` [B, L, N] (see ``ref.mamba_scan_ref``).  Where grad
    mode is on and an input requires grad it runs as ``MambaScan`` (the
    forward keeps its states for the backward kernel); else the forward
    alone."""
    args = (delta, A, Bmat, C, x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return MambaScan.apply(*args)
    return mamba_scan_fwd(*args)[:2]


class MambaScan(torch.autograd.Function):
    """``mamba_scan`` with its gradient: the forward keeps its operands and
    the states it saved every ``SAVE_EVERY`` steps; the backward is
    ``mamba_scan_bwd``, given null for the gradient of an output that the
    loss does not reach.  Both are looked up in this module at each call,
    so a caller may hold them to, or swap them for, their plain versions."""

    @staticmethod
    def forward(ctx, delta, A, Bmat, C, x):
        y, h_last, states = mamba_scan_fwd(delta, A, Bmat, C, x, with_states=True)
        ctx.save_for_backward(delta, A, Bmat, C, x, states)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        delta, A, Bmat, C, x, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(delta.shape, dtype=_mamba_scan.state_dtype(x), device=delta.device)
        grads = mamba_scan_bwd(
            delta, A, Bmat, C, x, dy.contiguous(),
            None if dh_last is None else dh_last.contiguous(), states=states,
        )
        return tuple(g.to(t.dtype) for g, t in zip(grads, (delta, A, Bmat, C, x)))


def mamba_scan_fwd(
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    x: torch.Tensor,
    *,
    with_states: bool = False,
):
    """The forward of ``mamba_scan``: ``(y, h_last)``, or ``(y, h_last,
    states)`` ``with_states`` (the state before every ``SAVE_EVERY``-th
    step, ``[B, ceil(L / SAVE_EVERY), D, N]`` f32, for the backward kernel;
    the CPU's plain version keeps them too, though its plain backward
    needs none).  On the CPU float64 is taken too, for ``gradcheck``."""
    args = (delta, A, Bmat, C, x)

    def work(out):
        (b, l, d), n = delta.shape, A.shape[1]
        return (AN.mamba_flops(b, l, d, n),
                AN.mamba_bytes(b, l, d, n, x.element_size()), 0)

    if delta.device.type == "meta":
        _mamba_scan.validate(*args)
        (b, l, d), n = delta.shape, A.shape[1]
        states = [((b, _mamba_scan.saves(l), d, n), F32)] if with_states else []
        return _counted("mamba_scan", work, lambda: _meta(
            ((b, l, d), F32), ((b, d, n), F32), *states, device=delta.device))
    if delta.device.type == "cpu":
        _mamba_scan.validate(*args, dtypes=_mamba_scan.CPU_DTYPES)
        every = _mamba_scan.SAVE_EVERY if with_states else 0
        return _counted("mamba_scan", work,
                        lambda: ref.mamba_scan_ref(*args, save_every=every))
    with launch_range("mamba_scan", x, Bmat):
        out = _mamba_scan.launch(library(), *args, with_states=with_states)
    LAUNCHES["mamba_scan"] += 1
    return out


def mamba_scan_bwd(
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    x: torch.Tensor,
    dy: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None,
    *,
    states: Optional[torch.Tensor] = None,
):
    """``(ddelta [B, L, D], dA [D, N], dB, dC [B, L, N], dx [B, L, D])``,
    f32: the gradients of ``mamba_scan``'s outputs for ``dy`` [B, L, D] and
    ``dh_last`` [B, D, N] (None: the final state reaches no loss), from the
    forward's operands (see ``ref.mamba_scan_bwd_ref``).  The kernel also
    needs the ``states`` its forward kept (``mamba_scan_fwd(...,
    with_states=True)``); the CPU path ignores them."""
    args = (delta, A, Bmat, C, x, dy, dh_last)

    def work(out):
        # the launch's scratch: dA's [B, D, N] partials and dB's and dC's,
        # one a cluster of the H100's plan
        (b, l, d), n, item = delta.shape, A.shape[1], x.element_size()
        clusters = _mamba_scan.plan_bwd(b, d, n, item=item).clusters if b and d else 0
        return (AN.mamba_flops(b, l, d, n, backward=True),
                AN.mamba_bwd_bytes(b, l, d, n, item, dh_last is not None),
                4 * b * d * n + 4 * 2 * b * l * clusters * n)

    if delta.device.type == "meta":
        _mamba_scan.validate_bwd(*args, states)
        if states is None:
            raise ValueError("mamba_scan_bwd needs the states the forward kept (with_states=True)")
        (b, l, d), n = delta.shape, A.shape[1]
        return _counted("mamba_scan_bwd", work, lambda: _meta(
            ((b, l, d), F32), ((d, n), F32), ((b, l, n), F32), ((b, l, n), F32),
            ((b, l, d), F32), device=delta.device))
    if delta.device.type == "cpu":
        _mamba_scan.validate_bwd(*args, states, dtypes=_mamba_scan.CPU_DTYPES)
        return _counted("mamba_scan_bwd", work, lambda: ref.mamba_scan_bwd_ref(*args))
    with launch_range("mamba_scan_bwd", x, Bmat):
        out = _mamba_scan.launch_bwd(library(), *args, states)
    LAUNCHES["mamba_scan_bwd"] += 1
    return out
