"""Counting a step's flops, bytes and peak memory without running it.

The port of ``repro.roofline.calibrate``.  XLA's ``cost_analysis()``
counts a while-loop body once, so the reference recompiles a cell with its
layer scans unrolled (``model.SCAN_UNROLL``) and MoE chunking off
(``layers.MOE_FULL_CHUNK``) and adds the flops its kernels' inner loops
hide (``analytic_inner_flops``).  The port runs eager: its layer stack and
its MoE chunks are Python loops, so every layer's and every chunk's
operations reach the counter, and neither probe flag has a twin.  What no
dispatch sees is a kernel's ``ctypes`` launch, so each hand-written kernel
counts its own work (``kernels/ops.py::_counted``, the formulas of
``roofline/analysis.py``).

``StepCounter`` is one counting mode.  Run a step inside it, on the
``meta`` device (nothing is allocated or computed; ``launch/dryrun.py``)
or on real tensors (the same counts; the tests hold the two equal):

* flops: every aten op by ``torch.utils.flop_counter``'s formulas (the
  matrix products), plus each kernel's formula;
* bytes: every aten op's operands in plus its results out, a view moving
  nothing and an allocation without a write moving nothing (the eager
  program's traffic, the counterpart of XLA's ``bytes accessed``), plus
  each kernel's least bytes; a copy from the host counts apart
  (``host_bytes``), as it crosses the host link, not the card's memory;
* peak live bytes: each storage an op creates counted from its creation to
  its release (the storage's weak reference), a kernel's outputs from its
  call and its scratch during it; the peak is the most held at once above
  what was live before the step.

On the meta device an op's results depend on its arguments' shapes,
strides, dtypes and scalars alone, so the counter keeps each new-result
op's output layouts by those and remakes them with ``empty_strided``
when they come again: torch computes many meta results in Python, and a
full-width step repeats the same few hundred ops thousands of times.
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig, ShapeCell

#: factories that allocate without writing: no traffic
_NO_TRAFFIC = frozenset(
    (torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
     torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
     torch.ops.aten.new_empty_strided.default)
)


_COPIES = frozenset((torch.ops.aten._to_copy, torch.ops.aten.copy_))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def _meta_key(tree):
    """A hashable key of an op's arguments when every tensor among them
    lies on the meta device (its shape, strides and dtype), else None."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "meta":
            return None
        return (tuple(tree.shape), tree.stride(), tree.dtype)
    if isinstance(tree, (tuple, list)):
        parts = tuple(_meta_key(t) for t in tree)
        return None if any(p is None for p in parts) else (type(tree), parts)
    if isinstance(tree, dict):
        return _meta_key(tuple((k, v) for k, v in sorted(tree.items())))
    if isinstance(tree, _SCALARS):
        return (type(tree), tree)
    return None


def _dense(t) -> bool:
    """``t`` is a meta tensor whose storage holds it from offset 0 and no
    more: ``empty_strided`` of its shape and strides remakes it."""
    if not isinstance(t, torch.Tensor) or t.device.type != "meta" or t.storage_offset():
        return False
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride())) if t.numel() else 0
    return t.untyped_storage().nbytes() == span * t.element_size()


@functools.lru_cache(maxsize=None)
def _kind(func) -> str:
    """``"view"`` (a result aliases an operand, nothing written),
    ``"inplace"`` (a result is a written operand) or ``"new"``."""
    alias = [r.alias_info for r in func._schema.returns if r.alias_info is not None]
    if not alias:
        return "new"
    return "inplace" if any(a.is_write for a in alias) else "view"


class StepCounter(TorchDispatchMode):
    """Counts the flops, bytes and peak live bytes of what runs inside it
    (see the module's docstring).  ``kernels`` holds each hand-written
    kernel's calls, flops and bytes; ``totals()`` the sums."""

    def __init__(self):
        super().__init__()
        self.flops = 0          # aten ops (flop_counter's formulas)
        self.bytes = 0          # aten ops' operands and results
        self.host_bytes = 0     # copied from the host onto the device
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0           # bytes of the storages created and not yet freed
        self.peak = 0
        self._paused = 0
        self._refs: Dict[int, weakref.ref] = {}
        # a new-result op's output layouts on the meta device, by its
        # arguments' (``_meta_key``); torch's Python meta kernels take about
        # 0.25 ms an elementwise op, ``empty_strided`` a tenth of that
        self._meta_out: Dict[tuple, tuple] = {}

    def __enter__(self):
        if ops.COUNTER[0] is not None:
            raise RuntimeError("a step is already being counted")
        ops.COUNTER[0] = self
        return super().__enter__()

    def __exit__(self, *exc):
        ops.COUNTER[0] = None
        return super().__exit__(*exc)

    def _free(self, key: int, n: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def _alloc(self, t: torch.Tensor, skip=()) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs or key in skip:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on the meta device a new-result op's
        outputs come from ``_meta_out`` when these arguments were seen."""
        key = _meta_key((args, kwargs)) if _kind(func) == "new" else None
        if key is not None:
            key = (func, key)
            hit = self._meta_out.get(key)
            if hit is not None:
                out = tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                            for sh, st, dt in hit[1])
                return out[0] if hit[0] else out
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else out
        if key is not None and isinstance(outs, tuple) and all(map(_dense, outs)):
            # an op whose schema declares no alias may still return its
            # input's storage (``_unsafe_view``): remade, it would count new
            shared = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
            if not any(id(t.untyped_storage()) in shared for t in outs):
                self._meta_out[key] = (single, tuple((tuple(t.shape), t.stride(), t.dtype)
                                                     for t in outs))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if self._paused:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            fargs = args
            if func._overloadname == "dtype":  # mm / bmm with out_dtype: its operands
                fargs = tuple(a for a in args if isinstance(a, torch.Tensor))
            self.flops += int(flop_registry[packet](*fargs, out_val=out))
        kind = _kind(func)
        if kind == "view":
            return out
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if packet in _COPIES and ins[0].device.type == "cpu" and any(
            t.device.type != "cpu" for t in outs
        ):  # a copy from the host (a rotary table): over the link, not HBM
            self.host_bytes += sum(map(_nbytes, outs))
        elif func not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if kind == "new":
            skip = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                self._alloc(t, skip)
        return out

    def kernel(self, name: str, work, run):
        """``run()`` uncounted, then the kernel's ``work(out) -> (flops,
        bytes, scratch)``, its outputs' storage and, during the call, its
        scratch."""
        self._paused += 1
        try:
            out = run()
        finally:
            self._paused -= 1
        flops, nbytes, scratch = work(out)
        k = self.kernels.setdefault(name, dict(calls=0, flops=0, bytes=0))
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        for t in _tensors(out):
            self._alloc(t)
        self.peak = max(self.peak, self.live + scratch)
        return out

    def totals(self) -> Dict[str, int]:
        """``flops`` and ``bytes`` (aten ops and kernels), the aten ops'
        alone (``matmul_flops``, ``aten_bytes``), the kernels' alone, the
        bytes copied from the host, and ``peak_bytes``."""
        kf = sum(k["flops"] for k in self.kernels.values())
        kb = sum(k["bytes"] for k in self.kernels.values())
        return dict(flops=self.flops + kf, bytes=self.bytes + kb, matmul_flops=self.flops,
                    aten_bytes=self.bytes, kernel_flops=kf, kernel_bytes=kb,
                    host_bytes=self.host_bytes, peak_bytes=self.peak)


def analytic_inner_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """Cluster-wide FLOPs hidden inside (collective-free) chunk loops."""
    b = cell.global_batch
    s = cell.seq_len if cell.kind in ("train", "prefill") else 1
    bwd = 3.0 if cell.kind == "train" else 1.0   # fwd + 2x bwd
    total = 0.0
    if cfg.attention != "none":
        h = cfg.n_heads
        dh = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.attention == "mla" \
            else cfg.head_dim
        sk = cell.seq_len if cell.kind == "decode" else s
        per_layer = 4.0 * b * s * sk * h * dh * (0.5 if s == sk else 1.0)
        n_attn = (
            cfg.n_layers // cfg.hybrid_attn_every
            if cfg.hybrid_attn_every
            else cfg.n_layers
        )
        total += per_layer * n_attn * bwd
        if cfg.encdec:
            t = cfg.max_source_positions
            total += 4.0 * b * t * t * h * dh * cfg.enc_layers * bwd
            total += 4.0 * b * s * t * h * dh * cfg.n_layers * bwd
    if cfg.ssm:
        di = cfg.ssm_expand * cfg.d_model
        total += 9.0 * b * s * di * cfg.ssm_state * cfg.n_layers * bwd
    if cell.kind == "train":
        total += 2.0 * b * s * cfg.d_model * cfg.vocab * bwd
    return total


def calibrated_terms(cfg: ArchConfig, cell: ShapeCell, mesh, mesh_name: str,
                     lower_fn) -> Dict[str, float]:
    """The counted step of one microbatch -> per-chip step totals.

    ``lower_fn(cfg, cell, mesh, mesh_name)`` must return a lowered cell
    (``launch/dryrun.py::lower_cell`` with ``microbatches=1``), whose
    counter already holds every layer and every kernel, so nothing is added
    analytically.  Per chip: the counts of one data shard over the model
    axis.  No collective is counted (``analysis.COLLECTIVE_NOTE``)."""
    lowered = lower_fn(cfg, cell, mesh, mesh_name)
    tot = lowered.counter.totals()
    n_model = mesh.shape.get("model", 1)
    return {"flops": tot["flops"] / n_model, "bytes": tot["bytes"] / n_model,
            "collective": None}
