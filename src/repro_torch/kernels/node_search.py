"""CUDA kernels: batched in-node lower bound and exact match, and the lower
bound over prefix-compressed rows.

``node_search`` replaces the TPU kernel ``node_search`` in
``src/repro/kernels/node_search.py``
(``_node_search_kernel``), which carried int64 keys as (hi, lo) int32 planes
because the TPU's vector unit has no 64-bit lanes.  Hopper compares int64
natively, so the kernel reads the key row as it is.

What bounds it: bytes.  Each lane's answer needs at least a binary search of
its sorted key row, five of the row's sixteen 32-byte sectors; the
comparisons are a handful of integer operations per byte.  Design: one warp
per row, each thread loads two keys with one 16-byte load (the warp reads the
whole 512-byte row in one coalesced transaction, about three times the least
bytes but no chain of dependent reads), ``__ballot_sync`` and ``__popc`` give
the count of keys <= q and the match mask, and only the lane that holds the
match reads its value, so no value row is streamed.  A sector-wise search is
later work.  The contract is the TPU kernel's: ``(slot, found, value)``.

The plain version is ``repro_torch.kernels.ref.node_search_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/node_search.cu``.

``node_search_prefix`` replaces the TPU kernel ``node_search_prefix`` in
``src/repro/kernels/node_search.py`` (``_prefix_search_kernel``): per lane,
one gathered row of the compressed planes (``core/pool.py::SepPlanes``:
prefix, nbits, suffix) and the canonical key row, and a slot out.  The TPU
kernel carried int64 as (hi, lo) int32 planes with a sign-flipped compare;
Hopper compares int64 natively.  What bounds it: bytes.  A compressible
lane needs its prefix (8 B), nbits (4 B), query (8 B) and slot (4 B), and
the suffix sectors a binary search reads out of its 256-byte row (four of
eight 32-byte sectors) unless its prefix already exceeds the query's; an
incompressible lane needs its nbits, query and slot and the five sectors
a search reads of its 512-byte canonical row.  Design: one warp per lane;
each thread loads two suffixes with one 8-byte load (the warp reads the
256-byte suffix row in one transaction); ballots and popcounts count the
suffixes <= the query's suffix and the real ones; the prefix compare is
scalar; only a lane with ``nbits < 0`` reads the canonical row, 16 bytes a
thread, as ``node_search`` does (the branch is warp-uniform: one warp, one
lane).  It reads whole rows, not the sectors a search needs; a
sector-wise search is later work.  The plain version is
``ref.node_search_prefix_ref``; the source is
``csrc/node_search_prefix.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.nodes import FANOUT
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    node_search_prefix_ref,
    node_search_ref,
)

_P = ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_node_search.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, _P]
    lib.dex_node_search.restype = ctypes.c_int
    lib.dex_node_search_prefix.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, _P]
    lib.dex_node_search_prefix.restype = ctypes.c_int


def check(
    t: torch.Tensor, name: str, dtype, shape, rows: bool = False, align: int = 16
) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype and shape; on
    the card, ``rows`` tensors are read ``align`` bytes a thread and must be
    aligned so.  The CPU path checks the same, so the CPU tests catch a
    layout the kernel would refuse."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if rows and t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def validate(rows: torch.Tensor, queries: torch.Tensor, values) -> None:
    b = queries.shape[0]
    check(rows, "rows", torch.int64, (b, FANOUT), rows=True)
    check(queries, "queries", torch.int64, (b,))
    if values is not None:
        check(values, "values", torch.int64, (b, FANOUT), rows=True)
    for t in (queries, values):
        if t is not None and t.device != rows.device:
            raise ValueError("node_search inputs must lie on one device")


def launch(
    lib: ctypes.CDLL,
    rows: torch.Tensor,
    queries: torch.Tensor,
    values: Optional[torch.Tensor],
):
    """Launch the kernel on the current stream; outputs are allocated here."""
    validate(rows, queries, values)
    if rows.device.type != "cuda":
        raise ValueError(f"node_search kernel needs CUDA tensors, got {rows.device}")
    b = queries.shape[0]
    slot = torch.empty((b,), dtype=torch.int32, device=rows.device)
    found = torch.empty((b,), dtype=torch.bool, device=rows.device)
    value = torch.empty((b,), dtype=torch.int64, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_node_search(
        rows.data_ptr(),
        queries.data_ptr(),
        None if values is None else values.data_ptr(),
        slot.data_ptr(),
        found.data_ptr(),
        value.data_ptr(),
        b,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"node_search launch failed: CUDA error {err}")
    return slot, found, value


def validate_prefix(prefix, nbits, suffix, rows, queries) -> None:
    b = queries.shape[0]
    check(prefix, "prefix", torch.int64, (b,))
    check(nbits, "nbits", torch.int32, (b,))
    check(suffix, "suffix", torch.int32, (b, FANOUT), rows=True, align=8)
    check(rows, "rows", torch.int64, (b, FANOUT), rows=True)
    check(queries, "queries", torch.int64, (b,))
    for t in (prefix, nbits, suffix, queries):
        if t.device != rows.device:
            raise ValueError("node_search_prefix inputs must lie on one device")


def launch_prefix(lib: ctypes.CDLL, prefix, nbits, suffix, rows, queries):
    """Launch ``node_search_prefix`` on the current stream; the slot plane
    is allocated here."""
    validate_prefix(prefix, nbits, suffix, rows, queries)
    if rows.device.type != "cuda":
        raise ValueError(
            f"node_search_prefix kernel needs CUDA tensors, got {rows.device}"
        )
    b = queries.shape[0]
    slot = torch.empty((b,), dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_node_search_prefix(
        prefix.data_ptr(),
        nbits.data_ptr(),
        suffix.data_ptr(),
        rows.data_ptr(),
        queries.data_ptr(),
        slot.data_ptr(),
        b,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"node_search_prefix launch failed: CUDA error {err}")
    return slot
