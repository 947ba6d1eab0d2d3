"""CUDA kernel: range-scan compaction over a window of leaf rows.

Replaces the TPU kernel ``leaf_scan`` in ``src/repro/kernels/leaf_scan.py``,
the last step of a scan lane (``core/engine.py``): out of each lane's window
of consecutive leaf rows, take up to ``count`` records with key >= the
lane's start, in window order, and compact them into ``[B, max_count]``.
The TPU kernel carried int64 as (hi, lo) int32 planes and placed every
output column with a one-hot ``[B, max_count, W]`` compare, since the TPU
has no scatter and no 64-bit lanes.  Hopper compares int64 natively and
writes by address, so neither carries over.

What bounds it: bytes.  An active lane needs its start row searched, each
selected record read and its output row written; an inactive slot (count
0, most of an engine batch's routed slots) only its start and count read
and its padded row written.  The compute is a ballot and a popcount per 32
keys.  Design: one warp per lane; the warp walks the window in 32-key
chunks (256-byte coalesced reads), ranks the selected keys with
``__ballot_sync`` / ``__popc`` under the lane mask, and each thread writes
its key and value straight to their output column.  The walk stops as soon
as the count is covered, so the hops a lane did not need are never read;
an inactive lane only writes its padding.

Contract (the TPU kernel's): ``leaf_scan(window_keys [B, W], window_values
[B, W] int64, start_keys [B] int64, counts [B] int32, max_count) ->
(keys [B, max_count] int64 KEY_MAX-padded, values [B, max_count] int64
0-padded, taken [B] int32)``; counts are clipped to ``[0, max_count]``.

The plain version is ``repro_torch.kernels.ref.leaf_scan_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/leaf_scan.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.ref import leaf_scan_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_leaf_scan.argtypes = [_P] * 7 + [ctypes.c_int64, ctypes.c_int,
                                             ctypes.c_int, _P]
    lib.dex_leaf_scan.restype = ctypes.c_int


def validate(window_keys, window_values, start_keys, counts, max_count) -> None:
    b, w = window_keys.shape
    check(window_keys, "window_keys", torch.int64, (b, w))
    check(window_values, "window_values", torch.int64, (b, w))
    check(start_keys, "start_keys", torch.int64, (b,))
    check(counts, "counts", torch.int32, (b,))
    if not 0 < max_count <= w:
        raise ValueError(f"max_count must be in [1, {w}], got {max_count}")
    for t in (window_values, start_keys, counts):
        if t.device != window_keys.device:
            raise ValueError("leaf_scan inputs must lie on one device")


def launch(lib: ctypes.CDLL, window_keys, window_values, start_keys, counts,
           max_count: int):
    """Launch the kernel on the current stream; outputs are allocated here."""
    validate(window_keys, window_values, start_keys, counts, max_count)
    dev = window_keys.device
    if dev.type != "cuda":
        raise ValueError(f"leaf_scan kernel needs CUDA tensors, got {dev}")
    b, w = window_keys.shape
    out_k = torch.empty((b, max_count), dtype=torch.int64, device=dev)
    out_v = torch.empty((b, max_count), dtype=torch.int64, device=dev)
    taken = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_leaf_scan(
        window_keys.data_ptr(),
        window_values.data_ptr(),
        start_keys.data_ptr(),
        counts.data_ptr(),
        out_k.data_ptr(),
        out_v.data_ptr(),
        taken.data_ptr(),
        b,
        w,
        max_count,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"leaf_scan launch failed: CUDA error {err}")
    return out_k, out_v, taken
