"""CUDA kernel: staged updates and inserts applied to sorted leaf rows.

Replaces the TPU kernel ``leaf_write`` in ``src/repro/kernels/leaf_write.py``,
the compute core of the write path (``core/write.py``): per leaf row, a
masked value scatter of the staged updates, a rank merge of the staged
inserts into the row's slack, and the new occupancy.  The TPU kernel carried
int64 as (hi, lo) int32 planes and found every rank and every output column
with one-hot ``[B, S, F]`` compares and reductions, since the TPU has no
scatter and no 64-bit lanes.  Hopper compares int64 natively and writes to
shared memory by address, so neither carries over.

What bounds it: bytes.  A row's key and value planes are read and written
once (2 KB a row); the active staged entries are few (an engine batch stages
a handful per touched leaf and leaves most rows empty), so the compute is a
few warp instructions per active entry.  Design: one warp per row, each
thread holding two row slots and two staged entries (16-byte loads).  The
warp loops over the active staged updates (broadcast each, the owner of the
slot takes the value) and over the active staged keys (two ballots count the
row keys below each, every lane counts it against its own row keys), so a
row with nothing staged costs no loop at all.  Each element goes straight to
its output column in a per-warp shared-memory row, which the warp then
stores with coalesced 16-byte stores.  The staged update slots and insert
keys are read whole (768 B a row) to find the active entries; their values
only where active.

Contract (the TPU kernel's, with ``S = 64``): ``leaf_write(rows_k [Q, 64],
rows_v [Q, 64], upd_slot [Q, 64] int32, upd_val, ins_key, ins_val [Q, 64])
-> (new_k [Q, 64], new_v [Q, 64], occ [Q] int32)``.  Active insert keys are
ascending, distinct from each other and from the row's keys, and fit in the
slack; updates target distinct slots.

The plain version is ``repro_torch.kernels.ref.leaf_write_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/leaf_write.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.nodes import FANOUT
from repro_torch.kernels.node_search import check
from repro_torch.kernels.ref import leaf_write_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_leaf_write.argtypes = [_P] * 9 + [ctypes.c_int64, _P]
    lib.dex_leaf_write.restype = ctypes.c_int


def validate(rows_k, rows_v, upd_slot, upd_val, ins_key, ins_val) -> None:
    q = rows_k.shape[0]
    for t, name, dtype in (
        (rows_k, "rows_k", torch.int64),
        (rows_v, "rows_v", torch.int64),
        (upd_slot, "upd_slot", torch.int32),
        (upd_val, "upd_val", torch.int64),
        (ins_key, "ins_key", torch.int64),
        (ins_val, "ins_val", torch.int64),
    ):
        check(t, name, dtype, (q, FANOUT), rows=True)
        if t.device != rows_k.device:
            raise ValueError("leaf_write inputs must lie on one device")


def launch(lib: ctypes.CDLL, rows_k, rows_v, upd_slot, upd_val, ins_key, ins_val):
    """Launch the kernel on the current stream; outputs are allocated here."""
    validate(rows_k, rows_v, upd_slot, upd_val, ins_key, ins_val)
    dev = rows_k.device
    if dev.type != "cuda":
        raise ValueError(f"leaf_write kernel needs CUDA tensors, got {dev}")
    q = rows_k.shape[0]
    out_k = torch.empty_like(rows_k)
    out_v = torch.empty_like(rows_v)
    occ = torch.empty((q,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_leaf_write(
        rows_k.data_ptr(),
        rows_v.data_ptr(),
        upd_slot.data_ptr(),
        upd_val.data_ptr(),
        ins_key.data_ptr(),
        ins_val.data_ptr(),
        out_k.data_ptr(),
        out_v.data_ptr(),
        occ.data_ptr(),
        q,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"leaf_write launch failed: CUDA error {err}")
    return out_k, out_v, occ
