"""CUDA kernel: staged inserts merged into sorted leaf rows, a row cut in
two where the merge overflows it.

Replaces the TPU kernel ``leaf_split`` in ``src/repro/kernels/leaf_split.py``,
the compute core of the on-mesh SMO round (``core/smo.py``): per leaf row, a
rank merge of the staged inserts; a row whose merged count ``m`` exceeds 64
is cut at ``m // 2`` into a left and a right row, and the right row's first
key is the separator its parent takes.  The TPU kernel carried int64 as
(hi, lo) int32 planes and ranked every element and placed every output
column with one-hot compares, since the TPU has no scatter and no 64-bit
lanes.  Hopper compares int64 natively and writes to shared memory by
address, so neither carries over.

What bounds it: bytes.  A row's key and value planes are read once and its
left row written once (2 KB a row); a row that splits also writes its right
row (1 KB more); the staged lists are read to find the active entries, whose
values are read only where active.  An SMO round stages a handful of keys
per touched leaf and leaves most rows empty, so the compute is a few warp
instructions per active entry.  Design: one warp per row, each thread
holding two row slots and two staged entries (16-byte loads); the warp loops
over the active staged keys only (ballots count the row keys and the staged
keys below each, every lane counts it against its own row keys), places each
element at its position in a per-warp shared-memory left or right row, and
stores both rows with coalesced 16-byte stores.

Contract (the TPU kernel's, with ``S = 64``): ``leaf_split(rows_k [Q, 64],
rows_v [Q, 64], ins_key [Q, 64], ins_val [Q, 64]) -> (left_k, left_v,
right_k, right_v [Q, 64] int64, occ_l, occ_r [Q] int32, sep [Q] int64,
did_split [Q] int32)``.  Row keys are ascending with KEY_MAX padding; active
staged keys are distinct from each other and from the row's keys, in any
order.

The plain version is ``repro_torch.kernels.ref.leaf_split_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/leaf_split.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.nodes import FANOUT
from repro_torch.kernels.node_search import check
from repro_torch.kernels.ref import leaf_split_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_leaf_split.argtypes = [_P] * 12 + [ctypes.c_int64, _P]
    lib.dex_leaf_split.restype = ctypes.c_int


def validate(rows_k, rows_v, ins_key, ins_val) -> None:
    q = rows_k.shape[0]
    for t, name in (
        (rows_k, "rows_k"),
        (rows_v, "rows_v"),
        (ins_key, "ins_key"),
        (ins_val, "ins_val"),
    ):
        check(t, name, torch.int64, (q, FANOUT), rows=True)
        if t.device != rows_k.device:
            raise ValueError("leaf_split inputs must lie on one device")


def launch(lib: ctypes.CDLL, rows_k, rows_v, ins_key, ins_val):
    """Launch the kernel on the current stream; outputs are allocated here."""
    validate(rows_k, rows_v, ins_key, ins_val)
    dev = rows_k.device
    if dev.type != "cuda":
        raise ValueError(f"leaf_split kernel needs CUDA tensors, got {dev}")
    q = rows_k.shape[0]
    rows = [torch.empty_like(rows_k) for _ in range(4)]
    i32 = dict(dtype=torch.int32, device=dev)
    occ_l, occ_r, did = (torch.empty((q,), **i32) for _ in range(3))
    sep = torch.empty((q,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_leaf_split(
        rows_k.data_ptr(),
        rows_v.data_ptr(),
        ins_key.data_ptr(),
        ins_val.data_ptr(),
        *(t.data_ptr() for t in rows),
        occ_l.data_ptr(),
        occ_r.data_ptr(),
        sep.data_ptr(),
        did.data_ptr(),
        q,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"leaf_split launch failed: CUDA error {err}")
    return (*rows, occ_l, occ_r, sep, did)
