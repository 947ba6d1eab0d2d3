"""CUDA kernel: the owner-side offload walk over the subtree-blocked pool.

Replaces the TPU kernel ``subtree_walk`` in
``src/repro/kernels/subtree_walk.py``, which staged one subtree block in VMEM
and turned each pointer dereference into a one-hot matrix product over 16-bit
f32 planes.  Hopper indexes memory directly, so the kernel follows the
child ids.  The contract is generalised so the engine can call it on a whole
pool: each query names its own subtree block
(``subtree_walk(pool_keys [S,C,64], pool_children [S,C,64], pool_values
[S,C,64], subtree [B], queries [B], levels)``); the TPU kernel's contract is
the case ``S = 1``, ``subtree = 0``.  Beside ``(found, value)`` it returns
the leaf's block-local id (``int32 [B]``): an offloaded write applies at the
leaf the owner's walk reached.

What bounds it: memory latency.  A query reads ``levels`` 512-byte rows, and
each row's address depends on the child id read from the row before, so a
warp waits out one device-memory round trip per level; the byte bound (a
binary search of each distinct row, over the card's memory rate) is far below
what the chain of dependent reads allows.  Design: one warp per query, one coalesced 512-byte read per
level, ballots for the slot, the child id read once by the whole warp (one
broadcast transaction), and the leaf value read only by the lane that holds
the match.  Many warps in flight hide part of the latency; staging an M = 1
block (45 nodes) in shared memory is later work.

The plain version is ``repro_torch.kernels.ref.subtree_walk_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/subtree_walk.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.nodes import FANOUT
from repro_torch.kernels.node_search import check
from repro_torch.kernels.ref import subtree_walk_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_subtree_walk.argtypes = [
        _P,
        _P,
        _P,
        _P,
        _P,
        _P,
        _P,
        _P,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        _P,
    ]
    lib.dex_subtree_walk.restype = ctypes.c_int


def validate(pool_keys, pool_children, pool_values, subtree, queries, levels):
    if pool_keys.dim() != 3:
        raise ValueError(f"pool_keys must be [S, C, {FANOUT}]")
    s, c, _ = pool_keys.shape
    b = queries.shape[0]
    check(pool_keys, "pool_keys", torch.int64, (s, c, FANOUT), rows=True)
    check(pool_children, "pool_children", torch.int32, (s, c, FANOUT))
    check(pool_values, "pool_values", torch.int64, (s, c, FANOUT), rows=True)
    check(subtree, "subtree", torch.int32, (b,))
    check(queries, "queries", torch.int64, (b,))
    for t in (pool_children, pool_values, subtree, queries):
        if t.device != pool_keys.device:
            raise ValueError("subtree_walk inputs must lie on one device")
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")


def launch(
    lib: ctypes.CDLL,
    pool_keys: torch.Tensor,
    pool_children: torch.Tensor,
    pool_values: torch.Tensor,
    subtree: torch.Tensor,
    queries: torch.Tensor,
    levels: int,
):
    """Launch the kernel on the current stream; outputs are allocated here."""
    validate(pool_keys, pool_children, pool_values, subtree, queries, levels)
    dev = pool_keys.device
    if dev.type != "cuda":
        raise ValueError(f"subtree_walk kernel needs CUDA tensors, got {dev}")
    s, c, _ = pool_keys.shape
    b = queries.shape[0]
    found = torch.empty((b,), dtype=torch.bool, device=dev)
    value = torch.empty((b,), dtype=torch.int64, device=dev)
    leaf = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_subtree_walk(
        pool_keys.data_ptr(),
        pool_children.data_ptr(),
        pool_values.data_ptr(),
        subtree.data_ptr(),
        queries.data_ptr(),
        found.data_ptr(),
        value.data_ptr(),
        leaf.data_ptr(),
        b,
        s,
        c,
        levels,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"subtree_walk launch failed: CUDA error {err}")
    return found, value, leaf
