"""CUDA kernels: batched in-node lower bound and exact match, and the lower
bound over prefix-compressed rows.

**The contract: sorted rows.**  Every key row handed to ``node_search`` or
``node_search_prefix`` is sorted non-decreasing, with any KEY_MAX padding at
its tail; for a compressible lane of ``node_search_prefix`` (``nbits >=
0``) the suffix row is sorted too, its ``0x7FFFFFFF`` padding at the tail.
On such rows the kernels equal their plain versions (``ref.node_search_ref``,
``ref.node_search_prefix_ref``, which count over the whole row) bit for
bit; on others their answers are undefined.  Every caller hands pool,
cache, tree or padding rows, all sorted.  The CPU path checks the contract
(``validate``, ``validate_prefix``); the card does not, since the check
would read the whole row.

``node_search`` replaces the TPU kernel ``node_search`` in
``src/repro/kernels/node_search.py`` (``_node_search_kernel``), which
carried int64 keys as (hi, lo) int32 planes because the TPU's vector unit
has no 64-bit lanes, and compared every key.  Hopper compares int64
natively.

What bounds it: bytes.  A sorted row's count of keys <= q needs only the
few of its sixteen 32-byte sectors a search reads, not the whole 512-byte
row.  Design (``csrc/sector_search.cuh``, ``csrc/node_search.cu``): a group
of ``G`` lanes serves one row and reads those sectors.  The default, design
B with G = 4, takes two dependent rounds: the three pairs that end the
row's first three 16-key quarters, then the chosen quarter in one 128-byte
read, seven sectors at most.  Designs A (a binary search over sectors, five
rounds of one) and C (three rounds of 1, 2 and 2 sectors) and other groups
are kept for timing (``VARIANTS``); B with G = 4 was the fastest on the
engine's descent mix (``PERF.md``).  A KEY_MAX query needs no search: the
count is 64 and ``found`` reads row[63].  With values, a hit reads one
value, or the values of its run of equal keys; a KEY_MAX query with values
reads its row's KEY_MAX run.  ``search_schedule`` walks a row in the order
each design reads it, for the tests.

``node_search_prefix`` replaces the TPU kernel ``node_search_prefix`` in
``src/repro/kernels/node_search.py`` (``_prefix_search_kernel``): per lane,
one gathered row of the compressed planes (``core/pool.py::SepPlanes``:
prefix, nbits, suffix) and the canonical key row, and a slot out.  The TPU
kernel carried int64 as (hi, lo) int32 planes with a sign-flipped compare;
Hopper compares int64 natively.  What bounds it: bytes.  The prefix compare
comes first: a prefix above the query's reads no suffix; an equal prefix
searches the suffix row for the query's suffix; a lower one counts the real
suffixes, the same search for ``0x7FFFFFFE``.  A suffix search reads at
most four of the row's eight sectors in two rounds; an incompressible lane
(``nbits < 0``) searches its canonical row as ``node_search`` does.
``prefix_schedule`` walks it for the tests.

The dispatch, build and launch count are in ``kernels/ops.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    node_search_prefix_ref,
    node_search_ref,
)

_P = ctypes.c_void_p

#: the variants ``dex_node_search`` can launch besides its default, in the
#: order of ``kVariants`` in ``csrc/node_search.cu``: design (A, B or C,
#: ``csrc/sector_search.cuh``) and lanes a group
VARIANTS = ("A1", "A2", "A4", "B1", "B2", "B4", "B8", "C1", "C2", "C4")
#: the default: ``kDefaultDesign`` and ``kDefaultGroup`` in
#: ``csrc/sector_search.cuh``
DESIGN, GROUP = "B", 4
#: the group sizes ``dex_node_search_prefix`` can launch besides its
#: default, ``kDefaultGroup`` in ``csrc/node_search_prefix.cu``
PREFIX_VARIANTS = ("G2", "G4", "G8")
PREFIX_GROUP = 2
SUFFIX_SENTINEL = 0x7FFFFFFF


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_node_search.argtypes = [
        _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P
    ]
    lib.dex_node_search.restype = ctypes.c_int
    lib.dex_node_search_prefix.argtypes = [
        _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P
    ]
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


def check_sorted(rows: torch.Tensor, name: str, lanes=None) -> None:
    """Raise unless every row (of ``lanes``, a bool mask, where given) is
    sorted non-decreasing: the kernels search and do not count.  Run on the
    CPU path only; on the card it would read every row whole."""
    bad = (rows[:, 1:] < rows[:, :-1]).any(-1)
    if lanes is not None:
        bad &= lanes
    if bool(bad.any()):
        lane = int(torch.nonzero(bad)[0, 0])
        raise ValueError(
            f"{name} must be sorted non-decreasing: lane {lane} is not"
        )


def validate(rows: torch.Tensor, queries: torch.Tensor, values) -> None:
    b = queries.shape[0]
    check(rows, "rows", torch.int64, (b, FANOUT), rows=True)
    check(queries, "queries", torch.int64, (b,))
    if values is not None:
        check(values, "values", torch.int64, (b, FANOUT), rows=True)
    for t in (queries, values):
        if t is not None and t.device != rows.device:
            raise ValueError("node_search inputs must lie on one device")
    if rows.device.type == "cpu":
        check_sorted(rows, "node_search rows")


def _variant(name, names):
    if name is None:
        return 0
    if name not in names:
        raise ValueError(f"unknown variant {name!r}: one of {names}")
    return names.index(name) + 1


def launch(
    lib: ctypes.CDLL,
    rows: torch.Tensor,
    queries: torch.Tensor,
    values: Optional[torch.Tensor],
    variant: Optional[str] = None,
):
    """Launch the kernel on the current stream (``variant``: one of
    ``VARIANTS``, else the default); outputs are allocated here."""
    validate(rows, queries, values)
    if rows.device.type != "cuda":
        raise ValueError(f"node_search kernel needs CUDA tensors, got {rows.device}")
    code = _variant(variant, VARIANTS)
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
        code,
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
    if rows.device.type == "cpu":
        check_sorted(rows, "node_search_prefix rows")
        check_sorted(suffix, "node_search_prefix suffix rows", nbits >= 0)


def launch_prefix(
    lib: ctypes.CDLL, prefix, nbits, suffix, rows, queries, variant=None
):
    """Launch ``node_search_prefix`` on the current stream (``variant``: one
    of ``PREFIX_VARIANTS``, else the default); the slot plane is allocated
    here."""
    validate_prefix(prefix, nbits, suffix, rows, queries)
    if rows.device.type != "cuda":
        raise ValueError(
            f"node_search_prefix kernel needs CUDA tensors, got {rows.device}"
        )
    code = _variant(variant, PREFIX_VARIANTS)
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
        code,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"node_search_prefix launch failed: CUDA error {err}")
    return slot


# ---------------------------------------------------------------------------
# The kernels' read order, in plain Python (tests only)


def _count_le(row, q, pairs, keys_per_sector, reads):
    """Keys <= q among the named pairs (keys 2p, 2p + 1) of a sorted row;
    their sectors are appended to ``reads``."""
    c = 0
    for p in pairs:
        reads.append(2 * p // keys_per_sector)
        c += (row[2 * p] <= q) + (row[2 * p + 1] <= q)
    return c


def _count_row(row, q, design, reads):
    """#(row <= q) over 64 sorted int64 keys as ``count_row`` in
    ``csrc/sector_search.cuh`` reads them (4 keys a sector)."""
    if design == "A":
        lo, hi = 0, 16
        while lo < hi:
            mid = (lo + hi) >> 1
            c = _count_le(row, q, (2 * mid, 2 * mid + 1), 4, reads)
            if c == 4:
                lo = mid + 1
            elif c == 0:
                hi = mid
            else:
                return 4 * mid + c
        return 4 * lo
    if design == "B":
        quarter = _count_le(row, q, (7, 15, 23), 4, reads) >> 1
        pairs = range(8 * quarter, 8 * quarter + 8)
        return 16 * quarter + _count_le(row, q, pairs, 4, reads)
    if design != "C":
        raise ValueError(f"unknown design {design!r}")
    c = _count_le(row, q, (16, 17), 4, reads)
    if c & 3:
        return 32 + c
    s0 = 9 if c else 0
    sectors = (s0 + 2, s0 + 5)
    c = _count_le(row, q, [2 * s + j for s in sectors for j in (0, 1)], 4, reads)
    if c & 3:
        return 4 * (s0 + 2 + 3 * (c >> 2)) + (c & 3)
    t = min(s0 + 3 * (c >> 2), 14)
    return 4 * t + _count_le(row, q, range(2 * t, 2 * t + 4), 4, reads)


def search_schedule(row, q, with_values, design=DESIGN):
    """Walk one sorted 64-key row as the CUDA ``node_search`` does under
    ``design``.  Returns ``(count, lo, sectors_read)``: ``count`` =
    #(row <= q), the values summed are ``values[lo:count]`` (``lo ==
    count``: none read), ``sectors_read`` the distinct 32-byte key sectors
    read, in the order first read."""
    row = [int(k) for k in row]
    q = int(q)
    reads = []
    if q == KEY_MAX:
        count = FANOUT
        reads.append(15)  # pair 31: row[62], row[63]
        last, prev = row[63], row[62]
        if with_values:
            reads.append(0)
    else:
        count = _count_row(row, q, design, reads)
        last = row[count - 1] if count else None
        if count:
            reads.append((count - 1) // 4)
    lo = count
    if with_values and count and last == q:
        if q != KEY_MAX and count > 1:
            prev = row[count - 2]
            reads.append((count - 2) // 4)
        if count > 1 and prev == q:
            if q == KEY_MIN or (q == KEY_MAX and row[0] == q):
                lo = 0
            else:
                lo = _count_row(row, q - 1, design, reads)
        else:
            lo = count - 1
    return count, lo, tuple(dict.fromkeys(reads))


def _count_suffix(row, q, reads):
    """#(suffix <= q) over 64 sorted int32 suffixes as ``count_suffix`` in
    ``csrc/sector_search.cuh`` reads them (8 a sector)."""
    c = _count_le(row, q, [8 + 12 * (j >> 2) + (j & 3) for j in range(8)], 8, reads)
    if c & 7:
        return 16 + 24 * (c >> 3) + (c & 7)
    t = 3 * (c >> 3)
    return 8 * t + _count_le(row, q, range(4 * t, 4 * t + 8), 8, reads)


def prefix_schedule(prefix, nbits, suffix, row, q):
    """Walk one lane as the CUDA ``node_search_prefix`` does.  Returns
    ``(count, suffix_sectors, key_sectors)``, the distinct 32-byte sectors
    of the suffix row and of the canonical row read."""
    q, nb = int(q), int(nbits)
    s_reads, k_reads = [], []
    if nb >= 0:
        mask = (1 << nb) - 1
        q_pref = q & ~mask
        p = int(prefix)
        if p > q_pref:
            count = 0
        else:
            q_suf = q & mask if p == q_pref else SUFFIX_SENTINEL - 1
            count = _count_suffix([int(s) for s in suffix], q_suf, s_reads)
    elif q == KEY_MAX:
        count = FANOUT
    else:
        count = _count_row([int(k) for k in row], q, DESIGN, k_reads)
    return count, tuple(dict.fromkeys(s_reads)), tuple(dict.fromkeys(k_reads))
