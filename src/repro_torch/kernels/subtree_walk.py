"""CUDA kernel: the owner-side offload walk over the subtree-blocked pool.

Replaces the TPU kernel ``subtree_walk`` in
``src/repro/kernels/subtree_walk.py``, which staged one subtree block in VMEM
and turned each pointer dereference into a one-hot matrix product over 16-bit
f32 planes.  Hopper indexes memory directly, so the kernel follows the
child ids.  The contract is generalised so the engine can call it on a whole
pool: each query names its own subtree block
(``subtree_walk(pool_keys [S,C,64], pool_children [S,C,64], pool_values
[S,C,64], subtree [B], queries [B], levels, active)``); the TPU kernel's
contract is the case ``S = 1``, ``subtree = 0``, ``active = None``.  Beside
``(found, value)`` it returns the leaf's block-local id (``int32 [B]``): an
offloaded write applies at the leaf the owner's walk reached.  A lane whose
``active`` is False returns ``(False, 0, 0)`` and reads nothing else: the
engine marks the lanes it walks in its padded exchange.

**The contract: sorted rows.**  Every key row of the pool is sorted
non-decreasing, KEY_MAX padding at its tail, as ``core/pool.py`` builds it
and the writes and splits keep it.  The kernel searches each row it visits
and reads only a few of its sectors; on an unsorted row its answer is
undefined.  The CPU path checks the whole pool (``validate``); the card
does not.

What bounds it: memory latency.  A lane's reads form a chain (a row, the
child id, the next row, ..., the value), each address known only when the
read before it returns.  Design (``csrc/subtree_walk.cu``): a group of
``GROUP`` lanes serves one query and searches each row by design
``DESIGN`` of ``csrc/sector_search.cuh`` (splitter pairs, then a 128-byte
quarter), so a 256-thread block holds 64 chains where a warp a query held
8; the group's rank 0 reads the child id; the leaf is ``node_search``'s
match.  ``VARIANTS`` lists the designs and group sizes the kernel can
launch for timing, ``W`` being the first design (a warp a query, whole
rows).  ``walk_schedule`` walks a lane in the kernel's read order, and
``read_sectors`` counts the default design's reads over a batch, for the
tests and the bounds of ``chip_smoke.py``.

The plain version is ``repro_torch.kernels.ref.subtree_walk_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/subtree_walk.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN
from repro_torch.kernels.node_search import (
    _count_row,
    _variant,
    check,
    check_sorted,
    search_schedule,
)
from repro_torch.kernels.ref import subtree_walk_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p

#: the variants ``dex_subtree_walk`` can launch besides its default, in the
#: order of ``kVariants`` in ``csrc/subtree_walk.cu``: design and lanes a
#: group, or ``W``, a warp a query over whole rows
VARIANTS = ("B2", "B4", "B8", "C2", "C4", "W")
#: the default: ``kWalkDesign`` and ``kWalkGroup`` in ``csrc/subtree_walk.cu``
DESIGN, GROUP = "B", 4
#: threads a block (``kThreads``)
THREADS = 256


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_subtree_walk.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        _P,
    ]
    lib.dex_subtree_walk.restype = ctypes.c_int


def validate(
    pool_keys, pool_children, pool_values, subtree, queries, levels, active=None
):
    if pool_keys.dim() != 3:
        raise ValueError(f"pool_keys must be [S, C, {FANOUT}]")
    s, c, _ = pool_keys.shape
    b = queries.shape[0]
    check(pool_keys, "pool_keys", torch.int64, (s, c, FANOUT), rows=True)
    check(pool_children, "pool_children", torch.int32, (s, c, FANOUT))
    check(pool_values, "pool_values", torch.int64, (s, c, FANOUT), rows=True)
    check(subtree, "subtree", torch.int32, (b,))
    check(queries, "queries", torch.int64, (b,))
    if active is not None:
        check(active, "active", torch.bool, (b,))
    for t in (pool_children, pool_values, subtree, queries, active):
        if t is not None and t.device != pool_keys.device:
            raise ValueError("subtree_walk inputs must lie on one device")
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if pool_keys.device.type == "cpu":
        check_sorted(pool_keys.view(-1, FANOUT), "subtree_walk pool rows")


def launch(
    lib: ctypes.CDLL,
    pool_keys: torch.Tensor,
    pool_children: torch.Tensor,
    pool_values: torch.Tensor,
    subtree: torch.Tensor,
    queries: torch.Tensor,
    levels: int,
    active: Optional[torch.Tensor] = None,
    variant: Optional[str] = None,
):
    """Launch the kernel on the current stream (``variant``: one of
    ``VARIANTS``, else the default); outputs are allocated here."""
    validate(pool_keys, pool_children, pool_values, subtree, queries, levels, active)
    dev = pool_keys.device
    if dev.type != "cuda":
        raise ValueError(f"subtree_walk kernel needs CUDA tensors, got {dev}")
    code = _variant(variant, VARIANTS)
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
        None if active is None else active.data_ptr(),
        found.data_ptr(),
        value.data_ptr(),
        leaf.data_ptr(),
        b,
        s,
        c,
        levels,
        code,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"subtree_walk launch failed: CUDA error {err}")
    return found, value, leaf


# ---------------------------------------------------------------------------
# The kernel's read order, in plain Python (tests and bounds only)

WRAP = 2**64


def walk_schedule(keys, children, values, st, q, levels, active=True, design=DESIGN):
    """Walk one lane as the CUDA ``subtree_walk`` does under ``design``.
    ``keys``, ``children``, ``values``: the pool ``[S, C, 64]`` (numpy);
    ``st``: the lane's subtree id; ``q``: its query.  Returns ``(found,
    value, leaf, reads)``, ``reads`` the rows read in order, each
    ``(plane, (subtree, local), sectors)`` with the distinct 32-byte sectors
    of that row read (8 child ids or 4 keys or values a sector)."""
    if not active:
        return False, 0, 0, []
    q = int(q)
    s_n, cap = keys.shape[:2]
    st = int(st) + s_n if st < 0 else int(st)
    local, read, reads = 0, 0, []
    for _ in range(levels - 1):
        sectors = []
        count = FANOUT if q == KEY_MAX else _count_row(
            [int(k) for k in keys[st, local]], q, design, sectors
        )
        slot = max(count - 1, 0)
        reads.append(("keys", (st, local), tuple(dict.fromkeys(sectors))))
        reads.append(("children", (st, local), (slot // 8,)))
        read = int(children[st, local, slot])
        local = read + cap if read < 0 else read
    row = keys[st, local]
    count, lo, sectors = search_schedule(row, q, True, design)
    reads.append(("keys", (st, local), sectors))
    found = count > 0 and int(row[count - 1]) == q
    if count > lo:
        reads.append(
            ("values", (st, local), tuple(range(lo // 4, (count - 1) // 4 + 1)))
        )
    v = sum(int(x) for x in values[st, local, lo:count]) % WRAP
    return found, v - WRAP if v >= 2**63 else v, read, reads


def _popcount(mask: torch.Tensor, bits: int) -> torch.Tensor:
    shifts = torch.arange(bits, device=mask.device)
    return ((mask[:, None] >> shifts) & 1).sum(1)


def _granules(mask: torch.Tensor) -> torch.Tensor:
    """64-byte granules (sector pairs) that a 16-bit sector mask touches."""
    return _popcount((mask | (mask >> 1)) & 0x5555, 16)


def _bit(i: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(i) << i.clamp(min=0)


def _at(rows: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``rows[lane, j[lane]]``, ``j`` clamped into the row."""
    return rows.gather(1, j.clamp(0, FANOUT - 1)[:, None])[:, 0]


def _b_search(rows: torch.Tensor, q: torch.Tensor):
    """Design B's ``count_row`` over sorted rows: ``(count, sector mask)``.
    Its first round reads the splitter pairs' sectors 3, 7 and 11; the
    number of splitters (keys 15, 31, 47) <= q picks the quarter whose four
    sectors it reads next."""
    count = (rows <= q[:, None]).sum(1)
    quarter = (rows[:, [15, 31, 47]] <= q[:, None]).sum(1)
    return count, (1 << 3) | (1 << 7) | (1 << 11) | (0xF << (4 * quarter))


def read_sectors(pool_keys, pool_children, subtree, queries, levels, active=None):
    """Per lane, ``(sectors, granules)``: the distinct 32-byte sectors and
    64-byte granules of each row the default design (B) reads, summed over
    the rows of its walk: key rows, child ids, values.  Vectorised
    ``walk_schedule`` (the tests hold them equal); 0 for an inactive lane.
    Rows must be sorted."""
    q = queries
    km = q == KEY_MAX
    st = subtree.long()
    st = torch.where(st < 0, st + pool_keys.shape[0], st)
    cap = pool_keys.shape[1]
    local = torch.zeros_like(st)
    one = torch.ones_like(st)
    sectors = torch.zeros_like(st)
    granules = torch.zeros_like(st)
    for _ in range(levels - 1):
        rows = pool_keys[st, local]
        count, mask = _b_search(rows, q)
        count = torch.where(km, FANOUT, count)
        mask = torch.where(km, 0, mask)
        sectors += _popcount(mask, 16) + one  # and the child id's sector
        granules += _granules(mask) + one
        slot = (count - 1).clamp(min=0)
        local = pool_children[st, local, slot].long()
        local = torch.where(local < 0, local + cap, local)
    rows = pool_keys[st, local]
    count, mask = _b_search(rows, q)
    count = torch.where(km, FANOUT, count)
    # the found check reads row[count - 1]; a KEY_MAX query reads row[63]
    # and row[0] (the pair 62-63 also gives prev)
    last = torch.where(count > 0, _bit((count - 1) // 4), 0)
    mask = torch.where(km, (1 << 15) | 1, mask | last)
    hit = (count > 0) & (_at(rows, count - 1) == q)
    prev = _at(rows, count - 2)
    mask |= torch.where(hit & ~km & (count > 1), _bit((count - 2) // 4), 0)
    run = hit & (count > 1) & (prev == q)
    from_0 = (q == KEY_MIN) | (km & (rows[:, 0] == q))
    second = run & ~from_0
    q1 = torch.where(second, q - 1, q)
    lo_count, lo_mask = _b_search(rows, q1)
    mask |= torch.where(second, lo_mask, 0)
    lo = torch.where(run, torch.where(from_0, 0, lo_count), count - 1)
    n_val = torch.where(hit, (count - 1) // 4 - lo // 4 + 1, 0)
    g_val = torch.where(hit, (count - 1) // 8 - lo // 8 + 1, 0)
    sectors += _popcount(mask, 16) + n_val
    granules += _granules(mask) + g_val
    if active is not None:
        sectors = torch.where(active, sectors, 0)
        granules = torch.where(active, granules, 0)
    return sectors, granules
