"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its CUDA kernel computes, with tensor
operations.  A kernel's wrapper (``kernels/ops.py``) takes the plain version
for tensors that lie on the CPU; ``chip_smoke.py`` holds each kernel to its
plain version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.nodes import KEY_MAX


def node_search_ref(
    rows: torch.Tensor,
    queries: torch.Tensor,
    values: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """In-node lower bound plus exact match, per lane.

    ``rows`` [B, F] int64, ``queries`` [B] int64, ``values`` [B, F] int64 or
    None.  Returns ``slot = max(#(row <= q) - 1, 0)`` as int32, ``found``
    (some key equals q) and ``value``, the int64 sum of the values at the
    matching slots (0 when ``values`` is None)."""
    q = queries[:, None]
    cnt = (rows <= q).sum(-1)
    slot = torch.clamp(cnt - 1, min=0).to(torch.int32)
    eq = rows == q
    found = eq.any(-1)
    if values is None:
        value = torch.zeros_like(queries)
    else:
        value = torch.where(eq, values, 0).sum(-1)
    return slot, found, value


def subtree_walk_ref(
    pool_keys: torch.Tensor,
    pool_children: torch.Tensor,
    pool_values: torch.Tensor,
    subtree: torch.Tensor,
    queries: torch.Tensor,
    *,
    levels: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query walks subtree block ``subtree[i]`` of the pool from its
    root (local id 0) down ``levels`` levels; returns ``(found, value,
    local)``, ``local`` [B] int32 being the leaf's block-local id as read
    from its parent's child slot (0 when ``levels == 1``).

    ``pool_keys``/``pool_values`` [S, C, F] int64, ``pool_children``
    [S, C, F] int32, ``subtree`` [B] int32, ``queries`` [B] int64.  A
    negative subtree or child id counts from the end, as numpy indexing
    does; ``local`` keeps the id unwrapped, as the reference engine's walk
    does."""
    st = subtree.long()
    q = queries[:, None]
    local = torch.zeros_like(st)
    for _ in range(levels - 1):
        slot, _, _ = node_search_ref(pool_keys[st, local], queries)
        local = pool_children[st, local, slot.long()].long()
    eq = pool_keys[st, local] == q
    found = eq.any(-1)
    value = torch.where(eq, pool_values[st, local], 0).sum(-1)
    return found, value, local.to(torch.int32)


def leaf_write_ref(
    rows_k: torch.Tensor,
    rows_v: torch.Tensor,
    upd_slot: torch.Tensor,
    upd_val: torch.Tensor,
    ins_key: torch.Tensor,
    ins_val: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Staged writes applied to sorted leaf rows, as
    ``repro.kernels.ref.leaf_write_ref`` computes them.

    ``rows_k``/``rows_v`` [Q, F] int64 (KEY_MAX padding), ``upd_slot``
    [Q, S] int32 (-1 inactive), ``upd_val``/``ins_key``/``ins_val`` [Q, S]
    int64 (``ins_key`` KEY_MAX inactive).  Updates land at their slot (the
    values of several updates of one slot add up), then the active inserts
    merge into the row by a stable sort of the ``[Q, F + S]`` concatenation.
    Active insert keys must be ascending, distinct from each other and from
    the row's keys, and fit in the row's slack.  Returns ``(new_keys [Q, F],
    new_values [Q, F], new_occupancy [Q] int32)``; padding values are 0."""
    q, f = rows_k.shape
    slot = upd_slot.long()
    # a spare column takes the inactive updates
    col = torch.where((slot >= 0) & (slot < f), slot, f)
    uv = torch.zeros((q, f + 1), dtype=torch.int64, device=rows_k.device)
    uv.scatter_add_(1, col, upd_val)
    has_u = torch.zeros((q, f + 1), dtype=torch.bool, device=rows_k.device)
    has_u.scatter_(1, col, torch.ones_like(col, dtype=torch.bool))
    v1 = torch.where(has_u[:, :f], uv[:, :f], rows_v)
    act = ins_key != KEY_MAX
    merged_k = torch.cat([rows_k, torch.where(act, ins_key, KEY_MAX)], -1)
    merged_v = torch.cat(
        [torch.where(rows_k != KEY_MAX, v1, 0), torch.where(act, ins_val, 0)], -1
    )
    out_k, order = torch.sort(merged_k, dim=-1, stable=True)
    out_k = out_k[:, :f].contiguous()
    out_v = merged_v.gather(1, order[:, :f])
    out_v = torch.where(out_k != KEY_MAX, out_v, 0)
    occ = (out_k != KEY_MAX).sum(-1).to(torch.int32)
    return out_k, out_v, occ
