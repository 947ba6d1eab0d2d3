"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its CUDA kernel computes, with tensor
operations.  A kernel's wrapper (``kernels/ops.py``) takes the plain version
for tensors that lie on the CPU; ``chip_smoke.py`` holds each kernel to its
plain version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query walks subtree block ``subtree[i]`` of the pool from its
    root (local id 0) down ``levels`` levels; returns ``(found, value)``.

    ``pool_keys``/``pool_values`` [S, C, F] int64, ``pool_children``
    [S, C, F] int32, ``subtree`` [B] int32, ``queries`` [B] int64.  A
    negative subtree or child id counts from the end, as numpy indexing
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
    return found, value
