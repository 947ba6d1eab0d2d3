"""Node layout constants shared by every module of the port.

A node row holds ``FANOUT`` 8-byte keys next to ``FANOUT`` children (inner
nodes) or values (leaves), the paper's 1KB node (§3 "Node Layout and
Addressing").  Keys are int64; ``KEY_MAX`` pads empty slots and marks
inactive lanes.  ``TreeArrays`` is the flat B+-tree of ``core/btree.py``
(the serving page table's index).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.mesh import resolve_device

#: Keys per node.
FANOUT = 64

#: Sentinel for "minus infinity" (leftmost fence / leftmost separator).
KEY_MIN = -(2**63)

#: Sentinel for "plus infinity" (empty key slots, inactive lanes).
KEY_MAX = 2**63 - 1

#: Null node id.
NULL = -1

#: Default leaf fill factor for bulk loading (slack for future inserts).
DEFAULT_FILL = 0.7


class TreeArrays(NamedTuple):
    """A flat B+-tree as tensors (the reference's ``TreeArrays``).

    ``keys[n, i]`` is the smallest key reachable through slot ``i``; empty
    slots hold KEY_MAX and the leftmost slot of the leftmost node of a level
    holds KEY_MIN.  Inner nodes: ``children[n, i]`` is a node id.  Leaves:
    ``values[n, i]`` is the payload of ``keys[n, i]``.  ``version`` is the
    optimistic lock word (even = unlocked), ``fence_lo <= k < fence_hi``
    bound a node's keys, ``level`` is 0 for a leaf and -1 for a free row.
    ``root``, ``height`` and ``num_nodes`` are 0-d int32 tensors."""

    keys: torch.Tensor  # [cap, FANOUT] int64
    children: torch.Tensor  # [cap, FANOUT] int32 (inner only)
    values: torch.Tensor  # [cap, FANOUT] int64 (leaf only)
    num_keys: torch.Tensor  # [cap] int32
    level: torch.Tensor  # [cap] int32, 0 = leaf, -1 = free
    fence_lo: torch.Tensor  # [cap] int64
    fence_hi: torch.Tensor  # [cap] int64
    version: torch.Tensor  # [cap] int32
    root: torch.Tensor  # [] int32
    height: torch.Tensor  # [] int32 (number of levels, >= 1)
    num_nodes: torch.Tensor  # [] int32 (allocated prefix; free rows beyond)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def empty_tree(capacity: int, device=None) -> TreeArrays:
    """An empty tree with room for ``capacity`` nodes."""
    device = resolve_device(device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return TreeArrays(
        keys=full((capacity, FANOUT), KEY_MAX, torch.int64),
        children=full((capacity, FANOUT), NULL, torch.int32),
        values=full((capacity, FANOUT), 0, torch.int64),
        num_keys=full((capacity,), 0, torch.int32),
        level=full((capacity,), -1, torch.int32),
        fence_lo=full((capacity,), KEY_MIN, torch.int64),
        fence_hi=full((capacity,), KEY_MAX, torch.int64),
        version=full((capacity,), 0, torch.int32),
        root=full((), NULL, torch.int32),
        height=full((), 0, torch.int32),
        num_nodes=full((), 0, torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class TreeMeta:
    """Static facts about a tree build (trip counts of the batched ops)."""

    height: int
    num_nodes: int
    num_leaves: int
    capacity: int
    keys_per_leaf: int

    @property
    def levels(self) -> int:
        return self.height
