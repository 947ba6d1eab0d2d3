"""Node layout constants shared by every module of the port.

A node row holds ``FANOUT`` 8-byte keys next to ``FANOUT`` children (inner
nodes) or values (leaves), the paper's 1KB node (§3 "Node Layout and
Addressing").  Keys are int64; ``KEY_MAX`` pads empty slots and marks
inactive lanes.
"""

from __future__ import annotations

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
