"""Elastic scaling: checkpoint-mediated mesh resizing and logical
repartitioning.

The port of ``repro.launch.elastic``.  Two mechanisms:

  * **Training**: a checkpoint taken under one mesh description restores
    under another: ``reshard_checkpoint`` restores through
    ``train/sharding.py``'s placements for the new mesh.  The data
    pipeline reshards deterministically (counter-based streams).
  * **Serving**: request key ranges move between replicas by adjusting
    ``LogicalPartitions`` boundaries; no page moves (the DEX index keeps
    addressing the same pool), only caches re-warm.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.partition import LogicalPartitions
from repro_torch.train import sharding as SH
from repro_torch.train.checkpoint import CheckpointManager


def reshard_checkpoint(
    ckpt: CheckpointManager,
    template,
    new_mesh,
    cfg,
    *,
    step: Optional[int] = None,
):
    """Restore ``(params, opt_state)`` under another mesh description:
    ``((params, opt_state), step, extra)``, every tensor on the new mesh's
    device."""
    params_t, opt_t = template
    p_sh = SH.param_shardings(params_t, new_mesh, cfg)
    o_sh = type(opt_t)(
        mu=SH.param_shardings(opt_t.mu, new_mesh, cfg),
        nu=SH.param_shardings(opt_t.nu, new_mesh, cfg),
        step=SH.Placement(new_mesh, ()),
    )
    return ckpt.restore((params_t, opt_t), step=step, shardings=(p_sh, o_sh))


def scale_serving_partitions(
    parts: LogicalPartitions, *, target_replicas: int, loads=None
) -> Tuple[LogicalPartitions, float]:
    """Grow or shrink the serving replica set by logical repartitioning.

    Returns ``(new_partitions, fraction_of_keyspace_moved)``: the moved
    fraction is the cache re-warm cost, the only data cost of the
    operation."""
    new = parts
    while new.num_partitions < target_replicas:
        # split the widest (or most loaded) partition at its midpoint
        widths = [
            int(new.boundaries[i + 1]) - int(new.boundaries[i])
            for i in range(new.num_partitions)
        ]
        if loads is not None and len(loads) == new.num_partitions:
            p = max(range(new.num_partitions), key=lambda i: loads[i])
            loads = list(loads[:p]) + [loads[p] / 2, loads[p] / 2] + list(loads[p + 1:])
        else:
            p = max(range(new.num_partitions), key=lambda i: widths[i])
        lo, hi = int(new.boundaries[p]), int(new.boundaries[p + 1])
        new = new.split_partition(p, lo + (hi - lo) // 2)
    while new.num_partitions > target_replicas:
        p = 0
        if loads is not None and len(loads) == new.num_partitions:
            p = min(range(new.num_partitions - 1), key=lambda i: loads[i] + loads[i + 1])
            loads = list(loads[:p]) + [loads[p] + loads[p + 1]] + list(loads[p + 2:])
        new = new.merge_partitions(p)
    return new, parts.assignment_diff(new)
