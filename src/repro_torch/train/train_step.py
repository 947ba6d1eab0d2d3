"""The training step: loss and gradients (with microbatch accumulation),
then AdamW.

The port of ``repro.train.train_step.make_train_step``: the same
microbatch split and f32 gradient accumulation, a Python loop where the
reference scans.  The parameters and the optimizer state are updated in
place (``adamw_update``) and returned; the reference's ``jax.jit`` with
donated buffers does the same to its inputs.  ``jit_train_step`` places
the batch by ``train/sharding.py``'s rules and runs the same step.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.train.optimizer import OptConfig, OptState, adamw_update, leaves, tree_map

F32 = torch.float32


def loss_and_grads(
    cfg: ArchConfig, params: Dict[str, Any], batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(total loss, metrics, grads)`` of ``M.loss_fn`` on ``batch``:
    ``grads`` has the parameters' structure and dtypes (a leaf the loss
    does not reach gets zeros).  ``params`` need not require grad: the loss
    runs on detached aliases of its leaves."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, metrics = M.loss_fn(cfg, live, batch)
        flat = list(leaves(live))
        got = torch.autograd.grad(total, flat, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g for t, g in zip(flat, got)}
    grads = tree_map(lambda t: by_id[id(t)], live)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *, microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` holds ``tokens`` and ``labels`` [B, S] (and
    ``enc_emb``) on the parameters' device; with ``microbatches`` > 1, B is
    split into that many microbatches, whose gradients are summed in f32
    and averaged, as are their losses.  The step updates ``params`` and
    ``opt_state``'s moments in place and returns them, with ``loss``,
    ``grad_norm`` and ``lr`` (and, with one microbatch, ``ce``,
    ``moe_aux`` and ``tokens``)."""

    def train_step(params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            val, metrics, grads = loss_and_grads(cfg, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
            micro = {k: v.chunk(microbatches) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
            val = torch.zeros((), dtype=F32, device=batch["tokens"].device)
            for i in range(microbatches):
                loss, _, g = loss_and_grads(cfg, params, {k: v[i] for k, v in micro.items()})
                tree_map(lambda acc, x: acc.add_(x.float()), grads, g)
                val = val + loss
                del g
            grads = tree_map(lambda g: g / microbatches, grads)
            val = val / microbatches
            metrics = {}
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        out = {"loss": val, **opt_metrics}
        out.update({k: v for k, v in metrics.items() if v.dim() == 0})
        return params, opt_state, out

    return train_step


def jit_train_step(
    cfg: ArchConfig,
    opt_cfg: OptConfig,
    mesh,
    params_shapes,
    *,
    microbatches: int = 1,
):
    """``make_train_step`` with the reference's placements on ``mesh``
    (``launch/mesh.py``): the step places the host batch where
    ``batch_shardings`` puts it (on one card every placement is the mesh's
    device) through ``data/pipeline.py::to_device``, and updates the
    parameters and moments in place, where the reference donates their
    buffers.  The parameters (``params_shapes``' structure) must lie on
    the mesh's device: a step that moved them could not update them in
    place."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.train.sharding import batch_shardings, param_shardings

    p_sh = param_shardings(params_shapes, mesh, cfg)
    (device,) = {s.device for s in batch_shardings(mesh, encdec=cfg.encdec).values()}
    step = make_train_step(cfg, opt_cfg, microbatches=microbatches)

    def placed_step(params, opt_state: OptState, batch):
        for p, s in zip(leaves(params), leaves(p_sh)):
            if p.device != s.device:
                raise ValueError(f"a parameter lies on {p.device}, the mesh on {s.device}")
        return step(params, opt_state, to_device(batch, cfg, device))

    return placed_step
