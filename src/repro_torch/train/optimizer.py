"""AdamW with global-norm clipping and a warm-up plus cosine schedule, and
the int8 error-feedback gradient compressor.

The port of ``repro.train.optimizer``.  Its arithmetic is the reference's
one for one, in f32, with one rounding back to each leaf's dtype and the
moments' dtype (bf16 moments by default).  Three differences:

* the update is in place: parameters and moments are written where they
  lie (the reference returns new trees), so a step holds no second copy
  of a 10 GB model;
* like the reference, a stacked ``[L, ...]`` leaf is updated a layer slice
  at a time, and any slice above ``CHUNK`` elements (the 786M-element
  embedding and head of minitron-4b, 3.1 GB per f32 temporary) in row
  chunks; the update is elementwise, so this is exact;
* XLA on the CPU contracts some ``a * b + c`` into fused multiply-adds
  (``ROADMAP.md`` queue 3, entry 2), so the moments may differ from the
  reference's by an ulp; ``tests/test_torch_train.py`` states the
  tolerance.

``OptState.step`` is a Python int, the schedule's scalars are f32
tensors on the CPU.  ``compressed_psum`` runs the reference's
``shard_map`` reduction over the virtual mesh's leading axis
(``core/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.core import mesh

F32 = torch.float32
#: elements an update piece may hold: a few f32 temporaries of 256 MB
CHUNK = 1 << 26
#: profiler range around ``adamw_update``
ADAMW_UPDATE = "adamw update"


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"  # bf16 moments: ZeRO-3 fit for 405B


class OptState(NamedTuple):
    mu: Any  # first moment (tree of tensors, moment_dtype)
    nu: Any  # second moment (tree of tensors, moment_dtype)
    step: int


def tree_map(fn, *trees):
    """``fn`` over the leaves of dicts of tensors that share one structure."""
    return {
        k: tree_map(fn, *(t[k] for t in trees)) if isinstance(v, dict) else fn(*(t[k] for t in trees))
        for k, v in trees[0].items()
    }


def leaves(tree) -> Iterator[torch.Tensor]:
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def init_opt_state(params: Any, cfg: OptConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params), step=0)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: a linear warm-up, then a cosine from
    ``lr`` down to ``min_lr_ratio * lr``; an f32 scalar on the CPU."""
    s = torch.as_tensor(step, dtype=F32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _pieces(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` that together cover it once: a stacked ``[L, ...]``
    leaf a layer at a time, and any slice of more than ``CHUNK`` elements
    in row chunks of at most ``CHUNK``."""
    slices = t.unbind(0) if t.dim() >= 3 and t.shape[0] > 1 else (t,)
    for sl in slices:
        if sl.numel() <= CHUNK:
            yield sl
            continue
        rows = sl.reshape(-1, sl.shape[-1])
        step = max(1, CHUNK // rows.shape[1])
        yield from rows.split(step)


def global_norm(tree: Any) -> torch.Tensor:
    """The f32 L2 norm of all the leaves, each leaf's sum of squares taken
    piece by piece (``_pieces``)."""
    sums = [
        sum(torch.sum(torch.square(p.float())) for p in _pieces(g)) for g in leaves(tree)
    ]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(
    cfg: OptConfig, params: Any, grads: Any, state: OptState
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params`` and the moments of ``state`` are
    written where they lie and returned, with the new step and the metrics
    ``grad_norm`` and ``lr``.  The gradients are clipped to ``clip_norm``
    by their global norm; weight decay applies to leaves of two or more
    dims.  The update runs under the profiler range ``ADAMW_UPDATE``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    s = torch.tensor(step, dtype=F32)
    bc1 = 1 - b1**s
    bc2 = 1 - b2**s

    def upd(p, g, m, v):
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("adamw_update writes parameters and moments in place: they"
                             " must be contiguous")
        decay = p.dim() >= 2
        for pp, gg, mm, vv in zip(_pieces(p), _pieces(g), _pieces(m), _pieces(v)):
            gf = gg.float() * scale
            m_new = b1 * mm.float() + (1 - b1) * gf
            v_new = b2 * vv.float() + (1 - b2) * gf * gf
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * pp.float()
            pp.copy_(pp.float() - lr * delta)
            mm.copy_(m_new)
            vv.copy_(v_new)

    with torch.no_grad(), torch.autograd.profiler.record_function(ADAMW_UPDATE):
        tree_map(upd, params, grads, state.mu, state.nu)
    return (
        params,
        OptState(mu=state.mu, nu=state.nu, step=step),
        {"grad_norm": gnorm, "lr": lr},
    )


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression (cross-pod all-reduce trick)
# ---------------------------------------------------------------------------


def compress_int8(
    g: torch.Tensor, err: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize g + err to int8 with a per-tensor scale.  Returns ``(q int8,
    scale f32, new_err)``: the residual is carried so the quantization noise
    cancels over steps instead of biasing training."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over the participants of the leading
    axis: ``g`` and ``err`` are ``[n, ...]``, participant ``i``'s gradient
    and residual at ``[i]``, as ``core/mesh.py`` lays out a virtual mesh.
    Each participant compresses its own slice (``compress_int8``); the
    int8 payloads are summed in int32 (``mesh.psum``) and the scales
    reduced by their maximum (``mesh.pmax``), as the reference's ``psum``
    and ``pmax`` over the axis do.  Returns ``(g_reduced f32 [n, ...],
    new_err [n, ...])``.  Like the reference's collective counter, which
    counts ``all_to_all`` and ``route_exchange`` only, ``core/mesh.py``
    counts neither reduction."""
    q, scale, new_err = zip(*(compress_int8(gi, ei) for gi, ei in zip(g, err)))
    q, scale, new_err = torch.stack(q), torch.stack(scale), torch.stack(new_err)
    summed = mesh.psum(q.to(torch.int32))
    scale_max = mesh.pmax(scale).reshape((-1,) + (1,) * (g.dim() - 1))
    return summed.float() * scale_max, new_err
