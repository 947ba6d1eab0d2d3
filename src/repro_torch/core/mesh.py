"""The virtual mesh: the reference's route x memory device mesh, run in one
process on one card.

The reference runs its engine body under ``shard_map`` over a
``(route, memory)`` mesh.  The port runs the same mesh as a leading ``Dev``
axis on every per-device tensor, route-major (``dev = r * n_memory + m``),
and runs the engine body once, batched over ``Dev``.  The collectives become
tensor operations on that axis:

* ``a2a`` over the memory axis, on ``[Dev, n_memory, ...]`` buffers:
  ``out[r*nm + m, s] = buf[r*nm + s, m]``;
* ``a2a`` over the route axis, on ``[Dev, n_route, ...]`` buffers:
  ``out[r*nm + m, s] = buf[s*nm + m, r]``.  With two route axes ``(a0,
  a1)`` of sizes ``(s0, s1)`` the route index is ``r = d0 * s1 + d1``
  (route-major, as the reference's ``P(all_axes)`` orders devices), and an
  exchange over ``a0`` swaps the buffer's ``i0`` with the device's ``d0``,
  one over ``a1`` its ``i1`` with ``d1``;
* ``psum`` and ``pmax`` over all axes: a sum or maximum over ``Dev``,
  broadcast back;
* ``gather_route``, the write round's all-gather over the route axis: the
  reference makes every route replica of a memory column apply the same
  gathered batch to its copy of the shard; the virtual mesh holds the pool
  once, so it keeps one gathered batch per column, and ``route_share``
  hands each device its own route row of the response.

Every collective goes through this module, which counts the calls the way
``repro.core.routing`` counts them while tracing (``all_to_all`` and
``route_exchange``; the reference counts no all-gather), so the per-batch
counts can be held against the reference's.  Inside a :func:`phase` block
each call is also counted under the block's label, as the reference's
``trace_phase`` does: the pipelined engine labels its two halves
``pipe/front`` and ``pipe/back``.
"""

from __future__ import annotations

import contextlib

import torch

COUNTS = {"all_to_all": 0, "route_exchange": 0}
#: the counts of each :func:`phase` label since the last reset
PHASE_COUNTS: dict = {}
_PHASE: list = [None]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; raises when CUDA is asked for and missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def phase(label: str):
    """Count the collectives called inside this block under ``label`` too
    (the innermost label wins)."""
    prev = _PHASE[0]
    _PHASE[0] = label
    try:
        yield
    finally:
        _PHASE[0] = prev


def count(kind: str) -> None:
    COUNTS[kind] += 1
    label = _PHASE[0]
    if label is not None:
        per = PHASE_COUNTS.setdefault(label, {"all_to_all": 0, "route_exchange": 0})
        per[kind] += 1


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    PHASE_COUNTS.clear()


def collective_counts(by_phase: bool = False) -> dict:
    """The counts since the last reset; with ``by_phase`` also ``"phases"``,
    the counts of each label that counted a collective."""
    out = dict(COUNTS)
    if by_phase:
        out["phases"] = {
            label: dict(per) for label, per in PHASE_COUNTS.items() if any(per.values())
        }
    return out


def device_linear_index(cfg, device) -> torch.Tensor:
    """``[Dev]`` linear device position over all mesh axes, route-major."""
    return torch.arange(cfg.n_devices, device=device)


def route_linear_index(cfg, device) -> torch.Tensor:
    """``[Dev]`` position of each device along the composed route axes,
    route-major (the leading axis of :func:`gather_route`)."""
    return torch.arange(cfg.n_devices, device=device) // cfg.n_memory


def memory_linear_index(cfg, device) -> torch.Tensor:
    """``[Dev]`` memory column of each device."""
    return torch.arange(cfg.n_devices, device=device) % cfg.n_memory


def a2a(x: torch.Tensor, cfg, axis: str) -> torch.Tensor:
    """``[Dev, n_axis, ...]`` per-destination buffers -> per-source buffers
    along the named mesh axis (``cfg.memory_axis`` or the route axis)."""
    count("all_to_all")
    nr, nm = cfg.n_route, cfg.n_memory
    rest = tuple(x.shape[2:])
    tail = tuple(range(3, 3 + len(rest)))
    if axis == cfg.memory_axis:
        y = x.reshape((nr, nm, nm) + rest).permute((0, 2, 1) + tail)
    elif axis in cfg.route_axes:
        if len(cfg.route_axes) == 1:
            return route_transpose(x, cfg)
        # [d0, d1, m, i0, i1, ...]: swap the device's and the buffer's
        # position along this axis
        sizes = cfg.route_sizes
        k = cfg.route_axes.index(axis)
        y = x.reshape(sizes + (nm,) + sizes + rest)
        perm = list(range(y.dim()))
        perm[k], perm[3 + k] = perm[3 + k], perm[k]
        y = y.permute(perm)
    else:
        raise ValueError(f"unknown mesh axis {axis!r}")
    return y.reshape(x.shape)


def route_transpose(x: torch.Tensor, cfg) -> torch.Tensor:
    """``[Dev, n_route, ...]`` -> the buffers exchanged over the whole route
    index: ``out[r*nm + m, s] = x[s*nm + m, r]``.  Counts nothing; with two
    route axes it is the composition of the exchanges over each, which act
    on disjoint index pairs and so commute."""
    nr, nm = cfg.n_route, cfg.n_memory
    rest = tuple(x.shape[2:])
    tail = tuple(range(3, 3 + len(rest)))
    y = x.reshape((nr, nm, nr) + rest).permute((2, 1, 0) + tail)
    return y.reshape(x.shape)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ``Dev``, broadcast back to every device.  Callers only sum
    integer-valued planes, which are exact in any order."""
    return x.sum(0, keepdim=True).expand_as(x)


def gather_route(x: torch.Tensor, cfg) -> torch.Tensor:
    """``[Dev, ...]`` -> ``[n_memory, n_route, ...]``: each memory column's
    batch gathered over its route replicas, ``out[m, r] = x[r*nm + m]``.

    The reference all-gathers so that every route replica of a column's pool
    shard applies the same writes; the virtual mesh holds one copy of the
    pool, so it keeps one gathered batch per column and applies it once.
    Like the reference's counter, this counts nothing.  With two route
    axes the reference gathers over ``a1`` then ``a0``, which leaves the
    route index in the same route-major order."""
    rest = tuple(x.shape[1:])
    return x.reshape((cfg.n_route, cfg.n_memory) + rest).transpose(0, 1)


def route_share(x: torch.Tensor, cfg) -> torch.Tensor:
    """``[n_memory, n_route, ...]`` -> ``[Dev, ...]``, the inverse of
    :func:`gather_route`: device ``r*nm + m`` takes its own route row ``r``
    of column ``m``'s response."""
    rest = tuple(x.shape[2:])
    return x.transpose(0, 1).reshape((cfg.n_devices,) + rest)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Maximum over ``Dev``, broadcast back to every device."""
    return x.amax(0, keepdim=True).expand_as(x)
