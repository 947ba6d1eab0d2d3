"""Meshes for the launchers: named mesh descriptions, and the ranks of a
``torch.distributed`` group that run the index mesh across processes.

The port of ``repro.launch.mesh``.  The reference builds a JAX device mesh
of TPU chips.  Here a :class:`MeshSpec` is a description: its axis names,
their sizes, and the one device that the virtual mesh runs on.
``train/sharding.py`` reads the names and sizes to give each leaf the
reference's partition spec, and every leaf of a training run lives whole
on the device; the specs are kept so that the bytes each chip of the
described mesh would hold can be reckoned from them.

The index mesh also runs over ranks: :func:`spawn_ranks` starts a world of
processes, one rank each, joined in one process group, and hands each rank
a ``core/mesh.py::RankMesh``, active while it runs.  Each rank then holds
its block of the mesh's virtual devices and its share of the ``DexState``
(``core/dex.py::shard_state``).  The backend is the caller's: ``"nccl"``
runs one rank a card; ``"gloo"`` runs CPU tensors, or CUDA tensors staged
through pinned host memory where ranks share a card.  Nothing picks
another backend or device on its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import pathlib
import pickle
import traceback
from typing import Dict, Tuple

import torch

from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import BACKENDS, RankMesh, resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named mesh shape over one device: ``shape`` maps each axis name
    to its size, in the order of ``axis_names``, as a JAX mesh's does."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes, default=1) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and sizes {self.sizes} do not match")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape, axes, device=None) -> MeshSpec:
    """A mesh of ``shape`` named ``axes`` on ``device`` (``None`` means
    CUDA)."""
    return MeshSpec(tuple(axes), tuple(int(s) for s in shape), resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> MeshSpec:
    """16x16 (256 chips, one pod slice) or 2x16x16 (2 pods, 512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device=None) -> MeshSpec:
    """Small mesh for local testing (8 devices in the reference)."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def _rank_main(rank, fn, world, backend, init, box):
    """One rank: join the group through the file store under ``init``, take
    its card, run ``fn(rank_mesh, *args)`` on the active rank mesh and save
    what it returns (or its traceback) for :func:`spawn_ranks`.  ``args``
    comes in the one-element list ``box``, so that the rank drops its last
    reference to them when ``fn`` returns: the parent's tensors shared
    through CUDA IPC are then released before the rank exits, and the
    parent can free them."""
    import gc

    import torch.distributed as dist

    args = box.pop()
    out = pathlib.Path(init) / f"rank{rank}.pkl"
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend,
            init_method="file://" + str(pathlib.Path(init) / "store"),
            world_size=world,
            rank=rank,
            timeout=datetime.timedelta(seconds=600),
        )
        try:
            rm = RankMesh(group=None, world=world, rank=rank, backend=backend)
            with core_mesh.use(rm):
                result = fn(rm, *args)
            del args
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                dist.barrier(device_ids=[torch.cuda.current_device()]
                             if backend == "nccl" else None)
            else:
                dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


class RankError(RuntimeError):
    """A rank of :func:`spawn_ranks` failed; the message holds its
    traceback."""


def spawn_ranks(fn, world: int, backend: str, *args, init):
    """Run ``fn(rank_mesh, *args)`` on ``world`` ranks of one process group
    over ``backend``, each in a process of its own; returns the list of
    what each rank returned, in rank order.

    ``init`` is a directory of the caller's: the ranks meet through a
    ``file://`` store in it, so no port is fixed, and leave their results
    there.  Where CUDA is available rank ``p`` takes card ``p %
device_count`` (one rank a card when there are enough); the
    kernel library is built here, before the ranks start, so they only
    load it.  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function; tensors in ``args`` go to the ranks through shared memory,
    CUDA ones through CUDA IPC).  The rest of ``args`` is written down each
    rank's start-up pipe while the rank imports, so pass large arrays as
    tensors, or the ranks start one after another.  The call joins every rank; if any
    fails, the others are stopped and this raises :class:`RankError` with
    the failing rank's traceback."""
    import torch.multiprocessing as tmp

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; options: {BACKENDS}")
    if world < 1:
        raise ValueError(f"a world needs at least one rank, got {world}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA, and CUDA is not available")
    init = pathlib.Path(init)
    init.mkdir(parents=True, exist_ok=True)
    for f in init.glob("rank*.pkl"):
        f.unlink()
    store = init / "store"
    if store.exists():
        store.unlink()
    if torch.cuda.is_available():
        from repro_torch.kernels import ops

        ops.build()
    try:
        tmp.spawn(
            _rank_main, args=(fn, world, backend, str(init), [args]), nprocs=world,
            join=True,
        )
    except Exception as exc:
        failed = []
        for p in range(world):
            f = init / f"rank{p}.pkl"
            if f.exists():
                with open(f, "rb") as fh:
                    status, payload = pickle.load(fh)
                if status == "error":
                    failed.append(f"rank {p}:\n{payload}")
        raise RankError(
            "\n".join(failed) if failed else f"a rank failed: {exc}"
        ) from exc
    if torch.cuda.is_available():
        torch.cuda.ipc_collect()  # the blocks the ranks have released
    results = []
    for p in range(world):
        with open(init / f"rank{p}.pkl", "rb") as fh:
            results.append(pickle.load(fh)[1])
    return results
