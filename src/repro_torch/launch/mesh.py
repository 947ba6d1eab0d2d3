"""Mesh descriptions for the training launcher.

The port of ``repro.launch.mesh``.  The reference builds a JAX device mesh
of TPU chips; the port runs one card, so a mesh here is a description:
its axis names, their sizes, and the one device that the virtual mesh
runs on.  ``train/sharding.py`` reads the names and sizes to give each
leaf the reference's partition spec, and every leaf lives whole on the
device.  The specs are kept so that the bytes each chip of the described
mesh would hold can be reckoned from them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.mesh import resolve_device


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
