"""Parameter, batch and cache partition specs: the reference's GSPMD rules.

The port of ``repro.train.sharding``.  The rules are the reference's,
rule for rule:

  * TP over the ``model`` axis: attention heads / ffn width / experts /
    vocab dims.
  * ZeRO-3/FSDP over the ``data`` axes (and ``pod`` when present): the other
    large dim of every stacked weight.
  * Norm scales and other small vectors are replicated.

A spec is a plain tuple with one entry a dim: an axis name, a tuple of
axis names, or ``None`` (replicated), the entries of the reference's
``PartitionSpec``.  A ``Placement`` pairs a spec with a mesh
(``launch/mesh.py``): the port runs one card, so it places a leaf whole
on the mesh's device, and the spec says how the described mesh would
split it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's spec on ``mesh``: the tensor lives whole on the mesh's
    device."""

    mesh: MeshSpec
    spec: Tuple

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def place(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """One shard's shape of a leaf of ``shape`` on the described mesh,
        as ``NamedSharding.shard_shape`` gives it: each dim over the product
        of its axes' sizes, which must divide it (``ValueError``)."""
        out = []
        for dim, axes in zip(shape, tuple(self.spec) + (None,) * (len(shape) - len(self.spec))):
            n = 1 if axes is None else _axis_size(self.mesh, axes)
            if dim % n:
                raise ValueError(f"spec {self.spec} splits dim {dim} of {tuple(shape)} {n} ways")
            out.append(dim // n)
        return tuple(out)

    def shard_bytes(self, t) -> int:
        """Bytes of one shard of the tensor ``t`` on the described mesh."""
        n = 1
        for dim in self.shard_shape(tuple(t.shape)):
            n *= dim
        return n * t.element_size()


def _data_axes(mesh: MeshSpec):
    """The data axes: one axis by its name, two as a tuple (the entry
    ``PartitionSpec`` makes of them)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes[0] if len(axes) == 1 else axes


def _axis_size(mesh: MeshSpec, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def spec_for_param(path: str, shape: Tuple[int, ...], mesh: MeshSpec, cfg: ArchConfig) -> Tuple:
    """Partition spec of one parameter leaf."""
    data = _data_axes(mesh)
    n_data = _axis_size(mesh, data)
    n_model = mesh.shape["model"]

    is_stacked = len(shape) >= 2 and shape[0] in (cfg.n_layers, cfg.enc_layers)
    dims = list(shape)
    start = 1 if is_stacked else 0
    spec = [None] * len(shape)

    # name-specific orientation: "row parallel" weights put model on dim -2
    row_parallel = any(s in path for s in ("wo", "out_proj", "dt_proj"))
    # embedding: shard d_model (a vocab-sharded table makes every token
    # gather an all-gather of the whole table).  head: vocab col-parallel.
    if path.endswith("embed") or path.endswith("lm_head"):
        return (None, "model") if shape[1] % n_model == 0 else (None, None)
    if "router" in path:
        return (None,) * len(shape)
    if "moe" in path and len(shape) == 4:
        # [L, E, d_in, d_out].  Many experts: shard the expert axis (EP).
        # Few wide experts (E not a multiple of the model axis): TP inside
        # the expert FFN instead, col-parallel wi, row-parallel wo.
        s = [None, None, None, None]
        if shape[1] % n_model == 0:
            s[1] = "model"
            if n_data > 1 and shape[2] % n_data == 0:
                s[2] = data
        elif row_parallel:  # wo: [L, E, ffe, d]
            if shape[2] % n_model == 0:
                s[2] = "model"
            if n_data > 1 and shape[3] % n_data == 0:
                s[3] = data
        else:  # wi: [L, E, d, ffx]
            if shape[3] % n_model == 0:
                s[3] = "model"
            if n_data > 1 and shape[2] % n_data == 0:
                s[2] = data
        return tuple(s)

    big = [i for i in range(start, len(shape)) if dims[i] > 1]
    if len(big) >= 2:
        a, b = big[-2], big[-1]
        model_dim, data_dim = (a, b) if row_parallel else (b, a)
        if dims[model_dim] % n_model == 0:
            spec[model_dim] = "model"
        if n_data > 1 and dims[data_dim] % n_data == 0:
            spec[data_dim] = data
    elif len(big) == 1 and dims[big[0]] % n_model == 0 and dims[big[0]] >= 1024:
        spec[big[0]] = "model"
    return tuple(spec)


def param_shardings(params_shape: Any, mesh: MeshSpec, cfg: ArchConfig):
    """Placements for a parameter tree (of tensors, or of anything with a
    ``shape``)."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        return Placement(mesh, spec_for_param(prefix, tuple(tree.shape), mesh, cfg))

    return walk(params_shape, "")


def batch_shardings(mesh: MeshSpec, *, encdec: bool = False) -> Dict[str, Placement]:
    data = _data_axes(mesh)
    b = {"tokens": Placement(mesh, (data, None)), "labels": Placement(mesh, (data, None))}
    if encdec:
        b["enc_emb"] = Placement(mesh, (data, None, "model"))
    return b


def cache_shardings(
    cfg: ArchConfig, mesh: MeshSpec, *, batch: Optional[int] = None
) -> Dict[str, Placement]:
    """Decode-cache specs: batch over data; heads (or state) over model;
    S always unsharded (decode appends along S at a runtime position).
    ``batch`` not a multiple of the data axes' size (``batch=1``,
    long-context single-request decode) drops the data axis from the batch
    dim."""
    data = _data_axes(mesh)
    n_model = mesh.shape["model"]
    n_data = _axis_size(mesh, data)
    if batch is not None and batch % n_data != 0:
        data = None
    out: Dict[str, Placement] = {}

    def ns(*spec):
        return Placement(mesh, spec)

    if cfg.ssm or cfg.hybrid_attn_every:
        out["ssm"] = ns(None, data, "model", None)
        out["conv"] = ns(None, data, None, "model")
        if cfg.hybrid_attn_every:
            # [G, B, S, HKV, Dh]
            if cfg.n_kv_heads % n_model == 0:
                out["shared_k"] = ns(None, data, None, "model", None)
            else:
                out["shared_k"] = ns(None, data, "model", None, None)
            out["shared_v"] = out["shared_k"]
        return out
    if cfg.attention == "mla":
        # [L, B, S, kvlr] / [L, B, S, ropeD]: shard the feature dim
        out["c_kv"] = ns(None, data, None, "model" if cfg.kv_lora_rank % n_model == 0 else None)
        out["k_rope"] = ns(None, data, None, "model" if cfg.qk_rope_dim % n_model == 0 else None)
        return out
    # [L, B, S, HKV, Dh]: shard kv heads when divisible, else head_dim
    if cfg.n_kv_heads % n_model == 0:
        kv = ns(None, data, None, "model", None)
    elif cfg.head_dim % n_model == 0:
        kv = ns(None, data, None, None, "model")
    else:
        kv = ns(None, data, None, None, None)
    out["k"] = kv
    out["v"] = kv
    if cfg.encdec:
        out["xk"] = kv
        out["xv"] = kv
    return out
