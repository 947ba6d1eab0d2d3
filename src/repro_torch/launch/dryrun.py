"""Dry-run: count every (arch x shape x mesh) cell's step and what one
chip would hold, without a card and without allocating.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 256 or 512 placeholder TPU devices and reads XLA's memory and
cost analyses.  The port runs eager on one card and has no partitioner, so
a cell here is one step on the ``meta`` device (tensors with shapes and
dtypes and no memory), run once under ``roofline/calibrate.py``'s counter:

* argument bytes a chip: each leaf's shard under its
  ``train/sharding.py`` spec on the described mesh (``launch/mesh.py``):
  parameters, AdamW moments, the batch or the decode cache.  Exact: the
  port's ``argument_size_in_bytes``;
* temp bytes a chip: the counted step's peak over one data shard's batch
  (one microbatch of it at a time), with the model whole, not split over
  the ``model`` axis: an upper bound, which tensor parallelism only
  shrinks.  For ``train_4k`` on 16x16 that is 2 x 4,096 tokens a
  microbatch, the shape the card trains;
* flops and bytes a chip: the counted step of one data shard, over the
  ``model`` axis's size;
* the collective term: null, "no partitioner on one card".

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell writes one JSON file, ``<arch>__<shape>__<mesh>.json``, to
``--out`` (default ``dryrun_results_torch/``).  Nothing here needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as LY
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, SHAPES, ShapeCell, cell_applicable, shape_by_name
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.calibrate import StepCounter
from repro_torch.train import sharding as SH
from repro_torch.train.optimizer import OptConfig, init_opt_state, leaves
from repro_torch.train.train_step import make_train_step

META = torch.device("meta")

# microbatch split for the train cell (activation-memory fit); 8 keeps
# 1-2 sequences per chip per microbatch at global_batch=256
DEFAULT_MICROBATCHES = 8


class InputSpec(NamedTuple):
    """A model input of a cell: a meta tensor of its global shape and
    dtype, and its placement (spec) on the described mesh."""

    value: torch.Tensor
    sharding: SH.Placement


def _data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def input_specs(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """``InputSpec`` of every model input of this cell, the reference's
    shapes and dtypes (``tokens`` / ``labels`` [B, S] int32, ``enc_emb``;
    for decode one token, the dense cache of length ``seq_len`` and
    ``pos``)."""
    b, s = cell.global_batch, cell.seq_len
    bs = SH.batch_shardings(mesh, encdec=cfg.encdec)
    if cell.kind in ("train", "prefill"):
        specs = {
            "tokens": InputSpec(torch.empty((b, s), dtype=torch.int32, device=META), bs["tokens"]),
            "labels": InputSpec(torch.empty((b, s), dtype=torch.int32, device=META), bs["labels"]),
        }
        if cfg.encdec:
            specs["enc_emb"] = InputSpec(
                torch.empty((b, cfg.max_source_positions, cfg.d_model),
                            dtype=LY.torch_dtype(cfg), device=META),
                bs["enc_emb"],
            )
        return specs
    # decode: one token, dense sharded cache of length seq_len
    data = _data_axes(mesh)
    n_data = int(np.prod([mesh.shape[a] for a in data]))
    # one data axis by its name, two as a tuple, as PartitionSpec holds them
    batch_ax = SH._data_axes(mesh) if b % n_data == 0 else None  # long_500k: global_batch=1
    cache = M.init_decode_cache(cfg, b, s, device=META, enc_len=cfg.max_source_positions)
    cache_sh = SH.cache_shardings(cfg, mesh, batch=b)
    return {
        "tokens": InputSpec(torch.empty((b, 1), dtype=torch.int32, device=META),
                            SH.Placement(mesh, (batch_ax, None))),
        "cache": {k: InputSpec(v, cache_sh[k]) for k, v in cache.items()},
        "pos": InputSpec(torch.empty((), dtype=torch.int32, device=META), SH.Placement(mesh, ())),
    }


def _spec_leaves(specs):
    for v in specs.values():
        if isinstance(v, dict):
            yield from _spec_leaves(v)
        else:
            yield v


def argument_bytes(cfg: ArchConfig, cell: ShapeCell, mesh, params=None) -> int:
    """Bytes a chip of the described mesh holds of the step's arguments:
    each leaf's shard under its spec (parameters, for train also the AdamW
    moments, and the cell's inputs)."""
    params = M.init_params(cfg, 0, device=META) if params is None else params
    p_sh = SH.param_shardings(params, mesh, cfg)
    total = sum(s.shard_bytes(p) for p, s in zip(leaves(params), leaves(p_sh)))
    if cell.kind == "train":
        opt = init_opt_state(params, OptConfig())
        for moments in (opt.mu, opt.nu):
            m_sh = SH.param_shardings(moments, mesh, cfg)
            total += sum(s.shard_bytes(m) for m, s in zip(leaves(moments), leaves(m_sh)))
    specs = input_specs(cfg, cell, mesh)
    if cell.kind == "prefill":  # the prefill step takes no labels
        specs.pop("labels")
    total += sum(sp.sharding.shard_bytes(sp.value) for sp in _spec_leaves(specs))
    return total


@dataclasses.dataclass
class LoweredCell:
    """One cell's counted step: the counter, the argument bytes a chip, the
    batch one data shard ran and its microbatches, the seconds the count
    took."""

    counter: StepCounter
    argument_bytes: int
    batch: int
    microbatches: int
    seconds: float

    @property
    def temp_bytes(self) -> int:
        return self.counter.peak


def _shard_batch(cell: ShapeCell, mesh) -> int:
    """The batch of one data shard: the global batch over the data axes
    where they divide it, else whole (``long_500k``, one request)."""
    n_data = int(np.prod([mesh.shape[a] for a in _data_axes(mesh)]))
    return cell.global_batch // n_data if cell.global_batch % n_data == 0 else cell.global_batch


def lower_cell(cfg: ArchConfig, cell: ShapeCell, mesh, mesh_name: str,
               microbatches: Optional[int] = None) -> LoweredCell:
    """Count one cell's step on the meta device: parameters, optimizer
    state and the inputs of one data shard on ``meta``, then one step under
    a ``StepCounter``: ``make_train_step(microbatches=)`` (default
    ``DEFAULT_MICROBATCHES``), the prefill step (the last token's logits
    and their argmax) or the decode step.  Nothing is allocated."""
    t0 = time.perf_counter()
    LY.set_tp_context(mesh, _data_axes(mesh))
    params = M.init_params(cfg, 0, device=META)
    arg_bytes = argument_bytes(cfg, cell, mesh, params)
    b, s = _shard_batch(cell, mesh), cell.seq_len
    dt = LY.torch_dtype(cfg)
    enc = (torch.empty((b, cfg.max_source_positions, cfg.d_model), dtype=dt, device=META)
           if cfg.encdec else None)
    mb = 1
    counter = StepCounter()
    if cell.kind == "train":
        opt_cfg = OptConfig()
        opt_state = init_opt_state(params, opt_cfg)
        mb = DEFAULT_MICROBATCHES if microbatches is None else microbatches
        batch: Dict[str, Any] = {
            "tokens": torch.empty((b, s), dtype=torch.int32, device=META),
            "labels": torch.empty((b, s), dtype=torch.int32, device=META),
        }
        if enc is not None:
            batch["enc_emb"] = enc
        step = make_train_step(cfg, opt_cfg, microbatches=mb)
        with counter:
            step(params, opt_state, batch)
    elif cell.kind == "prefill":
        tokens = torch.empty((b, s), dtype=torch.int32, device=META)
        with counter, torch.no_grad():
            hidden, _ = M.forward(cfg, params, tokens, enc_emb=enc, return_hidden=True)
            # serving needs only the last token's logits, not [B, S, V]
            logits = M._logits(hidden[:, -1], M._head_of(cfg, params))
            logits.argmax(-1)
    else:  # decode
        cache = M.init_decode_cache(cfg, b, s, device=META, enc_len=cfg.max_source_positions)
        tokens = torch.empty((b, 1), dtype=torch.int32, device=META)
        with counter, torch.no_grad():
            logits, cache = M.decode_step(cfg, params, tokens, cache, s - 1)
            logits.argmax(-1)
    return LoweredCell(counter=counter, argument_bytes=arg_bytes, batch=b, microbatches=mb,
                       seconds=time.perf_counter() - t0)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir=None,
             verbose=True, calibrate: bool = False) -> dict:
    cfg = get_config(arch)
    cell = shape_by_name(shape_name)
    ok, why = cell_applicable(cfg, cell)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        result["status"] = "skipped"
        result["reason"] = why
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {why}")
        _write(result, out_dir)
        return result
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device=META)
    chips = int(np.prod(mesh.sizes))
    n_model = mesh.shape["model"]
    try:
        lowered = lower_cell(cfg, cell, mesh, mesh_kind)
    except Exception as e:  # a failure here is a bug in the port
        result["status"] = "FAILED"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAILED {e}")
        _write(result, out_dir)
        return result
    tot = lowered.counter.totals()
    terms = RA.build_terms(
        arch=arch, shape_cell=cell, mesh_name=mesh_kind, chips=chips,
        counts={"flops": tot["flops"] / n_model, "bytes": tot["bytes"] / n_model},
        argument_bytes=lowered.argument_bytes, temp_bytes=lowered.temp_bytes, cfg=cfg,
    )
    result.update(terms.to_dict())
    result.update(
        status="ok",
        compile_seconds=lowered.seconds,
        collective_note=RA.COLLECTIVE_NOTE,
        argument_bytes_per_chip=lowered.argument_bytes,
        temp_bytes_per_chip=lowered.temp_bytes,
        shard_batch=lowered.batch,
        microbatches=lowered.microbatches,
        counted=tot,
        kernels=lowered.counter.kernels,
    )

    if calibrate:
        # one microbatch of the shard's batch: the same arithmetic without
        # the accumulation (roofline/calibrate.py)
        from repro_torch.roofline import calibrate as CAL

        def lower_probe(pcfg, pcell, pmesh, pmesh_name):
            return lower_cell(pcfg, pcell, pmesh, pmesh_name, microbatches=1)

        cal = CAL.calibrated_terms(cfg, cell, mesh, mesh_kind, lower_probe)
        ct = cal["flops"] / RA.PEAK_FLOPS
        mt = cal["bytes"] / RA.HBM_BW
        result["cal_flops_per_chip"] = cal["flops"]
        result["cal_bytes_per_chip"] = cal["bytes"]
        result["cal_collective_per_chip"] = None
        result["cal_compute_term_s"] = ct
        result["cal_memory_term_s"] = mt
        result["cal_collective_term_s"] = None
        result["cal_dominant"] = "compute" if ct >= mt else "memory"
        bound = max(ct, mt)
        result["cal_useful_ratio"] = terms.model_flops / max(cal["flops"] * chips, 1.0)
        result["cal_roofline_fraction"] = (
            terms.model_flops / (chips * RA.PEAK_FLOPS * bound) if bound > 0 else float("nan")
        )
        if verbose:
            print(
                f"  calibrated: compute={ct:.3e}s memory={mt:.3e}s "
                f"dominant={result['cal_dominant']} "
                f"useful={result['cal_useful_ratio']:.2f} "
                f"roofline={result['cal_roofline_fraction']:.3f}"
            )

    if verbose:
        gb = terms.per_device_memory_bytes / 2**30
        print(
            f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
            f"({lowered.seconds:.1f}s counted) mem/chip={gb:.2f}GiB "
            f"(args {lowered.argument_bytes / 2**30:.2f}, temp {lowered.temp_bytes / 2**30:.2f}) "
            f"flops/chip={terms.hlo_flops_per_chip:.3e} "
            f"bytes/chip={terms.hlo_bytes_per_chip:.3e} "
            f"collective: {RA.COLLECTIVE_NOTE} dominant={terms.dominant}"
        )
    _write(result, out_dir)
    return result


def _write(result: dict, out_dir) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES], default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default="dryrun_results_torch")
    ap.add_argument("--calibrate", action="store_true",
                    help="add the terms of one microbatch (one more counted step a cell)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = sorted(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = (
        [s.name for s in SHAPES]
        if args.all or args.shape is None
        else [args.shape]
    )

    t0 = time.perf_counter()
    failures = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mesh_kind, out_dir=args.out,
                             calibrate=args.calibrate)
                if r["status"] == "FAILED":
                    failures.append(r)
    if failures:
        print(f"\n{len(failures)} cell(s) FAILED:")
        for f in failures:
            print(f"  {f['arch']} x {f['shape']} x {f['mesh']}: {f['error']}")
        sys.exit(1)
    print(f"\nall requested dry-run cells passed ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
