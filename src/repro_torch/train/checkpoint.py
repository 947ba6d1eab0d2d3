"""Fault-tolerant checkpointing: atomic, keep-K, placement-aware.

The port of ``repro.train.checkpoint``, over trees (dicts, tuples, lists,
NamedTuples) of torch tensors, with the reference's layout on disk, so a
directory written by one package restores in the other::

    <root>/step_00000123/
        manifest.json        # tree paths, dtypes, shapes, extra state
        arrays/<leaf-id>.npy # one file per leaf

Writes go to ``step_XXXXXXXX.tmp`` and are renamed with ``os.replace``, so
a killed writer never leaves a half checkpoint (restore reads only
committed directories); ``keep`` bounds the committed steps.  A bfloat16
leaf is stored as its ``uint16`` bits with ``"dtype": "bfloat16"`` in the
manifest, as the reference stores it, and read back through torch (the
bits viewed as ``int16``, then as ``bfloat16``), so no ``ml_dtypes`` is
needed.  A Python ``int`` leaf (``OptState.step``) is stored as an int32
0-d array, the reference's dtype for it, and restores as an ``int``.

``restore`` places each leaf on the device of the template's leaf, or,
given ``shardings`` (``train/sharding.py`` placements), on the device
each placement names: a checkpoint taken under one mesh description
restores under another (``launch/elastic.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten_with_paths(v, f"{prefix}/{i}"))
        return out
    if hasattr(tree, "_fields"):  # NamedTuple
        out = []
        for name in tree._fields:
            out.extend(_flatten_with_paths(getattr(tree, name), f"{prefix}/{name}"))
        return out
    return [(prefix, tree)]


def _unflatten_like(template: Any, values: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, values, f"{prefix}/{k}") for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(
            *[_unflatten_like(getattr(template, n), values, f"{prefix}/{n}")
              for n in template._fields]
        )
    if isinstance(template, (tuple, list)):
        vals = [_unflatten_like(v, values, f"{prefix}/{i}") for i, v in enumerate(template)]
        return type(template)(vals) if isinstance(template, list) else tuple(vals)
    return values[prefix]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and its logical dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        arr = t.cpu().numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):  # OptState.step
        arr = np.asarray(leaf, dtype=np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"a leaf stored as {arr.dtype} names dtype {dtype}")
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)

    # -- write -----------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[Dict] = None) -> str:
        """Atomic save.  ``state`` is any tree of tensors (and ints);
        ``extra`` is a JSON-serializable dict (e.g. the data pipeline's
        position)."""
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, "arrays"))
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (path, leaf) in enumerate(_flatten_with_paths(state)):
            arr, true_dtype = _to_numpy(leaf)
            fname = f"{i:06d}.npy"
            np.save(os.path.join(tmp, "arrays", fname), arr, allow_pickle=False)
            manifest["leaves"].append(
                {"path": path, "file": fname, "dtype": true_dtype, "shape": list(arr.shape)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):  # re-save of the same step (e.g. final save
            shutil.rmtree(final)  # landing on a ckpt_every boundary)
        os.replace(tmp, final)  # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)

    # -- read ------------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        template: Any,
        *,
        step: Optional[int] = None,
        shardings: Any = None,
    ) -> Tuple[Any, int, Dict]:
        """Restore into ``template``'s structure: ``(state, step, extra)``.
        Each tensor leaf lands on the device of the template's leaf or, with
        ``shardings`` (a tree of placements matching the template), on the
        device its placement names; an ``int`` leaf of the template
        restores as an ``int``.  A leaf whose shape differs from the
        template's raises ``ValueError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        targets = dict(_flatten_with_paths(template))
        where = dict(_flatten_with_paths(shardings)) if shardings is not None else {}
        values = {}
        for leaf in manifest["leaves"]:
            path = leaf["path"]
            arr = np.load(os.path.join(d, "arrays", leaf["file"]), allow_pickle=False)
            t = _from_numpy(arr, leaf["dtype"])
            want = targets[path]
            if not isinstance(want, torch.Tensor):
                values[path] = int(t) if isinstance(want, int) else t
                continue
            if tuple(t.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint leaf {path} is {tuple(t.shape)}, the template's"
                    f" {tuple(want.shape)}"
                )
            device = where[path].device if path in where else want.device
            values[path] = t.to(device)
        return _unflatten_like(template, values), step, manifest["extra"]
