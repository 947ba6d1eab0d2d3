"""Import hygiene of the port: every ``repro_torch`` module and
``chip_smoke.py`` import without JAX and without the reference package, and
an entry point left on its default device raises where there is no CUDA
instead of running on the CPU."""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root / "src"))
sys.path.insert(0, str(root))
pkg = root / "src" / "repro_torch"
mods = sorted(
    "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
    for p in pkg.rglob("*.py")
)
mods = [m.removesuffix(".__init__") for m in mods] + ["chip_smoke"]
assert {
    "repro_torch.core.scan", "repro_torch.core.smo", "repro_torch.core.partition",
    "repro_torch.core.repartition", "repro_torch.core.route_table",
    "repro_torch.core.btree", "repro_torch.models.config",
    "repro_torch.models.layers", "repro_torch.models.model",
    "repro_torch.configs.registry", "repro_torch.configs.minitron_4b",
    "repro_torch.serve.kv_cache", "repro_torch.serve.serve_step",
    "repro_torch.kernels.paged_attention", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.mamba_scan", "repro_torch.configs.falcon_mamba_7b",
    "repro_torch.configs.zamba2_2_7b", "repro_torch.train.optimizer",
    "repro_torch.train.train_step", "repro_torch.data.pipeline",
    "repro_torch.train.fault", "repro_torch.train.checkpoint", "repro_torch.train.sharding",
    "repro_torch.launch.mesh", "repro_torch.launch.train", "repro_torch.launch.elastic",
    "repro_torch.launch.dryrun", "repro_torch.roofline.analysis",
    "repro_torch.roofline.calibrate",
} <= set(mods), mods
for m in mods:
    importlib.import_module(m)
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")
)
assert not bad, bad
import torch
from repro_torch.core import dex, engine, pool, scan, smo
from repro_torch.configs.registry import get_config
from repro_torch.models import model
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.data.pipeline import TokenPipeline, to_device
from repro_torch.launch import mesh as launch_mesh, train as launch_train
small = get_config("minitron-4b").reduced()
ssm = get_config("falcon-mamba-7b").reduced()
if not torch.cuda.is_available():
    for call in (
        lambda: model.init_params(small, seed=0),
        lambda: model.init_params(ssm, seed=0),
        lambda: model.init_decode_cache(ssm, 1, 1),
        lambda: PagedKVCache(cfg=small, n_pages=4, page_size=4, max_batch=1),
        lambda: pool.build_pool([1, 2, 3]),
        lambda: engine.make_dex_engine(None, dex.DexMeshConfig()),
        lambda: scan.make_dex_scan(None, dex.DexMeshConfig()),
        lambda: smo.make_dex_smo(None, dex.DexMeshConfig()),
        lambda: to_device(TokenPipeline(small, 1, 4).next_batch(), small),
        lambda: launch_mesh.make_production_mesh(),
        lambda: launch_train.build_run("minitron-4b", reduce=True),
    ):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("default device ran without CUDA")
print("IMPORTS_OK", len(mods))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT)],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(ROOT),
    )
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    assert "IMPORTS_OK" in res.stdout
