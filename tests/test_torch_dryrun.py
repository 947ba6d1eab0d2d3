"""The port's dry-run and roofline plane (``launch/dryrun.py``,
``roofline/{analysis,calibrate}.py``, the meta branch of
``kernels/ops.py``, ``models/layers.py::set_tp_context`` and
``core/dex.py::state_shardings``) against the reference's on the CPU.

* Bit for bit with the reference, all ten configs and the four ``SHAPES``:
  ``collective_bytes`` on the same HLO text (every collective opcode, their
  ``-start`` forms, tuple results, other ops), ``model_flops_for``,
  ``analytic_inner_flops`` and ``cell_applicable``'s verdicts.
* ``input_specs``' shapes, dtypes and specs at 16x16 and 2x16x16 equal the
  reference's ``ShapeDtypeStruct``s; argument bytes a chip equal the sum of
  the reference's ``NamedSharding(AbstractMesh, spec).shard_shape`` over
  the same leaves (parameters, moments, inputs); ``state_shardings``
  equals the reference's specs at 2x4 and 2x2x2.  Everything reads an
  ``AbstractMesh`` or runs on ``meta``: no 512-device mesh is built and
  nothing is compiled.
* The counter (``StepCounter``) on a reduced minitron-4b and falcon-mamba-7b
  train step on the meta device equals the same counter on CPU tensors
  (plain kernels): flops, bytes, peak and each kernel's calls and work;
  its matrix-product flops equal a hand count over the weight products, and
  its kernel flops ``roofline/analysis.py``'s formulas.
* One full-width cell, falcon-mamba-7b x train_4k x single, runs on meta;
  the skipped cells carry the reference's reason.

``src/repro/launch/dryrun.py`` sets ``XLA_FLAGS`` when it is imported, so
it is imported with ``os.environ`` saved and restored.
"""

import functools
import importlib
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.core import dex as RD  # noqa: E402
from repro.models import config as RCFG  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402
from repro.roofline import calibrate as RCAL  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import sharding as RS  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.core import dex as TD  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import config as TCFG  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.roofline import analysis as TA  # noqa: E402
from repro_torch.roofline import calibrate as TCAL  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
META = torch.device("meta")


@functools.lru_cache(maxsize=None)
def ref_dryrun():
    """``repro.launch.dryrun`` imported with the environment restored (it
    sets ``XLA_FLAGS`` for 512 host devices at import)."""
    saved = dict(os.environ)
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        os.environ.clear()
        os.environ.update(saved)


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), TMESH.make_mesh(shape, axes, "cpu")


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    return jax.eval_shape(lambda: RM.init_params(ref_config(arch), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def meta_params(arch):
    return TM.init_params(get_config(arch), 0, device=META)


def ref_cell(cell):
    return RCFG.shape_by_name(cell.name)


# ---------------------------------------------------------------------------
# roofline/analysis.py and calibrate.py: bit for bit
# ---------------------------------------------------------------------------


HLO = """\
HloModule step, entry_computation_layout={(bf16[8,4096]{1,0})->f32[]}
%add (a: f32[], b: f32[]) -> f32[] {
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}
ENTRY %main (p: bf16[8,4096]) -> f32[] {
  %p = bf16[8,4096]{1,0} parameter(0)
  %ag = bf16[128,4096]{1,0} all-gather(bf16[8,4096]{1,0} %p), replica_groups={{0,1}}, dimensions={0}
  %ags = (bf16[8,4096]{1,0}, bf16[128,4096]{1,0}) all-gather-start(bf16[8,4096]{1,0} %p)
  %agd = bf16[128,4096]{1,0} all-gather-done((bf16[8,4096]{1,0}, bf16[128,4096]{1,0}) %ags)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), to_apply=%add
  %ars = (f32[8]{0}, f32[8]{0}) all-reduce-start(f32[8]{0} %a, f32[8]{0} %b), to_apply=%add
  %rs = bf16[2,3]{1,0} reduce-scatter(bf16[32,3]{1,0} %y), dimensions={0}, to_apply=%add
  %a2a = (s32[4,2]{1,0}, s32[4,2]{1,0}) all-to-all(s32[4,2]{1,0} %c, s32[4,2]{1,0} %d)
  %cp = u8[128]{0} collective-permute(u8[128]{0} %z), source_target_pairs={{0,1},{1,0}}
  %cps = (f32[4]{0}, f32[4]{0}, u32[], u32[]) collective-permute-start(f32[4]{0} %w)
  %pr = pred[16]{0} all-reduce(pred[16]{0} %q), to_apply=%or
  %c64 = c64[3,3]{1,0} all-to-all(c64[3,3]{1,0} %cc), dimensions={0}
  %sc = f32[] all-reduce(f32[] %s0), to_apply=%add
  %dot = f32[8,8]{1,0} dot(f32[8,4096]{1,0} %l, f32[4096,8]{1,0} %r), lhs_contracting_dims={1}
  %fus = f64[2,2]{1,0} fusion(f64[2,2]{1,0} %m), kind=kLoop, calls=%fused
  ROOT %t = (f32[], pred[]) tuple(f32[] %sc, pred[] %pp)
}
"""


def random_hlo(seed, lines=400):
    """Seeded lines of collectives and other ops, results of one to three
    shapes of every dtype the table knows (and one it does not)."""
    rng = np.random.default_rng(seed)
    ops_ = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
            "add", "dot", "fusion", "copy", "all-gather-done", "send", "recv"]
    dts = ["pred", "s8", "u8", "s16", "u16", "bf16", "f16", "s32", "u32", "f32", "s64", "u64",
           "f64", "c64", "c128", "f8e4m3fn"]
    out = []
    for i in range(lines):
        op = ops_[rng.integers(len(ops_))]
        if op in ops_[:5] and rng.random() < 0.3:
            op += "-start"
        shapes = []
        for _ in range(int(rng.integers(1, 4))):
            dims = ",".join(str(int(d)) for d in rng.integers(1, 64, rng.integers(0, 4)))
            shapes.append(f"{dts[rng.integers(len(dts))]}[{dims}]{{0}}")
        res = shapes[0] if len(shapes) == 1 else "(" + ", ".join(shapes) + ")"
        out.append(f"  %v{i} = {res} {op}(f32[4]{{0}} %a{i}), replica_groups={{}}")
        if rng.random() < 0.1:
            out.append("  // a comment without an assignment")
    return "\n".join(out)


@pytest.mark.parametrize("text", ["fixed", "seed0", "seed1"])
def test_collective_bytes_match_reference(text):
    hlo = HLO if text == "fixed" else random_hlo(int(text[-1]))
    got = TA.collective_bytes(hlo)
    assert got == RA.collective_bytes(hlo)
    assert all(v > 0 for v in got.values()), got
    if text == "fixed":
        # all-gather 128x4096 bf16 twice (the -start form's tuple counts both
        # of its shapes: 8x4096 and 128x4096), ...
        assert got["all-gather"] == 2 * 128 * 4096 * 2 + 8 * 4096 * 2
        assert got["collective-permute"] == 128 + 4 * 4 + 4 * 4 + 4 + 4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_applicability_match_reference(arch):
    tc, rc = get_config(arch), ref_config(arch)
    for cell in TCFG.SHAPES:
        rcell = ref_cell(cell)
        assert TA.model_flops_for(tc, cell) == RA.model_flops_for(rc, rcell)
        assert TCAL.analytic_inner_flops(tc, cell) == RCAL.analytic_inner_flops(rc, rcell)
        assert TCFG.cell_applicable(tc, cell) == RCFG.cell_applicable(rc, rcell)
    assert [c.name for c in TCFG.SHAPES] == [c.name for c in RCFG.SHAPES]


def test_terms_keep_the_reference_keys_with_a_null_collective_term():
    cfg, cell = get_config("minitron-4b"), TCFG.shape_by_name("train_4k")
    terms = TA.build_terms(arch="minitron-4b", shape_cell=cell, mesh_name="single", chips=256,
                           counts={"flops": 2e15, "bytes": 1e12}, argument_bytes=3,
                           temp_bytes=4, cfg=cfg)
    ref = RA.RooflineTerms("a", "b", "c", 1, 1.0, 1.0, 1.0, {}, 1.0, 1.0)
    d = terms.to_dict()
    assert set(d) == set(ref.to_dict())
    assert d["collective_term_s"] is None and d["collective_bytes_per_chip"] is None
    assert d["compute_term_s"] == 2e15 / 989e12 and d["memory_term_s"] == 1e12 / 3.35e12
    assert d["dominant"] == "compute" and d["per_device_memory_bytes"] == 7
    assert d["roofline_fraction"] == d["model_flops"] / (256 * 989e12 * (2e15 / 989e12))


# ---------------------------------------------------------------------------
# launch/dryrun.py: specs and bytes a chip against the reference
# ---------------------------------------------------------------------------


def spec_leaves(specs, prefix=""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from spec_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def torch_dtype_name(dt):
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_input_specs_match_reference(mesh_name):
    rmesh, tmesh = meshes(mesh_name)
    n = 0
    for arch in sorted(ARCHS):
        tc, rc = get_config(arch), ref_config(arch)
        for cell in TCFG.SHAPES:
            want = dict(spec_leaves(ref_dryrun().input_specs(rc, ref_cell(cell), rmesh)))
            got = dict(spec_leaves(dryrun.input_specs(tc, cell, tmesh)))
            assert set(got) == set(want), (arch, cell.name)
            for k, w in want.items():
                g = got[k]
                assert g.value.device == META
                assert tuple(g.value.shape) == tuple(w.shape), (arch, cell.name, k)
                assert torch_dtype_name(g.value.dtype) == np.dtype(w.dtype).name, (arch, k)
                assert g.sharding.spec == tuple(w.sharding.spec), (arch, cell.name, k)
                n += 1
    assert n > 100


def ref_argument_bytes(arch, cell, rmesh):
    """The reference's per-chip bytes of the step's arguments: each leaf's
    ``NamedSharding(AbstractMesh, spec).shard_shape`` (parameters, AdamW
    moments for train, the inputs the step takes)."""
    rc = ref_config(arch)
    shapes = ref_param_shapes(arch)

    def total(tree, shardings):
        leaves = jax.tree.leaves(tree)
        shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(shs)
        return sum(math.prod(sh.shard_shape(t.shape)) * np.dtype(t.dtype).itemsize
                   for t, sh in zip(leaves, shs))

    out = total(shapes, RS.param_shardings(shapes, rmesh, rc))
    if cell.kind == "train":
        opt = jax.eval_shape(lambda: RO.init_opt_state(shapes, RO.OptConfig()))
        for m in (opt.mu, opt.nu):
            out += total(m, RS.param_shardings(m, rmesh, rc))
    specs = ref_dryrun().input_specs(rc, ref_cell(cell), rmesh)
    if cell.kind == "prefill":
        specs.pop("labels")
    for _, sds in spec_leaves(specs):
        out += math.prod(sds.sharding.shard_shape(sds.shape)) * np.dtype(sds.dtype).itemsize
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_argument_bytes_match_reference_shard_shapes(mesh_name):
    rmesh, tmesh = meshes(mesh_name)
    for arch in sorted(ARCHS):
        for cell in TCFG.SHAPES:
            if not TCFG.cell_applicable(get_config(arch), cell)[0]:
                continue
            got = dryrun.argument_bytes(get_config(arch), cell, tmesh, meta_params(arch))
            assert got == ref_argument_bytes(arch, cell, rmesh), (arch, cell.name)


def test_shard_shape_refuses_an_uneven_split_as_the_reference_does():
    rmesh, tmesh = meshes("16x16")
    from jax.sharding import PartitionSpec as P

    with pytest.raises(ValueError):
        NamedSharding(rmesh, P("data")).shard_shape((10, 3))
    with pytest.raises(ValueError, match="splits dim 10"):
        dryrun.SH.Placement(tmesh, ("data",)).shard_shape((10, 3))
    assert dryrun.SH.Placement(tmesh, (("data",), "model")).shard_shape((256, 4096)) == (16, 256)


@pytest.mark.parametrize("name", ["2x4", "2x2x2"])
def test_state_shardings_match_reference(name):
    if name == "2x4":
        rcfg = RD.DexMeshConfig(n_route=2, n_memory=4)
        tcfg = TD.DexMeshConfig(n_route=2, n_memory=4)
        shape, axes = (2, 4), ("data", "model")
    else:
        rcfg = RD.DexMeshConfig(route_axes=("data", "pod"), n_route=4, n_memory=2)
        tcfg = TD.DexMeshConfig(route_axes=("data", "pod"), route_shape=(2, 2), n_route=4,
                                n_memory=2)
        shape, axes = (2, 2, 2), ("data", "pod", "model")
    want = RD.state_shardings(AbstractMesh(shape, axes), rcfg)
    tmesh = TMESH.make_mesh(shape, axes, "cpu")
    got = TD.state_shardings(tmesh, tcfg)
    assert got._fields == want._fields
    n = 0
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        pairs = zip(w, g) if isinstance(w, tuple) else [(w, g)]
        for ws, gs in pairs:
            assert gs.spec == tuple(ws.spec), (field, gs.spec, ws.spec)
            assert gs.mesh is tmesh
            n += 1
    assert n == 26


def test_tp_context_is_recorded_as_the_reference_s():
    """``set_tp_context`` keeps what the reference's keeps; ``lower_cell``
    sets it to the cell's mesh and data axes, as the reference's does."""
    from repro.models import layers as RL

    rmesh, tmesh = meshes("2x16x16")
    try:
        TL.set_tp_context(tmesh, ["pod", "data"])
        RL.set_tp_context(rmesh, ["pod", "data"])
        assert TL._TP_CTX[1] == RL._TP_CTX[1] == ("pod", "data")
        assert TL._TP_CTX[0] is tmesh
        dryrun.lower_cell(reduced("whisper-small", "float32"), TCFG.ShapeCell("t", 8, 1, "decode"),
                          TMESH.make_mesh((1, 1), ("data", "model"), META), "1x1")
        assert TL._TP_CTX[1] == ("data",)
    finally:
        TL.set_tp_context(None, ())
        RL.set_tp_context(None, ())
    assert TL._TP_CTX is None


# ---------------------------------------------------------------------------
# the counter: meta against CPU tensors, and against hand counts
# ---------------------------------------------------------------------------


def reduced(arch, dtype):
    """A reduced config whose attention the flash backward kernel takes
    (head dim 64), with remat, as the meta branch refuses what the card
    would."""
    return get_config(arch).reduced(remat=True, head_dim=64, dtype=dtype)


def counted_step(cfg, device, b=2, s=64):
    params = TM.init_params(cfg, 0, device=device)
    opt = init_opt_state(params, OptConfig())
    toks = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32).to(device)
    counter = TCAL.StepCounter()
    step = make_train_step(cfg, OptConfig())
    with counter:
        step(params, opt, {"tokens": toks, "labels": toks.clone()})
    return counter, params


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["minitron-4b", "falcon-mamba-7b"])
def test_meta_counter_equals_the_cpu_counter(arch, one_thread):
    cfg = reduced(arch, "float32")
    cpu, _ = counted_step(cfg, "cpu")
    meta, _ = counted_step(cfg, META)
    got, want = meta.totals(), cpu.totals()
    # the meta device copies the rotary angles' f64 inverse frequencies from
    # the host, as the card does (4 calls: 2 layers, each recomputed once);
    # on the CPU that copy is no copy
    tables = 4 * (cfg.head_dim // 2) * 8 if cfg.attention != "none" else 0
    assert got.pop("host_bytes") == tables and want.pop("host_bytes") == 0
    assert got == want
    assert meta.kernels == cpu.kernels
    assert got["peak_bytes"] > 0 and got["kernel_flops"] > 0


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_meta_results_cached_by_argument_metadata(kind, monkeypatch, one_thread):
    """The counter remakes a new-result op's meta outputs from earlier
    arguments of the same shapes, strides, dtypes and scalars, but not an
    op that hands back its input's storage (``_unsafe_view``, whose remade
    storage would add a GiB to minitron-4b's decode peak): a reduced
    zamba2-2.7b train step and minitron-4b's decode_32k cell count the
    same with the cache as with every op run, and the cache was used."""
    if kind == "train":
        cfg, cell = reduced("zamba2-2.7b", "bfloat16"), TCFG.ShapeCell("t", 64, 2, "train")
        mesh = TMESH.make_mesh((1, 1), ("data", "model"), META)
    else:
        cfg, cell = get_config("minitron-4b"), TCFG.shape_by_name("decode_32k")
        mesh = TMESH.make_production_mesh(device=META)
    cached = dryrun.lower_cell(cfg, cell, mesh, "1x1", microbatches=1).counter
    assert cached._meta_out
    monkeypatch.setattr(TCAL.StepCounter, "_run", lambda self, f, a, k: f(*a, **k))
    plain = dryrun.lower_cell(cfg, cell, mesh, "1x1", microbatches=1).counter
    assert not plain._meta_out
    assert cached.totals() == plain.totals() and cached.kernels == plain.kernels


def weight_products(cfg, tokens):
    """``(sum of din x dout over the products each block and the head
    run, the last product of each block)``: the products are applied to
    ``tokens`` rows."""
    d = cfg.d_model
    if cfg.ssm:
        di, n = cfg.ssm_expand * d, cfg.ssm_state
        r = max(1, d // 16)
        per_layer = [(d, 2 * di), (di, r + 2 * n), (r, di), (di, d)]
    else:
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        per_layer = [(d, q), (d, kv), (d, kv), (q, d), (d, 2 * cfg.d_ff), (cfg.d_ff, d)]
    return per_layer, (d, cfg.vocab)


@pytest.mark.parametrize("arch", ["minitron-4b", "falcon-mamba-7b"])
def test_matmul_flops_equal_a_hand_count(arch, one_thread):
    """Each weight product of a checkpointed block runs four times (the
    forward, remat's recompute, the backward's dX and dW), 2 T din dout
    flops each; the block's last product runs three, as torch's
    non-reentrant checkpoint stops recomputing once it holds every tensor
    the backward needs, and that product's output is not one.  The head
    (a checkpointed cross-entropy chunk) runs four.  The kernels' flops are
    ``roofline/analysis.py``'s formulas for the calls the step makes."""
    cfg = reduced(arch, "bfloat16")
    b, s = 2, 64
    t = b * s
    per_layer, head = weight_products(cfg, t)
    layer = sum(4 * 2 * t * i * o for i, o in per_layer) - 2 * t * math.prod(per_layer[-1])
    want = cfg.n_layers * layer + 4 * 2 * t * math.prod(head)
    counter, _ = counted_step(cfg, META, b, s)
    assert counter.totals()["matmul_flops"] == want
    k, n = counter.kernels, cfg.n_layers
    if cfg.ssm:
        di = cfg.ssm_expand * cfg.d_model
        assert k["mamba_scan"]["calls"] == 2 * n and k["mamba_scan_bwd"]["calls"] == n
        assert k["mamba_scan"]["flops"] == 2 * n * TA.mamba_flops(b, s, di, cfg.ssm_state)
        assert k["mamba_scan_bwd"]["flops"] == n * TA.mamba_flops(
            b, s, di, cfg.ssm_state, backward=True)
        assert k["mamba_scan_bwd"]["bytes"] == n * TA.mamba_bwd_bytes(
            b, s, di, cfg.ssm_state, 2, False)
    else:
        h, hd = cfg.n_heads, cfg.head_dim
        assert k["flash_attention"]["calls"] == 2 * n
        assert k["flash_attention"]["flops"] == 2 * n * TA.flash_flops(b, h, s, s, hd, hd, True)
        assert k["flash_attention_bwd"]["flops"] == n * TA.flash_bwd_flops(b, h, s, s, hd, True)
        assert k["flash_attention"]["flops"] == 2 * n * 2 * 2 * hd * b * h * s * (s + 1) // 2


def test_meta_branch_gives_the_card_s_outputs():
    """Every kernel on the meta device returns its outputs with the shapes
    and dtypes the card's launch allocates (those of the plain version on
    the CPU; the scan's kept states ``[B, ceil(L / 8), D, N]`` f32), and
    launches nothing."""
    from repro_torch.core.nodes import KEY_MAX

    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 40, 64), generator=g)
    k = torch.randn((2, 2, 40, 64), generator=g)
    delta = torch.rand((2, 21, 16), generator=g)
    A = -torch.rand((16, 4), generator=g)
    bm, c, x = (torch.randn(s, generator=g) for s in ((2, 21, 4), (2, 21, 4), (2, 21, 16)))
    rows = torch.full((3, 64), KEY_MAX, dtype=torch.int64)
    rows[:, :10] = torch.arange(10)
    staged_slot = torch.full((3, 64), -1, dtype=torch.int32)
    staged_key = torch.full((3, 64), KEY_MAX, dtype=torch.int64)
    zeros = torch.zeros((3, 64), dtype=torch.int64)
    pages = torch.randn((6, 16, 2, 64), generator=g)
    calls = {
        "flash": lambda q, k: ops.flash_attention_fwd(q, k, k, with_lse=True),
        "flash_bwd": lambda q, k: ops.flash_attention_bwd(
            q, k, k, q, q, torch.zeros(q.shape[:3], device=q.device)),
        "scan": lambda *a: ops.mamba_scan_fwd(*a, with_states=True),
        "paged": lambda q, kp, t, n: ops.paged_attention(q, kp, kp, t, n, with_lse=True),
        "node_search": lambda r, qq: ops.node_search(r, qq, r),
        "leaf_write": lambda r, s_, k_: ops.leaf_write(r, r, s_, r, k_, r),
        "leaf_split": lambda r, k_: ops.leaf_split(r, r, k_, r),
        "leaf_scan": lambda r, st, n: ops.leaf_scan(r, r, st, n, max_count=5),
    }
    args = {
        "flash": (q, k),
        "flash_bwd": (q, k),
        "scan": (delta, A, bm, c, x),
        "paged": (q[:, :, 0].contiguous(), pages, torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
                  torch.tensor([20, 3], dtype=torch.int32)),
        "node_search": (rows, torch.tensor([3, -5, KEY_MAX])),
        "leaf_write": (rows, staged_slot, staged_key),
        "leaf_split": (rows, staged_key),
        "leaf_scan": (rows, torch.tensor([2, 5, KEY_MAX]), torch.tensor([3, 0, 7],
                                                                       dtype=torch.int32)),
    }
    before = dict(ops.LAUNCHES)
    for name, fn in calls.items():
        want = fn(*args[name])
        got = fn(*(t.to(META) for t in args[name]))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want), name
        for gt, wt in zip(got, want):
            assert gt.device == META and gt.dtype == wt.dtype and gt.shape == wt.shape, name
    assert want[0].shape == (3, 5) and zeros.shape == (3, 64)
    _, _, states = ops.mamba_scan_fwd(*(t.to(META) for t in args["scan"]), with_states=True)
    assert states.shape == (2, ms.saves(21), 16, 4) and states.dtype == torch.float32
    grads = ops.mamba_scan_bwd(*(t.to(META) for t in args["scan"]), x.to(META),
                               states=states)
    assert [tuple(t.shape) for t in grads] == [(2, 21, 16), (16, 4), (2, 21, 4), (2, 21, 4),
                                               (2, 21, 16)]
    with pytest.raises(ValueError, match="states"):
        ops.mamba_scan_bwd(*(t.to(META) for t in args["scan"]), x.to(META))
    assert ops.LAUNCHES == before


def test_plain_scan_keeps_the_kernel_s_states():
    """``mamba_scan_fwd(with_states=True)`` on the CPU keeps the state
    before every 8th step, as the kernel does: each equals the plain scan's
    final state over the steps before it."""
    g = torch.Generator().manual_seed(1)
    delta = torch.rand((2, 19, 8), generator=g)
    A = -torch.rand((8, 4), generator=g)
    bm, c, x = (torch.randn(s, generator=g) for s in ((2, 19, 4), (2, 19, 4), (2, 19, 8)))
    y, h, states = ops.mamba_scan_fwd(delta, A, bm, c, x, with_states=True)
    assert states.shape == (2, 3, 8, 4)
    assert torch.equal(states[:, 0], torch.zeros((2, 8, 4)))
    for i in (1, 2):
        t = 8 * i
        _, h_t = ref.mamba_scan_ref(delta[:, :t], A, bm[:, :t], c[:, :t], x[:, :t])
        assert torch.equal(states[:, i], h_t)
    assert torch.equal(y, ref.mamba_scan_ref(delta, A, bm, c, x)[0])


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def test_full_width_falcon_train_cell_reports_its_memory(tmp_path, one_thread):
    """falcon-mamba-7b x train_4k x single: one data shard's 16 sequences in
    8 microbatches of 2 x 4,096 tokens on the meta device; the JSON holds the
    reference's keys, the memory a chip, the null collective term and the
    kernel calls (128 scans and 64 backwards a microbatch)."""
    r = dryrun.run_cell("falcon-mamba-7b", "train_4k", "single", out_dir=str(tmp_path),
                        verbose=False)
    assert r["status"] == "ok", r.get("error")
    written = json.loads((tmp_path / "falcon-mamba-7b__train_4k__single.json").read_text())
    assert written["per_device_memory_bytes"] == r["per_device_memory_bytes"]
    assert r["per_device_memory_bytes"] == r["argument_bytes_per_chip"] + r["temp_bytes_per_chip"]
    cfg = get_config("falcon-mamba-7b")
    assert r["shard_batch"] == 16 and r["microbatches"] == 8 and r["chips"] == 256
    assert r["kernels"]["mamba_scan"]["calls"] == 8 * 2 * cfg.n_layers
    assert r["kernels"]["mamba_scan_bwd"]["calls"] == 8 * cfg.n_layers
    assert r["collective_term_s"] is None and r["collective_note"] == "no partitioner on one card"
    ref_keys = RA.RooflineTerms("a", "b", "c", 1, 1.0, 1.0, 1.0, {}, 1.0, 1.0).to_dict()
    assert set(ref_keys) <= set(r)
    assert r["model_flops"] == RA.model_flops_for(ref_config("falcon-mamba-7b"),
                                                   RCFG.shape_by_name("train_4k"))
    # the parameters (bf16, 7.3 B) and bf16 moments split over model and
    # data where the specs shard them; the temp the whole model's
    assert 1.5e8 < r["argument_bytes_per_chip"] < 5e8
    assert r["temp_bytes_per_chip"] > 14e9  # the f32 gradient accumulators


def test_skipped_cells_carry_the_reference_reason(tmp_path):
    for arch in sorted(ARCHS):
        r = dryrun.run_cell(arch, "long_500k", "multi", out_dir=str(tmp_path), verbose=False)
        ok, why = RCFG.cell_applicable(ref_config(arch), RCFG.shape_by_name("long_500k"))
        if ok:
            continue
        assert r == {"arch": arch, "shape": "long_500k", "mesh": "multi", "status": "skipped",
                     "reason": why}
        assert json.loads((tmp_path / f"{arch}__long_500k__multi.json").read_text()) == r


def test_cli_writes_a_cell_and_its_calibrated_terms(tmp_path, capsys):
    dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k", "--mesh", "multi",
                 "--out", str(tmp_path), "--calibrate"])
    r = json.loads((tmp_path / "whisper-small__decode_32k__multi.json").read_text())
    assert r["status"] == "ok" and r["chips"] == 512 and r["shard_batch"] == 4
    assert r["cal_collective_term_s"] is None and r["cal_dominant"] in ("compute", "memory")
    assert r["cal_flops_per_chip"] == r["hlo_flops_per_chip"]  # decode: one step either way
    assert "all requested dry-run cells passed" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the kernels' work formulas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_kept_pairs_closed_form_equals_the_row_sum(causal):
    for sq in (1, 2, 7, 64, 129):
        for sk in (1, 5, 64, 130, 300):
            want = sq * sk if not causal else sum(
                min(sk, max(0, i + sk - sq + 1)) for i in range(sq))
            assert TA.kept_pairs(sq, sk, causal) == want, (sq, sk)


def test_flash_formulas_keep_the_smoke_s_bounds():
    """The phase-3 bounds as ``chip_smoke.py`` wrote them before the
    formulas moved, to the last digit."""
    for h, dh, dv, sq in ((24, 128, 128, 2048), (40, 96, 64, 2048), (32, 80, 80, 2048)):
        assert TA.flash_flops(2, h, sq, sq, dh, dv, True) == 2 * 2 * h * (dh + dv) * (
            sq * (sq + 1) // 2)
        q, k, v = 2 * h * sq * dh, 2 * 8 * sq * dh, 2 * 8 * sq * dv
        assert TA.flash_bytes(q, k, v, 2 * h * sq * dv, 2) == 2 * (q + k + v + 2 * h * sq * dv)
    b, h, sq, sk, dh = 8, 12, 448, 1500, 64
    assert TA.flash_flops(b, h, sq, sk, dh, dh, False) == 2 * 2 * h * dh * b * sq * sk
    assert TA.flash_bwd_flops(2, 24, 4096, 4096, 128, True) == 10 * 128 * (
        4096 * 4097 // 2) * 2 * 24
    assert TA.flash_bwd_bytes(100, 30, 7, 2) == 2 * (4 * 100 + 4 * 30) + 4 * 7
    assert TA.mamba_exps(2, 4096, 8192, 16) == 2 * 4096 * 8192 * 16
    assert TA.paged_bytes((64, 24, 128), 8, 2, 17_909, 1_150) == (
        17_909 * 8 * 128 * 2 * 2 + 2 * 64 * 24 * 128 * 2 + 64 * 24 * 4 + 1_150 * 4 + 64 * 4)
