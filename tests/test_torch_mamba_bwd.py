"""The gradient of the port's ``mamba_scan`` on the CPU: the plain backward
``ref.mamba_scan_bwd_ref``, the ``ops.MambaScan`` function the CPU path
runs, the backward kernel's decomposition ``mamba_scan.lane_scan_bwd`` and
its plan ``plan_bwd``, with the constants read out of
``csrc/mamba_scan_bwd.cu``.  Inputs come from numpy with a seed.

Tolerances, each with what was measured:

* the plain backward in float64 against autograd of the plain forward:
  1e-10 x the largest |gradient| (measured 1.8e-16); ``gradcheck`` of
  ``MambaScan`` with its defaults;
* against ``jax.vjp`` of the reference's exact scan
  (``repro/kernels/ref.py::mamba_scan_ref``, ``lax.scan``) in f32: 1e-5 x
  the largest |gradient| of each output (measured 4.7e-7: sums in another
  order).  The reference returns y alone, so ``dh_last`` enters it
  through N appended steps with delta = 0 (a = 1, nothing added) whose
  ``C`` reads out one state each: their y is the final state;
* the decomposition against the plain backward: 1e-5 x the largest
  |gradient| (measured 3.0e-7).  On the card the kernel equals the
  decomposition bit for bit (``chip_smoke.py`` phase 3)."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CSRC = pathlib.Path(ms.__file__).resolve().parents[1] / "csrc"
_TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "mamba_bwd_variants.py"
_spec = importlib.util.spec_from_file_location("mamba_bwd_variants", _TOOL)
variants_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants_tool)
NAMES = ("ddelta", "dA", "dB", "dC", "dx")


def case(b, l, d, n, seed=0, dtype=np.float32):
    """Operands at the model's scales (``delta`` a softplus about 0.3,
    ``A = -(1..N) / N``), every fifth channel decay-heavy (``delta`` 0.5-2),
    and the output gradients ``dy`` and ``dh_last``."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((b, l, d)) - 1))
    delta[..., ::5] = rng.uniform(0.5, 2.0, size=delta[..., ::5].shape)
    A = -np.tile((1.0 + np.arange(n)) / n, (d, 1))
    bm, c = rng.standard_normal((b, l, n)), rng.standard_normal((b, l, n))
    x, dy = rng.standard_normal((b, l, d)), rng.standard_normal((b, l, d))
    dh = rng.standard_normal((b, d, n))
    return [a.astype(dtype) for a in (delta, A, bm, c, x, dy, dh)]


def tensors(arrays):
    return [torch.from_numpy(a) for a in arrays]


def close(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= tol * scale, (name, np.abs(g - w).max() / scale)


def reference_grads(delta, A, bm, c, x, dy, dh):
    """``jax.vjp`` of the reference's ``mamba_scan_ref`` (y alone); with
    ``dh``, N steps appended with delta = 0, B = x = 0 and ``C`` the unit
    vectors, whose y is the final state, take ``dh`` as their cotangent."""
    b, l, d = delta.shape
    n = A.shape[1]
    if dh is not None:
        z = np.zeros
        delta = np.concatenate([delta, z((b, n, d), np.float32)], 1)
        x = np.concatenate([x, z((b, n, d), np.float32)], 1)
        bm = np.concatenate([bm, z((b, n, n), np.float32)], 1)
        c = np.concatenate([c, np.broadcast_to(np.eye(n, dtype=np.float32), (b, n, n))], 1)
        dy = np.concatenate([dy, dh.transpose(0, 2, 1)], 1)
    grads = _reference_vjp(tuple(jnp.asarray(t) for t in (delta, A, bm, c, x)), jnp.asarray(dy))
    dd, da, db, dc, dx = (np.asarray(g) for g in grads)
    return dd[:, :l], da, db[:, :l], dc[:, :l], dx[:, :l]


@jax.jit
def _reference_vjp(args, dy):
    return jax.vjp(jref.mamba_scan_ref, *args)[1](dy)


@pytest.mark.parametrize("with_dh", [False, True])
def test_plain_backward_matches_autograd_in_float64(with_dh):
    """The reverse recurrence against autograd through the plain forward's
    tensor operations, both in float64."""
    delta, A, bm, c, x, dy, dh = tensors(case(2, 11, 6, 5, dtype=np.float64))
    ins = [t.clone().requires_grad_() for t in (delta, A, bm, c, x)]
    y, h = ref.mamba_scan_ref(*ins)
    assert y.dtype == torch.float64
    loss = (y * dy).sum() + ((h * dh).sum() if with_dh else 0)
    want = torch.autograd.grad(loss, ins)
    got = ref.mamba_scan_bwd_ref(delta, A, bm, c, x, dy, dh if with_dh else None)
    assert all(g.dtype == torch.float64 for g in got)
    close(got, want, 1e-10)


def test_mamba_scan_passes_gradcheck_in_float64():
    """``ops.MambaScan`` (plain forward, plain backward on the CPU) against
    finite differences, through y and the final state together and apart."""
    delta, A, bm, c, x = (t.requires_grad_() for t in tensors(case(1, 7, 4, 3, 1, np.float64)[:5]))
    args = (delta, A, bm, c, x)
    assert torch.autograd.gradcheck(lambda *a: ops.mamba_scan(*a), args)
    assert torch.autograd.gradcheck(lambda *a: ops.mamba_scan(*a)[0], args)
    assert torch.autograd.gradcheck(lambda *a: ops.mamba_scan(*a)[1], args)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("n", [8, 16, 64])
@pytest.mark.parametrize("l", [1, 24, 67])
def test_plain_backward_matches_jax_vjp_of_the_reference(l, n, with_dh):
    arrays = case(2, l, 16, n, seed=l + n)
    dh = arrays[6] if with_dh else None
    want = reference_grads(*arrays[:6], dh)
    got = ref.mamba_scan_bwd_ref(*tensors(arrays[:6]), None if dh is None else torch.from_numpy(dh))
    close(got, want, 1e-5)


DECOMPOSED = [  # b, l, d, n: L off the 8-step sub-block (31, 33, 67, 5), D tails
    (2, 31, 40, 8),
    (1, 33, 16, 64),
    (2, 67, 70, 16),
    (1, 32, 130, 4),
    (2, 5, 24, 12),
    # 9 CTAs of 16 channels in 2 clusters of 5: the last CTA holds no channel
    (1, 12, 140, 64),
    # 3 batch elements, 3 clusters of 7 CTAs
    (3, 9, 333, 16),
]


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("b,l,d,n", DECOMPOSED)
def test_decomposition_matches_plain_backward(b, l, d, n, with_dh):
    """``lane_scan_bwd`` (the kernel's lanes, warps, clusters and sum
    orders, at the plan ``plan_bwd`` gives and at every other pair the
    source holds for the width) against the plain backward."""
    delta, A, bm, c, x, dy, dh = tensors(case(b, l, d, n, seed=d + n))
    dh = dh if with_dh else None
    want = ref.mamba_scan_bwd_ref(delta, A, bm, c, x, dy, dh)
    padded = max(4, 1 << (n - 1).bit_length())
    for s in (4, 2, 1):
        if (s, padded // s) in ms.BWD_INSTANTIATED:
            p = ms.plan_bwd(b, d, n, item=4, states=s)
            close(ms.lane_scan_bwd(delta, A, bm, c, x, dy, dh, p), want, 1e-5)


def constant(source, name):
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, name
    return int(m.group(1))


def test_constants_match_the_source():
    """The backward refills each sub-block from a state the forward kept:
    its sub-block and the forward's ``kSaveEvery`` are one number, mirrored
    with the CTA, cluster and staging constants and the instantiated
    pairs."""
    bwd = "mamba_scan_bwd.cu"
    assert (constant(bwd, "kBwdSub") == ms.BWD_SUB == ms.SAVE_EVERY
            == constant("mamba_scan.cu", "kSaveEvery"))
    assert constant(bwd, "kBwdThreads") == ms.BWD_THREADS
    assert constant(bwd, "kBwdCtas") == ms.BWD_CTAS
    assert constant(bwd, "kBwdCluster") == ms.BWD_CLUSTER <= 8  # a portable cluster
    assert constant(bwd, "kBwdStages") == ms.BWD_STAGES
    assert constant(bwd, "kBwdMaxState") == ms.MAX_STATE
    assert constant(bwd, "kBwdSmemLimit") == ms.SMEM_LIMIT
    assert constant(bwd, "kSumThreads") == ms.SUM_THREADS
    text = (CSRC / bwd).read_text()
    plans = re.findall(r"^\s*DEX_MAMBA_BWD_PLAN\((\d+), (\d+)\)\s*$", text, re.M)
    assert {(int(s), int(lp)) for s, lp in plans} == ms.BWD_INSTANTIATED
    assert ms.BWD_INSTANTIATED <= ms.INSTANTIATED


@pytest.mark.parametrize("name", sorted(variants_tool.PATCHES))
def test_variant_patches_apply_to_the_source(name):
    """``tools/mamba_bwd_variants.py`` carries the variants the kernel no
    longer holds (sparser saves, a full butterfly) as patches of its
    source: each anchor is found once, and the patched source differs."""
    text = (CSRC / "mamba_scan_bwd.cu").read_text()
    out = variants_tool.patched(text, {}, name, variants_tool.PATCHES[name])
    assert out != text
    for start, end, new in variants_tool.PATCHES[name]:
        assert new in out


def test_plans_fit_and_take_the_forward_pair():
    """Every width 1-64 at every batch and channel count below gets a plan
    with a kernel whose shared memory lets two CTAs share an SM and whose
    registers fit the SM, in clusters of at most ``BWD_CLUSTER`` CTAs that
    cover ``D``; at falcon-mamba-7b's and zamba2-2.7b's training shapes it
    takes the forward's (states, lanes), its busiest SM holds at most 5%
    more CTAs than the mean, the clusters take the fewest rounds of those
    an H100 holds at once, and zamba2-2.7b's ``dB`` / ``dC`` partials are
    at most 168 MB (a quarter of the 671 MB that per-CTA partials took)."""
    for b in (1, 2, 4):
        for d in (7, 140, 333, 5120, 8192):
            for n in range(1, 65):
                for item in (2, 4):
                    p = ms.plan_bwd(b, d, n, item=item)
                    assert (p.states, p.lanes) in ms.BWD_INSTANTIATED
                    assert n <= p.lanes * p.states <= ms.MAX_STATE
                    assert p.channels * p.lanes == ms.BWD_THREADS
                    assert p.blocks * p.channels >= d > (p.blocks - 1) * p.channels
                    assert 1 <= p.cluster <= ms.BWD_CLUSTER
                    grid = p.cluster * p.clusters
                    assert p.blocks <= grid < p.blocks + p.clusters and p.ctas == b * grid
                    assert p.smem <= ms.SMEM_LIMIT and p.resident >= ms.BWD_CTAS
                    assert ms.BWD_THREADS * p.regs * ms.BWD_CTAS <= ms.SM_REGS
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        cfg = get_config(arch)
        d, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        fwd, bwd = ms.plan(2, d, n), ms.plan_bwd(2, d, n)
        assert (bwd.states, bwd.lanes) == (fwd.states, fwd.lanes), arch
        assert bwd.per_sm <= 1.05 * bwd.mean_per_sm and bwd.imbalance <= 1.05, arch
    # zamba2-2.7b's training shape: 640 CTAs of 16 channels, 5 on the
    # busiest SM against 4.85, in 40 clusters of 8 a batch element
    p = ms.plan_bwd(2, 5120, 64)
    assert (p.states, p.lanes, p.channels, p.blocks, p.cluster, p.clusters, p.ctas, p.per_sm) == (
        4, 16, 16, 320, 8, 40, 640, 5)
    assert p.partial_bytes(2, 4096, 64) == 4 * 2 * 2 * 4096 * 40 * 64 <= 168_000_000
    assert (p.active, p.rounds) == (30, 3)  # of 8-CTA clusters an H100 holds at once
    # falcon-mamba-7b's: 512 CTAs of 32 channels, 4 on the busiest SM, in
    # clusters of 2: two rounds of the 132 an H100 holds, where clusters of
    # 8 (64 a batch element, 30 at once) or 4 (128, 62) would take three
    p = ms.plan_bwd(2, 8192, 16)
    assert (p.states, p.lanes, p.channels, p.cluster, p.clusters, p.ctas, p.per_sm) == (
        2, 8, 32, 2, 128, 512, 4)
    assert (p.active, p.rounds) == (132, 2)
    assert ms.plan_bwd(2, 8192, 16, cluster=8).rounds == ms.plan_bwd(2, 8192, 16, cluster=4).rounds == 3


@pytest.mark.parametrize("use", ["both", "y", "h_last"])
def test_mamba_scan_gradient_is_the_plain_backward(use):
    """Under grad, ``ops.mamba_scan`` on the CPU is ``MambaScan``: its
    gradients are the plain backward's bit for bit, with a null ``dh_last``
    (or zero ``dy``) for an output the loss does not reach; bf16 operands
    get bf16 gradients."""
    delta, A, bm, c, x, dy, dh = tensors(case(2, 9, 12, 8, 3))
    bm, c, x = (t.bfloat16() for t in (bm, c, x))
    ins = [t.clone().requires_grad_() for t in (delta, A, bm, c, x)]
    y, h = ops.mamba_scan(*ins)
    assert y.grad_fn is not None and y.dtype == torch.float32
    loss = {"both": (y * dy).sum() + (h * dh).sum(), "y": (y * dy).sum(), "h_last": (h * dh).sum()}
    got = torch.autograd.grad(loss[use], ins)
    want = ref.mamba_scan_bwd_ref(
        delta, A, bm, c, x, dy if use != "h_last" else torch.zeros_like(dy),
        dh if use != "y" else None,
    )
    for name, g, w, t in zip(NAMES, got, want, ins):
        assert g.dtype == t.dtype, name
        assert torch.equal(g, w.to(t.dtype)), name
    with torch.no_grad():
        y2, _ = ops.mamba_scan(*ins)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_backward_contract_is_checked():
    """The CPU path checks the layout the kernel needs; the kernel's launch
    refuses CPU tensors and a missing set of saved states."""
    delta, A, bm, c, x, dy, dh = tensors(case(2, 40, 8, 4))
    with pytest.raises(ValueError, match="dy"):
        ops.mamba_scan_bwd(delta, A, bm, c, x, dy[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_scan_bwd(delta, A, bm, c, x, dy.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="dh_last"):
        ops.mamba_scan_bwd(delta, A, bm, c, x, dy, dh[..., :3].contiguous())
    with pytest.raises(ValueError, match="states"):
        ops.mamba_scan_bwd(delta, A, bm, c, x, dy, states=torch.zeros((2, 1, 8, 4)))
    states = torch.zeros((2, ms.saves(40), 8, 4))
    assert ms.saves(40) == 5 and ms.saves(33) == 5 and ms.saves(32) == 4 and ms.saves(0) == 0
    with pytest.raises(ValueError, match="CUDA"):
        ms.launch_bwd(None, delta, A, bm, c, x, dy, dh, states)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ms.validate_bwd(*(t.double() for t in (delta, A, bm, c, x, dy)))
    assert "mamba_scan_bwd" in ops.LAUNCHES and "mamba_scan" not in ops.NO_BACKWARD
