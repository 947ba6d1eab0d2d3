"""``mamba_scan``'s launch plan and its decomposition, mirrored in Python,
on the CPU.

The plan (``kernels/mamba_scan.py::plan``) is what the CUDA entry checks.
For falcon-mamba-7b's and zamba2-2.7b's prefill shapes, and for batches
of 1, 2 and 4 at state widths 1-64 and channel counts off the CTA's width,
each plan must give every (channel, state) pair exactly one thread, fit in
the 232,448 bytes of shared memory a CTA may use and in an SM's 65,536
registers at the registers it assumes; at the prefill shapes it must hold
at least twice the warps an SM of the kernel it replaced (32 channels x 4
lanes a CTA: 15.5 and 9.7) in one wave, with no SM above 1.1x the mean.
Its constants and instantiations are read out of ``csrc/mamba_scan.cu``.

``lane_scan`` computes the kernel's decomposition in torch (lanes, states
a lane, chunks, the lanes' partial y summed in lane order).  Against the
plain version its final state must be bit-equal (the same rounded
operations on the same values) and its y within 1e-5 of the largest |y|
(float32 sums of up to 64 terms in another order).  Against the reference's
Pallas kernel in interpret mode and its oracle: tests/test_kernels.py's
atol and rtol of 1e-4."""

import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SOURCE = pathlib.Path(ms.__file__).resolve().parents[1] / "csrc" / "mamba_scan.cu"
PREFILL_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
SMS = 132


def prefill_shape(arch):
    """(B, D, N) of ``mamba_scan`` in a 2-sequence prefill of ``arch``."""
    cfg = get_config(arch)
    return 2, cfg.ssm_expand * cfg.d_model, cfg.ssm_state


def parent_warps(b, d):
    """Warps of the kernel this one replaced: a CTA of 32 channels x 4
    lanes (4 warps) per 32 channels of each batch element."""
    return b * math.ceil(d / 32) * 4


def constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_constants_match_the_source():
    text = SOURCE.read_text()
    assert constant("kGroup") == ms.GROUP
    assert constant("kPartStride") == ms.PART_STRIDE
    assert constant("kMaxChunk") == ms.MAX_CHUNK
    assert constant("kSmemLimit") == ms.SMEM_LIMIT == 232_448
    assert constant("kMaxState") == ms.MAX_STATE
    bounds = re.findall(r"^DEX_MAMBA_BOUNDS\((\d+), (\d+), (\d+)\)$", text, re.M)
    assert {int(s): (int(t), int(c)) for s, t, c in bounds} == ms.BOUNDS
    plans = re.findall(r"^\s*DEX_MAMBA_PLAN\((\d+), (\d+)\)\s*$", text, re.M)
    assert {(int(s), int(lp)) for s, lp in plans} == ms.INSTANTIATED


def check_plan(p, b, d, n):
    assert (p.states, p.lanes) in ms.INSTANTIATED
    assert max(n, 4) <= p.lanes * p.states <= ms.MAX_STATE
    assert p.threads % 32 == 0 and p.channels % 8 == 0
    assert p.threads <= ms.BOUNDS[p.states][0]
    assert p.ctas == b * math.ceil(d / p.channels)
    # every (batch, channel, state) has exactly one thread: CTA (x, y) owns
    # channels x * channels + cl of batch y; lane j of a channel holds its
    # states j * states + s
    tid = np.arange(p.threads)
    warp, lane = tid // 32, tid % 32
    cl = warp * (32 // p.lanes) + lane // p.lanes
    j = lane % p.lanes
    cover = np.zeros((b, d, n), np.int64)
    for bx in range(math.ceil(d / p.channels)):
        c = bx * p.channels + cl
        for s in range(p.states):
            k = j * p.states + s
            live = (c < d) & (k < n)
            for by in range(b):
                np.add.at(cover[by], (c[live], k[live]), 1)
    assert (cover == 1).all()
    assert p.chunk % ms.GROUP == 0 and ms.GROUP <= p.chunk <= ms.MAX_CHUNK
    # shared memory at the plan's operand size, recomputed
    assert p.smem == p.smem_bytes(p.item) == ms.smem_bytes(
        p.chunk, p.channels, p.lanes * p.states, p.item, p.warps
    )
    assert p.smem <= ms.SMEM_LIMIT
    # a thread's four-element groups: 4 * threads elements of a chunk's
    # [chunk][channels] and [chunk][lanes * states] tiles a round, whole rows
    assert (4 * p.threads) % p.channels == 0 and (4 * p.threads) % (p.lanes * p.states) == 0
    # the registers it assumes: the launch bounds' share of an SM
    threads, ctas = ms.BOUNDS[p.states]
    assert p.regs == ms.regs(p.states) == min(255, 65_536 // (threads * ctas) // 8 * 8)
    assert p.resident >= 1
    assert p.resident * p.threads * p.regs <= 65_536
    assert p.resident * (p.smem + ms.CTA_RESERVED) <= ms.SM_SMEM
    assert p.resident * p.warps <= 64
    assert p.per_sm == math.ceil(p.ctas / p.sms)


@pytest.mark.parametrize("item", [2, 4])
@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_plans_fill_the_card_in_one_even_wave(arch, item):
    b, d, n = prefill_shape(arch)
    p = ms.plan(b, d, n, SMS, item=item)
    check_plan(p, b, d, n)
    assert p.one_wave
    assert p.ctas * p.warps >= 2 * parent_warps(b, d)
    assert p.max_warps_per_sm <= 1.1 * p.warps_per_sm
    for v in ms.variants(b, d, n, SMS, item).values():
        check_plan(v, b, d, n)


def test_prefill_plans():
    """bf16 operands.  falcon-mamba-7b: 2 states x 8 lanes, 64 channels a
    CTA, 256 CTAs of 16 warps (31.0 warps an SM, 32 at most; the parent
    15.5); zamba2-2.7b: 4 x 16, 40 channels, 256 CTAs of 20 warps (38.8, 40;
    the parent 9.7); chunks of 40 and 32 steps, the longest that let two
    CTAs share an SM (with float32 operands, 40 and 24)."""
    f = ms.plan(*prefill_shape("falcon-mamba-7b"), SMS)
    assert (f.states, f.lanes, f.channels, f.ctas, f.warps) == (2, 8, 64, 256, 16)
    assert (f.chunk, f.regs, f.max_warps_per_sm, f.resident) == (40, 64, 32, 2)
    z = ms.plan(*prefill_shape("zamba2-2.7b"), SMS)
    assert (z.states, z.lanes, z.channels, z.ctas, z.warps) == (4, 16, 40, 256, 20)
    assert (z.chunk, z.regs, z.max_warps_per_sm, z.resident) == (32, 48, 40, 2)
    assert ms.plan(*prefill_shape("falcon-mamba-7b"), SMS, item=4).chunk == 40
    assert ms.plan(*prefill_shape("zamba2-2.7b"), SMS, item=4).chunk == 24
    assert parent_warps(2, 8192) / SMS == pytest.approx(15.52, abs=0.01)
    assert parent_warps(2, 5120) / SMS == pytest.approx(9.70, abs=0.01)


@pytest.mark.parametrize("item", [2, 4])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 12, 16, 48, 64])
@pytest.mark.parametrize("d", [1, 7, 40, 333, 1000, 8200])
def test_plan_at_other_shapes_fits_and_covers(b, d, n, item):
    check_plan(ms.plan(b, d, n, SMS, item=item), b, d, n)


def test_plan_refuses_what_has_no_kernel():
    with pytest.raises(ValueError, match="state width"):
        ms.plan(1, 8, 65)
    with pytest.raises(ValueError, match="no kernel"):
        ms.plan(1, 8, 16, states=8)


def inputs(b, l, d, n, seed, heavy=False):
    """tests/test_torch_mamba.py's distributions: delta |N(0,1)| * 0.1 +
    0.01 (up to 2 on decay-heavy inputs), A = -|N(0,1)| - 0.1, B, C, x
    N(0,1); float32."""
    rng = np.random.default_rng(seed)
    scale = 0.8 if heavy else 0.1
    delta = np.minimum(np.abs(rng.standard_normal((b, l, d))) * scale + 0.01, 2.0)
    A = -np.abs(rng.standard_normal((d, n))) - 0.1
    Bm = rng.standard_normal((b, l, n))
    C = rng.standard_normal((b, l, n))
    x = rng.standard_normal((b, l, d))
    return [a.astype(np.float32) for a in (delta, A, Bm, C, x)]


def plans(b, d, n):
    """The default plan and its variants, plus every states-a-lane choice
    with a kernel at 16- and 24-step chunks."""
    out = dict(ms.variants(b, d, n, SMS))
    padded = max(4, 1 << (n - 1).bit_length())
    for s in (1, 2, 4, 8):
        if (s, max(1, padded // s)) in ms.INSTANTIATED:
            for t in (16, 24):
                out[f"states {s}, chunk {t}"] = ms.plan(b, d, n, SMS, states=s, chunk=t)
    return out


@pytest.mark.parametrize(
    "b,l,d,n",
    [(1, 70, 40, 16), (2, 33, 24, 64), (2, 17, 9, 12), (1, 40, 8, 1), (2, 9, 16, 48)],
)
@pytest.mark.parametrize("heavy", [False, True])
def test_lane_scan_matches_plain(b, l, d, n, heavy):
    args = [torch.from_numpy(a) for a in inputs(b, l, d, n, seed=l + n, heavy=heavy)]
    want_y, want_h = ref.mamba_scan_ref(*args)
    for label, p in plans(b, d, n).items():
        y, h = ms.lane_scan(*args, p)
        assert torch.equal(h, want_h), label
        assert float((y - want_y).abs().max()) <= 1e-5 * float(want_y.abs().max()), label


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_scan_bf16_operands(dtype):
    """B, C and x in the working dtype are cast to f32 first, as the
    kernel's conversion pass and the plain version cast them."""
    arrays = inputs(2, 37, 24, 16, seed=4, heavy=True)
    args = [torch.from_numpy(a) for a in arrays]
    args[2:] = [a.to(dtype) for a in args[2:]]
    want_y, want_h = ref.mamba_scan_ref(*args)
    y, h = ms.lane_scan(*args, ms.plan(2, 24, 16, SMS, chunk=16))
    assert torch.equal(h, want_h)
    assert float((y - want_y).abs().max()) <= 1e-5 * float(want_y.abs().max())


@pytest.mark.parametrize(
    "b,l,d,n,heavy",
    [(1, 70, 128, 16, False), (2, 70, 128, 16, True), (1, 41, 64, 64, True),
     (2, 1, 128, 16, False), (1, 97, 32, 12, True)],
)
def test_lane_scan_matches_pallas_kernel_and_oracle(b, l, d, n, heavy):
    """L past a chunk and not a multiple of one (70, 41, 97 against 64-step
    chunks; 1), decay-heavy channels."""
    arrays = inputs(b, l, d, n, seed=3 + l, heavy=heavy)
    p = ms.plan(b, d, n, SMS)
    assert l == 1 or l % p.chunk
    y, _ = ms.lane_scan(*[torch.from_numpy(a) for a in arrays], p)
    jx = [jnp.asarray(a) for a in arrays]
    for want in (r_ops.mamba_scan(*jx), r_ref.mamba_scan_ref(*jx)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_lane_scan_zero_length():
    arrays = inputs(2, 1, 40, 16, seed=0)
    args = [torch.from_numpy(a[:, :0] if a.ndim == 3 else a) for a in arrays]
    y, h = ms.lane_scan(*args, ms.plan(2, 40, 16, SMS))
    assert y.shape == (2, 0, 40) and h.shape == (2, 40, 16)
    assert not h.any()
    want = r_ref.mamba_scan_ref(*[jnp.asarray(a.numpy()) for a in args])
    assert np.asarray(want).shape == (2, 0, 40)


def test_lane_scan_queue3_entry14():
    """ROADMAP queue 3, entry 14: B = D = N = 1, A = -1, delta = 2, x = B =
    C = 1, L = 35 gives y[-1] = 2.313, as the Pallas kernel and its oracle
    do."""
    one = np.ones((1, 35, 1), np.float32)
    arrays = [2 * one, -np.ones((1, 1), np.float32), one, one, one]
    y, h = ms.lane_scan(*[torch.from_numpy(a) for a in arrays], ms.plan(1, 1, 1, SMS))
    assert abs(float(y[0, -1, 0]) - 2.313) < 1e-3 and abs(float(h[0, 0, 0]) - 2.313) < 1e-3
    jx = [jnp.asarray(a) for a in arrays]
    for want in (r_ops.mamba_scan(*jx), r_ref.mamba_scan_ref(*jx)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
