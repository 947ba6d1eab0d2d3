"""The bf16 ``flash_attention`` kernel's launch plan, its backward's, and the
plain version at zamba2-2.7b's head dim of 80, on the CPU.

The plan (``kernels/flash_attention.py::plan``) is what the CUDA entry
checks against its instantiations: every head dim ``validate`` takes (8 to
256 in steps of 8) must get a plan that names one of them, pads D to a
multiple of 64 (the TMA boxes are 128 bytes of bf16) by less than 64, and
fits in the 232,448 bytes of shared memory a CTA may use; float32 gets the
CUDA-core kernel.

The backward's plan (``plan_bwd``) is what ``dex_flash_attention_bwd_plan``
checks: every head dim it takes gets 64-row consumer tiles, the tile
constants of ``csrc/flash_attention_bwd.cu``, an instantiation there, and
both passes' shared bytes within the limit; D = 80 and 96 report the share
of the executed work their padding to 128 costs.

D = 80 runs as a padded 128 on the card; here the plain version is held to
the reference's ``flash_attention_ref`` and, where the lengths tile, to the
Pallas kernel in interpret mode (as tests/test_kernels.py runs it).
Tolerances as tests/test_torch_attention.py: float32 2e-5, bfloat16 2e-2."""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402

SOURCE = pathlib.Path(t_flash.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"


def instantiations():
    """(padded D, kv rows, stages) of every bf16 kernel the source builds."""
    text = SOURCE.read_text()
    return {
        tuple(int(x) for x in m)
        for m in re.findall(r"^\s*DEX_FLASH_PLAN\((\d+), (\d+), (\d+)\)\s*$", text, re.M)
    }


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_every_head_dim_gets_a_plan_that_fits(d):
    built = instantiations()
    assert len(built) == 4
    p = t_flash.plan(d, torch.bfloat16)
    assert p.route == "wgmma"
    assert p.padded_d % 64 == 0 and d <= p.padded_d < d + 64
    assert (p.padded_d, p.block_kv, p.stages) in built
    assert p.block_q == 128 and p.stages >= 2
    tiles = 2 * (p.block_q * p.padded_d + 2 * p.stages * p.block_kv * p.padded_d)
    assert tiles < p.smem_bytes <= t_flash.SMEM_LIMIT
    f = t_flash.plan(d, torch.float32)
    assert f.route == "cuda-cores" and f.padded_d == d
    assert f.smem_bytes == 4 * (2 * 64 * (d + 1) + 64 * d + 64 * 65) <= t_flash.SMEM_LIMIT


def test_head_dim_80_pads_to_128():
    p = t_flash.plan(80, torch.bfloat16)
    assert (p.padded_d, p.block_kv) == (128, 128)
    assert 1 - 80 / p.padded_d == 0.375  # the padded share of the products


BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")


def bwd_source():
    """The backward's integer constants and its bf16 kernels' (D, padded
    D), read out of the source."""
    text = BWD_SOURCE.read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    built = {
        tuple(int(x) for x in m)
        for m in re.findall(r"^\s*DEX_FLASH_BWD_PLAN\((\d+), (\d+)\)\s*$", text, re.M)
    }
    return const, built


@pytest.mark.parametrize("d", t_flash.BWD_HEAD_DIMS)
def test_every_bwd_head_dim_gets_a_plan_that_fits(d):
    const, built = bwd_source()
    assert {x for x, _ in built} == set(t_flash.BWD_HEAD_DIMS)
    p = t_flash.plan_bwd(d, torch.bfloat16)
    assert p.route == "wgmma" and (d, p.padded_d) in built
    assert p.padded_d % 64 == 0 and d <= p.padded_d < d + 64
    assert p.consumer_rows == 64 and p.block_rows == 2 * p.consumer_rows == const["kTile"]
    assert p.step_rows == const["kStep"] == 64 and p.stages == const["kStages"] >= 3
    big, small = 2 * p.block_rows * p.padded_d, 2 * p.step_rows * p.padded_d
    held = const["kHold"] * 2 * big
    assert p.smem_dkdv == held + p.stages * (2 * small + 8 * p.step_rows) + t_flash._SLACK
    assert p.smem_dq == held + p.stages * 2 * small + t_flash._SLACK
    assert max(p.smem_dkdv, p.smem_dq) <= t_flash.SMEM_LIMIT
    f = t_flash.plan_bwd(d, torch.float32)
    assert f.route == "cuda-cores" and f.padded_d == d and f.padding == 0
    assert max(f.smem_dkdv, f.smem_dq) <= t_flash.SMEM_LIMIT


def test_bwd_plan_reports_its_padding():
    padding = {d: t_flash.plan_bwd(d, torch.bfloat16).padding for d in t_flash.BWD_HEAD_DIMS}
    assert padding[64] == padding[128] == 0
    # S and dP over the true D in both passes (8 D a pair), dV, dK and dQ
    # over the padded 128 (6 x 128)
    assert padding[80] == pytest.approx(1 - 14 * 80 / (8 * 80 + 6 * 128))
    assert padding[96] == pytest.approx(0.125)
    with pytest.raises(ValueError, match="head dims"):
        t_flash.plan_bwd(72, torch.bfloat16)


JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "h,hkv,sq,sk,pallas",
    [
        (4, 4, 128, 256, True),  # G = 1, as zamba2's 32 heads over 32
        (6, 2, 128, 384, True),  # G = 3
        (4, 4, 72, 136, False),  # lengths off the 64-row tile
        (6, 2, 100, 230, False),
    ],
)
def test_flash_attention_ref_at_head_dim_80(dtype, h, hkv, sq, sk, pallas):
    d = 80
    rng = np.random.default_rng(sq + sk + h)
    q, k, v = (
        rng.standard_normal(s).astype(np.float32)
        for s in ((1, h, sq, d), (1, hkv, sk, d), (1, hkv, sk, d))
    )
    got = t_ops.flash_attention(
        *(torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v)), causal=True
    )
    assert got.dtype == TORCH[dtype] and got.shape == (1, h, sq, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    jq, jk, jv = (jnp.asarray(a, JNP[dtype]) for a in (q, k, v))
    want = ref_ref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)
    if pallas:  # the Pallas kernel asserts that the lengths tile
        want = ref_ops.flash_attention(jq, jk, jv, causal=True)
        np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)
