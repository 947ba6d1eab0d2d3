"""The plain versions of the port's attention kernels against the
reference's Pallas kernels (interpret mode, as tests/test_kernels.py runs
them) and its jnp oracles, on the same numpy inputs: the shapes of
tests/test_kernels.py plus a request of length 0, partial last pages,
groups G of 1, 3 and 4, Sq < Sk, ``causal=False`` and lengths that are not
a multiple of the block.

Tolerances: float32 2e-5 (flash) and 3e-5 (paged), the reference's own for
its kernels against its oracles (sums in another order; the oracles scale
by a float64 numpy scalar); bfloat16 2e-2 (one bf16 rounding of outputs of
order 1).  The CUDA kernels are held to these plain versions by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype])


def as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor
    ) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,causal,pallas",
    [
        (1, 4, 4, 128, 128, True, True),  # tests/test_kernels.py shapes
        (2, 8, 2, 256, 256, True, True),
        (1, 4, 1, 128, 128, True, True),
        (1, 2, 2, 128, 256, False, True),  # non-causal, Sq < Sk
        (1, 2, 2, 128, 384, True, True),  # causal offset Sk - Sq
        (1, 6, 2, 128, 128, True, True),  # G = 3
        (1, 6, 2, 200, 200, True, False),  # not a multiple of the block
        (1, 4, 1, 72, 136, True, False),
        (1, 4, 2, 72, 136, False, False),
    ],
)
def test_flash_attention_ref_matches_reference(dtype, b, h, hkv, sq, sk, causal, pallas):
    d = 64 if h != 4 or hkv != 1 or sq != 128 else 128
    rng = np.random.default_rng(sq + sk + h)
    q, k, v = (
        rng.standard_normal(s).astype(np.float32)
        for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    )
    jq, jk, jv = (jnp.asarray(a, JNP[dtype]) for a in (q, k, v))
    got = t_ops.flash_attention(
        to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype), causal=causal
    )
    assert got.dtype == TORCH[dtype] and got.shape == (b, h, sq, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    want = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)
    if pallas:  # the Pallas kernel asserts that the lengths tile
        want = ref_ops.flash_attention(jq, jk, jv, causal=causal)
        np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def test_flash_attention_ref_takes_a_scale():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 64, 32)).astype(np.float32) for _ in range(3))
    got = t_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.25)
    want = ref_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,hkv,d,page,ppr",
    [
        (2, 8, 2, 64, 16, 4),  # tests/test_kernels.py shapes (G = 4)
        (1, 4, 4, 128, 32, 2),  # G = 1
        (5, 6, 2, 32, 8, 3),  # G = 3, lengths 0, 1, page, partial, full
    ],
)
def test_paged_attention_ref_matches_reference(dtype, b, h, hkv, d, page, ppr):
    rng = np.random.default_rng(5)
    n_pages = b * ppr + 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    table = rng.permutation(n_pages)[: b * ppr].reshape(b, ppr).astype(np.int32)
    lens = rng.integers(1, ppr * page + 1, size=b).astype(np.int32)
    if b == 5:
        lens[:] = [0, 1, page, page + 3, ppr * page]
    args_t = [to_torch(a, dtype) for a in (q, kp, vp)] + [
        torch.from_numpy(table), torch.from_numpy(lens)
    ]
    args_j = [jnp.asarray(a, JNP[dtype]) for a in (q, kp, vp)] + [
        jnp.asarray(table), jnp.asarray(lens)
    ]
    got = t_ops.paged_attention(*args_t)
    assert got.dtype == TORCH[dtype] and got.shape == (b, h, d)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    oracle = as_f32(ref_ref.paged_attention_ref(*args_j))
    np.testing.assert_allclose(as_f32(got), oracle, atol=tol, rtol=tol)  # NaN = NaN
    # length 0: NaN in both plain versions, 0 from the Pallas kernel
    assert np.isnan(as_f32(got)[lens == 0]).all()
    pallas = as_f32(ref_ops.paged_attention(*args_j))
    assert (pallas[lens == 0] == 0).all()
    np.testing.assert_allclose(
        np.nan_to_num(as_f32(got)), pallas, atol=tol, rtol=tol
    )


def test_paged_attention_ref_ignores_stale_rows_past_the_length():
    """A recycled page holds another request's rows past this one's length;
    changing them must not change the answer."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((3, 8, 2, 16)).astype(np.float32))
    vp = kp.clone()
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    lens = torch.tensor([11], dtype=torch.int32)
    before = t_ops.paged_attention(q, kp, vp, table, lens)
    kp[0, 3:], vp[0, 3:], kp[1], vp[1] = 50.0, -50.0, 50.0, 50.0
    after = t_ops.paged_attention(q, kp, vp, table, lens)
    assert torch.equal(before, after)
