"""The port's selective scan (``repro_torch.kernels.ref.mamba_scan_ref``,
which ``ops.mamba_scan`` takes for CPU tensors) against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.mamba_scan``) and its
oracle (``repro.kernels.ref.mamba_scan_ref``), on the same numpy inputs.

Tolerance: atol and rtol 1e-4, the reference's own kernel test's
(``tests/test_kernels.py``); the largest absolute difference measured is
1.5e-5, on a decay-heavy input whose y runs to tens (the same f32
recurrence, products and sums in another order).  The final state is held
to a plain numpy recurrence in float64.

``ROADMAP.md`` queue 3, entry 14: on ``B = D = N = 1``, ``A = -1``,
``delta = 2``, ``x = B = C = 1``, ``L = chunk = 35``, the recurrence (the
port, the Pallas kernel and its oracle) gives ``y[-1] = 2.313``, and the
reference model's chunked scan (``repro.models.layers._ssm_chunked_scan``)
gives 1.108, since it drops inputs once a chunk's decay falls below
1e-30."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-4


def inputs(b, l, d, n, seed, heavy=False):
    """The reference test's distributions: delta |N(0,1)| * 0.1 + 0.01 (up
    to 2 on decay-heavy inputs), A = -|N(0,1)| - 0.1, B, C, x N(0,1)."""
    rng = np.random.default_rng(seed)
    scale = 0.8 if heavy else 0.1
    delta = np.minimum(np.abs(rng.standard_normal((b, l, d))) * scale + 0.01, 2.0)
    A = -np.abs(rng.standard_normal((d, n))) - 0.1
    Bm = rng.standard_normal((b, l, n))
    C = rng.standard_normal((b, l, n))
    x = rng.standard_normal((b, l, d))
    return [a.astype(np.float32) for a in (delta, A, Bm, C, x)]


def port(arrays, dtype=torch.float32):
    t = [torch.from_numpy(a.copy()) for a in arrays]
    t[2:] = [a.to(dtype) for a in t[2:]]  # B, C and x in the working dtype
    return ops.mamba_scan(*t)


def recurrence(delta, A, Bm, C, x):
    """float64 numpy: (y, h_last)."""
    b, l, d = delta.shape
    h = np.zeros((b, d, A.shape[1]))
    y = np.zeros((b, l, d))
    for t in range(l):
        dt = delta[:, t, :, None].astype(np.float64)
        h = np.exp(dt * A) * h + dt * x[:, t, :, None] * Bm[:, t, None, :]
        y[:, t] = (h * C[:, t, None, :]).sum(-1)
    return y, h


@pytest.mark.parametrize(
    "b,l,d,n",
    [(1, 32, 128, 16), (2, 64, 256, 16), (1, 24, 128, 64), (2, 17, 40, 8), (2, 1, 128, 16)],
)
@pytest.mark.parametrize("heavy", [False, True])
def test_matches_pallas_kernel_and_oracle(b, l, d, n, heavy):
    arrays = inputs(b, l, d, n, seed=11 + n, heavy=heavy)
    y, h = port(arrays)
    assert y.dtype == torch.float32 and y.shape == (b, l, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    jx = [jnp.asarray(a) for a in arrays]
    for want in (r_ops.mamba_scan(*jx), r_ref.mamba_scan_ref(*jx)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    y64, h64 = recurrence(*arrays)
    np.testing.assert_allclose(y.numpy(), y64, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), h64, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,l,d,n", [(1, 20, 200, 16), (2, 9, 77, 64), (1, 33, 5, 1)])
def test_channel_widths_off_the_block(b, l, d, n):
    """D not a multiple of the TPU kernel's 128-channel block (which it
    asserts away): against the oracle and the float64 recurrence."""
    arrays = inputs(b, l, d, n, seed=5)
    y, h = port(arrays)
    want = r_ref.mamba_scan_ref(*[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    y64, h64 = recurrence(*arrays)
    np.testing.assert_allclose(h.numpy(), h64, atol=TOL, rtol=TOL)


def test_bfloat16_operands_cast_as_the_pallas_kernel_casts():
    arrays = inputs(2, 32, 128, 16, seed=3)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrays[2:]]
    y, h = port(arrays, torch.bfloat16)
    want = r_ops.mamba_scan(*[jnp.asarray(a) for a in arrays[:2]], *map(jnp.asarray, bf))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    _, h64 = recurrence(*arrays[:2], *[a.astype(np.float32) for a in bf])
    np.testing.assert_allclose(h.numpy(), h64, atol=TOL, rtol=TOL)


def test_queue3_entry14_recurrence_not_chunked_scan():
    """ROADMAP queue 3, entry 14: the port gives the recurrence's 2.313
    where the reference model's chunked scan gives 1.108."""
    one = np.ones((1, 35, 1), np.float32)
    arrays = [2 * one, -np.ones((1, 1), np.float32), one, one, one]
    y, h = port(arrays)
    assert abs(float(y[0, -1, 0]) - 2.313) < 1e-3
    assert abs(float(h[0, 0, 0]) - 2.313) < 1e-3
    jx = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(y.numpy(), np.asarray(r_ref.mamba_scan_ref(*jx)), atol=TOL, rtol=TOL)
    y_chunk, _ = RL._ssm_chunked_scan(jx[0], jx[1], jx[2], jx[3], jx[4], chunk=35)
    assert abs(float(y_chunk[0, -1, 0]) - 1.108) < 1e-3


def test_zero_length_gives_empty_output_and_zero_state():
    arrays = inputs(2, 1, 40, 16, seed=0)
    y, h = port([a[:, :0] if a.ndim == 3 else a for a in arrays])
    assert y.shape == (2, 0, 40) and h.shape == (2, 40, 16)
    assert not h.any()


def test_cpu_path_refuses_what_the_kernel_refuses():
    delta, A, Bm, C, x = (torch.from_numpy(a) for a in inputs(1, 8, 32, 16, seed=1))
    x_dbl = torch.cat([Bm, C], dim=-1)
    with pytest.raises(ValueError, match="Bmat must be contiguous"):
        ops.mamba_scan(delta, A, x_dbl[..., :16], C, x)
    with pytest.raises(ValueError, match="Bmat must be"):
        ops.mamba_scan(delta, A, Bm.to(torch.bfloat16), C, x)
    with pytest.raises(ValueError, match="delta must be"):
        ops.mamba_scan(delta.double(), A, Bm, C, x)
    with pytest.raises(ValueError, match="state width"):
        ops.mamba_scan(delta, torch.zeros((32, 65)), Bm, C, x)
    ops.mamba_scan(delta, A, x_dbl[..., :16].contiguous(), C, x)
    assert ops.LAUNCHES["mamba_scan"] == 0  # the CPU path launches nothing
    assert torch.equal(ref.mamba_scan_ref(delta, A, Bm, C, x)[0], ops.mamba_scan(delta, A, Bm, C, x)[0])
