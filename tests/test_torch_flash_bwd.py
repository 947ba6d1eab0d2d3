"""The gradient of the port's ``flash_attention`` on the CPU: the plain
backward ``ref.flash_attention_bwd_ref`` and the ``ops.FlashAttention``
function that the CPU path runs, against ``jax.vjp`` of the reference's
``repro.kernels.ref.flash_attention_ref``, and against
``torch.autograd.gradcheck`` in float64.  Inputs come from numpy with a
seed.

Cases: causal and not, G = 1 and 3, Sq < Sk, Sq > Sk (rows no key reaches:
the reference gives NaN there, and its NaN reaches every dK and dV through
P^T dO, so it is held on the rows that see a key, whose causal offset is
the same once the others are cut off; the port gives those rows dQ = 0 and
adds nothing from them).  Tolerance in float32: 1e-5 x the largest
|gradient| of the tensor (measured about 1e-6: sums in another order).
``paged_attention`` refuses a gradient on the CPU as on the card;
``mamba_scan``'s is its plain backward's (tests/test_torch_mamba_bwd.py)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5

CASES = [  # b, h, hkv, sq, sk, d, causal
    (2, 3, 3, 20, 20, 16, True),
    (1, 6, 2, 13, 29, 8, True),  # G = 3, Sq < Sk
    (2, 6, 2, 17, 11, 16, False),  # G = 3, non-causal, Sq > Sk
    (1, 3, 1, 21, 9, 8, True),  # G = 3, Sq > Sk: 12 rows see no key
    (1, 2, 2, 9, 33, 24, False),
]


def case(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, sk, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def reference_grads(q, k, v, do, causal):
    """``jax.vjp`` of the reference's ``flash_attention_ref`` over the rows
    that see a key: ``(dq of those rows, dk, dv, the number cut)``."""
    cut = max(0, q.shape[2] - k.shape[2]) if causal else 0
    qs, dos = q[:, :, cut:], do[:, :, cut:]
    _, vjp = jax.vjp(
        lambda a, b_, c: jref.flash_attention_ref(a, b_, c, causal=causal),
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v),
    )
    return (*(np.asarray(g) for g in vjp(jnp.asarray(dos))), cut)


def close(got, want, tol=TOL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale <= tol


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", CASES)
def test_plain_backward_matches_jax_vjp(b, h, hkv, sq, sk, d, causal):
    q, k, v, do = case(b, h, hkv, sq, sk, d)
    dq_r, dk_r, dv_r, cut = reference_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert bool(torch.isinf(lse[:, :, :cut]).all()) and bool(torch.isfinite(lse[:, :, cut:]).all())
    dq, dk, dv = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal)
    assert close(dq[:, :, cut:], dq_r) and close(dk, dk_r) and close(dv, dv_r)
    assert bool((dq[:, :, :cut] == 0).all())


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", CASES)
def test_cpu_function_matches_jax_vjp(b, h, hkv, sq, sk, d, causal):
    """``ops.flash_attention`` under grad runs ``FlashAttention``: the
    forward keeps its log-sum-exp, the backward is ``flash_attention_bwd``
    (the plain version on the CPU); no launch is counted."""
    q, k, v, do = case(b, h, hkv, sq, sk, d, seed=1)
    dq_r, dk_r, dv_r, cut = reference_grads(q, k, v, do, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    assert ops.LAUNCHES == before
    assert close(tq.grad[:, :, cut:], dq_r) and close(tk.grad, dk_r) and close(tv.grad, dv_r)


def test_no_grad_skips_the_function():
    """Without grad (serving) the forward alone runs, with no lse."""
    q, k, v, _ = case(1, 2, 2, 5, 5, 8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = ops.flash_attention(tq, tk, tv)
    assert out.grad_fn is None and out.shape == (1, 2, 5, 8)
    o, lse = ops.flash_attention_fwd(tq.detach(), tk.detach(), tv.detach(), with_lse=True)
    assert torch.equal(o, out)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [1, 3])
def test_function_passes_gradcheck_in_float64(causal, hkv):
    """``torch.autograd.gradcheck`` of the CPU function in float64 (the plain
    versions keep float64): the analytic backward against finite
    differences, G = 3 / 1, Sq < Sk."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 3, 4, 8))).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((1, hkv, 6, 8))).requires_grad_()
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: ops.flash_attention(a, b_, c, causal=causal, scale=0.4), (q, k, v)
    )


def test_lse_is_the_natural_log_sum_exp():
    q, k, v, _ = case(1, 4, 2, 7, 12, 8, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = ref.flash_attention_ref(tq, tk, tv, causal=True, scale=0.7, with_lse=True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), np.repeat(k, 2, 1)) * 0.7
    s = np.where(np.arange(7)[:, None] + 5 >= np.arange(12)[None, :], s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert np.abs(lse.numpy() - want).max() <= 1e-5


def test_backward_launch_checks():
    """``launch_bwd`` takes the backward's head dims only and raises on a
    CPU tensor; ``validate_bwd`` checks o, do and lse as the kernel needs
    them.  float64 is the CPU path's alone."""
    def operands(d, dtype=torch.float32):
        q = torch.zeros((1, 2, 4, d), dtype=dtype)
        kv = torch.zeros((1, 1, 4, d), dtype=dtype)
        return q, kv, kv, q, q, torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="head dims"):
        t_flash.launch_bwd(None, *operands(32), True, None)
    with pytest.raises(ValueError, match="CUDA"):
        t_flash.launch_bwd(None, *operands(64), True, None)
    q, k, v, o, do, lse = operands(64)
    with pytest.raises(ValueError, match="lse"):
        t_flash.validate_bwd(q, k, v, o, do, lse[..., :3])
    with pytest.raises(ValueError, match="do"):
        t_flash.validate_bwd(q, k, v, o, do.transpose(2, 3), lse)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_flash.validate(*operands(64, torch.float64)[:3])
    assert "flash_attention_bwd" in ops.LAUNCHES


@pytest.mark.parametrize("grad_mode", [True, False])
def test_off_slice_kernels_refuse_a_gradient(grad_mode):
    """``paged_attention`` has no backward: under grad, an input that
    requires grad raises, naming the ROADMAP item; without grad mode it
    runs.  ``mamba_scan`` has one now: under grad its gradient is the plain
    backward's (``ref.mamba_scan_bwd_ref``) bit for bit; without grad mode
    it records none."""
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    delta = t(1, 3, 4).abs().requires_grad_()
    scan_args = (delta, -t(4, 2).abs(), t(1, 3, 2), t(1, 3, 2), t(1, 3, 4))
    q = t(2, 4, 8).requires_grad_()
    pages = (t(3, 4, 2, 8), t(3, 4, 2, 8))
    paged_args = (q, *pages, torch.zeros((2, 2), dtype=torch.int32),
                  torch.tensor([3, 5], dtype=torch.int32))
    with torch.set_grad_enabled(grad_mode):
        y, _ = ops.mamba_scan(*scan_args)
        if grad_mode:
            with pytest.raises(RuntimeError, match="no backward"):
                ops.paged_attention(*paged_args)
            dy = torch.ones_like(y)
            (got,) = torch.autograd.grad(y, delta, dy)
            want = ref.mamba_scan_bwd_ref(*(a.detach() for a in scan_args), dy)[0]
            assert torch.equal(got, want)
        else:
            assert y.grad_fn is None
            ops.paged_attention(*paged_args)
    with torch.no_grad():
        y, _ = ops.mamba_scan(*scan_args)
    assert y.shape == (1, 3, 4) and math.isfinite(float(y.sum()))
