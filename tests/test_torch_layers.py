"""The port's dense layers (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``) on the same numpy inputs, parameters
made by the reference's ``init_*`` and carried across by
``params_from_numpy``.

Tolerances: float32 1e-5 (the same casts, sums in another order);
bfloat16 2e-2 (one bf16 rounding of values of order 1 can differ where the
orders differ, and the reference's ``sdpa`` rounds its probabilities to bf16
before P.V where the port's kernel keeps them in f32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def cfgs(dtype, name="minitron-4b", **kw):
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, dtype=dtype, **kw)
    return ref_config(name).reduced(**kw), get_config(name).reduced(**kw)


def pair(a, dtype):
    """One numpy array as a reference array and a port tensor, in dtype
    (bf16 carried bit for bit)."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    h = np.asarray(j)
    if h.dtype.name == "bfloat16":
        return j, torch.from_numpy(h.view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(h.copy())


def close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
        atol=TOL[dtype], rtol=TOL[dtype],
    )


def carry(cfg, tree):
    return TM.params_from_numpy(cfg, jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_and_layernorm(dtype):
    rng = np.random.default_rng(0)
    x, tx = pair(rng.standard_normal((2, 5, 64)) * 3, dtype)
    s, ts = pair(rng.standard_normal(64), dtype)
    bias, tbias = pair(rng.standard_normal(64), dtype)
    close(TL.rmsnorm(tx, ts, 1e-5), RL.rmsnorm(x, s, 1e-5), dtype)
    close(TL.layernorm(tx, ts, tbias, 1e-5), RL.layernorm(x, s, bias, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_angles_are_float64_and_rotation_matches(dtype):
    pos = np.array([0, 1, 7, 300, 4095], np.int32)
    cos, sin = TL.rope_freqs(32, 1e4, torch.from_numpy(pos))
    rcos, rsin = RL.rope_freqs(32, 1e4, jnp.asarray(pos))
    assert cos.dtype == torch.float64 and np.asarray(rcos).dtype == np.float64
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), rtol=0, atol=1e-12)
    x, tx = pair(np.random.default_rng(1).standard_normal((2, 5, 3, 32)), dtype)
    got = TL.apply_rope(tx, cos[:, None, :], sin[:, None, :])
    want = RL.apply_rope(x, rcos[:, None, :], rsin[:, None, :])
    assert got.dtype == tx.dtype
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(dtype, act):
    rc, tc = cfgs(dtype, act=act)
    p = RL.init_mlp(rc, jax.random.PRNGKey(2))
    x, tx = pair(np.random.default_rng(2).standard_normal((2, 6, 64)), dtype)
    close(TL.mlp(tc, carry(tc, p), tx), RL.mlp(rc, p, x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,sq,sk,h,hkv,causal",
    [(2, 16, 16, 4, 2, True), (1, 24, 24, 6, 2, True), (1, 8, 8, 4, 4, False)],
)
def test_sdpa(dtype, b, sq, sk, h, hkv, causal):
    rng = np.random.default_rng(sq + h)
    q, tq = pair(rng.standard_normal((b, sq, h, 16)), dtype)
    k, tk = pair(rng.standard_normal((b, sk, hkv, 16)), dtype)
    v, tv = pair(rng.standard_normal((b, sk, hkv, 16)), dtype)
    got = TL.sdpa(tq, tk, tv, causal=causal)
    assert got.shape == (b, sq, h, 16)
    close(got, RL.sdpa(q, k, v, causal=causal, block_q=8, block_k=8), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "name", ["minitron-4b", "qwen1.5-110b", "chameleon-34b"]  # plain, qkv_bias, qk_norm
)
def test_gqa_attention_with_and_without_a_dense_cache(dtype, name):
    rc, tc = cfgs(dtype, name)
    p = RL.init_gqa(rc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    # nonzero biases and norm scales, so those branches do something
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in p:
            p[key] = jnp.asarray(1 + 0.3 * rng.standard_normal(p[key].shape), p[key].dtype)
    tp = carry(tc, p)
    x, tx = pair(rng.standard_normal((2, 6, 64)), dtype)
    pos = np.arange(6, dtype=np.int32)
    got, cache = TL.gqa_attention(tc, tp, tx, torch.from_numpy(pos))
    want, _ = RL.gqa_attention(rc, p, x, jnp.asarray(pos))
    assert cache is None
    close(got, want, dtype)

    # a dense cache of 10 positions, 3 already written: one step at 3
    ck, tck = pair(rng.standard_normal((2, 10, 2, 16)), dtype)
    cv, tcv = pair(rng.standard_normal((2, 10, 2, 16)), dtype)
    x1, tx1 = x[:, :1], tx[:, :1]
    pos1 = np.array([3], np.int32)
    got, (nk, nv) = TL.gqa_attention(
        tc, tp, tx1, torch.from_numpy(pos1), kv_cache=(tck, tcv), cache_len=3
    )
    want, (rk, rv) = RL.gqa_attention(
        rc, p, x1, jnp.asarray(pos1), kv_cache=(ck, cv), cache_len=jnp.int32(3)
    )
    assert nk is tck and nv is tcv  # written in place
    close(got, want, dtype)
    close(nk, rk, dtype)
    close(nv, rv, dtype)
