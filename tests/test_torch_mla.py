"""The port's multi-head latent attention (MLA) against the reference's:
``mla_attention`` in prefill and decode, ``sdpa`` with a v narrower than q
and k, and reduced minicpm3-4b's ``forward`` and ``decode_step`` with their
compressed cache planes.  Each runs at the reduced config as it is (q and k
16 wide, v 16) and with ``v_head_dim=8`` (v narrower than q and k, as
minicpm3-4b's 64 against 96), in float32 and bfloat16.  Parameters are made
by the reference's ``init_params`` / ``init_mla`` and carried across by
``params_from_numpy``; inputs are made with numpy from a seed, on the CPU,
where the port's ``flash_attention`` is its plain version.

Tolerances, as ``tests/test_torch_model.py``'s: float32 1e-5; bfloat16
2e-2 (measured about 8e-3 on the logits over two layers: the reference's
``sdpa`` rounds its probabilities to bf16 where the port's kernel does not,
and bf16 sums run in another order).  The bf16 cache planes are held in the
first layer, whose inputs are the same embeddings on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serve.serve_step import paged_decode_step  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NAME = "minicpm3-4b"
CASES = [(vd, dtype) for vd in (16, 8) for dtype in ("float32", "bfloat16")]
IDS = [f"v{vd}-{dtype}" for vd, dtype in CASES]
STEPS = 6  # decode steps
# the reference's layer, traced once a shape (unjitted, each call traces
# its scans and dispatches every operation on its own)
REF_MLA = jax.jit(RL.mla_attention, static_argnums=0, static_argnames="causal")
REF_SDPA = jax.jit(RL.sdpa, static_argnames=("causal", "scale"))


def configs(vd, dtype):
    return (ref_config(NAME).reduced(dtype=dtype, v_head_dim=vd),
            get_config(NAME).reduced(dtype=dtype, v_head_dim=vd))


def to_torch(a):
    """A numpy or jax array as a CPU tensor, bf16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype]
    )


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def model_run(request):
    """Reduced minicpm3-4b on both sides: ``forward`` over 2 x 12 tokens
    and ``STEPS`` ``decode_step``s of the same tokens, with the caches
    after them."""
    vd, dtype = request.param
    rc, tc = configs(vd, dtype)
    rp = RM.init_params(rc, jax.random.PRNGKey(vd))
    tp = TM.params_from_numpy(tc, jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(vd + 1).integers(0, rc.vocab, size=(2, 12)).astype(np.int32)
    run = dict(dtype=dtype, rc=rc, tc=tc, rp=rp, tp=tp, toks=toks)
    run["want_fwd"] = np.asarray(RM.forward(rc, rp, jnp.asarray(toks))[0])
    run["got_fwd"] = TM.forward(tc, tp, torch.from_numpy(toks))[0]
    rcache = RM.init_decode_cache(rc, 2, STEPS)
    tcache = TM.init_decode_cache(tc, 2, STEPS, device="cpu")
    # one trace for every step (unjitted, each call traces its layer scan anew)
    ref_step = jax.jit(RM.decode_step, static_argnums=0)
    wants, gots = [], []
    for t in range(STEPS):
        want, rcache = ref_step(rc, rp, jnp.asarray(toks[:, t : t + 1]), rcache, jnp.int32(t))
        got, tcache = TM.decode_step(tc, tp, torch.from_numpy(toks[:, t : t + 1]), tcache, t)
        wants.append(np.asarray(want))
        gots.append(got)
    run.update(want_dec=np.stack(wants, 1), got_dec=torch.stack(gots, 1),
               rcache=rcache, tcache=tcache)
    return run


def test_forward_matches_reference(model_run):
    r = model_run
    got = r["got_fwd"]
    assert got.dtype == torch.float32 and got.shape == (2, 12, r["rc"].vocab)
    close(got, r["want_fwd"], r["dtype"])


def test_decode_step_matches_reference(model_run):
    """The logits of every step, and the ``c_kv`` / ``k_rope`` planes the
    steps wrote (every layer in f32, the first in bf16)."""
    r = model_run
    close(r["got_dec"], r["want_dec"], r["dtype"])
    depth = slice(None) if r["dtype"] == "float32" else slice(0, 1)
    for key in ("c_kv", "k_rope"):
        close(r["tcache"][key][depth], np.asarray(r["rcache"][key], np.float32)[depth],
              r["dtype"])


def test_decode_matches_forward(model_run):
    """The port's two MLA forms, folded prefill and compressed decode, give
    the same logits at the decoded positions (float32 1e-5; bf16 2e-2)."""
    r = model_run
    close(r["got_dec"], r["got_fwd"][:, :STEPS].numpy(), r["dtype"])


@pytest.mark.parametrize("vd,dtype", CASES, ids=IDS)
def test_init_decode_cache_planes(vd, dtype):
    rc, tc = configs(vd, dtype)
    want = RM.init_decode_cache(rc, 3, 5)
    got = TM.init_decode_cache(tc, 3, 5, device="cpu")
    assert set(got) == set(want) == {"c_kv", "k_rope"}
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == getattr(torch, dtype), key
        assert not bool(got[key].any())
    assert got["c_kv"].shape == (tc.n_layers, 3, 5, tc.kv_lora_rank)
    assert got["k_rope"].shape == (tc.n_layers, 3, 5, tc.qk_rope_dim)


@pytest.mark.parametrize("vd", [16, 8])
def test_init_params_has_the_reference_tree(vd):
    rc, tc = configs(vd, "bfloat16")
    rp = RM.init_params(rc, jax.random.PRNGKey(0))
    tp = TM.init_params(tc, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(got) == set(want)
    assert {"['blocks']['attn']['wkv_b']", "['blocks']['attn']['kv_norm']"} <= set(got)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == torch.bfloat16, key
    # the reference's scales: N(0, 1/sqrt(kv_lora)) for wkv_b
    wkv_b = tp["blocks"]["attn"]["wkv_b"].float()
    assert abs(wkv_b.std().item() * np.sqrt(tc.kv_lora_rank) - 1) < 0.1


def layer_setup(vd, dtype, seed):
    """One MLA layer's parameters from the reference's ``init_mla``, on
    both sides."""
    rc, tc = configs(vd, dtype)
    rp = RL.init_mla(rc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # norm scales away from 1, so the norms' scale multiply does something
    for key in ("q_norm", "kv_norm"):
        rp[key] = jnp.asarray(1 + 0.3 * rng.standard_normal(rp[key].shape), rp[key].dtype)
    tp = {k: to_torch(v) for k, v in rp.items()}
    return rc, tc, rp, tp, rng


@pytest.mark.parametrize("vd,dtype", CASES, ids=IDS)
def test_mla_attention_prefill_matches_reference(vd, dtype):
    rc, tc, rp, tp, rng = layer_setup(vd, dtype, seed=3)
    x = rng.standard_normal((2, 20, rc.d_model)).astype(np.float32)
    xr = jnp.asarray(x, rc.dtype)
    want, want_cache = REF_MLA(rc, rp, xr, jnp.arange(20))
    got, cache = TL.mla_attention(tc, tp, to_torch(xr), torch.arange(20))
    assert want_cache is None and cache is None
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 20, rc.d_model)
    close(got, want, dtype)


@pytest.mark.parametrize("vd,dtype", CASES, ids=IDS)
def test_mla_attention_decode_matches_reference(vd, dtype):
    """Four one-token steps, then a two-token chunk, into a compressed
    cache of 8 positions: the outputs and both planes after each call."""
    rc, tc, rp, tp, rng = layer_setup(vd, dtype, seed=4)
    smax = 8
    rcc = jnp.zeros((2, smax, rc.kv_lora_rank), rc.dtype)
    rcr = jnp.zeros((2, smax, rc.qk_rope_dim), rc.dtype)
    tcc = torch.zeros((2, smax, tc.kv_lora_rank), dtype=getattr(torch, dtype))
    tcr = torch.zeros((2, smax, tc.qk_rope_dim), dtype=getattr(torch, dtype))
    pos = 0
    for s in (1, 1, 1, 1, 2):
        xr = jnp.asarray(rng.standard_normal((2, s, rc.d_model)).astype(np.float32), rc.dtype)
        want, (rcc, rcr) = REF_MLA(
            rc, rp, xr, jnp.arange(pos, pos + s), kv_cache=(rcc, rcr), cache_len=jnp.int32(pos)
        )
        got, (tcc2, tcr2) = TL.mla_attention(
            tc, tp, to_torch(xr), torch.arange(pos, pos + s), kv_cache=(tcc, tcr), cache_len=pos
        )
        assert tcc2 is tcc and tcr2 is tcr  # written in place
        close(got, want, dtype)
        close(tcc, rcc, dtype)
        close(tcr, rcr, dtype)
        pos += s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv,dq,dv,causal", [(4, 4, 16, 8, True), (6, 2, 24, 16, True),
                                                (4, 2, 32, 32, False), (4, 1, 16, 8, False)])
def test_sdpa_narrow_v_matches_reference(dtype, h, hkv, dq, dv, causal):
    """The port's ``sdpa`` (v zero-padded to q's width for the kernel, the
    output cut back) against the reference's, which takes Dv < Dq as it is,
    with the default scale and with the caller's."""
    rng = np.random.default_rng(dq + dv)
    shapes = ((2, 24, h, dq), (2, 24, hkv, dq), (2, 24, hkv, dv))
    q, k, v = (jnp.asarray(rng.standard_normal(s).astype(np.float32), dtype) for s in shapes)
    for scale in (None, 0.3):
        want = REF_SDPA(q, k, v, causal=causal, scale=scale)
        got = TL.sdpa(*(to_torch(a) for a in (q, k, v)), causal=causal, scale=scale)
        assert got.shape == (2, 24, h, dv) and got.is_contiguous()
        close(got, want, dtype)


def test_sdpa_refuses_a_wider_v():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="wider"):
        TL.sdpa(q, q, torch.zeros((1, 4, 2, 16)), causal=True)


def test_paged_decode_step_refuses_mla():
    _, tc = configs(16, "float32")
    params = TM.init_params(tc, seed=0, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    pages = torch.zeros((tc.n_layers, 2, 4, 1, 16))
    with pytest.raises(ValueError, match="decode_step"):
        paged_decode_step(tc, params, tok, pages, pages, torch.zeros((1, 1), dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32))


def test_paged_kv_cache_refuses_mla():
    _, tc = configs(16, "float32")
    with pytest.raises(ValueError, match="decode_step"):
        PagedKVCache(cfg=tc, n_pages=4, page_size=4, max_batch=1, device="cpu")
