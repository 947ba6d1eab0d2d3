"""The port's encoder-decoder path against the reference's: reduced
whisper-small (2 encoder and 2 decoder layers, d_model 64, 4 heads over 4
of 16, 64 source positions) in float32 and bfloat16.  ``_encode``,
``forward(enc_emb=)``, ``prefill_cross_kv``'s cross planes, six
``decode_step``s with their caches, and decode against ``forward``, each at
T = 64 source frames (``max_source_positions``) and at T = 48, which is not
a multiple of 64; ``gqa_attention`` with ``cross_kv`` (no RoPE); the
decode cache's planes; the refusals.  Parameters are made by the
reference's ``init_params`` and carried across by ``params_from_numpy``;
tokens and frame embeddings are made with numpy from a seed, on the CPU,
where the port's ``flash_attention`` is its plain version.

Tolerances, as ``tests/test_torch_mla.py``'s: float32 1e-5; bfloat16 2e-2
(the reference's ``sdpa`` rounds its probabilities to bf16 where the port's
kernel does not, and bf16 sums run in another order).  The bf16 cross
planes are held in the first decoder layer, the self planes in the first
layer too.  The reference runs under ``jax.jit``, once a shape."""

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
from repro_torch.serve.serve_step import paged_decode_step, prefill  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NAME = "whisper-small"
DTYPES = ("float32", "bfloat16")
CASES = [(dtype, t) for t in (64, 48) for dtype in DTYPES]
IDS = [f"{dtype}-T{t}" for dtype, t in CASES]
B, S, STEPS = 2, 10, 6  # requests, decoder tokens, decode steps
REF_FORWARD = jax.jit(RM.forward, static_argnums=0)
REF_ENCODE = jax.jit(RM._encode, static_argnums=0)
REF_CROSS_KV = jax.jit(RM.prefill_cross_kv, static_argnums=0)
REF_STEP = jax.jit(RM.decode_step, static_argnums=0)
REF_GQA = jax.jit(RL.gqa_attention, static_argnums=0, static_argnames="causal")


def configs(dtype):
    return ref_config(NAME).reduced(dtype=dtype), get_config(NAME).reduced(dtype=dtype)


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


def frames(rc, b, t, seed):
    """Seeded frame embeddings [b, t, D] in the model's dtype (the conv
    front end's stub output), as a jax array."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((b, t, rc.d_model)).astype(np.float32), rc.dtype)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def run(request):
    """Reduced whisper-small on both sides at T source frames: the encoder,
    ``forward`` over B x S tokens, ``prefill_cross_kv`` and ``STEPS``
    ``decode_step``s of the same tokens, with the caches after them."""
    dtype, t = request.param
    rc, tc = configs(dtype)
    rp = RM.init_params(rc, jax.random.PRNGKey(t))
    tp = TM.params_from_numpy(tc, jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(t + 1).integers(0, rc.vocab, size=(B, S)).astype(np.int32)
    emb = frames(rc, B, t, seed=t + 2)
    r = dict(dtype=dtype, t=t, rc=rc, tc=tc, rp=rp, tp=tp, toks=toks, emb=emb)
    r["want_enc"] = np.asarray(REF_ENCODE(rc, rp, emb))
    r["got_enc"] = TM._encode(tc, tp, to_torch(emb))
    r["want_fwd"] = np.asarray(REF_FORWARD(rc, rp, jnp.asarray(toks), enc_emb=emb)[0])
    r["got_fwd"] = TM.forward(tc, tp, torch.from_numpy(toks), enc_emb=to_torch(emb))[0]
    rcache = REF_CROSS_KV(rc, rp, emb, RM.init_decode_cache(rc, B, STEPS, enc_len=t))
    tcache = TM.init_decode_cache(tc, B, STEPS, device="cpu", enc_len=t)
    assert TM.prefill_cross_kv(tc, tp, to_torch(emb), tcache) is tcache
    r["want_x"] = {k: np.asarray(rcache[k], np.float32) for k in ("xk", "xv")}
    r["got_x"] = {k: tcache[k].clone() for k in ("xk", "xv")}
    wants, gots = [], []
    for i in range(STEPS):
        tok = toks[:, i : i + 1]
        want, rcache = REF_STEP(rc, rp, jnp.asarray(tok), rcache, jnp.int32(i))
        got, tcache = TM.decode_step(tc, tp, torch.from_numpy(tok), tcache, i)
        wants.append(np.asarray(want))
        gots.append(got)
    r.update(want_dec=np.stack(wants, 1), got_dec=torch.stack(gots, 1),
             rcache=rcache, tcache=tcache)
    return r


def test_encode_matches_reference(run):
    got = run["got_enc"]
    assert got.dtype == getattr(torch, run["dtype"])
    assert got.shape == (B, run["t"], run["tc"].d_model)
    close(got, run["want_enc"], run["dtype"])


def test_forward_matches_reference(run):
    got = run["got_fwd"]
    assert got.dtype == torch.float32 and got.shape == (B, S, run["rc"].vocab)
    close(got, run["want_fwd"], run["dtype"])


def test_prefill_cross_kv_planes_match_reference(run):
    """``xk`` / ``xv`` [L, B, T, HKV, Dh]: every layer in f32, the first in
    bf16."""
    tc, dtype = run["tc"], run["dtype"]
    depth = slice(None) if dtype == "float32" else slice(0, 1)
    for key in ("xk", "xv"):
        got = run["got_x"][key]
        assert got.shape == (tc.n_layers, B, run["t"], tc.n_kv_heads, tc.head_dim)
        assert got.dtype == getattr(torch, dtype)
        close(got[depth], run["want_x"][key][depth], dtype)


def test_decode_step_matches_reference(run):
    """The logits of every step; the self planes the steps wrote (every
    layer in f32, the first in bf16); the cross planes untouched."""
    dtype = run["dtype"]
    close(run["got_dec"], run["want_dec"], dtype)
    depth = slice(None) if dtype == "float32" else slice(0, 1)
    for key in ("k", "v"):
        close(run["tcache"][key][depth], np.asarray(run["rcache"][key], np.float32)[depth], dtype)
    for key in ("xk", "xv"):
        assert torch.equal(run["tcache"][key], run["got_x"][key])


def test_decode_matches_forward(run):
    """The port's two paths, ``forward`` (the cross keys projected in every
    call) and ``prefill_cross_kv`` + ``decode_step``, give the same logits
    at the decoded positions."""
    close(run["got_dec"], run["got_fwd"][:, :STEPS].numpy(), run["dtype"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_cross_attention_matches_reference(dtype):
    """One decoder layer's cross attention: q alone projected, keys and
    values given, neither rotated: the output does not depend on the
    positions."""
    rc, tc = configs(dtype)
    rp = RL.init_gqa(rc, jax.random.PRNGKey(5))
    tp = {k: to_torch(v) for k, v in rp.items()}
    rng = np.random.default_rng(5)

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32), rc.dtype)

    x, kx, vx = arr(B, 7, rc.d_model), arr(B, 48, 4, 16), arr(B, 48, 4, 16)
    want, cache = REF_GQA(rc, rp, x, jnp.arange(7), causal=False, cross_kv=(kx, vx))
    assert cache is None
    for pos in (torch.arange(7), torch.arange(100, 107)):
        got, cache = TL.gqa_attention(tc, tp, to_torch(x), pos,
                                      cross_kv=(to_torch(kx), to_torch(vx)))
        assert cache is None
        assert got.dtype == getattr(torch, dtype) and got.shape == (B, 7, rc.d_model)
        close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_decode_cache_planes(dtype):
    rc, tc = configs(dtype)
    want = RM.init_decode_cache(rc, 3, 5, enc_len=48)
    got = TM.init_decode_cache(tc, 3, 5, device="cpu", enc_len=48)
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == getattr(torch, dtype), key
        assert not bool(got[key].any())
    assert got["xk"].shape == (tc.n_layers, 3, 48, tc.n_kv_heads, tc.head_dim)


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_round_trip_bit_for_bit(dtype):
    """The encoder subtree and the decoder blocks' ``lnx`` / ``xattn``
    carried across and back, leaf for leaf."""
    rc, tc = configs(dtype)
    tree = jax.tree.map(np.asarray, RM.init_params(rc, jax.random.PRNGKey(3)))
    back = TM.params_to_numpy(TM.params_from_numpy(tc, tree, "cpu"))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {k for k, _ in flat}
    assert {"['encoder']['pos']", "['blocks']['xattn']['wq']"} <= {
        jax.tree_util.keystr(k) for k in got
    }
    for path, want in flat:
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got[path].dtype == want.dtype, path
        np.testing.assert_array_equal(got[path], want)


def small_model():
    _, tc = configs("float32")
    return tc, TM.init_params(tc, seed=0, device="cpu")


def test_forward_without_enc_emb_raises():
    tc, params = small_model()
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="enc_emb"):
        TM.forward(tc, params, toks)
    with pytest.raises(ValueError, match="enc_emb"):
        prefill(tc, params, toks)


def test_more_frames_than_source_positions_raise():
    tc, params = small_model()
    emb = torch.zeros((1, tc.max_source_positions + 1, tc.d_model))
    with pytest.raises(ValueError, match="max_source_positions"):
        TM.forward(tc, params, torch.zeros((1, 4), dtype=torch.long), enc_emb=emb)
    cache = TM.init_decode_cache(tc, 1, 4, device="cpu", enc_len=emb.shape[1])
    with pytest.raises(ValueError, match="max_source_positions"):
        TM.prefill_cross_kv(tc, params, emb, cache)


def test_prefill_cross_kv_refuses_planes_of_another_length():
    tc, params = small_model()
    cache = TM.init_decode_cache(tc, 1, 4, device="cpu", enc_len=16)
    with pytest.raises(ValueError, match="xk"):
        TM.prefill_cross_kv(tc, params, torch.zeros((1, 20, tc.d_model)), cache)


def test_paged_decode_step_refuses_encdec():
    tc, params = small_model()
    tok = torch.zeros((1, 1), dtype=torch.long)
    pages = torch.zeros((tc.n_layers, 2, 4, tc.n_kv_heads, tc.head_dim))
    with pytest.raises(ValueError, match="decode_step"):
        paged_decode_step(tc, params, tok, pages, pages, torch.zeros((1, 1), dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32))


def test_paged_kv_cache_refuses_encdec():
    _, tc = configs("float32")
    with pytest.raises(ValueError, match="decode_step"):
        PagedKVCache(cfg=tc, n_pages=4, page_size=4, max_batch=1, device="cpu")
