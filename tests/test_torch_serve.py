"""The port's DEX-paged serving (``repro_torch.serve``) against the
reference's (``repro.serve``): the page lifecycle through the index, page
tables over an admit / extend / release / re-admit trace (identical, bit for
bit), the pools after ``append_tokens`` (identical), and
``paged_decode_step`` over ten steps, with the reference's attention as its
jnp oracle and as its Pallas kernel in interpret mode.

Tolerances on the logits: float32 1e-5 (the same casts, sums in another
order); bfloat16 2e-2 (bf16 roundings where the sums run in another order),
the reference's own tolerance for paged against dense decode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import kv_cache as rkv  # noqa: E402
from repro.serve.serve_step import paged_decode_step as ref_step  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.kv_cache import PAGE_BITS, PagedKVCache, page_key  # noqa: E402
from repro_torch.serve.serve_step import blend, paged_decode_step, prefill  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def small(dtype="bfloat16", name="minitron-4b", **kw):
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, dtype=dtype, **kw)
    return ref_config(name).reduced(**kw), get_config(name).reduced(**kw)


def cache(cfg, **kw):
    return PagedKVCache(cfg=cfg, device="cpu", **kw)


# -- the reference's TestPagedKVCache cases, on the port ----------------------


def test_admit_resolve_release():
    kv = cache(small()[1], n_pages=32, page_size=8, max_batch=4)
    req = np.array([5, 9])
    kv.admit_request(5, prompt_len=20)  # 3 pages
    kv.admit_request(9, prompt_len=8)  # 1 page
    t = kv.resolve_tables(req, pages_per_req=3).numpy()
    assert t.shape == (2, 3) and t.dtype == np.int32
    assert len(set(t[0].tolist())) == 3
    assert kv.release_request(5) == 3
    assert kv.release_request(9) == 1
    assert len(kv.free) == 32


def test_extend_allocates_on_boundary():
    kv = cache(small()[1], n_pages=8, page_size=4, max_batch=1)
    kv.admit_request(1, prompt_len=0)
    pages = [p for p in (kv.extend_request(1) for _ in range(9)) if p is not None]
    # tokens 1..9 with page 0 pre-allocated: new pages at len 4 and 8
    assert len(pages) == 2


def test_pool_exhaustion():
    kv = cache(small()[1], n_pages=2, page_size=4, max_batch=1)
    kv.admit_request(1, prompt_len=8)
    with pytest.raises(MemoryError):
        kv.admit_request(2, prompt_len=8)


def test_page_key_layout():
    k = page_key(3, 7)
    assert (int(k) >> PAGE_BITS) == 3 and (int(k) & ((1 << PAGE_BITS) - 1)) == 7
    assert PAGE_BITS == rkv.PAGE_BITS and k == rkv.page_key(3, 7)


# -- traces against the reference --------------------------------------------


def trace(kv, ref, rng, steps):
    """Admit, extend, release and re-admit on both caches; every step the
    port's and the reference's page tables, lengths and free lists must be
    identical."""
    live = {}
    next_id = 1
    for step in range(steps):
        if len(live) < 3 or rng.random() < 0.3:
            n = int(rng.integers(0, 12))
            for c in (kv, ref):
                c.admit_request(next_id, prompt_len=n)
            live[next_id] = n
            next_id += 1
        for r in list(live):
            for c in (kv, ref):
                c.extend_request(r)
        if step % 4 == 3:
            r = sorted(live)[int(rng.integers(0, len(live)))]
            assert kv.release_request(r) == ref.release_request(r)
            del live[r]
        req = np.array(sorted(live))
        got = kv.resolve_tables(req, 5).numpy()
        want = np.asarray(ref.resolve_tables(req, 5))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            kv.batch_seq_lens(req).numpy(), np.asarray(ref.batch_seq_lens(req))
        )
        assert kv.free == ref.free and kv.lookups == ref.lookups
    return live


def test_page_tables_equal_the_reference_over_a_trace():
    rc, tc = small()
    kv = cache(tc, n_pages=40, page_size=4, max_batch=8)
    ref = rkv.PagedKVCache(cfg=rc, n_pages=40, page_size=4, max_batch=8)
    trace(kv, ref, np.random.default_rng(0), 24)
    for name in kv.tree._fields:
        np.testing.assert_array_equal(
            getattr(kv.tree, name).numpy(), np.asarray(getattr(ref.tree, name))
        )


def test_append_tokens_equals_the_reference():
    rc, tc = small("float32")
    kv = cache(tc, n_pages=12, page_size=4, max_batch=3)
    ref = rkv.PagedKVCache(cfg=rc, n_pages=12, page_size=4, max_batch=3)
    rng = np.random.default_rng(1)
    req = np.array([4, 2, 7])
    for r, n in zip(req, (3, 0, 5)):
        kv.admit_request(int(r), prompt_len=n)
        ref.admit_request(int(r), prompt_len=n)
    for _ in range(6):
        for r in req:
            kv.extend_request(int(r))
            ref.extend_request(int(r))
        k_new = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
        v_new = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
        got = kv.append_tokens(req, torch.from_numpy(k_new), torch.from_numpy(v_new))
        want = ref.append_tokens(req, jnp.asarray(k_new), jnp.asarray(v_new))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kv.k_pages.numpy(), np.asarray(ref.k_pages))
    np.testing.assert_array_equal(kv.v_pages.numpy(), np.asarray(ref.v_pages))
    assert np.abs(kv.k_pages.numpy()).sum() > 0


STEP_CASES = [("float32", False), ("float32", True), ("bfloat16", True)]


@pytest.mark.parametrize("dtype,use_kernel", STEP_CASES)
def test_paged_decode_step_matches_reference(dtype, use_kernel):
    """Ten steps for three requests, one of them admitted after another's
    release, so its pages are recycled with stale rows; the reference runs
    its jnp oracle or its Pallas kernel (interpret), the port its wrapper
    (the plain version on the CPU)."""
    check_paged_decode_step("minitron-4b", dtype, use_kernel)


@pytest.mark.parametrize("dtype,use_kernel", STEP_CASES)
def test_moe_paged_decode_step_matches_reference(dtype, use_kernel):
    """The same for reduced granite-moe-1b-a400m: top-2 of 4 experts at a
    capacity factor of 8.0, so no pair is dropped."""
    check_paged_decode_step("granite-moe-1b-a400m", dtype, use_kernel)


def check_paged_decode_step(name, dtype, use_kernel):
    rc, tc = small(dtype, name, head_dim=32)
    rp = RM.init_params(rc, jax.random.PRNGKey(3))
    tp = TM.params_from_numpy(tc, jax.tree.map(np.asarray, rp), "cpu")
    kv = cache(tc, n_pages=16, page_size=4, max_batch=3)
    ref = rkv.PagedKVCache(cfg=rc, n_pages=16, page_size=4, max_batch=3)
    rng = np.random.default_rng(4)
    req = [1, 2, 3]
    for r, n in zip(req, (0, 2, 5)):
        kv.admit_request(r, prompt_len=n)
        ref.admit_request(r, prompt_len=n)
    for t in range(10):
        if t == 4:  # release request 2, admit request 9 in its slot
            kv.release_request(2)
            ref.release_request(2)
            kv.admit_request(9, prompt_len=0)
            ref.admit_request(9, prompt_len=0)
            req = [1, 9, 3]
        for r in req:
            kv.extend_request(r)
            ref.extend_request(r)
        ids = np.array(req)
        tok = rng.integers(0, rc.vocab, size=(3, 1)).astype(np.int32)
        table = kv.resolve_tables(ids, 4)
        r_table = ref.resolve_tables(ids, 4)
        np.testing.assert_array_equal(table.numpy(), np.asarray(r_table))
        got, k_new, v_new = paged_decode_step(
            tc, tp, torch.from_numpy(tok), kv.k_pages, kv.v_pages, table,
            kv.batch_seq_lens(ids), use_kernel=use_kernel,
        )
        want, rk, rv = ref_step(
            rc, rp, jnp.asarray(tok), ref.k_pages, ref.v_pages, r_table,
            ref.batch_seq_lens(ids), use_kernel=use_kernel,
        )
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=TOL[dtype], rtol=TOL[dtype]
        )
        kv.append_tokens(ids, k_new, v_new)
        ref.append_tokens(ids, rk, rv)


def test_paged_decode_matches_dense_decode():
    """Paged decode reproduces the dense-cache decoder, and ``prefill``
    over the same tokens gives the last step's logits at every position."""
    _, tc = small("float32")
    tp = TM.init_params(tc, seed=0, device="cpu")
    b, steps, page = 2, 10, 4
    toks = np.random.default_rng(1).integers(0, tc.vocab, size=(b, steps)).astype(np.int32)
    dense = TM.init_decode_cache(tc, b, max_len=steps, device="cpu")
    kv = cache(tc, n_pages=16, page_size=page, max_batch=b)
    req = np.array([11, 22])
    for r in req:
        kv.admit_request(int(r), prompt_len=0)
    ppr = (steps + page - 1) // page
    for t in range(steps):
        want, dense = TM.decode_step(tc, tp, torch.from_numpy(toks[:, t : t + 1]), dense, t)
        for r in req:
            kv.extend_request(int(r))
        got, k_new, v_new = paged_decode_step(
            tc, tp, torch.from_numpy(toks[:, t : t + 1]), kv.k_pages, kv.v_pages,
            kv.resolve_tables(req, ppr), kv.batch_seq_lens(req),
        )
        kv.append_tokens(req, k_new, v_new)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    full = prefill(tc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(full[:, -1].numpy(), got.numpy(), atol=1e-5, rtol=1e-5)


# -- the blend of history and fresh token past float32's exp range -----------


def test_blend_matches_float64_past_exp_overflow():
    """``blend`` where the history's log-sum-exp and the fresh logit exceed
    88.7, above which exp overflows float32: the reference's weights,
    exp(lse) / (exp(lse) + exp(s)) in float32, are NaN there; the port's
    max-shifted ones match a float64 host computation of the same softmax
    (float32 rounding of the weights and products: 1e-6)."""
    lse = np.array([[[95.0, 100.0], [120.5, 300.0]], [[89.0, 100.5], [88.8, 250.0]],
                    [[-np.inf, -np.inf], [-np.inf, -np.inf]]], np.float32)
    s = np.array([[[100.0, 95.0], [130.0, 290.0]], [[89.5, 100.0], [95.0, 250.0]],
                  [[120.0, -3.0], [99.0, 400.0]]], np.float32)
    has = np.array([True, True, False])[:, None, None]
    rng = np.random.default_rng(7)
    o_hist = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    o_hist[2] = np.nan  # an empty history's plain softmax
    v_self = rng.standard_normal((3, 2, 1, 8)).astype(np.float32)
    got = blend(*(torch.from_numpy(a) for a in (o_hist, lse, s, v_self, has)))
    e_h, e_s = np.exp(lse.astype(np.float64)), np.exp(s.astype(np.float64))
    w_h = np.where(has, e_h / (e_h + e_s), 0.0)
    w_s = np.where(has, e_s / (e_h + e_s), 1.0)
    want = np.nan_to_num(o_hist.astype(np.float64)) * w_h[..., None] + v_self * w_s[..., None]
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    jl, js = jnp.asarray(lse[:2]), jnp.asarray(s[:2])
    assert np.isnan(np.asarray(jnp.exp(jl) / (jnp.exp(jl) + jnp.exp(js)))).any()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_decode_step_past_exp_overflow(use_kernel):
    """float32 decode steps whose fresh logits exceed 88.7: wq and wk are
    scaled by 8 and made equal, so a fresh token's logit is |q|^2 /
    sqrt(d), and each history holds earlier copies of the fresh token
    beside other tokens.  The reference's step gives NaN logits; the
    port's stay finite and match ``prefill`` over the same tokens (a dense
    softmax, max-shifted) at the dense test's 1e-5."""
    kw = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=4, dtype="float32")
    rc, tc = ref_config("minitron-4b").reduced(**kw), get_config("minitron-4b").reduced(**kw)
    tree = jax.tree.map(np.asarray, RM.init_params(rc, jax.random.PRNGKey(3)))
    attn = tree["blocks"]["attn"]
    attn["wq"] = attn["wq"] * 8.0
    attn["wk"] = attn["wq"].copy()
    tp = TM.params_from_numpy(tc, tree, "cpu")
    rp = jax.tree.map(jnp.asarray, tree)
    kv = cache(tc, n_pages=8, page_size=4, max_batch=2)
    ref = rkv.PagedKVCache(cfg=rc, n_pages=8, page_size=4, max_batch=2)
    req = np.array([1, 2])
    for r in req:
        kv.admit_request(int(r), prompt_len=0)
        ref.admit_request(int(r), prompt_len=0)
    toks = np.array([[5, 9, 5, 12, 5], [7, 3, 7, 7, 1]], np.int32)
    for t in range(toks.shape[1]):
        for r in req:
            kv.extend_request(int(r))
            ref.extend_request(int(r))
        tok = toks[:, t : t + 1]
        got, k_new, v_new = paged_decode_step(
            tc, tp, torch.from_numpy(tok), kv.k_pages, kv.v_pages, kv.resolve_tables(req, 2),
            kv.batch_seq_lens(req), use_kernel=use_kernel,
        )
        want, rk, rv = ref_step(
            rc, rp, jnp.asarray(tok), ref.k_pages, ref.v_pages, ref.resolve_tables(req, 2),
            ref.batch_seq_lens(req), use_kernel=False,
        )
        kv.append_tokens(req, k_new, v_new)
        ref.append_tokens(req, rk, rv)
        assert bool(torch.isfinite(got).all())
        assert np.isnan(np.asarray(want)).any() == (t > 0)
        dense = prefill(tc, tp, torch.from_numpy(toks[:, : t + 1]))[:, -1]
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5, rtol=1e-5)
