"""The port's MoE block (``repro_torch.models.layers.moe_block``) against the
reference's (``repro.models.layers.moe_block``) on the same numpy inputs,
parameters made by the reference's ``init_moe`` and carried across by
``params_from_numpy``: reduced granite-moe-1b-a400m (top-2 of 4 experts)
and reduced grok-1-314b (top-2 of 8), with ample capacity (factor 8.0, no
pair dropped), at the served factor 1.25 (pairs dropped), with the router
biased so that one expert's queue overflows, and over more than 8,192
tokens, where both dispatch in chunks.

The routing is compared exactly: the port's top-k choices equal
``lax.top_k`` of the reference's probabilities, ties going to the lower
expert.  Tolerances on the output: float32 1e-5 (the same casts, sums in
another order); bfloat16 2e-2 at most anywhere (the expert products' f32
sums are rounded to bf16 once, before the second product, and a rounding
can differ where the orders differ) and an RMS difference of at most 1e-3 x
the reference's RMS.  That limit tells the rounding orders apart: over 18
bf16 readings (both models, factors 8.0 and 1.25, an overflowing expert,
three input seeds) the port's RMS difference was at most 3.3e-4 x RMS (0 to
11 of 3,072 outputs differ), while rounding the first product's result to
bf16 before silu * up (``mlp``'s order) gave at least 3.4e-3 x RMS (1,300 or
more differ); ``test_moe_block_bf16_limit_rejects_mlps_rounding_order``
holds that control to it.  The aux loss: 1e-6, an f32 mean of the same
numbers."""

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
RMS_TOL = 1e-3  # bf16: RMS of the difference over the reference's RMS
DTYPES = ["float32", "bfloat16"]
NAMES = ["granite-moe-1b-a400m", "grok-1-314b"]


def cfgs(name, dtype, **kw):
    kw = dict(n_layers=2, d_model=64, n_heads=4, dtype=dtype, **kw)
    if name == "grok-1-314b":
        kw.setdefault("n_experts", 8)
    return ref_config(name).reduced(**kw), get_config(name).reduced(**kw)


def moe_params(rc, tc, seed=0, bias=0.0):
    """The reference's MoE leaves and the port's copy; ``bias`` is added to
    the router's column of expert 0."""
    p = jax.tree.map(np.asarray, RL.init_moe(rc, jax.random.PRNGKey(seed)))
    p["router"] = p["router"].copy()
    p["router"][:, 0] += bias
    return jax.tree.map(jnp.asarray, p), TM.params_from_numpy(tc, p, "cpu")


def tokens(shape, dtype, seed=1, shift=0.0):
    """One numpy draw as a reference array and a port tensor, in dtype (bf16
    carried bit for bit)."""
    j = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) + shift, dtype)
    h = np.asarray(j)
    if h.dtype.name == "bfloat16":
        return j, torch.from_numpy(h.view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(h.copy())


def dropped(tc, tp, tx):
    """Pairs the port drops over one dispatch of ``tx`` [B, S, D], and
    whether its routing equals ``lax.top_k`` of the reference's
    probabilities."""
    xt = tx.reshape(-1, tx.shape[-1])
    probs, idx, _ = TL.moe_route(tc, tp["router"], xt)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), tc.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    keep = TL.moe_queue(idx, TL.moe_capacity(tc, xt.shape[0]))[3]
    return int((~keep).sum())


def rms_ratio(got, want):
    """RMS of ``got - want`` over the RMS of ``want``."""
    d = got.float().numpy().astype(np.float64) - np.asarray(want, np.float64)
    return float(np.sqrt((d**2).mean() / (np.asarray(want, np.float64) ** 2).mean()))


def close(got, aux, want, want_aux, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype]
    )
    if dtype == "bfloat16":
        assert rms_ratio(got, want) <= RMS_TOL, rms_ratio(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=1e-6)


def check(rc, tc, rp, tp, x, tx, dtype):
    want, want_aux = RL.moe_block(rc, rp, x)
    got, aux = TL.moe_block(tc, tp, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    close(got, aux, want, want_aux, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_moe_block_matches_reference(name, dtype, factor):
    """Inputs with a mean of 1, so the router favours some experts (at 0
    the loads are too even for the served factor to drop a pair)."""
    rc, tc = cfgs(name, dtype, moe_capacity_factor=factor)
    rp, tp = moe_params(rc, tc)
    x, tx = tokens((2, 24, 64), dtype, shift=1.0)
    n = dropped(tc, tp, tx)
    assert (n > 0) == (factor < 2), n  # the served factor drops pairs here
    check(rc, tc, rp, tp, x, tx, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_moe_block_matches_reference_with_an_expert_overflowing(name, dtype):
    """Expert 0 is every token's first choice, so its queue overflows and
    every pair past its capacity is dropped, in token order."""
    rc, tc = cfgs(name, dtype, moe_capacity_factor=1.25)
    rp, tp = moe_params(rc, tc, bias=0.5)
    x, tx = tokens((2, 24, 64), dtype, shift=1.0)
    xt = tx.reshape(-1, 64)
    _, idx, _ = TL.moe_route(tc, tp["router"], xt)
    assert bool((idx[:, 0] == 0).all())
    assert dropped(tc, tp, tx) >= 48 - TL.moe_capacity(tc, 48)
    check(rc, tc, rp, tp, x, tx, dtype)


@pytest.mark.parametrize("name", NAMES)
def test_moe_block_bf16_limit_rejects_mlps_rounding_order(name, monkeypatch):
    """The control: the first expert product's result rounded to bf16
    before silu * up, as ``mlp`` rounds ``h``, fails the RMS limit that the
    port passes on the same inputs."""
    rc, tc = cfgs(name, "bfloat16", moe_capacity_factor=1.25)
    rp, tp = moe_params(rc, tc)
    x, tx = tokens((2, 24, 64), "bfloat16", shift=1.0)
    want, _ = RL.moe_block(rc, rp, x)
    got, _ = TL.moe_block(tc, tp, tx)
    assert rms_ratio(got, want) <= RMS_TOL
    bmm = TL._bmm_f32

    def rounded_first(a, b):
        out = bmm(a, b)
        return out.to(torch.bfloat16).float() if b is tp["wi"] else out

    monkeypatch.setattr(TL, "_bmm_f32", rounded_first)
    wrong, _ = TL.moe_block(tc, tp, tx)
    assert rms_ratio(wrong, want) > 3 * RMS_TOL, rms_ratio(wrong, want)


@pytest.mark.parametrize("full_chunk", [False, True])
def test_moe_block_chunked_matches_reference(full_chunk, monkeypatch):
    """2 x 4,608 tokens: ``moe_block`` dispatches two chunks of 4,608 (the
    chunk is cut down from 8,192 until it divides the tokens), each with its
    own capacity, as the reference does; with the reference's
    ``MOE_FULL_CHUNK`` set it makes one dispatch over all of them, which the
    port's ``_moe_chunk`` over every token matches.  The two differ: the
    chunking decides which pairs are dropped."""
    monkeypatch.setattr(RL, "MOE_FULL_CHUNK", full_chunk)
    rc, tc = cfgs("granite-moe-1b-a400m", "float32", moe_capacity_factor=1.0)
    rp, tp = moe_params(rc, tc, seed=3)
    x, tx = tokens((2, 4608, 64), "float32", seed=4)
    want, want_aux = RL.moe_block(rc, rp, x)
    whole, whole_aux = TL._moe_chunk(tc, tp, tx.reshape(-1, 64))
    chunked, chunked_aux = TL.moe_block(tc, tp, tx)
    if full_chunk:
        close(whole.reshape(tx.shape), whole_aux, want, want_aux, "float32")
    else:
        close(chunked, chunked_aux, want, want_aux, "float32")
    assert not torch.equal(chunked.reshape(-1, 64), whole)


def test_moe_block_without_aux_gives_the_same_output():
    """Serving asks for no aux loss: the output is the same, bit for bit."""
    rc, tc = cfgs("grok-1-314b", "float32", moe_capacity_factor=1.25)
    _, tp = moe_params(rc, tc)
    _, tx = tokens((2, 24, 64), "float32", shift=1.0)
    got, aux = TL.moe_block(tc, tp, tx, with_aux=False)
    want, _ = TL.moe_block(tc, tp, tx)
    assert aux is None and torch.equal(got, want)


def test_moe_route_takes_the_lower_expert_on_ties():
    _, tc = cfgs("grok-1-314b", "float32")
    router = torch.zeros((64, 8))
    router[:, 5] = 1.0
    xt = torch.ones((3, 64))
    xt[1] = 0.0  # every expert equal: experts 0 and 1
    _, idx, gates = TL.moe_route(tc, router, xt)
    assert idx.tolist() == [[5, 0], [0, 1], [5, 0]]
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_queue_is_stable_in_token_order():
    idx = torch.tensor([[2, 0], [2, 1], [0, 2], [2, 0]])
    order, expert, rank, keep = TL.moe_queue(idx, cap=2)
    assert expert.tolist() == [0, 0, 0, 1, 2, 2, 2, 2]
    assert order.tolist() == [1, 4, 7, 3, 0, 2, 5, 6]  # pairs in token order
    assert rank.tolist() == [0, 1, 2, 0, 0, 1, 2, 3]
    assert keep.tolist() == [True, True, False, True, True, True, False, False]


@pytest.mark.parametrize("name", NAMES)
def test_moe_params_round_trip_bit_for_bit(name):
    """The whole parameter tree of a bf16 model, its f32 router included."""
    from repro.models import model as RM

    dtype = "bfloat16"
    rc, tc = cfgs(name, dtype)
    tree = jax.tree.map(np.asarray, RM.init_params(rc, jax.random.PRNGKey(0)))
    assert tree["blocks"]["moe"]["router"].dtype == np.float32
    tp = TM.params_from_numpy(tc, tree, "cpu")
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"]["moe"]["wi"].dtype == getattr(torch, dtype)
    back = TM.params_to_numpy(tp)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {k for k, _ in flat}
    for path, want in flat:
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got[path].dtype == want.dtype, path
        np.testing.assert_array_equal(got[path], want)


@pytest.mark.parametrize("name", NAMES)
def test_init_moe_scales(name):
    """The port's own draw: the reference's shapes, dtypes and scales."""
    _, tc = cfgs(name, "bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = TL.init_moe(tc, gen, layers=2, device="cpu")
    e, d, f = tc.n_experts, tc.d_model, tc.expert_d_ff
    assert p["router"].shape == (2, d, e) and p["router"].dtype == torch.float32
    assert p["wi"].shape == (2, e, d, 2 * f) and p["wi"].dtype == torch.bfloat16
    assert p["wo"].shape == (2, e, f, d) and p["wo"].dtype == torch.bfloat16
    assert abs(p["wi"].float().std().item() * np.sqrt(d) - 1) < 0.1
    want = 1 / np.sqrt(f) / np.sqrt(2 * tc.n_layers)
    assert abs(p["wo"].float().std().item() / want - 1) < 0.1
