"""The port's SSM and hybrid models (``repro_torch.models``: ``init_mamba``,
``mamba_block``, ``forward``, ``decode_step``) against the reference's
(``repro.models``) on the CPU: reduced falcon-mamba-7b (2 layers, d_model
64, 8 states) and reduced zamba2-2.7b (4 Mamba layers, the shared GQA block
after every 2), parameters made by the reference's ``init_params`` and
carried across by ``params_from_numpy``, tokens made with numpy from a seed.

Tolerances: float32 1e-5 (measured at most 8.7e-7 on the logits: the
port's scan is the recurrence where the reference's is the chunked
cumulative form, the same sums in another order); bfloat16 2e-2, the
tolerance of ``tests/test_torch_model.py`` (measured 1.2e-7 on
falcon-mamba-7b's logits and 6.5e-3 on zamba2-2.7b's forward, whose shared
block's ``sdpa`` rounds its probabilities to bf16 in the reference and not
in the port's kernel)."""

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

#: the reference's forward and decode step, traced once a config and shape
#: (unjitted, each decode step retraces its layer scan)
REF_FORWARD = jax.jit(RM.forward, static_argnums=0)
REF_STEP = jax.jit(RM.decode_step, static_argnums=0)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
NAMES = ["falcon-mamba-7b", "zamba2-2.7b"]


def setup(name, dtype, seed=0, **kw):
    kw = dict(d_model=64, dtype=dtype, **kw)
    rc, tc = ref_config(name).reduced(**kw), get_config(name).reduced(**kw)
    rp = RM.init_params(rc, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(tc, jax.tree.map(np.asarray, rp), "cpu")
    return rc, tc, rp, tp


def close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
        atol=TOL[dtype], rtol=TOL[dtype],
    )


def pair(a, dtype):
    """One numpy array as a reference array and a port tensor, in dtype
    (bf16 carried bit for bit)."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    h = np.asarray(j)
    if h.dtype.name == "bfloat16":
        return j, torch.from_numpy(h.view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(h.copy())


def flat(tree):
    return {
        jax.tree_util.keystr(k): v
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_init_params_has_the_reference_tree(name, dtype):
    rc, tc, rp, _ = setup(name, dtype)
    tp = TM.init_params(tc, seed=0, device="cpu")
    want, got = flat(rp), flat(tp)
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == w.dtype.name, key
    ssm = tp["blocks"]["ssm"]
    for key in ("A_log", "dt_bias", "D_skip"):
        assert ssm[key].dtype == torch.float32
        np.testing.assert_allclose(
            ssm[key].numpy(), np.asarray(rp["blocks"]["ssm"][key]), rtol=1e-6
        )
    # the reference's scales: N(0, 1/sqrt(d)) in_proj, N(0, 0.1) conv
    d = tc.d_model
    assert abs(ssm["in_proj"].float().std().item() * np.sqrt(d) - 1) < 0.1
    assert abs(ssm["conv"].float().std().item() / 0.1 - 1) < 0.15
    assert not ssm["conv_bias"].float().any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_over_a_sequence_matches_reference(dtype):
    rc, tc, rp, tp = setup("falcon-mamba-7b", dtype)
    p_ref = jax.tree.map(lambda a: a[0], rp["blocks"]["ssm"])
    p_port = TM.layer_params(tp["blocks"]["ssm"], 0)
    x, tx = pair(np.random.default_rng(0).standard_normal((2, 24, 64)), dtype)
    want = RL.mamba_block(rc, p_ref, x)
    got = TL.mamba_block(tc, p_port, tx)
    for g, w in zip(got, want):  # out, new state, new conv state
        assert g.shape == w.shape
        close(g, w, dtype)
    assert got[1].dtype == got[2].dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_one_token_with_a_state_matches_reference(dtype):
    rc, tc, rp, tp = setup("falcon-mamba-7b", dtype, seed=1)
    p_ref = jax.tree.map(lambda a: a[1], rp["blocks"]["ssm"])
    p_port = TM.layer_params(tp["blocks"]["ssm"], 1)
    rng = np.random.default_rng(1)
    di, n = 2 * 64, rc.ssm_state
    x, tx = pair(rng.standard_normal((3, 1, 64)), dtype)
    st, tst = pair(rng.standard_normal((3, di, n)), "float32")
    cv, tcv = pair(rng.standard_normal((3, rc.ssm_conv - 1, di)), "float32")
    want = RL.mamba_block(rc, p_ref, x, ssm_state=st, conv_state=cv)
    got = TL.mamba_block(tc, p_port, tx, ssm_state=tst, conv_state=tcv)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name, dtype):
    rc, tc, rp, tp = setup(name, dtype)
    toks = np.random.default_rng(1).integers(0, rc.vocab, size=(2, 24)).astype(np.int32)
    want, _ = REF_FORWARD(rc, rp, jnp.asarray(toks))
    got, aux = TM.forward(tc, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 24, rc.vocab)
    assert float(aux) == 0.0
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name, dtype):
    rc, tc, rp, tp = setup(name, dtype, seed=2)
    b, steps = 2, 8
    toks = np.random.default_rng(3).integers(0, rc.vocab, size=(b, steps)).astype(np.int32)
    rcache = RM.init_decode_cache(rc, b, max_len=steps)
    tcache = TM.init_decode_cache(tc, b, max_len=steps, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: v.shape for k, v in rcache.items()
    }
    for t in range(steps):
        want, rcache = REF_STEP(
            rc, rp, jnp.asarray(toks[:, t : t + 1]), rcache, jnp.int32(t)
        )
        got, tcache = TM.decode_step(tc, tp, torch.from_numpy(toks[:, t : t + 1]), tcache, t)
        close(got, want, dtype)
    # the recurrent states in f32 and the first layer's in bf16 (deeper
    # layers' inputs carry the activations' bf16 differences); the shared
    # block's keys and values of its first application
    depth = slice(None) if dtype == "float32" else slice(0, 1)
    for key in ("ssm", "conv", "shared_k", "shared_v"):
        if key in rcache:
            close(tcache[key][depth], np.asarray(rcache[key], np.float32)[depth], dtype)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """Token-by-token decode (the inline recurrence) reproduces the
    teacher-forced forward (the scan), as ``tests/test_arch_smoke.py``
    checks for the reference; float32, within 1e-4."""
    _, tc, _, tp = setup(name, "float32", seed=4)
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tc.vocab, size=(b, s)))
    full, _ = TM.forward(tc, tp, toks)
    cache = TM.init_decode_cache(tc, b, max_len=s, device="cpu")
    dec = torch.stack(
        [TM.decode_step(tc, tp, toks[:, t : t + 1], cache, t)[0] for t in range(s)], 1
    )
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=1e-4, rtol=1e-4)


def test_hybrid_decode_runs_the_layers_past_the_last_group():
    """ROADMAP queue 3, entry 15: with ``n_layers % hybrid_attn_every != 0``
    the reference's forward runs the trailing Mamba layers and its
    ``decode_step`` skips them; the port's decode runs them, so it matches
    its forward (and the reference's forward)."""
    rc, tc, rp, tp = setup("zamba2-2.7b", "float32", seed=5, n_layers=5)
    b, s = 1, 6
    toks = np.random.default_rng(8).integers(0, rc.vocab, size=(b, s)).astype(np.int32)
    want, _ = REF_FORWARD(rc, rp, jnp.asarray(toks))
    rcache = RM.init_decode_cache(rc, b, max_len=s)
    tcache = TM.init_decode_cache(tc, b, max_len=s, device="cpu")
    r_dec, t_dec = [], []
    for t in range(s):
        lg, rcache = REF_STEP(rc, rp, jnp.asarray(toks[:, t : t + 1]), rcache, jnp.int32(t))
        r_dec.append(np.asarray(lg))
        t_dec.append(TM.decode_step(tc, tp, torch.from_numpy(toks[:, t : t + 1]), tcache, t)[0])
    np.testing.assert_allclose(torch.stack(t_dec, 1).numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert np.abs(np.stack(r_dec, 1) - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip_bit_for_bit(name, dtype):
    _, tc, rp, _ = setup(name, dtype)
    tree = jax.tree.map(np.asarray, rp)
    back = TM.params_to_numpy(TM.params_from_numpy(tc, tree, "cpu"))
    want, got = flat(tree), flat(back)
    assert set(got) == set(want)
    for key, w in want.items():
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w)


def test_paged_decode_refuses_an_ssm_config():
    """An SSM model's decode state has no pages: ``paged_decode_step``
    names ``decode_step`` instead of failing on a missing leaf."""
    from repro_torch.serve.serve_step import paged_decode_step

    _, tc, _, tp = setup("falcon-mamba-7b", "float32")
    with pytest.raises(ValueError, match="decode_step"):
        paged_decode_step(tc, tp, torch.zeros((1, 1), dtype=torch.long), None, None, None, None)
