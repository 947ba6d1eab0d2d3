"""The port's dense decoder (``repro_torch.models.model``) against the
reference's (``repro.models.model``): ``forward`` and ``decode_step`` on
reduced minitron-4b, qwen1.5-110b (QKV bias), chameleon-34b (QK-norm),
granite-moe-1b-a400m (top-2 of 4 experts) and grok-1-314b (top-2 of 8),
parameters made by the reference's ``init_params`` and carried across by
``params_from_numpy``, tokens made with numpy from a seed.

Tolerances on the logits: float32 1e-5 (measured about 6e-7); bfloat16
2e-2 (measured about 1e-2 over two layers: bf16 roundings where the sums run
in another order, and the reference's ``sdpa`` rounds its probabilities to
bf16 where the port's kernel does not), the tolerance of the reference's own
paged-vs-dense test.

The MoE models' reduced configs have a capacity factor of 8.0, so no pair
is dropped and tokens do not compete for slots.  Every MoE block's top-k
choices are recorded on both sides.  In float32 they must all agree, and the
aux loss is held at 1e-5.  In bf16 a choice flips where two probabilities
nearly tie (the attention's roundings differ by design), and a flip moves
its token's output by its gate times the difference of two experts'
outputs, far beyond any rounding; the logits are held at the positions no
flip reaches (a position sees only its own sequence's earlier tokens), at
least a quarter of them, and a failure reports the routing agreement
(measured: 0.91-1.0 of (token, layer) choices, clean positions within
about 6e-3)."""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NAMES = ["minitron-4b", "qwen1.5-110b", "chameleon-34b",
         "granite-moe-1b-a400m", "grok-1-314b"]


def setup(name, dtype, seed=0):
    kw = dict(n_layers=2, d_model=64, n_heads=4, dtype=dtype)
    if name == "minitron-4b":
        kw["n_kv_heads"] = 2
    if name == "grok-1-314b":
        kw["n_experts"] = 8
    rc, tc = ref_config(name).reduced(**kw), get_config(name).reduced(**kw)
    rp = RM.init_params(rc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # nonzero biases and norm scales, so those branches do something
    attn = rp["blocks"]["attn"]
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in attn:
            attn[key] = jnp.asarray(
                1 + 0.3 * rng.standard_normal(attn[key].shape), attn[key].dtype
            )
    tp = TM.params_from_numpy(tc, jax.tree.map(np.asarray, rp), "cpu")
    return rc, tc, rp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name, dtype, monkeypatch):
    rc, tc, rp, tp = setup(name, dtype)
    toks = np.random.default_rng(1).integers(0, rc.vocab, size=(2, 24)).astype(np.int32)
    ref_log, port_log = [], []
    with recorded_routing(monkeypatch, ref_log, port_log):
        want, want_aux = RM.forward(rc, rp, jnp.asarray(toks))
        jax.effects_barrier()
        got, aux = TM.forward(tc, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 24, rc.vocab)
    if not tc.moe:
        assert float(aux) == 0.0 and not port_log
        return check_logits(got, want, dtype)
    clean, agreement = clean_positions(ref_log, port_log, toks.shape)
    assert len(port_log) == tc.n_layers
    if dtype == "float32":
        assert agreement == 1.0
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL[dtype])
    check_logits(got, want, dtype, clean, agreement)


@contextlib.contextmanager
def recorded_routing(monkeypatch, ref_log, port_log):
    """Within the block, every MoE block call of the reference and of the
    port appends its top-k choices ([T, k], tokens in order) to ``ref_log``
    and ``port_log``; the reference's arrive through an ordered debug
    callback from inside its layer scan."""
    from repro.models import layers as RL
    from repro_torch.models import layers as TL

    ref_block, port_block = RL.moe_block, TL.moe_block

    def ref_wrap(cfg, p, x):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"])
        _, idx = jax.lax.top_k(probs, cfg.top_k)
        jax.debug.callback(lambda i: ref_log.append(np.asarray(i)), idx, ordered=True)
        return ref_block(cfg, p, x)

    def port_wrap(cfg, p, x, **kw):
        port_log.append(TL.moe_route(cfg, p["router"], x.reshape(-1, x.shape[-1]))[1].numpy())
        return port_block(cfg, p, x, **kw)

    monkeypatch.setattr(RL, "moe_block", ref_wrap)
    monkeypatch.setattr(TL, "moe_block", port_wrap)
    yield
    monkeypatch.setattr(RL, "moe_block", ref_block)
    monkeypatch.setattr(TL, "moe_block", port_block)


def clean_positions(ref_log, port_log, shape):
    """``(clean [B, S], agreement)``: a sequence's position is clean when no
    MoE block's choice differed between the two for any of its tokens up to
    it (its logits depend on nothing else: with the reduced configs' ample
    capacity no pair is dropped, so tokens do not compete); ``agreement`` is
    the share of (token, layer) top-k sets that are equal.  Each log entry
    is one block call over ``shape`` [B, S] tokens, or over [B] tokens of
    one decode step (the calls of a step are consecutive)."""
    assert len(ref_log) == len(port_log) and ref_log
    same = np.stack([
        (np.sort(r, -1) == np.sort(g, -1)).all(-1) for r, g in zip(ref_log, port_log)
    ])  # [calls, tokens]
    b, s = shape
    if same.shape[1] == b * s:  # forward: one call a layer
        ok = same.reshape(-1, b, s).all(0)
    else:  # decode: layers x steps calls of b tokens, step-major
        ok = same.reshape(s, -1, b).all(1).T
    return np.cumprod(ok, axis=1).astype(bool), float(same.mean())


def check_logits(got, want, dtype, clean=None, agreement=1.0):
    """Logits within ``TOL``; in bf16 an MoE model is held at its clean
    positions only, at least a quarter of them, and a failure reports the
    routing agreement."""
    got, want = got.numpy(), np.asarray(want)
    if clean is not None and dtype == "bfloat16":
        assert clean.mean() >= 0.25, f"routing agreement {agreement:.4f}"
        got, want = got[clean], want[clean]
    np.testing.assert_allclose(
        got, want, atol=TOL[dtype], rtol=TOL[dtype], err_msg=f"routing agreement {agreement:.4f}"
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name, dtype, monkeypatch):
    rc, tc, rp, tp = setup(name, dtype, seed=2)
    b, steps = 2, 8
    toks = np.random.default_rng(3).integers(0, rc.vocab, size=(b, steps)).astype(np.int32)
    rcache = RM.init_decode_cache(rc, b, max_len=steps)
    tcache = TM.init_decode_cache(tc, b, max_len=steps, device="cpu")
    wants, gots, ref_log, port_log = [], [], [], []
    with recorded_routing(monkeypatch, ref_log, port_log):
        # jitted inside the block, so its trace holds this test's recorder:
        # traced once for the 8 steps, where unjitted each step retraces
        # the layer scan
        ref_step = jax.jit(RM.decode_step, static_argnums=0)
        for t in range(steps):
            want, rcache = ref_step(
                rc, rp, jnp.asarray(toks[:, t : t + 1]), rcache, jnp.int32(t)
            )
            jax.effects_barrier()
            got, tcache = TM.decode_step(
                tc, tp, torch.from_numpy(toks[:, t : t + 1]), tcache, t
            )
            wants.append(np.asarray(want))
            gots.append(got)
    got, want = torch.stack(gots, 1), np.stack(wants, 1)  # [B, steps, V]
    if tc.moe:
        clean, agreement = clean_positions(ref_log, port_log, toks.shape)
        assert dtype == "bfloat16" or agreement == 1.0
        check_logits(got, want, dtype, clean, agreement)
    else:
        check_logits(got, want, dtype)
    # the caches: every layer in f32; in bf16 the first layer, whose inputs
    # are the same embeddings in both (deeper layers' keys carry the
    # activations' bf16 differences through QK-norm, beyond one rounding)
    depth = slice(None) if dtype == "float32" else slice(0, 1)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key][depth].float().numpy(),
            np.asarray(rcache[key], np.float32)[depth],
            atol=TOL[dtype], rtol=TOL[dtype],
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_for_bit(dtype):
    _, tc, rp, _ = setup("qwen1.5-110b", dtype)
    tree = jax.tree.map(np.asarray, rp)
    back = TM.params_to_numpy(TM.params_from_numpy(tc, tree, "cpu"))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {k for k, _ in flat}
    for path, want in flat:
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got[path].dtype == want.dtype, path
        np.testing.assert_array_equal(got[path], want)


@pytest.mark.parametrize("name", NAMES)
def test_init_params_has_the_reference_tree(name):
    """Every leaf bf16 but an MoE block's router, which is f32 in both."""
    rc, tc, rp, _ = setup(name, "bfloat16")
    tp = TM.init_params(tc, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        f32 = key.endswith("['router']")
        assert got[key].dtype == (torch.float32 if f32 else torch.bfloat16), key
        assert w.dtype == (np.float32 if f32 else jnp.bfloat16), key
    # the reference's scales: N(0, 1/sqrt(d)) projections, N(0, 0.02) embed
    wq = tp["blocks"]["attn"]["wq"].float()
    assert abs(wq.std().item() * np.sqrt(tc.d_model) - 1) < 0.1
    assert abs(tp["embed"].float().std().item() / 0.02 - 1) < 0.1


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_inits_the_reference_tree(name):
    """Every family is served: each reduced config's ``init_params`` gives
    the reference's parameter tree (traced by ``jax.eval_shape``, nothing
    drawn), key for key, with its shapes and dtypes."""
    rc, tc = ref_config(name).reduced(), get_config(name).reduced()
    assert tc.name == name and tc == dataclasses.replace(tc, **dataclasses.asdict(rc))
    rp = jax.eval_shape(lambda k: RM.init_params(rc, k), jax.random.PRNGKey(0))
    tp = TM.init_params(tc, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == getattr(torch, w.dtype.name), key
