"""The port's dense decoder (``repro_torch.models.model``) against the
reference's (``repro.models.model``): ``forward`` and ``decode_step`` on
reduced minitron-4b, qwen1.5-110b (QKV bias) and chameleon-34b (QK-norm),
parameters made by the reference's ``init_params`` and carried across by
``params_from_numpy``, tokens made with numpy from a seed.

Tolerances on the logits: float32 1e-5 (measured about 6e-7); bfloat16
2e-2 (measured about 1e-2 over two layers: bf16 roundings where the sums run
in another order, and the reference's ``sdpa`` rounds its probabilities to
bf16 where the port's kernel does not), the tolerance of the reference's own
paged-vs-dense test."""

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
NAMES = ["minitron-4b", "qwen1.5-110b", "chameleon-34b"]


def setup(name, dtype, seed=0):
    kw = dict(n_layers=2, d_model=64, n_heads=4, dtype=dtype)
    if name == "minitron-4b":
        kw["n_kv_heads"] = 2
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
def test_forward_matches_reference(name, dtype):
    rc, tc, rp, tp = setup(name, dtype)
    toks = np.random.default_rng(1).integers(0, rc.vocab, size=(2, 24)).astype(np.int32)
    want, _ = RM.forward(rc, rp, jnp.asarray(toks))
    got, aux = TM.forward(tc, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 24, rc.vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=TOL[dtype], rtol=TOL[dtype]
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name, dtype):
    rc, tc, rp, tp = setup(name, dtype, seed=2)
    b, steps = 2, 8
    toks = np.random.default_rng(3).integers(0, rc.vocab, size=(b, steps)).astype(np.int32)
    rcache = RM.init_decode_cache(rc, b, max_len=steps)
    tcache = TM.init_decode_cache(tc, b, max_len=steps, device="cpu")
    for t in range(steps):
        want, rcache = RM.decode_step(
            rc, rp, jnp.asarray(toks[:, t : t + 1]), rcache, jnp.int32(t)
        )
        got, tcache = TM.decode_step(tc, tp, torch.from_numpy(toks[:, t : t + 1]), tcache, t)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=TOL[dtype], rtol=TOL[dtype]
        )
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
    rc, tc, rp, _ = setup(name, "bfloat16")
    tp = TM.init_params(tc, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == torch.bfloat16, key
    # the reference's scales: N(0, 1/sqrt(d)) projections, N(0, 0.02) embed
    wq = tp["blocks"]["attn"]["wq"].float()
    assert abs(wq.std().item() * np.sqrt(tc.d_model) - 1) < 0.1
    assert abs(tp["embed"].float().std().item() / 0.02 - 1) < 0.1


@pytest.mark.parametrize(
    "name",
    sorted(
        set(ARCHS)
        - {"minitron-4b", "qwen1.5-110b", "chameleon-34b", "llama3-405b",
           "falcon-mamba-7b", "zamba2-2.7b"}
    ),
)
def test_other_families_resolve_then_raise(name):
    cfg = get_config(name)
    assert cfg.name == name
    with pytest.raises(NotImplementedError, match="slice"):
        TM.init_params(cfg.reduced(), seed=0, device="cpu")
