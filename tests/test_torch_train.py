"""The port's training path (``models/model.py::loss_fn`` / ``chunked_ce``,
``train/optimizer.py``, ``train/train_step.py``, ``data/pipeline.py``)
against the reference's on the CPU, float32, inputs from numpy with a seed
and parameters carried across by ``params_from_numpy``.

Tolerances, each with what was measured:

* ``loss_fn`` on reduced minitron-4b, granite-moe-1b-a400m,
  falcon-mamba-7b, minicpm3-4b (MLA) and whisper-small (2 layers; whisper's
  2 encoder layers over 48 frames of ``enc_emb`` from the batch's seed)
  and zamba2-2.7b (4 Mamba layers, the shared block after every 2), three
  cross-entropy chunks, ignored labels: the loss within 1e-5 relative
  (measured 1e-7; 0 for the SSM models, minicpm3-4b and whisper-small),
  every leaf's gradient within 1e-4 x that leaf's RMS (measured up to
  1.5e-5, minicpm3-4b 1.4e-5, whisper-small 1.2e-5, zamba2-2.7b's
  ``A_log`` 3.9e-5: sums in another order through attention, the MoE
  combine, the scan's backward and the head);
* ``adamw_update`` over three steps with clipping, the chunked update and
  bf16 and f32 moments: parameters within 1e-6 x their largest magnitude
  (measured 4e-10); f32 moments within 1e-6 relative (measured 2e-7: XLA
  fuses some multiply-adds, queue 3 entry 2), bf16 moments within one bf16
  step of each element (measured equal); the schedule bit for bit;
* ``make_train_step`` with 1 and 2 microbatches over two steps, and one
  step of reduced zamba2-2.7b: the losses within 1e-5 relative, the
  parameters within 5% of the peak learning rate (an Adam step moves an
  element by about the learning rate; measured 1.4%).

``remat=True`` gives the same gradients as ``remat=False`` bit for bit,
and the token pipeline's batches equal the reference's bit for bit."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.data import pipeline as RP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import train_step as RT  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402

NAMES = ["minitron-4b", "granite-moe-1b-a400m", "falcon-mamba-7b", "zamba2-2.7b", "minicpm3-4b",
         "whisper-small"]
FRAMES = 48  # whisper-small's source frames (the reduced config holds 64)
CE_CHUNK = 8  # three chunks of the 24 positions


def configs(name, **more):
    """Reduced configs: 2 layers, but the hybrid's own reduction (4 layers,
    the shared block after every 2)."""
    kw = dict(d_model=64, n_heads=4, dtype="float32", **more)
    if not ref_config(name).hybrid_attn_every:
        kw["n_layers"] = 2
    if name == "minitron-4b":
        kw["n_kv_heads"] = 2
    return ref_config(name).reduced(**kw), get_config(name).reduced(**kw)


def batch_of(vocab, b, s, seed, frames=0, width=0):
    """Tokens and labels; with ``frames``, an encoder-decoder's frame
    embeddings ``enc_emb`` [b, frames, width] f32 from the same seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    labels[0, 3] = -100
    out = {"tokens": toks, "labels": labels}
    if frames:
        out["enc_emb"] = (0.02 * rng.standard_normal((b, frames, width))).astype(np.float32)
    return out


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaf_pairs(ref_tree, port_tree, path=""):
    for k, v in ref_tree.items():
        if isinstance(v, dict):
            yield from leaf_pairs(v, port_tree[k], f"{path}{k}.")
        else:
            yield f"{path}{k}", np.asarray(v), port_tree[k]


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's loss, metrics and gradients (jitted once) and the
    inputs, shared by the tests of one config."""
    rc, tc = configs(name)
    rp = RM.init_params(rc, jax.random.PRNGKey(0))
    frames = dict(frames=FRAMES, width=rc.d_model) if rc.encdec else {}
    batch = batch_of(rc.vocab, 2, 24, seed=1, **frames)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(rc, p, b, ce_chunk=CE_CHUNK), has_aux=True
    ))
    (loss, metrics), grads = fn(rp, jax.tree.map(jnp.asarray, batch))
    host = jax.tree.map(np.asarray, rp)
    return tc, host, batch, float(loss), jax.tree.map(np.asarray, metrics), jax.tree.map(
        np.asarray, grads
    )


def port_grads(tc, host, batch, monkeypatch):
    monkeypatch.setattr(TM, "loss_fn", functools.partial(TM.loss_fn, ce_chunk=CE_CHUNK))
    params = TM.params_from_numpy(tc, host, "cpu")
    return TT.loss_and_grads(tc, params, tensors(batch))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name, monkeypatch):
    tc, host, batch, want, want_metrics, want_grads = reference(name)
    loss, metrics, grads = port_grads(tc, host, batch, monkeypatch)
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    for k in ("ce", "moe_aux"):
        assert abs(float(metrics[k]) - float(want_metrics[k])) <= 1e-5 * max(
            1.0, abs(float(want_metrics[k]))
        )
    assert int(metrics["tokens"]) == int(want_metrics["tokens"]) == 45
    if tc.moe:
        assert float(metrics["moe_aux"]) > 0
    for path, w, g in leaf_pairs(want_grads, grads):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
        rms = float(np.sqrt(np.mean(w.astype(np.float64) ** 2)))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * rms, (path, err, rms)


@pytest.mark.parametrize("name", NAMES)
def test_remat_gives_the_same_gradients(name, monkeypatch):
    """Checkpointing every block (the recompute runs the same operations)
    changes no bit of the loss or of any gradient."""
    tc, host, batch, *_ = reference(name)
    plain = port_grads(tc, host, batch, monkeypatch)
    remat = port_grads(dataclasses.replace(tc, remat=True), host, batch, monkeypatch)
    assert torch.equal(plain[0], remat[0])
    for (path, a), (_, b) in zip(port_leaves(plain[2]), port_leaves(remat[2])):
        assert torch.equal(a, b), path


def port_leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from port_leaves(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", v


def test_remat_checkpoints_every_block(monkeypatch):
    """With ``remat`` each layer's block runs once more in the backward."""
    tc, host, batch, *_ = reference("minitron-4b")
    calls = []
    real = TM._apply_block

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TM, "_apply_block", counted)
    port_grads(tc, host, batch, monkeypatch)
    assert len(calls) == tc.n_layers
    calls.clear()
    port_grads(dataclasses.replace(tc, remat=True), host, batch, monkeypatch)
    assert len(calls) == 2 * tc.n_layers


def optimizer_case():
    rng = np.random.default_rng(5)
    shapes = {"w": (5, 9), "norm": (7,), "blocks": {"wi": (3, 4, 6), "scale": (3, 10)},
              "one": (1, 4, 4)}

    def make(f, tree=shapes):
        return {k: make(f, v) if isinstance(v, dict) else f(v) for k, v in tree.items()}

    params = make(lambda s: rng.standard_normal(s).astype(np.float32))
    # gradients of global norm about 40, so clip_norm 1.0 scales them
    grads = [make(lambda s: (3 * rng.standard_normal(s)).astype(np.float32)) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float32"])
def test_adamw_update_matches_reference(moment_dtype, monkeypatch):
    """Three steps through warm-up and the cosine, clipped, with pieces of
    at most 8 elements (``CHUNK``): layer slices and row chunks."""
    monkeypatch.setattr(TO, "CHUNK", 8)
    params, grads = optimizer_case()
    kw = dict(warmup_steps=2, total_steps=5, moment_dtype=moment_dtype)
    rcfg, tcfg = RO.OptConfig(**kw), TO.OptConfig(**kw)
    rp = jax.tree.map(jnp.asarray, params)
    rs = RO.init_opt_state(rp, rcfg)
    tp = TO.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = TO.init_opt_state(tp, tcfg)
    update = jax.jit(lambda p, g, s: RO.adamw_update(rcfg, p, g, s))
    for i in range(3):
        rp, rs, rm = update(rp, jax.tree.map(jnp.asarray, grads[i]), rs)
        got_p, ts, tm = TO.adamw_update(tcfg, tp, TO.tree_map(torch.from_numpy, grads[i]), ts)
        assert got_p is tp and ts.step == i + 1
        assert float(tm["lr"]) == float(rm["lr"])
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-6 * float(rm["grad_norm"])
        assert float(rm["grad_norm"]) > 30  # clipping scales the update
        for path, w, g in leaf_pairs(rp, tp):
            assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max(), path
        for tree_r, tree_t in ((rs.mu, ts.mu), (rs.nu, ts.nu)):
            for path, w, g in leaf_pairs(tree_r, tree_t):
                assert g.dtype == getattr(torch, moment_dtype), path
                w, g = w.astype(np.float32), g.float().numpy()
                if moment_dtype == "bfloat16":
                    assert (np.abs(g - w) <= np.abs(w) * 2.0**-8).all(), path
                else:
                    assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), path


def test_schedule_matches_reference():
    kw = dict(warmup_steps=3, total_steps=11)
    rcfg, tcfg = RO.OptConfig(**kw), TO.OptConfig(**kw)
    for step in (0, 1, 2, 3, 4, 7, 10, 11, 20):
        want = float(RO.schedule(rcfg, jnp.asarray(step, jnp.int32)))
        assert float(TO.schedule(tcfg, step)) == want, step


def test_compress_int8_matches_reference():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((5, 7)).astype(np.float32)
    err = (0.01 * rng.standard_normal((5, 7))).astype(np.float32)
    want = RO.compress_int8(jnp.asarray(g), jnp.asarray(err))
    got = TO.compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert got[0].dtype == torch.int8
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert float(got[1]) == float(want[1])
    assert np.abs(got[2].numpy() - np.asarray(want[2])).max() <= 1e-7
    back = TO.decompress_int8(got[0], got[1]).numpy()
    assert np.array_equal(back, np.asarray(RO.decompress_int8(want[0], want[1])))


@functools.lru_cache(maxsize=None)
def reference_steps(microbatches, name="minitron-4b", steps=2):
    """``steps`` reference train steps (jitted) from one init: their
    metrics and parameters after each step."""
    rc, _ = configs(name)
    rp = RM.init_params(rc, jax.random.PRNGKey(0))
    ocfg = RO.OptConfig(warmup_steps=1, total_steps=4)
    step = jax.jit(RT.make_train_step(rc, ocfg, microbatches=microbatches))
    state = RO.init_opt_state(rp, ocfg)
    out, host0 = [], jax.tree.map(np.asarray, rp)
    for i in range(steps):
        rp, state, m = step(rp, state, jax.tree.map(jnp.asarray, batch_of(rc.vocab, 4, 16, i)))
        out.append((jax.tree.map(float, m), jax.tree.map(np.asarray, rp)))
    return host0, out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    check_train_steps("minitron-4b", microbatches, 2)


def test_ssm_train_step_matches_reference():
    """One step of reduced zamba2-2.7b: Mamba layers (the scan's backward)
    and the shared attention block, AdamW on its f32 leaves (``A_log``,
    ``dt_bias``, ``D_skip``) as on the others."""
    check_train_steps("zamba2-2.7b", 1, 1)


def check_train_steps(name, microbatches, steps):
    _, tc = configs(name)
    host0, want = reference_steps(microbatches, name, steps)
    ocfg = TO.OptConfig(warmup_steps=1, total_steps=4)
    params = TM.params_from_numpy(tc, host0, "cpu")
    state = TO.init_opt_state(params, ocfg)
    step = TT.make_train_step(tc, ocfg, microbatches=microbatches)
    for i, (wm, wp) in enumerate(want):
        params, state, m = step(params, state, tensors(batch_of(tc.vocab, 4, 16, i)))
        assert set(m) == set(wm)
        assert abs(float(m["loss"]) - wm["loss"]) <= 1e-5 * abs(wm["loss"])
        assert float(m["lr"]) == wm["lr"]
        for path, w, g in leaf_pairs(wp, params):
            assert np.abs(g.numpy() - w).max() <= 0.05 * ocfg.lr, path


def test_microbatches_must_divide_the_batch():
    _, tc = configs("minitron-4b")
    params = TM.init_params(tc, 0, device="cpu")
    step = TT.make_train_step(tc, TO.OptConfig(), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, TO.init_opt_state(params, TO.OptConfig()), tensors(batch_of(tc.vocab, 4, 8, 0)))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_token_pipeline_matches_reference(n_shards):
    """Every shard's batches, bit for bit, over three steps; a snapshot
    restored replays them; a reshard keeps the step."""
    rc, tc = configs("minitron-4b")
    for shard in range(n_shards):
        ref = RP.TokenPipeline(rc, global_batch=4, seq_len=32, seed=7, n_shards=n_shards,
                               shard=shard)
        port = TP.TokenPipeline(tc, global_batch=4, seq_len=32, seed=7, n_shards=n_shards,
                                shard=shard)
        snap = port.snapshot()
        got = [port.next_batch() for _ in range(3)]
        for g in got:
            w = ref.next_batch()
            assert set(g) == set(w) == {"tokens", "labels"}
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["tokens"].shape == (4 // n_shards, 32)
        port.restore(snap)
        for g in got:
            again = port.next_batch()
            assert all(np.array_equal(again[k], g[k]) for k in g)
        moved = port.reshard(2 * n_shards, 0)
        assert moved.state.step == 3 and moved.local_batch == 4 // (2 * n_shards)
        want = ref.reshard(2 * n_shards, 0).next_batch()
        assert np.array_equal(moved.next_batch()["tokens"], want["tokens"])


def test_token_pipeline_frames_and_device_move():
    """An encoder-decoder config's batches carry the reference's frames;
    ``to_device`` gives int32 tokens and frames in the model's dtype."""
    rc = ref_config("whisper-small").reduced()
    tc = get_config("whisper-small").reduced(dtype="bfloat16")
    got = TP.TokenPipeline(tc, global_batch=2, seq_len=8, seed=3).next_batch()
    want = RP.TokenPipeline(rc, global_batch=2, seq_len=8, seed=3).next_batch()
    assert np.array_equal(got["enc_emb"], want["enc_emb"])
    moved = TP.to_device(got, tc, "cpu")
    assert moved["tokens"].dtype == torch.int32 and moved["enc_emb"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="split"):
        TP.TokenPipeline(tc, global_batch=3, seq_len=8, n_shards=2)


def test_ssm_training_is_refused():
    """No longer refused: a reduced falcon-mamba-7b's loss reaches
    ``mamba_scan``, whose backward (``MambaScan``) carries the gradient to
    every leaf, finite and not all zero (a gradient cut at the scan would
    leave ``A_log``, ``dt_proj``, ``dt_bias`` and the layers below at
    zero)."""
    tc = get_config("falcon-mamba-7b").reduced(dtype="float32")
    params = TM.init_params(tc, 0, device="cpu")
    loss, _, grads = TT.loss_and_grads(tc, params, tensors(batch_of(tc.vocab, 1, 40, 0)))
    assert bool(torch.isfinite(loss))
    names = [path for path, _ in port_leaves(grads)]
    assert "blocks.ssm.A_log" in names and "blocks.ssm.dt_bias" in names
    for path, g in port_leaves(grads):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
