"""The port's training launch plane (``train/{fault,checkpoint,sharding}.py``,
``train/optimizer.py::compressed_psum``, ``train/train_step.py::
jit_train_step``, ``launch/{mesh,train,elastic}.py``) against the
reference's on the CPU.

* Partition specs: every parameter leaf of all ten configs, the decode
  caches and the batch, at the 2x4, 16x16 and 2x16x16 meshes, equal to
  the reference's ``PartitionSpec`` entries (the reference reads an
  ``AbstractMesh``, so no 512-device mesh is built).
* Checkpoints: the reference's and the port's directories for one state
  hold the same manifest and the same ``.npy`` bytes, and each restores
  in the other package bit for bit, bf16 leaves and moments included.
* The fault classes pass the reference's own cases
  (``tests/test_train_substrate.py::TestFault``, run on the port's
  classes).
* ``compressed_psum`` equals the reference's under ``jax.vmap(...,
  axis_name="i")`` bit for bit.
* ``jit_train_step`` equals ``make_train_step`` bit for bit, and the
  reference's ``jit_train_step`` on a 1x1 mesh within
  ``tests/test_torch_train.py``'s step tolerances: the loss within 1e-5
  relative, the parameters within 5% of the peak learning rate.
* ``launch.train.train`` against the reference's through a checkpoint, a
  ``TransientError``, a ``FatalError`` and a resume in a fresh run: the
  same losses within 1e-5 relative, the same steps, the same parameters
  within 5% of the peak learning rate.
* After a ``FatalError`` both packages retry the failing step with the
  batch it drew, then draw again from the restored pipeline position
  (``ROADMAP.md`` queue 3, entry 20): the runs' parameters equal, bit for
  bit, a replay of the batch order that rule gives, and differ from the
  uninterrupted run's.
* ``scale_serving_partitions`` gives the reference's partitions and moved
  fraction; ``reshard_checkpoint`` round-trips.

Models are reduced configs in float32 on 2 x 16 tokens, one CPU thread.
"""

import contextlib
import dataclasses
import functools
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.core.partition import LogicalPartitions as RefPartitions  # noqa: E402
from repro.launch import elastic as RE  # noqa: E402
from repro.launch import train as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import fault as RF  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import sharding as RS  # noqa: E402
from repro.train import train_step as RT  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.core.partition import LogicalPartitions  # noqa: E402
from repro_torch.launch import elastic as TE  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import fault as TF  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import sharding as TS  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
ARCH = "minitron-4b"
BATCH, SEQ = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny products run ~70x faster on one thread than on eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), TMESH.make_mesh(shape, axes, "cpu")


def named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    rc = ref_config(arch)
    return jax.eval_shape(lambda: RM.init_params(rc, jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_specs_match_reference(mesh_name):
    """Every parameter leaf of all ten configs: the port's spec is the
    reference's ``PartitionSpec``, entry for entry."""
    rmesh, tmesh = meshes(mesh_name)
    sharded = 0
    for arch in sorted(ARCHS):
        shapes = ref_param_shapes(arch)
        want = RS.param_shardings(shapes, rmesh, ref_config(arch))
        got = TS.param_shardings(shapes, tmesh, get_config(arch))
        pairs = list(zip(named(want), named(got)))
        assert len(pairs) == len(list(named(shapes))), arch
        for (path, w), (path_t, g) in pairs:
            assert path == path_t
            assert g.spec == tuple(w.spec), (arch, path, g.spec, w.spec)
            assert g.mesh is tmesh and g.device == torch.device("cpu")
            sharded += any(e is not None for e in g.spec)
    assert sharded > 100


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_and_batch_specs_match_reference(mesh_name):
    rmesh, tmesh = meshes(mesh_name)
    for arch in sorted(ARCHS):
        rc, tc = ref_config(arch), get_config(arch)
        for batch in (None, 1, 64):
            want = RS.cache_shardings(rc, rmesh, batch=batch)
            got = TS.cache_shardings(tc, tmesh, batch=batch)
            assert set(got) == set(want), arch
            for k in want:
                assert got[k].spec == tuple(want[k].spec), (arch, batch, k)
    for encdec in (False, True):
        want = RS.batch_shardings(rmesh, encdec=encdec)
        got = TS.batch_shardings(tmesh, encdec=encdec)
        assert {k: v.spec for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}


def test_meshes_describe_the_reference_shapes():
    prod = TMESH.make_production_mesh(device="cpu")
    pods = TMESH.make_production_mesh(multi_pod=True, device="cpu")
    debug = TMESH.make_debug_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16}
    assert pods.axis_names == ("pod", "data", "model") and pods.sizes == (2, 16, 16)
    assert debug.shape == {"data": 2, "model": 4} and debug.device == torch.device("cpu")
    with pytest.raises(ValueError, match="do not match"):
        TMESH.make_mesh((2, 2), ("data",), "cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def ckpt_state(seed=0):
    """A reduced bf16 model's parameters with bf16 moments and an f32 leaf,
    as the reference's tree (``OptState.step`` an int32 scalar) and the
    port's (``step`` an int)."""
    rc = ref_config(ARCH).reduced()
    rp = RM.init_params(rc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def moment(p):
        return jnp.asarray(rng.standard_normal(p.shape).astype(ml_dtypes.bfloat16))

    mu, nu = jax.tree.map(moment, rp), jax.tree.map(moment, rp)
    rp = dict(rp, extra_f32=jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32)))
    ref = (rp, RO.OptState(mu=mu, nu=nu, step=jnp.asarray(7, jnp.int32)))

    def port(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    tree = jax.tree.map(port, (rp, mu, nu))
    return ref, (tree[0], TO.OptState(mu=tree[1], nu=tree[2], step=7))


def bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def assert_trees_equal(ref_tree, port_tree):
    want = RC._flatten_with_paths(ref_tree)
    got = TC._flatten_with_paths(port_tree)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        if isinstance(g, int):
            assert g == int(w), path
            continue
        gb, wb = bits(g), bits(w)
        assert gb.dtype == wb.dtype and np.array_equal(gb, wb), path


def test_checkpoint_layout_is_the_reference_bytes(tmp_path):
    """One state saved by both packages: the same manifest, and every
    array file byte for byte."""
    ref, port = ckpt_state()
    a = RC.CheckpointManager(str(tmp_path / "ref")).save(3, ref, extra={"pipeline": {"step": 3}})
    b = TC.CheckpointManager(str(tmp_path / "port")).save(3, port, extra={"pipeline": {"step": 3}})
    assert os.path.basename(a) == os.path.basename(b) == "step_00000003"
    with open(os.path.join(a, "manifest.json")) as f, open(os.path.join(b, "manifest.json")) as g:
        ma, mb = json.load(f), json.load(g)
    assert ma == mb
    assert {leaf["dtype"] for leaf in mb["leaves"]} == {"bfloat16", "float32", "int32"}
    for leaf in ma["leaves"]:
        with open(os.path.join(a, "arrays", leaf["file"]), "rb") as f:
            with open(os.path.join(b, "arrays", leaf["file"]), "rb") as g:
                assert f.read() == g.read(), leaf["path"]


def test_reference_checkpoint_restores_in_port(tmp_path):
    ref, port = ckpt_state(seed=1)
    RC.CheckpointManager(str(tmp_path)).save(5, ref, extra={"pipeline": {"step": 5}})
    _, template = ckpt_state(seed=2)
    got, step, extra = TC.CheckpointManager(str(tmp_path)).restore(template)
    assert step == 5 and extra == {"pipeline": {"step": 5}}
    assert isinstance(got[1].step, int) and got[1].step == 7
    assert_trees_equal(ref, got)


def test_port_checkpoint_restores_in_reference(tmp_path):
    ref, port = ckpt_state(seed=3)
    TC.CheckpointManager(str(tmp_path)).save(9, port)
    template, _ = ckpt_state(seed=4)
    got, step, extra = RC.CheckpointManager(str(tmp_path)).restore(template)
    assert step == 9 and extra == {}
    assert_trees_equal(got, port)


def test_checkpoint_keeps_k_commits_atomically_and_places_leaves(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": 0}
    for s in (1, 2, 3):
        mgr.save(s, dict(state, w=state["w"] + s, n=s))
    os.makedirs(tmp_path / "step_00000009.tmp")  # a killed writer's leftovers
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    got, step, _ = mgr.restore({"w": torch.empty(2, 3, device="meta"), "n": 0},
                               shardings={"w": TS.Placement(TMESH.make_debug_mesh(device="cpu"),
                                                            (None, None))})
    assert step == 3 and got["n"] == 3 and got["w"].device == torch.device("cpu")
    assert torch.equal(got["w"], state["w"] + 3)
    got, _, _ = mgr.restore({"w": torch.zeros(2, 3), "n": 0}, step=2)
    assert torch.equal(got["w"], state["w"] + 2)
    with pytest.raises(ValueError, match="template"):
        mgr.restore({"w": torch.zeros(3, 2), "n": 0})
    with pytest.raises(FileNotFoundError):
        TC.CheckpointManager(str(tmp_path / "empty")).restore(state)


# ---------------------------------------------------------------------------
# fault handling
# ---------------------------------------------------------------------------

FAULT_CASES = ["test_watchdog_flags_stragglers", "test_retry_transient",
               "test_fatal_triggers_restore", "test_injector"]


@pytest.mark.parametrize("case", FAULT_CASES)
def test_fault_classes_pass_reference_cases(case, monkeypatch):
    """The reference's own ``TestFault`` cases, run on the port's classes."""
    substrate = importlib.import_module("test_train_substrate")
    assert sorted(n for n in dir(substrate.TestFault) if n.startswith("test_")) == sorted(
        FAULT_CASES)
    for name in ("StepWatchdog", "RetryPolicy", "TransientError", "FatalError",
                 "FailureInjector"):
        assert getattr(substrate, name) is getattr(RF, name)
        monkeypatch.setattr(substrate, name, getattr(TF, name))
    getattr(substrate.TestFault(), case)()


def test_retry_exhaustion_and_heartbeat(tmp_path):
    calls, restored = [], []

    def always():
        calls.append(1)
        raise TF.TransientError("blip")

    with pytest.raises(TF.TransientError):
        TF.RetryPolicy(max_retries=2, backoff_base=0).run(always)
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(TF.TransientError):  # one restore, then one more round
        TF.RetryPolicy(max_retries=1, backoff_base=0).run(always, on_fatal=lambda: restored.append(1))
    assert len(calls) == 4 and restored == [1]
    hb = TF.Heartbeat(str(tmp_path / "hb"), interval=0.0)
    hb.beat(4)
    assert (tmp_path / "hb").read_text().split()[0] == "4"


# ---------------------------------------------------------------------------
# the int8 all-reduce
# ---------------------------------------------------------------------------


def test_compressed_psum_matches_reference():
    rng = np.random.default_rng(8)
    g = (rng.standard_normal((4, 5, 7)) * rng.uniform(0.1, 3, (4, 1, 1))).astype(np.float32)
    err = (0.01 * rng.standard_normal((4, 5, 7))).astype(np.float32)
    want = jax.vmap(lambda a, b: RO.compressed_psum(a, b, "i"), axis_name="i")(
        jnp.asarray(g), jnp.asarray(err))
    got = TO.compressed_psum(torch.from_numpy(g), torch.from_numpy(err))
    for w, t in zip(want, got):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), np.asarray(w))
    # every participant holds the same reduction
    assert all(torch.equal(got[0][0], got[0][i]) for i in range(4))


# ---------------------------------------------------------------------------
# the train step and the launcher
# ---------------------------------------------------------------------------


def f32_configs():
    rc = dataclasses.replace(ref_config(ARCH).reduced(n_layers=4, d_model=128, d_ff=256,
                                                      vocab=512), dtype="float32")
    tc = dataclasses.replace(get_config(ARCH).reduced(n_layers=4, d_model=128, d_ff=256,
                                                      vocab=512), dtype="float32")
    return rc, tc


@functools.lru_cache(maxsize=None)
def ref_init():
    rc, _ = f32_configs()
    return jax.tree.map(np.asarray, RM.init_params(rc, jax.random.PRNGKey(0)))


def batches(n):
    _, tc = f32_configs()
    pipe = TL.TokenPipeline(tc, global_batch=BATCH, seq_len=SEQ, seed=0)
    return [pipe.next_batch() for _ in range(n)]


def port_params():
    _, tc = f32_configs()
    return TM.params_from_numpy(tc, ref_init(), "cpu")


def test_jit_train_step_matches_make_train_step_and_reference():
    rc, tc = f32_configs()
    ocfg = TO.OptConfig(warmup_steps=1, total_steps=4)
    mesh = TMESH.make_mesh((1, 1), ("data", "model"), "cpu")
    a, b = port_params(), port_params()
    sa, sb = TO.init_opt_state(a, ocfg), TO.init_opt_state(b, ocfg)
    jitted = TT.jit_train_step(tc, ocfg, mesh, a)
    plain = TT.make_train_step(tc, ocfg)
    rocfg = RO.OptConfig(warmup_steps=1, total_steps=4)
    rmesh = make_mesh_compat((1, 1), ("data", "model"))
    rp = jax.tree.map(jnp.asarray, ref_init())
    rstep = RT.jit_train_step(rc, rocfg, rmesh, rp)
    rs = RO.init_opt_state(rp, rocfg)
    for batch in batches(2):
        a, sa, ma = jitted(a, sa, batch)  # numpy in: placed by batch_shardings
        b, sb, mb = plain(b, sb, {k: torch.from_numpy(v) for k, v in batch.items()})
        rp, rs, rm = rstep(rp, rs, jax.tree.map(jnp.asarray, batch))
        assert torch.equal(ma["loss"], mb["loss"]) and sa.step == sb.step
        for (path, x), (_, y) in zip(named(a), named(b)):
            assert torch.equal(x, y), path
        for tree_a, tree_b in ((sa.mu, sb.mu), (sa.nu, sb.nu)):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(named(tree_a), named(tree_b)))
        assert abs(float(ma["loss"]) - float(rm["loss"])) <= 1e-5 * abs(float(rm["loss"]))
        for (path, w), (_, g) in zip(named(jax.tree.map(np.asarray, rp)), named(a)):
            assert np.abs(g.numpy() - w).max() <= 0.05 * ocfg.lr, path
    with pytest.raises(ValueError, match="lies on"):
        jitted(TM.params_from_numpy(tc, ref_init(), "meta"), sa, batch)


def ref_run(ckpt_dir, steps):
    rc, _ = f32_configs()
    run = RL.build_run(ARCH, reduce=True, batch=BATCH, seq=SEQ, steps=steps, ckpt_dir=ckpt_dir,
                       mesh=make_mesh_compat((1, 1), ("data", "model")))
    run.cfg = rc
    run.params = jax.tree.map(jnp.asarray, ref_init())
    run.opt_state = RO.init_opt_state(run.params, run.opt_cfg)
    return run


def port_run(ckpt_dir, steps):
    _, tc = f32_configs()
    run = TL.build_run(ARCH, reduce=True, batch=BATCH, seq=SEQ, steps=steps, ckpt_dir=ckpt_dir,
                       device="cpu")
    run.cfg = tc
    run.params = port_params()
    run.opt_state = TO.init_opt_state(run.params, run.opt_cfg)
    return run


def test_train_matches_reference_through_faults_and_resume(tmp_path, capsys):
    """Both launchers from the same weights: 4 steps with a checkpoint
    every 2, a ``TransientError`` at step 1 and a ``FatalError`` at step 3,
    then a fresh run that resumes at step 4 and trains to 6."""
    out = {}
    for name, make, fault, train in (("ref", ref_run, RF, RL.train),
                                     ("port", port_run, TF, TL.train)):
        d = str(tmp_path / name)
        run = make(d, 6)
        sched = {1: fault.TransientError, 3: fault.FatalError}
        losses, wd = train(run, 4, ckpt_every=2, log_every=100,
                           injector=fault.FailureInjector(sched))
        assert run.step == 4 and wd.steps == 5 and not sched  # step 3 ran twice
        if name == "port":
            assert len(run.step_seconds) == wd.steps and min(run.step_seconds) > 0
        run2 = make(d, 6)
        more, _ = train(run2, 6, ckpt_every=2, log_every=1)
        assert run2.step == 6 and len(more) == 2 and run2.ckpt.all_steps() == [2, 4, 6]
        out[name] = (losses + more, run2.params)
    printed = capsys.readouterr().out
    assert printed.count("restored from step 2 after failure") == 2
    assert printed.count("resumed from step 4") == 2
    assert printed.count("[train] step=6") == 2
    want, got = out["ref"][0], out["port"][0]
    assert len(got) == len(want) == 7  # 5 steps ran before the resume
    for w, g in zip(want, got):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    for (path, w), (_, g) in zip(named(jax.tree.map(np.asarray, out["ref"][1])),
                                 named(out["port"][1])):
        assert np.abs(g.numpy() - w).max() <= 0.05 * 3e-4, path


def replay(order):
    """The parameters after training the pipeline's batches in ``order``
    from the shared init, straight through ``make_train_step``."""
    _, tc = f32_configs()
    ocfg = TO.OptConfig(total_steps=6, warmup_steps=1)
    params = port_params()
    state = TO.init_opt_state(params, ocfg)
    step = TT.make_train_step(tc, ocfg)
    drawn = batches(max(order) + 1)
    for i in order:
        params, state, _ = step(params, state, {k: torch.from_numpy(v) for k, v in drawn[i].items()})
    return params


@pytest.mark.parametrize("fail_at, order", [
    (None, [0, 1, 2, 3, 4, 5]),
    (2, [0, 1, 2, 2, 3, 4]),  # right after the checkpoint at step 2
    (3, [0, 1, 3, 2, 3, 4]),  # a step later
])
def test_fatal_error_replays_the_failing_batch(tmp_path, fail_at, order):
    """Queue 3, entry 20: a ``FatalError`` while step ``f + 1`` runs
    restores the checkpoint at step ``s`` (2), retries with the batch the
    failing iteration drew (``f``), then draws again from the restored
    position ``s``.  So even a failure right after the checkpoint trains
    batch 2 twice and never reaches batch 5: the run equals the replay of
    that order bit for bit, and differs from the uninterrupted run."""
    run = port_run(str(tmp_path), 6)
    sched = {} if fail_at is None else {fail_at: TF.FatalError}
    TL.train(run, 6, ckpt_every=2, log_every=100, injector=TF.FailureInjector(sched))
    assert run.step == 6
    for (path, want), (_, got) in zip(named(replay(order)), named(run.params)):
        assert torch.equal(got, want), path
    if fail_at is not None:
        straight = replay(list(range(6)))
        assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(named(straight),
                                                                   named(run.params)))


def test_build_run_and_main_on_the_cpu(capsys):
    run = TL.build_run(ARCH, reduce=True, batch=2, seq=8, steps=2, device="cpu")
    assert (run.cfg.n_layers, run.cfg.d_model, run.cfg.d_ff, run.cfg.vocab) == (4, 128, 256, 512)
    assert run.opt_cfg.total_steps == 2 and run.opt_cfg.warmup_steps == 1
    assert run.mesh.shape == {"data": 1, "model": 1}
    assert all(p.device == torch.device("cpu") for _, p in named(run.params))
    with pytest.raises(ValueError, match="mesh"):
        TL.build_run(ARCH, reduce=True, device="cpu", mesh=TMESH.make_mesh((1, 1), ("data", "model"),
                                                                            "meta"))
    TL.main(["--arch", "whisper-small", "--reduce", "--steps", "2", "--batch", "2", "--seq",
             "8", "--device", "cpu"])
    assert "[train] done: loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# elasticity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target, loads", [(7, None), (2, None), (6, [5.0, 1.0, 1.0, 9.0]),
                                           (3, [1.0, 8.0, 2.0, 2.0])])
def test_scale_serving_partitions_matches_reference(target, loads):
    ref = RefPartitions.equal_width(4, 0, 1 << 20)
    port = LogicalPartitions.equal_width(4, 0, 1 << 20)
    want, want_moved = RE.scale_serving_partitions(ref, target_replicas=target, loads=loads)
    got, moved = TE.scale_serving_partitions(port, target_replicas=target, loads=loads)
    assert got.num_partitions == target
    assert np.array_equal(got.boundaries, np.asarray(want.boundaries))
    assert moved == want_moved


def test_reshard_checkpoint_round_trips(tmp_path):
    _, port = ckpt_state(seed=5)
    _, tc = f32_configs()
    cfg = get_config(ARCH).reduced()
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save(5, port)
    template = jax.tree.map(lambda t: t if isinstance(t, int) else torch.empty_like(t, device="meta"),
                            port)
    (params, opt), step, _ = TE.reshard_checkpoint(
        mgr, template, TMESH.make_production_mesh(device="cpu"), cfg)
    assert step == 5
    for (path, a), (_, b) in zip(TC._flatten_with_paths(port), TC._flatten_with_paths((params, opt))):
        assert a == b if isinstance(a, int) else np.array_equal(bits(a), bits(b)), path
    assert all(t.device == torch.device("cpu") for _, t in named(params))


# ---------------------------------------------------------------------------
# the kernels' profiler ranges
# ---------------------------------------------------------------------------


def test_launch_label_names_kernel_and_shapes():
    from repro_torch.kernels import ops

    q, k = torch.zeros(2, 40, 16, 96), torch.zeros(2, 40, 24, 96)
    assert ops.launch_label("flash_attention", q.shape, k.shape, causal=True) == (
        "flash_attention [2, 40, 16, 96] [2, 40, 24, 96] causal")
    assert ops.launch_label("flash_attention_bwd", q.shape, k.shape, causal=False) == (
        "flash_attention_bwd [2, 40, 16, 96] [2, 40, 24, 96]")
    with torch.profiler.profile() as prof:
        with ops.launch_range("leaf_scan", q, k):
            pass
    assert [e.name for e in prof.events()] == ["leaf_scan [2, 40, 16, 96] [2, 40, 24, 96]"]
    # no profiler: no range is opened
    assert isinstance(ops.launch_range("leaf_scan", q, k), contextlib.nullcontext)
