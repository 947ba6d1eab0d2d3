"""End-to-end training launcher.

The port of ``repro.launch.train``: config registry -> model init ->
placed train step -> deterministic data pipeline -> checkpoint manager ->
fault-tolerance hooks (watchdog, heartbeat, retry with restore), on one
card (``device=None`` means CUDA and raises where there is none).

After a ``FatalError`` the loop restores the latest checkpoint and
retries the failing step with the batch it had drawn, as the reference's
``do_step`` closure does: a failure while drawing batch ``f`` restored to
step ``s`` trains step ``s + 1`` on batch ``f``, then draws batches ``s,
s + 1, ...`` from the restored pipeline position (``ROADMAP.md`` queue 3,
entry 20).  So no fatal failure resumes exactly, not even one right after
a checkpoint (``f = s`` trains batch ``s`` twice); a resume in a fresh
run, and a ``TransientError`` retried in place, do.

Example (on the card, full width)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm3-4b \\
        --steps 3 --batch 2 --seq 4096
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.mesh import resolve_device
from repro_torch.data.pipeline import TokenPipeline, to_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.train import sharding as SH
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import FailureInjector, Heartbeat, RetryPolicy, StepWatchdog
from repro_torch.train.optimizer import OptConfig, init_opt_state, tree_map
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainRun:
    cfg: object
    opt_cfg: OptConfig
    mesh: object
    params: object
    opt_state: object
    pipeline: TokenPipeline
    ckpt: Optional[CheckpointManager]
    step: int = 0
    #: each trained step's seconds, as the watchdog observes them (from
    #: the step's call to its loss on the host, which waits for the step)
    step_seconds: list = dataclasses.field(default_factory=list)


def build_run(
    arch: str,
    *,
    reduce: bool = False,
    batch: int = 8,
    seq: int = 128,
    steps: int = 100,
    ckpt_dir: Optional[str] = None,
    seed: int = 0,
    mesh=None,
    device=None,
) -> TrainRun:
    """A run of ``arch`` (``reduce``: 4 layers, width 128, ffn 256, vocab
    512) with weights from ``seed`` on ``device``, or on ``mesh``'s device
    where a mesh is given (default: a 1x1 ``("data", "model")`` mesh)."""
    cfg = get_config(arch)
    if reduce:
        cfg = cfg.reduced(n_layers=4, d_model=128, d_ff=256, vocab=512)
    if mesh is None:
        mesh = make_mesh((1, 1), ("data", "model"), device)
    elif device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    opt_cfg = OptConfig(total_steps=steps, warmup_steps=max(1, steps // 20))
    params = M.init_params(cfg, seed, device=mesh.device)
    opt_state = init_opt_state(params, opt_cfg)
    params = tree_map(lambda p, s: s.place(p), params, SH.param_shardings(params, mesh, cfg))
    pipeline = TokenPipeline(cfg=cfg, global_batch=batch, seq_len=seq, seed=seed)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    return TrainRun(
        cfg=cfg, opt_cfg=opt_cfg, mesh=mesh, params=params,
        opt_state=opt_state, pipeline=pipeline, ckpt=ckpt,
    )


def train(
    run: TrainRun,
    steps: int,
    *,
    microbatches: int = 1,
    ckpt_every: int = 50,
    injector: Optional[FailureInjector] = None,
    log_every: int = 10,
    heartbeat_path: Optional[str] = None,
):
    """The training loop with checkpoint/restart and the straggler
    watchdog, up to step ``steps``.  Returns ``(losses, watchdog)``."""
    cfg, device = run.cfg, run.mesh.device
    step_fn = make_train_step(cfg, run.opt_cfg, microbatches=microbatches)
    watchdog = StepWatchdog()
    heartbeat = Heartbeat(heartbeat_path, interval=5.0) if heartbeat_path else None
    retry = RetryPolicy(max_retries=2)
    losses = []

    # resume if a checkpoint exists
    if run.ckpt is not None and run.ckpt.latest_step() is not None:
        (run.params, run.opt_state), run.step, extra = run.ckpt.restore(
            (run.params, run.opt_state)
        )
        run.pipeline.restore(extra.get("pipeline", {}))
        print(f"[train] resumed from step {run.step}")

    def save():
        if run.ckpt is not None:
            run.ckpt.save(
                run.step, (run.params, run.opt_state),
                extra={"pipeline": run.pipeline.snapshot()},
            )

    def restore():
        if run.ckpt is None or run.ckpt.latest_step() is None:
            return
        (run.params, run.opt_state), run.step, extra = run.ckpt.restore(
            (run.params, run.opt_state)
        )
        run.pipeline.restore(extra.get("pipeline", {}))
        print(f"[train] restored from step {run.step} after failure")

    while run.step < steps:
        batch = to_device(run.pipeline.next_batch(), cfg, device)

        def do_step():
            if injector is not None:
                injector.maybe_fail(run.step)
            t0 = time.time()
            params, opt_state, metrics = step_fn(run.params, run.opt_state, batch)
            float(metrics["loss"])  # waits for the step; also surfaces NaN early
            dt = time.time() - t0
            return params, opt_state, metrics, dt

        params, opt_state, metrics, dt = retry.run(do_step, on_fatal=restore)
        run.params, run.opt_state = params, opt_state
        run.step += 1
        straggler = watchdog.observe(dt)
        run.step_seconds.append(dt)
        losses.append(float(metrics["loss"]))
        if heartbeat:
            heartbeat.beat(run.step)
        if run.step % log_every == 0:
            print(
                f"[train] step={run.step} loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.3f} "
                f"dt={dt*1e3:.0f}ms{' STRAGGLER' if straggler else ''}"
            )
        if ckpt_every and run.step % ckpt_every == 0:
            save()
    save()
    return losses, watchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="minitron-4b")
    ap.add_argument("--reduce", action="store_true",
                    help="shrink to a small model of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: CUDA")
    args = ap.parse_args(argv)

    run = build_run(
        args.arch, reduce=args.reduce, batch=args.batch, seq=args.seq,
        steps=args.steps, ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device,
    )
    losses, watchdog = train(run, args.steps, microbatches=args.microbatches)
    print(
        f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"({watchdog.steps} steps, straggler rate {watchdog.straggler_rate:.1%})"
    )


if __name__ == "__main__":
    main()
