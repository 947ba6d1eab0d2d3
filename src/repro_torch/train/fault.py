"""Fault tolerance and straggler mitigation for the training launcher.

The port of ``repro.train.fault``, plain Python with the same semantics
(wired together in ``launch/train.py``):

  * ``StepWatchdog`` — EMA of step wall-time; flags stragglers (step >
    ``straggler_factor`` x EMA).  On a fleet the launcher reacts by
    excluding the slow host at the next elastic boundary; here the hook
    records and reports (one card).
  * ``RetryPolicy`` — bounded retries with exponential backoff around the
    step call; distinguishes transient errors (retry in place) from fatal
    ones (restore from the latest checkpoint).
  * ``Heartbeat`` — a file rewritten atomically that an external
    orchestrator watches; missing heartbeats trigger replacement upstream.
  * ``FailureInjector`` — deterministic fault injection for tests.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional


class TransientError(RuntimeError):
    """Worth retrying in place (network blip, preempted collective)."""


class FatalError(RuntimeError):
    """Requires restore (device loss, corrupted state)."""


@dataclasses.dataclass
class StepWatchdog:
    ema_decay: float = 0.9
    straggler_factor: float = 2.5
    ema: Optional[float] = None
    stragglers: int = 0
    steps: int = 0

    def observe(self, seconds: float) -> bool:
        """Record one step; returns True if it was a straggler step."""
        self.steps += 1
        is_straggler = (
            self.ema is not None and seconds > self.straggler_factor * self.ema
        )
        if is_straggler:
            self.stragglers += 1
        # stragglers do not poison the EMA
        if self.ema is None:
            self.ema = seconds
        elif not is_straggler:
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * seconds
        return is_straggler

    @property
    def straggler_rate(self) -> float:
        return self.stragglers / max(self.steps, 1)


@dataclasses.dataclass
class Heartbeat:
    path: str
    interval: float = 10.0
    _last: float = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{step} {now}\n")
            os.replace(tmp, self.path)
            self._last = now


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_base: float = 0.1

    def run(
        self,
        fn: Callable[[], object],
        *,
        on_fatal: Optional[Callable[[], None]] = None,
    ):
        """Run ``fn`` with bounded retries.  TransientError -> retry with
        backoff; FatalError (or retries exhausted) -> invoke ``on_fatal``
        (checkpoint restore / elastic downsize) once, then one final try."""
        attempt = 0
        while True:
            try:
                return fn()
            except TransientError:
                attempt += 1
                if attempt > self.max_retries:
                    if on_fatal is not None:
                        on_fatal()
                        on_fatal = None
                        attempt = 0
                        continue
                    raise
                time.sleep(self.backoff_base * (2 ** (attempt - 1)))
            except FatalError:
                if on_fatal is not None:
                    on_fatal()
                    on_fatal = None
                    attempt = 0
                    continue
                raise


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault schedule for tests: {step: exception_type}."""

    schedule: dict

    def maybe_fail(self, step: int) -> None:
        exc = self.schedule.pop(step, None)
        if exc is not None:
            raise exc(f"injected failure at step {step}")
