"""Fault tolerance for long runs (counterpart of ``repro.dist.fault``).

  StepGuard       — runs each step under a wall-clock deadline (a hung step
                    surfaces as StepTimeout instead of an endless wait) and
                    flags straggler steps that take more than
                    ``straggler_ratio`` x the median of the earlier steps.
  FailureInjector — deterministic failure drills: raises InjectedFailure the
                    FIRST time each configured step is reached, so restart
                    paths are exercised in tests, not found in production.
  run_resilient   — the restart loop: build (or restore) the state, run the
                    steps under the guard, checkpoint every ``ckpt_every``
                    steps, and on a failed step restore the latest
                    checkpoint and replay; the checkpoint records the count
                    of COMPLETED steps, so none is lost or counted twice.

The reference's guard re-enters the caller's device mesh on its worker
thread; the port has no mesh yet, so its guard runs the step as it is.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Any, Callable


class StepTimeout(RuntimeError):
    """A guarded step exceeded its wall-clock deadline."""


class InjectedFailure(RuntimeError):
    """Deterministic drill failure from FailureInjector."""


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float

    @property
    def ratio(self) -> float:
        return self.duration_s / max(self.median_s, 1e-12)


class StepGuard:
    """Deadline + straggler detection around a single step callable.

    The deadline is enforced by running the step on a daemon thread and
    abandoning it on timeout: Python offers no safe preemption, so a
    timed-out step may still be running while the caller restarts.  After
    a StepTimeout the caller tears the worker's resources down; it does
    not reuse them beside the abandoned step.
    """

    def __init__(self, deadline_s: float, straggler_ratio: float | None = None):
        self.deadline_s = deadline_s
        self.straggler_ratio = straggler_ratio
        self.durations: list[float] = []
        self.stragglers: list[StragglerEvent] = []

    def run(self, step_no: int, fn: Callable[[], Any]) -> Any:
        box: dict[str, Any] = {}
        errs: list[BaseException] = []

        def target():
            try:
                box["value"] = fn()
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errs.append(e)

        t0 = time.perf_counter()
        worker = threading.Thread(target=target, daemon=True)
        worker.start()
        worker.join(self.deadline_s)
        if worker.is_alive():
            raise StepTimeout(f"step {step_no} exceeded deadline of {self.deadline_s}s")
        if errs:
            # raised straight from the list: a local holding the exception
            # would close a cycle (this frame -> exception -> traceback ->
            # this frame) that keeps the failed step's frames, and every
            # tensor they hold, alive until the garbage collector runs
            raise errs.pop()
        dur = time.perf_counter() - t0
        if self.straggler_ratio is not None and self.durations:
            med = statistics.median(self.durations)
            if med > 0 and dur > self.straggler_ratio * med:
                self.stragglers.append(StragglerEvent(step_no, dur, med))
        self.durations.append(dur)
        return box["value"]


class FailureInjector:
    """Raises InjectedFailure the first time each configured step runs."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self._fired: set[int] = set()

    def check(self, step_no: int) -> None:
        if step_no in self.fail_at and step_no not in self._fired:
            self._fired.add(step_no)
            raise InjectedFailure(f"injected failure at step {step_no}")


def run_resilient(
    n_steps: int,
    build: Callable[[], Any],
    step: Callable[[Any, int], Any],
    save: Callable[[Any, int], None],
    restore: Callable[[], tuple[Any, int] | None],
    *,
    ckpt_every: int = 0,
    max_restarts: int = 3,
    guard: StepGuard | None = None,
) -> tuple[Any, dict]:
    """Run ``n_steps`` steps with checkpoint-resume on failure.

    ``save(state, k)`` / ``restore() -> (state, k)`` use k = the number of
    COMPLETED steps, so a replay resumes at exactly step k.  On a failure
    the run restores (a fresh ``build()`` when no checkpoint exists) and
    replays; after ``max_restarts`` restarts the failure propagates.
    Returns (final_state, report) with the restart and straggler records.
    """
    restarts = 0

    def load() -> tuple[Any, int]:
        got = restore()
        if got is None:
            return build(), 0
        return got

    state, i = load()
    while i < n_steps:
        try:
            if guard is not None:
                state = guard.run(i, lambda: step(state, i))
            else:
                state = step(state, i)
            # the periodic save shares the restart budget: a failed write
            # restores and replays instead of aborting a run with restarts left
            if ckpt_every and (i + 1) % ckpt_every == 0:
                save(state, i + 1)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            state, i = load()
            continue
        i += 1
    report = dict(restarts=restarts,
                  stragglers=list(guard.stragglers) if guard is not None else [])
    # No final save where the periodic cadence already wrote step n_steps:
    # the streamed HSS build checkpoints whole levels, and writing the
    # complete state twice in a row doubles the IO for nothing.
    if not (ckpt_every and n_steps % ckpt_every == 0):
        try:
            save(state, n_steps)
        except Exception as e:   # noqa: BLE001 — reported, not fatal
            # the run IS complete; a failed final checkpoint must not discard
            # the computed state, so it is reported instead of raised
            report["final_save_error"] = repr(e)
    return state, report
