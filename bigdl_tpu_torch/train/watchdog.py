"""Hung-step watchdog: failure DETECTION for long training jobs (a copy
of bigdl_tpu/train/watchdog.py; it imports nothing but the standard
library).

The failure-recovery story covers the state half (atomic
checkpoint/resume, train/checkpoint.py) and this, detection: on a
multi-host job a single lost peer leaves every other process blocked
inside a collective forever — no exception, no timeout, a silently
idle pod bill (the reference's MPI jobs hang identically; their k8s
spec only restarts on process EXIT,
reference docker/llm/finetune/lora/cpu/kubernetes/templates/
ipex-llm-lora-finetuning-job.yaml:7-54).

`StepWatchdog` converts a hang into an exit the orchestrator can see: a
daemon thread checks progress beats; if no step completes within
`timeout_s` it logs a diagnosis and hard-exits the process (os._exit —
a blocked collective never returns to Python, so SystemExit/signals
through the main thread cannot fire). The container restart policy then
relaunches the job, which resumes from the last atomic checkpoint.

Usage (BIGDL_TPU_WATCHDOG_S sets the timeout, as for the JAX package):

    wd = StepWatchdog(timeout_s=1800)
    for step in range(...):
        loss = train_step(model, tokens, mask)
        torch.cuda.synchronize()   # beat only counts finished work
        wd.beat(step)
    wd.stop()
"""

from __future__ import annotations

import os
import sys
import threading
import time


class StepWatchdog:
    """Exit the process (code 42) if no beat arrives within timeout_s.

    The check thread is a daemon: a normally-finishing job needs no
    explicit stop() (but calling it is cheap and makes intent clear).
    `on_timeout` (testing hook) replaces the default os._exit.
    """

    EXIT_CODE = 42  # distinct, grep-able "watchdog fired" exit status

    def __init__(self, timeout_s: float, check_interval_s: float | None = None,
                 on_timeout=None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self._interval = check_interval_s or min(timeout_s / 4, 30.0)
        self._on_timeout = on_timeout or self._default_timeout
        self._last_beat = time.monotonic()
        self._last_step = -1
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="bigdl-tpu-watchdog", daemon=True
        )
        self._thread.start()

    def beat(self, step: int | None = None) -> None:
        self._last_beat = time.monotonic()
        if step is not None:
            self._last_step = step

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            idle = time.monotonic() - self._last_beat
            if idle > self.timeout_s:
                self._on_timeout(idle)
                return

    def _default_timeout(self, idle: float) -> None:
        pid = os.environ.get("BIGDL_TPU_PROC_ID", "?")
        print(
            f"[bigdl-tpu watchdog] no training step completed for "
            f"{idle:.0f}s (> {self.timeout_s:.0f}s) on process {pid}; "
            f"last finished step={self._last_step}. A lost peer leaves "
            "collectives blocked forever — exiting "
            f"{self.EXIT_CODE} so the orchestrator restarts the job "
            "from the last checkpoint.",
            file=sys.stderr, flush=True,
        )
        sys.stderr.flush()
        os._exit(self.EXIT_CODE)  # collectives never return; exit hard


def timeout_from_env() -> float | None:
    """The BIGDL_TPU_WATCHDOG_S timeout, or None when unset/disabled.
    "0", negative, or malformed values DISABLE with a warning — a
    config typo must not crash-loop a 16-host job at startup. Callers
    that own their own watchdog (train/supervisor.py) read this instead
    of from_env() so no throwaway check thread is ever started."""
    v = os.environ.get("BIGDL_TPU_WATCHDOG_S")
    if not v:
        return None
    try:
        timeout = float(v)
    except ValueError:
        timeout = 0.0
    if timeout <= 0:
        print(f"[bigdl-tpu watchdog] BIGDL_TPU_WATCHDOG_S={v!r} is not a "
              "positive number; watchdog disabled", file=sys.stderr)
        return None
    return timeout


def from_env() -> StepWatchdog | None:
    """BIGDL_TPU_WATCHDOG_S=<seconds> enables the watchdog (the deploy/
    job specs set it alongside the restart policy)."""
    timeout = timeout_from_env()
    return None if timeout is None else StepWatchdog(timeout)
