"""Guarded on-demand `torch.profiler` windows (port of
bigdl_tpu/obs/profiler.py, which wraps jax.profiler).

A profiler session is process-global and stateful: two overlapping
windows corrupt each other, and a stop without a live window has nothing
to stop. `ProfilerWindow` makes the window an explicit, guarded resource,
so the ApiServer's `/debug/profiler` endpoint and `bigdl-tpu-torch trace
profile-*` can drive it against a live server: a start while a window is
open raises `ProfilerBusy`, a stop with none open `ProfilerIdle`, a start
that fails leaves the window idle, and a stop that fails still closes it.

The default window is a `torch.profiler.profile` over the CPU and, when a
card is present, the CUDA activity; its stop writes a Chrome trace JSON
(`trace-<pid>-<n>.json`) into the logdir, which Perfetto and
chrome://tracing open. The window is opened from an HTTP handler thread
while the engine thread launches the kernels: the CUDA activity (CUPTI)
records every kernel of the process whichever thread launched it, but
torch.profiler records CPU ops only on the thread that started it unless
its experimental `profile_all_threads` is set, which the default window
sets where the installed torch has it. The device kernels say which op
ran; `obs/tracing.py`'s spans say which request waited meanwhile.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Callable, Optional


class ProfilerBusy(RuntimeError):
    """start() while a window is already open."""


class ProfilerIdle(RuntimeError):
    """stop() with no window open."""


class TorchProfilerSession:
    """The default start and stop of a window: a `torch.profiler.profile`
    (imported at the first start, so importing this module never loads the
    profiler) whose stop exports a Chrome trace into the logdir. The
    profiler is enabled and disabled on one thread the session owns, since
    a window's start and stop arrive on different HTTP handler threads."""

    _n = itertools.count()

    def __init__(self):
        self._stop_evt: Optional[threading.Event] = None
        self._done: Optional[threading.Event] = None
        self._error: Optional[BaseException] = None

    def _run(self, logdir: str, started: threading.Event) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            kw = {}
            try:  # the engine thread's CPU ops too, where torch can
                kw["experimental_config"] = torch.profiler._ExperimentalConfig(
                    profile_all_threads=True)
            except (AttributeError, TypeError):
                pass
            os.makedirs(logdir, exist_ok=True)
            prof = profile(activities=acts, **kw)
            prof.start()
        except BaseException as e:  # handed to start()'s caller
            self._error = e
            started.set()
            return
        started.set()
        self._stop_evt.wait()
        try:
            prof.stop()
            path = os.path.join(logdir, f"trace-{os.getpid()}-{next(self._n)}.json")
            prof.export_chrome_trace(path)
        except BaseException as e:  # handed to stop()'s caller
            self._error = e
        self._done.set()

    def start(self, logdir: str) -> None:
        started = threading.Event()
        self._stop_evt, self._done, self._error = threading.Event(), threading.Event(), None
        threading.Thread(target=self._run, args=(logdir, started), daemon=True,
                         name="torch-profiler").start()
        started.wait()
        if self._error is not None:
            err, self._error = self._error, None
            self._done = None
            raise err

    def stop(self) -> None:
        if self._done is None:
            return
        self._stop_evt.set()
        self._done.wait()
        self._done = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class ProfilerWindow:
    """One process-wide profiling window. `start_fn(logdir)`/`stop_fn()`
    default to a `TorchProfilerSession`'s; tests inject stubs."""

    def __init__(self, start_fn: Optional[Callable] = None,
                 stop_fn: Optional[Callable] = None,
                 clock: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._session: Optional[TorchProfilerSession] = None
        self._clock = clock  # window-age timestamps
        self.logdir: Optional[str] = None
        self.started_at: Optional[float] = None

    def _fns(self):
        if self._start_fn is not None:
            return self._start_fn, self._stop_fn
        if self._session is None:
            self._session = TorchProfilerSession()
        return self._session.start, self._session.stop

    def start(self, logdir: str) -> dict:
        if not logdir:
            raise ValueError("profiler window needs a logdir")
        with self._lock:
            if self.logdir is not None:
                raise ProfilerBusy(f"a profiler window is already open (logdir="
                                   f"{self.logdir}); stop it first")
            start, _ = self._fns()
            start(logdir)  # raises before any state flips on failure
            self.logdir = logdir
            self.started_at = self._clock()
            return self.status()

    def stop(self) -> dict:
        with self._lock:
            if self.logdir is None:
                raise ProfilerIdle("no profiler window is open")
            _, stop = self._fns()
            logdir, t0 = self.logdir, self.started_at
            try:
                stop()
            finally:
                # the window is spent either way: a failed stop must not
                # wedge every later start behind ProfilerBusy
                self.logdir = None
                self.started_at = None
            return {"active": False, "logdir": logdir,
                    "seconds": round(self._clock() - (t0 or 0.0), 3)}

    def status(self) -> dict:
        out = {"active": self.logdir is not None, "logdir": self.logdir}
        if self.started_at is not None:
            out["seconds"] = round(self._clock() - self.started_at, 3)
        return out


# the process-wide window the ApiServer's debug endpoint drives
PROFILER = ProfilerWindow()
