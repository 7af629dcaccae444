"""Deterministic fault injection for the serving engine (a copy of
bigdl_tpu/serving/faults.py): the engine fires named points on its hot
paths, and an armed `FaultInjector` makes them fail on cue, so every
recovery path runs on the CPU as an ordinary test. An unarmed injector
changes nothing; the engine's default, `NULL_INJECTOR`, costs one call
a point.

Injection points (the strings the engine fires):

==================  =======================================================
point               effect when armed
==================  =======================================================
``alloc_page``      the next paged-pool page allocation fails (returns no
                    page), as if the pool were exhausted — drives the
                    preemption path without needing a real page storm
``nan_logits``      one decode step's host-side logprobs for a victim slot
                    become NaN, as if the model produced non-finite logits
                    for that row — drives the quarantine guard. payload:
                    ``slots=[...]`` picks victims (default: first active)
``slow_step``       ``engine.step()`` sleeps before doing work, as if the
                    device stalled. payload: ``seconds=float``
``crash_before_done``  ``_finish`` raises :class:`FaultError` after the
                    request is complete but BEFORE its journal tombstone
                    is written — the crash-recovery window the journal
                    replay must cover
``adapter_load_corrupt``  the next LoRA adapter load fails as if the
                    artifact were corrupt (structured AdapterError,
                    serving/adapters.py) — the request naming it must
                    finish "error" without taking the batch down
``adapter_page_in_stall``  the next device page-in of an adapter's
                    weights stalls (AdapterPager.ensure raises a
                    structured AdapterError) — quarantines exactly the
                    one request naming the tenant, never fail_all
==================  =======================================================

Arming is deterministic by construction: ``arm(point, times=N, after=M)``
fires on eligible calls M+1 .. M+N. The optional ``prob`` mode draws from
a seeded ``random.Random`` so even probabilistic chaos replays exactly.

Usage::

    inj = FaultInjector(seed=7)
    inj.arm("alloc_page", times=1, after=2)   # 3rd allocation fails
    eng = InferenceEngine(model, paged=True, faults=inj)
"""

from __future__ import annotations

import dataclasses
import random
import threading
from collections import defaultdict
from typing import Optional

POINTS = ("alloc_page", "nan_logits", "slow_step", "crash_before_done",
          "adapter_load_corrupt", "adapter_page_in_stall")


class FaultError(RuntimeError):
    """Raised by an injected crash point (never by real engine code)."""


@dataclasses.dataclass
class _Arm:
    times: int  # firings remaining; -1 = unlimited
    after: int  # eligible calls to skip first
    prob: float  # per-eligible-call firing probability
    payload: dict


class FaultInjector:
    """Seedable hook table; thread-safe (handler threads and the engine
    thread may hit different points concurrently).

    `points` is a class attribute so other subsystems can reuse the
    arm/disarm/fire discipline with their own injection-point table
    (utils/diskfaults.py does, for storage faults)."""

    points = POINTS

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._arms: dict[str, _Arm] = {}
        self._lock = threading.Lock()
        # observability for tests: how often each point was reached/fired
        self.seen: dict[str, int] = defaultdict(int)
        self.fired: dict[str, int] = defaultdict(int)

    def arm(self, point: str, times: int = 1, after: int = 0,
            prob: float = 1.0, **payload) -> "FaultInjector":
        """Arm `point` to fire `times` times (-1 = forever) after skipping
        the first `after` eligible calls. Extra kwargs ride along as the
        payload dict `fire` returns. Returns self for chaining."""
        if point not in self.points:
            raise ValueError(
                f"unknown injection point {point!r}; known: {self.points}"
            )
        with self._lock:
            self._arms[point] = _Arm(times=times, after=after, prob=prob,
                                     payload=dict(payload))
        return self

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._arms.clear()
            else:
                self._arms.pop(point, None)

    def fire(self, point: str) -> Optional[dict]:
        """Engine-side hook: returns the arm's payload dict when the fault
        triggers, None otherwise. Unarmed points return None in O(1)."""
        with self._lock:
            self.seen[point] += 1
            a = self._arms.get(point)
            if a is None:
                return None
            if a.after > 0:
                a.after -= 1
                return None
            if a.times == 0:
                return None
            if a.prob < 1.0 and self._rng.random() >= a.prob:
                return None
            if a.times > 0:
                a.times -= 1
            self.fired[point] += 1
            return dict(a.payload)


class NullFaultInjector(FaultInjector):
    """The engine's default: every point unarmed, arming forbidden (a
    shared module-level instance must stay inert). `fire` is overridden
    to a bare None so production engines pay no lock acquisition and
    share no counter state through the module-level instance."""

    def arm(self, *a, **k):  # pragma: no cover - guard rail
        raise RuntimeError(
            "this is the shared no-op injector; construct your own "
            "FaultInjector and pass it to the engine via faults="
        )

    def fire(self, point: str) -> Optional[dict]:
        return None


NULL_INJECTOR = NullFaultInjector()
