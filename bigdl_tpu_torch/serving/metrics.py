"""Serving histograms (copies of `Histogram`, `FAST_BUCKETS` and the
request buckets of bigdl_tpu/serving/metrics.py). The engine observes its
TTFT, inter-token, prefill and decode-step latencies into them; the
Prometheus exposition (`render`) and the training registry wait for the
HTTP layer (ROADMAP queue 1 item 5)."""

from __future__ import annotations

# request latency histogram bucket upper bounds (seconds)
_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# per-token / per-step phase latencies live in milliseconds: the request
# buckets would flatten every inter-token-latency distribution into the
# bottom bucket
FAST_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0)


class Histogram:
    """Minimal lock-free Prometheus histogram: one writer (the engine
    thread observes), any reader (a racing reader sees a value at most
    one observation stale)."""

    def __init__(self, buckets=_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0

    def observe(self, x: float) -> None:
        for i, ub in enumerate(self.buckets):
            if x <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.sum += x

    @property
    def count(self) -> int:
        return sum(self.counts)
