"""Observability (port of bigdl_tpu/obs): the request-lifecycle span
recorder with Chrome trace-event export, the crc-suffixed per-request
JSONL log and the trace summary (`tracing.py`). The JAX package's
`profiler.py` window over jax.profiler waits for its torch.profiler
counterpart (ROADMAP queue 1 item [5])."""

from bigdl_tpu_torch.obs.tracing import (RequestLog, TraceRecorder, format_summary,
                                         summarize_trace, validate_nesting)

__all__ = ["RequestLog", "TraceRecorder", "format_summary", "summarize_trace",
           "validate_nesting"]
