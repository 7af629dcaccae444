"""Observability (port of bigdl_tpu/obs): the request-lifecycle span
recorder with Chrome trace-event export, the crc-suffixed per-request
JSONL log and the trace summary (`tracing.py`), and guarded on-demand
torch.profiler windows (`profiler.py`, loaded lazily)."""

from bigdl_tpu_torch.obs.tracing import (RequestLog, TraceRecorder, format_summary,
                                         summarize_trace, validate_nesting)

__all__ = ["RequestLog", "TraceRecorder", "format_summary", "summarize_trace",
           "validate_nesting", "ProfilerWindow", "PROFILER"]


def __getattr__(name):
    if name in ("ProfilerWindow", "PROFILER"):  # lazy, as JAX's
        from bigdl_tpu_torch.obs import profiler as _p

        return getattr(_p, name)
    raise AttributeError(name)
