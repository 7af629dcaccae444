"""Serving (port of bigdl_tpu/serving): the continuous-batching engine over
dense and paged KV pools with chunked prefill, overload control and the
drain, its radix prefix cache, multi-tenant LoRA adapters
(`serving.adapters`), the crash-recovery journal (`serving.journal`),
fault injection (`serving.faults`) and the metrics exposition
(`serving.metrics`). The HTTP layer (`api_server.py`, `cli serve`,
`fastchat_worker.py`) waits for a later slice (ROADMAP queue 1 item [5])."""

from bigdl_tpu_torch.serving.engine import InferenceEngine, Request

__all__ = ["InferenceEngine", "Request"]
