"""Serving (port of bigdl_tpu/serving): the continuous-batching engine over
dense and paged KV pools with chunked prefill, overload control and the
drain, its radix prefix cache, multi-tenant LoRA adapters
(`serving.adapters`), the crash-recovery journal (`serving.journal`),
fault injection (`serving.faults`), the metrics exposition
(`serving.metrics`), and the HTTP layer over it: the OpenAI/TGI server
(`serving.api_server.ApiServer`) and the FastChat worker
(`FastChatWorker`, loaded lazily)."""

from bigdl_tpu_torch.serving.engine import InferenceEngine, Request

__all__ = ["InferenceEngine", "Request", "FastChatWorker"]


def __getattr__(name):
    if name == "FastChatWorker":  # lazy: keeps engine-only imports light
        from bigdl_tpu_torch.serving.fastchat_worker import FastChatWorker

        return FastChatWorker
    raise AttributeError(name)
