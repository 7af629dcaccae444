"""Serving (port of bigdl_tpu/serving): the continuous-batching engine over
dense and paged KV pools, its radix prefix cache, latency histograms, and
multi-tenant LoRA adapters (`serving.adapters`). The HTTP layer waits for
a later slice (ROADMAP queue 1 item 5)."""

from bigdl_tpu_torch.serving.engine import InferenceEngine, Request

__all__ = ["InferenceEngine", "Request"]
