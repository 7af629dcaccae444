"""Error contract and structured logging (a copy of
bigdl_tpu/utils/errors.py): one import site for the error class and its
guard (`utils/common.py`), plus single-line key=value events and the
request timer the HTTP layer wraps every POST in."""

from __future__ import annotations

import time
from typing import Any

from bigdl_tpu_torch.utils.common import (  # noqa: F401  (re-exports)
    InvalidInputError,
    get_logger,
    invalid_input_error,
)
from bigdl_tpu_torch.utils.durability import IntegrityError  # noqa: F401  (re-export)


def log_event(event: str, **fields: Any) -> None:
    """One structured line: `event key=value ...` at INFO."""
    parts = [event]
    for k, v in fields.items():
        if isinstance(v, float):
            v = f"{v:.4f}"
        parts.append(f"{k}={v}")
    get_logger().info(" ".join(parts))


class request_timer:
    """Context manager: the block's wall-clock duration into `log_event`
    and `metrics.observe_request` (status 500 when the block raised)."""

    def __init__(self, metrics, endpoint: str):
        self.metrics = metrics
        self.endpoint = endpoint
        self.status = 200

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = 500 if exc_type is not None else self.status
        if self.metrics is not None:
            self.metrics.observe_request(self.endpoint, status, dt)
        log_event("http_request", endpoint=self.endpoint, status=status, seconds=dt)
        return False
