"""Logging and error helpers (a copy of bigdl_tpu/utils/common.py): the
typed caller-mistake error the HTTP layer maps to 400, its assert-style
guards, and a namespaced logger factory. The logger keeps the JAX
package's name, so one log pipeline reads either package's lines."""

from __future__ import annotations

import logging
from typing import Any, Optional


def get_logger(name: str = "bigdl_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class InvalidInputError(ValueError):
    """Caller mistakes (bad request shapes, contradictory options): the
    serving layer maps this to HTTP 400."""


def invalid_input_error(condition: Any, msg: str, fix: Optional[str] = None) -> None:
    """Log and raise InvalidInputError (with `fix` appended) unless
    `condition`."""
    if not condition:
        full = msg if fix is None else f"{msg}. {fix}"
        get_logger().error(full)
        raise InvalidInputError(full)


def invalid_operation_error(condition: Any, msg: str) -> None:
    if not condition:
        get_logger().error(msg)
        raise RuntimeError(msg)
