"""Logging facade.

TPU-native analog of the reference ``core/logging.h``: a module-level logger
with level + sink initialization from environment variables
(``SVS_LOG_LEVEL`` / ``SVS_LOG_SINK``, reference ``logging.h:141-176``) and
per-index logger injection (every index constructor accepts ``logger=``,
mirroring the reference's per-index ``logger_ptr``).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

_global_logger: Optional[logging.Logger] = None


def _init_from_env() -> logging.Logger:
    logger = logging.getLogger("svs_tpu")
    level = _LEVELS.get(os.environ.get("SVS_LOG_LEVEL", "warn").lower(),
                        logging.WARNING)
    logger.setLevel(level)
    sink = os.environ.get("SVS_LOG_SINK", "stderr").lower()
    if not logger.handlers:
        if sink == "null":
            handler: logging.Handler = logging.NullHandler()
        elif sink == "stdout":
            handler = logging.StreamHandler(sys.stdout)
        elif sink.startswith("file:"):
            handler = logging.FileHandler(sink[len("file:"):])
        else:
            handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s"))
        logger.addHandler(handler)
    return logger


def get() -> logging.Logger:
    """Global default logger (reference: svs::logging::get())."""
    global _global_logger
    if _global_logger is None:
        _global_logger = _init_from_env()
    return _global_logger


def as_logger(logger: Optional[logging.Logger]) -> logging.Logger:
    return logger if logger is not None else get()
