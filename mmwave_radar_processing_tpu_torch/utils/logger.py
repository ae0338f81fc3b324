"""Central logging setup of the port (JAX: ``utils/logger.py``).

One stdout stream handler with a consistent format, configured once; module
loggers inherit it lazily via :func:`get_logger`.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_DEFAULT_LOGGER: Optional[logging.Logger] = None
_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"


def setup_logger(
    name: str = "mmwave_radar_processing_tpu_torch",
    level: int = logging.INFO,
    *,
    set_default: bool = True,
) -> logging.Logger:
    """Configure and return a stdout logger with the package format."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if logger.hasHandlers():
        logger.handlers.clear()
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(fmt=_FORMAT, datefmt="%H:%M:%S"))
    logger.addHandler(handler)
    logger.propagate = False

    global _DEFAULT_LOGGER
    if set_default:
        _DEFAULT_LOGGER = logger
    return logger


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Return a configured logger, setting up the default lazily."""
    global _DEFAULT_LOGGER
    if _DEFAULT_LOGGER is None:
        setup_logger()
    if name is None:
        return _DEFAULT_LOGGER
    logger = logging.getLogger(name)
    if not logger.hasHandlers():
        setup_logger(name=name, level=_DEFAULT_LOGGER.level, set_default=False)
    return logger
