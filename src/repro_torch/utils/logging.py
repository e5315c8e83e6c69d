"""Minimal structured logging for the port, as the JAX package's
``utils/logging.py``: every module logs to ``repro_torch.<name>``, and
the first :func:`get_logger` call gives the ``repro_torch`` logger one
stderr handler in the reference's format at INFO.

Unlike the reference's, the ``repro_torch`` logger keeps propagating:
records also reach the root logger's handlers, which is where pytest's
``caplog`` reads them.  A program that configures the root logger too
(``logging.basicConfig``) prints the port's records twice."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        _configured = True
    return logging.getLogger(f"repro_torch.{name}")
