"""``repro_torch.*``-namespaced logging.

Library modules log through :func:`logger`; the root ``repro_torch`` logger
carries a ``NullHandler`` so importing the library never prints anything —
output is opt-in via :func:`setup_logging` (wired to the ``--verbose`` CLI
flag) or whatever handlers the embedding application configures.
"""

from __future__ import annotations

import logging
import sys
from typing import TextIO

__all__ = ["logger", "setup_logging"]

_ROOT = logging.getLogger("repro_torch")
_ROOT.addHandler(logging.NullHandler())

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"


def logger(name: str) -> logging.Logger:
    """A logger under the ``repro_torch`` namespace (``logger("core.api")``
    → ``repro_torch.core.api``)."""
    return logging.getLogger(f"repro_torch.{name}" if name else "repro_torch")


def setup_logging(level: int = logging.INFO,
                  stream: TextIO | None = None) -> logging.Logger:
    """Attach a stream handler to the ``repro_torch`` root (idempotent).

    Repeated calls adjust the level instead of stacking handlers."""
    for h in _ROOT.handlers:
        if isinstance(h, logging.StreamHandler) and not isinstance(
                h, logging.NullHandler):
            h.setLevel(level)
            _ROOT.setLevel(level)
            return _ROOT
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(_FORMAT))
    _ROOT.addHandler(handler)
    _ROOT.setLevel(level)
    return _ROOT
