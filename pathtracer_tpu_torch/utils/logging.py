"""Per-module loggers under the "pathtracer" root.

The part of ``pathtracer_tpu/utils/logging.py`` the importers use:
``get_logger``. The allowlist filter and the runtime level switch come
with the frontends (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import logging

ROOT = "pathtracer"


def get_logger(module: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{module}")
