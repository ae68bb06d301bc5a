"""Module-filtered logging with runtime level switching.

Replaces the reference's slog stack (common/mod.rs:72-84: level filter +
module-keyed KV filter + async drain) with stdlib logging: per-module
loggers under the "pathtracer" root, an allowlist filter (the `-m` flag)
and a runtime-switchable level (the reference binds this to the T key,
main.rs:65-66).
"""

from __future__ import annotations

import logging

ROOT = "pathtracer"

MODULES = ("integrator", "bvh", "sampler", "scene", "viewer", "headless")


class ModuleAllowlistFilter(logging.Filter):
    """Pass records whose module tag is allowlisted (warnings always pass,
    mirroring the KVFilter's Warning override, common/mod.rs:80-82)."""

    def __init__(self, allowed: set[str] | None):
        super().__init__()
        self.allowed = allowed

    def filter(self, record: logging.LogRecord) -> bool:
        if self.allowed is None or record.levelno >= logging.WARNING:
            return True
        mod = record.name.rsplit(".", 1)[-1]
        return mod in self.allowed


_handler: logging.Handler | None = None


def init_logging(level: str = "INFO",
                 allowed_modules: set[str] | None = None) -> logging.Logger:
    global _handler
    root = logging.getLogger(ROOT)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if _handler is None:
        _handler = logging.StreamHandler()
        _handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
        root.addHandler(_handler)
        root.propagate = False
    for f in list(_handler.filters):
        _handler.removeFilter(f)
    _handler.addFilter(ModuleAllowlistFilter(allowed_modules))
    return root


def set_level(level: str) -> None:
    """Runtime level switch (slog_atomic equivalent)."""
    logging.getLogger(ROOT).setLevel(
        getattr(logging, level.upper(), logging.INFO))


def cycle_level() -> str:
    """Toggle INFO <-> DEBUG at runtime (the reference binds this to the
    T key, viewer/mod.rs:199-212; the CLI also binds it to SIGUSR1)."""
    root = logging.getLogger(ROOT)
    new = "DEBUG" if root.level > logging.DEBUG else "INFO"
    root.setLevel(getattr(logging, new))
    root.warning("log level switched to %s", new)
    return new


def get_logger(module: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{module}")
