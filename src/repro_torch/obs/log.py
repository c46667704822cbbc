"""Structured logging for the port's command-line entry points (port of
``repro/obs/log.py``): leveled, optionally JSON lines, tuned from the
environment at emit time.

  REPRO_LOG_LEVEL   debug | info | warning | error   (default info)
  REPRO_LOG_JSON    1/true → one JSON object per line on stdout

Text mode prints ``[name] message key=value …``.
"""

from __future__ import annotations

import json
import os
import sys
import time

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _threshold() -> int:
    name = os.environ.get("REPRO_LOG_LEVEL", "info").strip().lower()
    return _LEVELS.get(name, _LEVELS["info"])


def _json_mode() -> bool:
    raw = os.environ.get("REPRO_LOG_JSON", "").strip().lower()
    return raw in ("1", "true", "yes", "on")


class Logger:
    """Leveled logger with key=value fields: ``log.info("served",
    decisions=192)`` prints ``[name] served decisions=192``, or a JSON
    object in JSON-lines mode (numbers, bools, strings and None pass
    through; anything else is stringified)."""

    def __init__(self, name: str, stream=None):
        self.name = name
        self._stream = stream

    @property
    def stream(self):
        return self._stream if self._stream is not None else sys.stdout

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        if _LEVELS[level] < _threshold():
            return
        if _json_mode():
            rec = {"ts": time.time(), "level": level, "logger": self.name,
                   "msg": msg}
            for k, v in fields.items():
                rec[k] = v if isinstance(v, (int, float, bool, str,
                                             type(None))) else str(v)
            print(json.dumps(rec), file=self.stream, flush=True)
            return
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        tag = f"[{self.name}] " if self.name else ""
        line = f"{tag}{msg}"
        if kv:
            line = f"{line} {kv}"
        print(line, file=self.stream, flush=True)

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit("warning", msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._emit("error", msg, fields)


_LOGGERS: dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    """Process-cached logger for ``name`` (the ``[name]`` text prefix)."""
    if name not in _LOGGERS:
        _LOGGERS[name] = Logger(name)
    return _LOGGERS[name]
