"""Logging in the reference's format, plus structured run records.

A copy of the JAX package's ``utils/logger.py`` (standard library only).
Reference ``utils/utils_logger.py:25-44``: a named logger with an
append-mode FileHandler and a StreamHandler, format ``%(asctime)s.%(msecs)03d
: %(message)s``; and a JSONL record sink for machine-readable sweeps.
``release`` (not in the JAX module) closes a logger's handlers.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Any, Dict


def logger_info(logger_name: str, log_path: str = "default.log") -> logging.Logger:
    """Create/fetch a named logger with file + stream handlers."""
    log = logging.getLogger(logger_name)
    if log.handlers:  # own handlers only — hasHandlers() also sees root's
        return log
    level = logging.INFO
    formatter = logging.Formatter("%(asctime)s.%(msecs)03d : %(message)s", "%y-%m-%d %H:%M:%S")
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    fh = logging.FileHandler(log_path, mode="a")
    fh.setFormatter(formatter)
    log.setLevel(level)
    log.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    log.addHandler(sh)
    return log


def release(log: logging.Logger) -> None:
    """Close and detach ``log``'s handlers, so that the next ``logger_info``
    of the same name opens the file it is given (``logger_info`` returns a
    logger that has handlers as it is)."""
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)


class TeeLogger:
    """stdout tee into a log file (reference ``utils_logger.logger_print``
    ``:54-64``): everything printed also lands in the file."""

    def __init__(self, log_path: str, stream=None):
        import sys

        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        self._file = open(log_path, "a")
        self._stream = stream or sys.stdout

    def write(self, msg: str) -> None:
        self._stream.write(msg)
        self._file.write(msg)

    def flush(self) -> None:
        self._stream.flush()
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def append_record(jsonl_path: str, record: Dict[str, Any]) -> None:
    """Append one structured run record (timestamped) to a JSONL file."""
    record = dict(record)
    record.setdefault("ts", datetime.datetime.now().isoformat(timespec="seconds"))
    os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
    with open(jsonl_path, "a") as f:
        f.write(json.dumps(record) + "\n")
