"""Logging / progress reporting (util::Logger parity, Logger.cpp).

The port's copy of imageencoder_tpu/utils/logger.py: a class of its own,
so its state (the open log file) is not the JAX package's.

Mirrors the reference's observability surface: stdout + optional append-mode
log file with per-line timestamps (Logger.cpp:89-115), a throttled progress
bar (:134-162), and Pause/Resume used inside frame loops (:164-170).
"""

from __future__ import annotations

import sys
import time


class Logger:
    _file = None
    _paused = False
    _enabled = True
    _progress_last = -1

    @classmethod
    def create(cls, logfile: str = "") -> None:
        cls.close()
        cls._enabled = True
        if logfile:
            cls._file = open(logfile, "a")

    @classmethod
    def close(cls) -> None:
        if cls._file:
            cls._file.close()
            cls._file = None

    @classmethod
    def pause(cls) -> None:
        cls._paused = True

    @classmethod
    def resume(cls) -> None:
        cls._paused = False

    @classmethod
    def write(cls, msg: str, timestamp: bool = True) -> None:
        if cls._paused or not cls._enabled:
            return
        line = msg
        if timestamp and msg:
            line = time.strftime("[%Y-%m-%d %H:%M:%S] ") + msg
        print(line, file=sys.stderr)
        if cls._file:
            cls._file.write(line + "\n")
            cls._file.flush()

    @classmethod
    def progress(cls, current: int, total: int, width: int = 55) -> None:
        if cls._paused or not cls._enabled or total == 0:
            return
        if not sys.stderr.isatty():  # keep piped/test output clean
            return
        filled = int(width * current / total)
        if filled == cls._progress_last and current != total:
            return
        cls._progress_last = filled
        bar = "=" * filled + " " * (width - filled)
        end = "\n" if current >= total else "\r"
        print(f"[{bar}] {current}/{total}", end=end, file=sys.stderr)
