"""Timestamped logging, timing decorator, per-song error ledger.

Parity target: `/root/reference/preprocess/utils.py:16-93` (`log`,
`timeit`, `ErrorFile`).
"""

from __future__ import annotations

import functools
import logging
import os
import time


def get_logger(name: str = "acoss_jax",
               logfile: str | None = None) -> logging.Logger:
    """Timestamped file+console logger (`utils.py:16-28`)."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if logfile:
        # honor a logfile request even when the logger already exists
        # (e.g. the timeit decorator created it console-only earlier) —
        # but never attach the same file twice
        attached = {getattr(h, "baseFilename", None)
                    for h in logger.handlers}
        if os.path.abspath(logfile) not in attached:
            fh = logging.FileHandler(logfile)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def timeit(fn):
    """Wall-clock decorator (`utils.py:31-43`)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        get_logger().info("%s took %.3fs", fn.__name__, time.time() - t0)
        return out
    return wrapper


class ErrorFile:
    """Append-only ledger of failed songs (`utils.py:80-93`); extraction
    skips logged songs and keeps going."""

    def __init__(self, path: str):
        self.path = path

    def add(self, track: str, error: str = "") -> None:
        # one ledger ROW per failure: interior newlines/tabs (the
        # natural payload is a multi-line traceback) are flattened so
        # tracks() never returns traceback fragments as track names
        error = " | ".join(ln for ln in error.splitlines() if ln.strip())
        track = str(track).replace("\t", " ").replace("\n", " ")
        with open(self.path, "a") as f:
            f.write(f"{track}\t{error.replace(chr(9), ' ')}\n")

    def tracks(self) -> list[str]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [ln.split("\t")[0] for ln in f if ln.strip()]
