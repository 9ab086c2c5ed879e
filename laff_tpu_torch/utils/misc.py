"""Shared utilities: logging, idempotent-rerun guards, running meters."""

from __future__ import annotations

import logging
import os
import sys
import time

ROOT_PATH = os.path.join(os.environ.get("HOME", os.path.expanduser("~")), "VisualSearch")

_LOG_FORMAT = "[%(asctime)s %(filename)s:%(lineno)d] %(message)s"
_DATE_FORMAT = "%d %b %H:%M:%S"


def get_logger(name: str = "laff_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT, _DATE_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


logger = get_logger()


def makedirs(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def makedirs_for_file(filename: str) -> None:
    parent = os.path.dirname(filename)
    if parent:
        makedirs(parent)


def check_to_skip(filename: str, overwrite: bool) -> bool:
    """True when ``filename`` exists and must NOT be overwritten."""
    if os.path.exists(filename):
        if overwrite:
            logger.info("%s exists. overwrite", filename)
            return False
        logger.info("%s exists. skip", filename)
        return True
    return False


class AverageMeter:
    """Running mean and sum (reference ``util.py:55-80``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Progress:
    """Progress line with rate and ETA, logged at most every ``interval`` s."""

    def __init__(self, total: int, label: str = "", interval: float = 2.0) -> None:
        self.total = max(int(total), 1)
        self.label = label
        self.interval = interval
        self.seen = 0
        self.start = time.time()
        self._last_print = 0.0

    def add(self, n: int) -> None:
        self.seen += n
        now = time.time()
        if now - self._last_print < self.interval and self.seen < self.total:
            return
        self._last_print = now
        rate = self.seen / max(now - self.start, 1e-9)
        eta = (self.total - self.seen) / max(rate, 1e-9)
        logger.info("%s %d/%d (%.1f%%) %.1f/s eta %.0fs", self.label, self.seen, self.total,
                    100.0 * self.seen / self.total, rate, eta)
