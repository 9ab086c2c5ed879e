"""Shared utilities: logging and idempotent-rerun guards."""

from __future__ import annotations

import logging
import os
import sys

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
