"""BigFile feature store: a memory-mapped random-access feature matrix.

On-disk format (byte-compatible with the reference store so existing
feature dumps load unchanged; cf. reference ``bigfile.py:13-241``):

  <dir>/feature.bin   row-major float32, one D-dim vector per row
  <dir>/id.txt        newline- (or space-) separated row names
  <dir>/shape.txt     "N D"

A single ``numpy.memmap`` replaces the reference's per-row
``seek``+``array.fromfile`` loop: gathers become one fancy-index read (the
OS page cache does the coalescing), giving the host feed large contiguous
numpy reads that go to the card with one copy per batch.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..utils import get_logger, makedirs

logger = get_logger(__name__)


def _read_names(id_file: str, expected: int) -> List[str]:
    with open(id_file, "r") as fh:
        raw = fh.read().strip()
    names = raw.split("\n")
    if len(names) != expected:
        names = raw.split(" ")
    if len(names) != expected:
        raise ValueError(
            f"{id_file}: found {len(names)} ids, shape.txt says {expected}"
        )
    return names


class BigFile:
    """Random-access reader over a (N, D) float32 feature matrix."""

    def __init__(self, datadir: str, bin_file: str = "feature.bin") -> None:
        with open(os.path.join(datadir, "shape.txt")) as fh:
            self.nr_of_images, self.ndims = map(int, fh.readline().split())
        self.names = _read_names(os.path.join(datadir, "id.txt"), self.nr_of_images)
        self.name2index = {name: i for i, name in enumerate(self.names)}
        self.binary_file = os.path.join(datadir, bin_file)
        self._mmap = np.memmap(
            self.binary_file, dtype=np.float32, mode="r",
            shape=(self.nr_of_images, self.ndims),
        )
        logger.info(
            "[BigFile] %dx%d instances mapped from %s",
            self.nr_of_images, self.ndims, datadir,
        )

    def gather(self, names: Sequence[str]) -> Tuple[List[str], np.ndarray]:
        """Return (found_names, (n, D) float32 array) preserving request order.

        Unknown names are silently dropped, matching reference semantics.
        """
        found = [n for n in names if n in self.name2index]
        if not found:
            return [], np.zeros((0, self.ndims), dtype=np.float32)
        idx = np.fromiter((self.name2index[n] for n in found), dtype=np.int64)
        return found, np.asarray(self._mmap[idx])

    def shape(self) -> List[int]:
        return [self.nr_of_images, self.ndims]


def write_bigfile(resultdir: str, names: Sequence[str], matrix: np.ndarray) -> None:
    """Write a (N, D) float32 matrix in BigFile format."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    if matrix.ndim != 2 or len(names) != matrix.shape[0]:
        raise ValueError(f"names ({len(names)}) / matrix {matrix.shape} mismatch")
    makedirs(resultdir)
    matrix.tofile(os.path.join(resultdir, "feature.bin"))
    with open(os.path.join(resultdir, "id.txt"), "w") as fh:
        fh.write("\n".join(names))
    with open(os.path.join(resultdir, "shape.txt"), "w") as fh:
        fh.write("%d %d" % matrix.shape)
    logger.info("wrote %dx%d features to %s", matrix.shape[0], matrix.shape[1], resultdir)
