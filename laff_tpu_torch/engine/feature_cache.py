"""Device-resident train features (``laff_tpu.engine.feature_cache``).

The train set's video features and caption encodings do not change between
epochs, yet the fed path featurizes and copies them to the card for every
batch. A cache uploads every row once; a batch then becomes a (B,) vector
of row indices and the train step gathers its rows on the card. The arrays
are the batchers' own over all ids (chunked), with the same host bf16
rounding the fed path applies for bf16 towers, so gathered rows equal fed
batches bit for bit.

A FrameLAFF batcher's frame arrays and masks are cached as the feed makes
them, padded to ``max_frame`` for every video ((V, max_frame, D) and
(V, max_frame)): a gathered batch equals a fed one bit for bit and has the
one shape a CUDA graph of the step needs, and the estimate counts them.
task2's per-video concept labels ('task2_labels', a multi-hot row per
video) are one more visual array, cached and gathered like the features.

At the rehearsal world's scale (1,500 videos x 5,376 dims, 30,000
captions with a dense bow row each) both caches together take under a GB
of device memory (the FrameLAFF world's 50 x 512 bf16 frame rows add
77 MB); the trainer's auto rule estimates first and declines a cache above
``LAFF_TPU_CACHE_BUDGET``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data import host_cast_bf16
from ..utils import get_logger

logger = get_logger(__name__)


def _nbytes(tensors: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


class _RowCache:
    """Arrays on ``device`` with one row per id, and the ids' row indices."""

    def __init__(self, ids: Sequence[str], arrays: Dict[str, np.ndarray], bf16: bool,
                 device: torch.device, what: str, t0: float) -> None:
        self.device = torch.device(device)
        self.row = {v: i for i, v in enumerate(ids)}
        self.arrays = {k: v.to(self.device) for k, v in host_cast_bf16(arrays, bf16).items()}
        self.nbytes = _nbytes(self.arrays)
        self.build_seconds = time.perf_counter() - t0
        logger.info("device %s cache: %d rows, %d arrays, %.1f MB on %s in %.1f s", what,
                    len(ids), len(self.arrays), self.nbytes / 1e6, self.device,
                    self.build_seconds)

    def indices(self, ids: Sequence[str]) -> torch.Tensor:
        """(B,) int64 row indices on the CPU, pinned when the cache lives on
        the card (built in the prefetch thread, copied without a sync)."""
        idx = torch.from_numpy(np.fromiter((self.row[v] for v in ids), np.int64,
                                           count=len(ids)))
        return idx.pin_memory() if self.device.type == "cuda" else idx

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: v[idx] for k, v in self.arrays.items()}


class DeviceVisCache(_RowCache):
    """Every train video's features on ``device``, looked up by vis_id."""

    def __init__(self, vis_batcher, device: torch.device, bf16: bool = False,
                 chunk: int = 512) -> None:
        t0 = time.perf_counter()
        vids = list(vis_batcher.source.vis_ids)
        parts = [vis_batcher(vids[s:s + chunk]) for s in range(0, len(vids), chunk)]
        arrays = {n: np.concatenate([p[n] for p in parts]) for n in parts[0]}
        super().__init__(vids, arrays, bf16, device, "feature", t0)


class DeviceTxtCache(_RowCache):
    """Every train caption's text arrays on ``device``, looked up by cap_id:
    the feed's TextBatcher run once over all captions (chunked). With the
    visual cache a train batch is two (B,) index vectors."""

    def __init__(self, text_batcher, device: torch.device,
                 cap_ids: Optional[Sequence[str]] = None, bf16: bool = False,
                 chunk: int = 1024) -> None:
        t0 = time.perf_counter()
        caps = list(cap_ids if cap_ids is not None else text_batcher.source.cap_ids)
        parts = [text_batcher(caps[s:s + chunk]) for s in range(0, len(caps), chunk)]
        # every array the batcher makes has a fixed width (max_txtlength, or
        # BERT's max_length); a live tower's rows are tensors on its device
        arrays = {n: torch.cat([p[n] for p in parts]) if isinstance(parts[0][n], torch.Tensor)
                  else np.concatenate([p[n] for p in parts]) for n in parts[0]}
        super().__init__(caps, arrays, bf16, device, "text", t0)


def _bytes_per_row(sample: Dict[str, np.ndarray], bf16: bool) -> int:
    tensors = host_cast_bf16(sample, bf16)
    return sum(t.numel() * t.element_size() // t.shape[0] for t in tensors.values())


def estimate_txt_cache_bytes(text_batcher, cap_ids=None, bf16: bool = False,
                             probe: int = 64) -> int:
    """The text cache's bytes, from a probe batch (every array has a fixed
    width, so the probe's rows are every row's)."""
    caps = list(cap_ids if cap_ids is not None else text_batcher.source.cap_ids)
    return _bytes_per_row(text_batcher(caps[:probe]), bf16) * len(caps)


def estimate_vis_cache_bytes(vis_batcher, bf16: bool = False, probe: int = 64) -> int:
    vids = list(vis_batcher.source.vis_ids)
    return _bytes_per_row(vis_batcher(vids[:probe]), bf16) * len(vids)
