"""The reference's similarity, ground-truth ranks and text-to-video
metrics, and the comparison that judges ranks a program reported.

The score of caption t against video v is the mean over the H heads of
the cosine of their embeddings: one dot product of the per-head
normalized, flattened rows, divided by H. A caption's rank is 1 plus the
number of videos whose score beats its ground truth's (a tie counts for
the larger video index, the rule the port ranks by).

``rank_gaps``: a reported rank r says that r - 1 videos beat the ground
truth. Against the reference's scores it is consistent within a gap e
when at most r - 1 videos score more than e above the ground truth and at
least r - 1 score more than -e above it. The smallest such e is the
caption's gap, 0 when the reference counts r - 1 itself: the widest gap,
in score units, by which a reported rank departs from the reference."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

Tensor = torch.Tensor
METRICS = ("r1", "r5", "r10", "medr", "meanr", "mir", "mAP")


def scores(txt_flat: Tensor, vis_flat: Tensor, heads: int) -> Tensor:
    return (txt_flat @ vis_flat.T) / heads


def ranks_from_scores(s: Tensor, gt: Tensor) -> Tensor:
    cols = torch.arange(s.shape[1], device=s.device)[None, :]
    g = s.gather(1, gt[:, None])
    beats = (s > g) | ((s == g) & (cols > gt[:, None]))
    return 1 + beats.sum(dim=1)


def rank_gaps(s: Tensor, gt: Tensor, ranks: Tensor) -> Tensor:
    """(T,) gap of each reported rank against the reference scores ``s``
    (T, V)."""
    rows = torch.arange(s.shape[0], device=s.device)
    d = s - s[rows, gt][:, None]
    d[rows, gt] = -float("inf")  # the ground truth never beats itself
    ds = torch.sort(d, dim=1, descending=True).values
    above = ranks.long() - 1  # videos the report puts above the ground truth
    above = above.clamp(0, s.shape[1] - 1)
    n_ref = (d > 0).sum(dim=1)
    fewer = ds[rows, above.clamp(max=s.shape[1] - 1)]  # the first video the report leaves below
    more = ds[rows, (above - 1).clamp(min=0)]  # the last video the report puts above
    gap = torch.zeros_like(ds[:, 0])
    gap = torch.where(above < n_ref, fewer, gap)
    gap = torch.where(above > n_ref, -more, gap)
    bad = (ranks < 1) | (ranks > s.shape[1])  # a rank no gallery can give
    return torch.where(bad, torch.full_like(gap, float("inf")), gap)


def metrics_from_ranks(ranks: Sequence[int]) -> Dict[str, float]:
    r = np.asarray(ranks, dtype=np.float64)
    mir = float(np.mean(1.0 / r))
    return {"r1": 100.0 * float(np.mean(r <= 1)), "r5": 100.0 * float(np.mean(r <= 5)),
            "r10": 100.0 * float(np.mean(r <= 10)), "medr": float(np.floor(np.median(r))),
            "meanr": float(np.mean(r)), "mir": mir, "mAP": mir}
