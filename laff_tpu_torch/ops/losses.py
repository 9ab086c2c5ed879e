"""Retrieval losses: the counterparts of ``laff_tpu.ops.losses``.

  triplet_loss_from_scores  improved triplet on a (B, B) score matrix whose
                            diagonal holds the positive pairs
  triplet_loss              the same on (B, D) embedding pairs
  triplet_loss_multi_space  LAFF-ml: one triplet loss per head, summed
  dual_softmax_loss         prior-reweighted symmetric InfoNCE (DSL)
  cross_entropy_loss        -sum(diag(sim))

Layout as in the JAX package: rows index videos, columns index captions
(``scores = sim(vis, txt)``); ``measure`` is 'cosine' or 'hist' (the
generalized Jaccard of ``ops.similarity.hist_sim``). Direction 't2i' compares each diagonal entry
with its column (video retrieval), 'i2t' with its row, 'bidir' both;
``max_violation`` keeps the hardest negative only. Score matrices may carry
leading batch dimensions (one per head); the losses reduce the last two.
The negation losses (margin, margin2, kl) come with task3.
"""

from __future__ import annotations

import torch

from .norms import l2norm
from .similarity import hist_sim


def _triplet(scores: torch.Tensor, margin: float, direction: str, max_violation: bool,
             cost_style: str) -> torch.Tensor:
    """Per-matrix triplet loss of (..., B, B) scores -> (...)."""
    n = scores.shape[-1]
    diagonal = torch.diagonal(scores, dim1=-2, dim2=-1)
    eye = torch.eye(n, dtype=torch.bool, device=scores.device)
    zero = scores.new_zeros(())
    total = scores.new_zeros(scores.shape[:-2])
    reduce = torch.sum if cost_style == "sum" else torch.mean
    if direction in ("i2t", "bidir"):
        cost_s = torch.where(eye, zero, torch.clamp(margin + scores - diagonal[..., :, None],
                                                    min=0.0))
        cost_s = cost_s.amax(dim=-1) if max_violation else cost_s.flatten(-2)
        total = total + reduce(cost_s, dim=-1)
    if direction in ("t2i", "bidir"):
        cost_im = torch.where(eye, zero, torch.clamp(margin + scores - diagonal[..., None, :],
                                                     min=0.0))
        cost_im = cost_im.amax(dim=-2) if max_violation else cost_im.flatten(-2)
        total = total + reduce(cost_im, dim=-1)
    return total


def triplet_loss_from_scores(scores: torch.Tensor, margin: float = 0.2, direction: str = "t2i",
                             max_violation: bool = True, cost_style: str = "sum") -> torch.Tensor:
    """Improved triplet loss on a (B, B) score matrix (rows videos, columns
    captions)."""
    return _triplet(scores, margin, direction, max_violation, cost_style)


def _cosine_scores(vis: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
    """(B, D) pairs -> (B, B); (B, H, d) pairs -> (H, B, B) per-head cosines."""
    if vis.ndim == 3:
        return torch.einsum("bhd,chd->hbc", l2norm(vis), l2norm(txt))
    return l2norm(vis) @ l2norm(txt).T


def _scores(vis: torch.Tensor, txt: torch.Tensor, measure: str) -> torch.Tensor:
    """(B, D) pairs -> (B, B); (B, H, d) pairs -> (H, B, B), per head."""
    if measure == "cosine":
        return _cosine_scores(vis, txt)
    if measure != "hist":
        raise ValueError(f"measure {measure!r} is not 'cosine' or 'hist'")
    if vis.ndim == 3:
        return hist_sim(vis.transpose(0, 1), txt.transpose(0, 1))
    return hist_sim(vis, txt)


def triplet_loss(txt_embs: torch.Tensor, vis_embs: torch.Tensor, margin: float = 0.2,
                 measure: str = "cosine", direction: str = "t2i", max_violation: bool = True,
                 cost_style: str = "sum") -> torch.Tensor:
    """MarginRankingLoss on (B, D) embedding pairs."""
    return _triplet(_scores(vis_embs, txt_embs, measure), margin, direction, max_violation,
                    cost_style)


def triplet_loss_multi_space(txt_embs: torch.Tensor, vis_embs: torch.Tensor, margin: float = 0.2,
                             measure: str = "cosine", direction: str = "t2i",
                             max_violation: bool = True, cost_style: str = "sum") -> torch.Tensor:
    """LAFF-ml: one triplet loss per head of (B, H, d) embeddings, summed
    (not averaged) over the heads; the H score matrices are one batched
    product."""
    per_head = _triplet(_scores(vis_embs, txt_embs, measure), margin, direction, max_violation,
                        cost_style)
    return per_head.sum()


def dual_softmax_loss_from_scores(sim: torch.Tensor, temp: float = 1000.0) -> torch.Tensor:
    """DSL on (..., B, B) in-batch similarities -> (...)."""

    def one_side(s: torch.Tensor) -> torch.Tensor:
        n = s.shape[-2]
        s = s * torch.softmax(s / temp, dim=-2) * n
        return -torch.diagonal(torch.log_softmax(s, dim=-1), dim1=-2, dim2=-1).sum(dim=-1)

    return (one_side(sim) + one_side(sim.transpose(-2, -1))) / 2.0


def dual_softmax_loss(txt_embs: torch.Tensor, vis_embs: torch.Tensor,
                      temp: float = 1000.0) -> torch.Tensor:
    """DSL over (B, D) pairs, or per head over (B, H, d) pairs -> (H,)."""
    return dual_softmax_loss_from_scores(_cosine_scores(txt_embs, vis_embs), temp)


def cross_entropy_loss_from_scores(sim: torch.Tensor) -> torch.Tensor:
    return -torch.diagonal(sim, dim1=-2, dim2=-1).sum(dim=-1)


def cross_entropy_loss(txt_embs: torch.Tensor, vis_embs: torch.Tensor) -> torch.Tensor:
    """The reference CrossEntropyLoss, which reduces to -sum(diag(sim));
    per head over (B, H, d) pairs -> (H,)."""
    return cross_entropy_loss_from_scores(_cosine_scores(txt_embs, vis_embs))
