"""Rank-based retrieval metrics: R@1/5/10, MedR, MeanR, MIR, mAP.

Two paths, as in ``laff_tpu.eval.metrics``:

* **Host path** — the reference metric semantics (``evaluation.py:64-109``
  and the label matrix of ``trainer.py:590-594``) in numpy, including the
  argsort tie rule: descending order comes from *reversing a stable
  ascending argsort*, so among tied scores the larger column index ranks
  first, and MedR is ``floor(median)`` without +1.

* **Device path** — ``ranks_from_scores`` counts, per row, the scores
  above the ground-truth column plus the ties at a larger column index:
  two masked row reductions in torch on whatever device holds the scores,
  giving the host path's ranks without a sort.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _id_codes(*id_lists: Sequence[str]):
    """One int64 array per list, equal ids given equal codes: the label
    matrices compare these instead of strings, with the same result."""
    table: dict = {}
    return [np.fromiter((table.setdefault(i, len(table)) for i in ids), np.int64, len(ids))
            for ids in id_lists]


def label_matrix_from_scores(
    scores: np.ndarray, query_ids: Sequence[str], gallery_ids: Sequence[str]
) -> np.ndarray:
    """Sort each row descending (reversed stable ascending argsort) and mark
    the positions whose gallery id equals ``query_id.split('#')[0]``."""
    scores = np.asarray(scores)
    inds = np.argsort(scores, axis=1)
    query_codes, gallery_codes = _id_codes([q.split("#")[0] for q in query_ids], gallery_ids)
    label_matrix = np.zeros(scores.shape, dtype=np.int32)
    for i in range(len(query_ids)):
        ind = inds[i][::-1]
        label_matrix[i][np.where(gallery_codes[ind] == query_codes[i])[0]] = 1
    return label_matrix


def eval_label_matrix(label_matrix: np.ndarray):
    """(r1, r5, r10, medr, meanr, mir, mAP) from a 0/1 label matrix whose
    columns are already in ranked order."""
    label_matrix = np.asarray(label_matrix).astype(int)
    n = label_matrix.shape[0]
    ranks = np.zeros(n)
    aps = np.zeros(n)
    for i in range(n):
        positions = np.where(label_matrix[i] == 1)[0] + 1
        ranks[i] = positions[0]
        aps[i] = np.mean([(k + 1.0) / positions[k] for k in range(len(positions))])

    r1, r5, r10 = [100.0 * np.mean(ranks <= k) for k in (1, 5, 10)]
    medr = np.floor(np.median(ranks))
    meanr = ranks.mean()
    mir = (1.0 / ranks).mean()
    return (r1, r5, r10, medr, meanr, mir, aps.mean())


def eval_qry2retro(qry2retro_sim: np.ndarray, n_qry: int = 1):
    """Legacy block-diagonal protocol (reference ``evaluation.py:64-89``):
    query row i matches gallery column i // n_qry. MedR and MeanR are +1
    here, unlike ``eval_label_matrix``; ties follow the reversed ascending
    argsort, as there."""
    sim = np.asarray(qry2retro_sim)
    assert sim.shape[0] / sim.shape[1] == n_qry, sim.shape
    inds = np.argsort(sim, axis=1)
    ranks = np.zeros(sim.shape[0])
    for i in range(sim.shape[0]):
        ind = inds[i][::-1]
        ranks[i] = np.where(ind == i // n_qry)[0][0]
    r1 = 100.0 * np.mean(ranks < 1)
    r5 = 100.0 * np.mean(ranks < 5)
    r10 = 100.0 * np.mean(ranks < 10)
    medr = np.floor(np.median(ranks)) + 1
    meanr = ranks.mean() + 1
    mir = (1.0 / (ranks + 1)).mean()
    return (r1, r5, r10, medr, meanr, mir)


def eval_t2v(scores: np.ndarray, txt_ids: Sequence[str], vis_ids: Sequence[str]):
    """Text->video metrics straight from a score matrix."""
    return eval_label_matrix(label_matrix_from_scores(scores, txt_ids, vis_ids))


def eval_v2t(scores: np.ndarray, txt_ids: Sequence[str], vis_ids: Sequence[str]):
    """Video->text: transpose, queries become videos; a caption is relevant
    when its ``cap_id.split('#')[0]`` equals the video id (reference
    ``predictor.py:261-276``)."""
    t_scores = np.asarray(scores).T
    inds = np.argsort(t_scores, axis=1)
    root_codes, vis_codes = _id_codes([t.split("#")[0] for t in txt_ids], vis_ids)
    label_matrix = np.zeros(t_scores.shape, dtype=np.int32)
    for i in range(len(vis_ids)):
        ind = inds[i][::-1]
        label_matrix[i][np.where(root_codes[ind] == vis_codes[i])[0]] = 1
    return eval_label_matrix(label_matrix)


def ranks_from_scores(scores: torch.Tensor, gt_cols: torch.Tensor) -> torch.Tensor:
    """1-based rank of ``gt_cols[q]`` in row q under descending order with
    larger-index-first ties: (Q, G) float scores, (Q,) ints -> (Q,) int32."""
    gt = gt_cols.to(device=scores.device, dtype=torch.long)[:, None]
    cols = torch.arange(scores.shape[1], device=scores.device)[None, :]
    gt_scores = torch.gather(scores, 1, gt)
    beats = (scores > gt_scores) | ((scores == gt_scores) & (cols > gt))
    return (1 + beats.sum(dim=1)).to(torch.int32)


def metrics_from_ranks(ranks):
    """(r1, r5, r10, medr, meanr, mir, mAP) for the single-positive case
    (mAP == MIR when each query has exactly one relevant item)."""
    ranks = np.asarray(ranks, dtype=np.float64)
    r1, r5, r10 = [100.0 * np.mean(ranks <= k) for k in (1, 5, 10)]
    medr = np.floor(np.median(ranks))
    meanr = ranks.mean()
    mir = (1.0 / ranks).mean()
    return (r1, r5, r10, medr, meanr, mir, mir)
