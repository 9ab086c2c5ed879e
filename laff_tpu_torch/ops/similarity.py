"""Similarity measures: cosine, the LAFF-ml multi-head mean, flat heads,
and the generalized Jaccard ('hist').

The H-head mean of per-head cosines equals (1/H) times the dot of the
per-head-normalized, concatenated embeddings, so the multi-head score
matrix is one (T, H*d) x (H*d, V) product over ``flatten_heads`` output.

``hist_sim`` is ``laff_tpu``'s, term for term (the losses use it);
``hist_scores`` is the same measure for scoring galleries: with
min(a, b) = (a + b - |a - b|) / 2, the sums of the minima and the maxima
over d come from the rows' sums and their L1 distance (``torch.cdist``,
p=1), in f64, so no (T, V, d) intermediate is made and the scores do not
depend on the device's order of summation.
"""

from __future__ import annotations

import torch

from .norms import l2norm


def cosine_sim(query: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (G, D) -> (Q, G) cosine similarity."""
    return l2norm(query) @ l2norm(gallery).T


def multi_head_cosine_sim(
    txt: torch.Tensor, vis: torch.Tensor, mean: bool = True
) -> torch.Tensor:
    """txt (T, H, d), vis (V, H, d): per-head cosines averaged over heads
    when ``mean``, else the (H, T, V) per-space matrices."""
    sims = torch.einsum("thd,vhd->htv", l2norm(txt), l2norm(vis))
    return sims.mean(dim=0) if mean else sims


def flatten_heads(embs: torch.Tensor) -> torch.Tensor:
    """(N, H, d) multi-head embeddings -> per-head-normalized (N, H*d)."""
    if embs.ndim == 2:
        return l2norm(embs)
    n, h, d = embs.shape
    return l2norm(embs, dim=-1).reshape(n, h * d)


def hist_sim(im: torch.Tensor, s: torch.Tensor, eps: float = 1e-14) -> torch.Tensor:
    """Generalized Jaccard similarity (reference ``loss.py:43-50``):
    sum(min) / (sum(max) + eps) over all row pairs, (..., B_im, D) x
    (..., B_s, D) -> (..., B_im, B_s)."""
    im_e, s_e = im[..., :, None, :], s[..., None, :, :]
    intersection = torch.minimum(im_e, s_e).sum(dim=-1)
    union = torch.maximum(im_e, s_e).sum(dim=-1) + eps
    return intersection / union


def hist_scores(txt: torch.Tensor, vis: torch.Tensor, eps: float = 1e-14) -> torch.Tensor:
    """'hist' scores of (T, D) x (V, D) embeddings, or the per-head mean of
    (T, H, d) x (V, H, d) ones, in f64 -> (T, V)."""
    t = (txt if txt.ndim == 3 else txt[:, None, :]).double()
    v = (vis if vis.ndim == 3 else vis[:, None, :]).double()
    l1 = torch.cdist(t.transpose(0, 1), v.transpose(0, 1), p=1)  # (H, T, V)
    total = t.sum(dim=-1).T[:, :, None] + v.sum(dim=-1).T[:, None, :]  # (H, T, V)
    scores = (total - l1) / (total + l1 + 2.0 * eps)  # sum(min) / (sum(max) + eps)
    return scores.mean(dim=0)
