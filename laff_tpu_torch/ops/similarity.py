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

``blocked_topk`` is the exact top k of a gallery scored a block of rows at
a time, in the port's order (equal scores in decreasing gallery index):
each (score, column) pair is packed into one int64 key that sorts as the
pair does (``order_keys``), so ``torch.topk``, whose order of ties is
unspecified, never sees a tie, and the keys of several blocks, or of
several ranks' shards (``parallel.sim_engine``), merge by one more top k.
"""

from __future__ import annotations

from typing import Callable, Tuple

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


def order_keys(scores: torch.Tensor, col0: int) -> torch.Tensor:
    """(T, B) f32 scores of gallery columns col0.. -> int64 keys that sort
    as (score, column): the score's bits made monotone as a signed int32
    (negative floats have their magnitude bits flipped; -0.0 is made +0.0)
    in the high word, the column in the low word."""
    bits = (scores + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(col0, col0 + scores.shape[1], device=scores.device)
    return (bits.to(torch.int64) << 32) | cols


def decode_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``order_keys``' inverse: (scores f32, columns int64)."""
    bits = (keys >> 32).to(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.view(torch.float32), keys & 0xFFFFFFFF


def blocked_topk_keys(score_block: Callable[[int, int], torch.Tensor], n_rows: int, k: int,
                      block: int, col0: int = 0) -> torch.Tensor:
    """The top ``k`` ``order_keys`` (T, min(k, n_rows)) of ``n_rows`` gallery
    rows scored ``score_block(start, stop)`` -> (T, stop - start), ``block``
    rows at a time; the rows are gallery columns ``col0``.. . The last block
    is scored as the full-width window that ends at ``n_rows`` (its columns
    before ``start`` dropped), so every product has one shape whatever
    ``n_rows`` is: a row's score then does not depend on how the gallery was
    cut into blocks or shards (a product of another width may sum in
    another order)."""
    run = None
    for start in range(0, n_rows, block):
        stop = min(start + block, n_rows)
        lo = max(0, stop - block)
        keys = order_keys(score_block(lo, stop)[:, start - lo:], col0 + start)
        if run is not None:
            keys = torch.cat([run, keys], dim=1)
        run = torch.topk(keys, min(k, keys.shape[1]), dim=1).values
    return run


def blocked_topk(score_block: Callable[[int, int], torch.Tensor], n_rows: int, k: int,
                 block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top ``k`` of ``n_rows`` gallery rows (``blocked_topk_keys``):
    (values (T, k), indices (T, k)), descending, equal scores in decreasing
    gallery index."""
    return decode_keys(blocked_topk_keys(score_block, n_rows, k, block))
