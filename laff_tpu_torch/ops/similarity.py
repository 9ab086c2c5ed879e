"""Similarity measures: cosine, the LAFF-ml multi-head mean, flat heads.

The H-head mean of per-head cosines equals (1/H) times the dot of the
per-head-normalized, concatenated embeddings, so the multi-head score
matrix is one (T, H*d) x (H*d, V) product over ``flatten_heads`` output.
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
