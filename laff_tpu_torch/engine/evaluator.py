"""Inference: embed galleries and queries, similarity matrices, gt ranks.

Visual embeddings are computed once and kept on the device; text batches
stream through the text tower; the full score matrix (for v2t metrics and
the rank dump) is built in text blocks; t2v ranks come from counting on
the device, never from a host argsort.

Rank paths (``rank_path``), with the rule of ``laff_tpu.engine.evaluator``:

  flat       one (block, V) f32 score block per text block (torch.matmul,
             a plain product outside any kernel) + torch counting; taken by
             ``auto`` while the block fits ``FLAT_SCORE_BUDGET``
  blockwise  the same with text blocks shrunk to the budget
  kernel     the fused CUDA rank kernel (``ops.fused_sim_rank``) on bf16
             operands; ``auto`` takes it only for bf16 embeddings on the
             card above the budget, so f32 towers keep full precision.
             Asking for it explicitly opts f32 embeddings into the bf16 cast
             (the counterpart of ``LAFF_TPU_RANK_PATH=pallas``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data import EvalFeed, Prefetcher
from ..eval.metrics import metrics_from_ranks, ranks_from_scores
from ..ops import cosine_sim, flatten_heads, fused_sim_rank, multi_head_cosine_sim
from ..utils import get_logger

logger = get_logger(__name__)

RANK_PATHS = ("auto", "flat", "kernel", "blockwise")

# bytes of one materialized f32 score block on the flat rank path
FLAT_SCORE_BUDGET = 2 * 1024**3

# galleries above this are streamed by the reference (model/model.py:1020);
# the streaming evaluator comes in a later slice of the port
LARGE_GALLERY = 50_000


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


class Embedder:
    """Tower application over eval feeds, grad off, batches featurized on
    the host by a prefetch thread ``prefetch_depth`` batches ahead."""

    def __init__(self, model, device: torch.device, prefetch_depth: int = 2):
        self.model = model
        self.device = torch.device(device)
        self.prefetch_depth = max(1, prefetch_depth)

    @torch.no_grad()
    def _embed(self, fn, feed: EvalFeed) -> Tuple[torch.Tensor, List[str]]:
        chunks, ids = [], []
        for item in Prefetcher(iter(feed), depth=self.prefetch_depth):
            emb = fn(to_device(item["data"], self.device))
            valid = item["valid"]
            chunks.append(emb[:valid] if valid < emb.shape[0] else emb)
            ids.extend(item["ids"])
        return torch.cat(chunks, dim=0), ids

    def embed_txt(self, feed: EvalFeed):
        return self._embed(self.model.encode_txt, feed)

    def embed_vis(self, feed: EvalFeed):
        return self._embed(self.model.encode_vis, feed)


@torch.no_grad()
def score_matrix(txt_embs: torch.Tensor, vis_embs: torch.Tensor, block: int = 8192,
                 measure: str = "cosine") -> np.ndarray:
    """Full (T, V) f32 similarity matrix on the host, computed on the
    embeddings' device in text blocks."""
    if measure != "cosine":
        raise NotImplementedError(f"measure {measure!r} is not ported yet")
    fn = multi_head_cosine_sim if txt_embs.ndim == 3 else cosine_sim
    n = txt_embs.shape[0]
    out = np.empty((n, vis_embs.shape[0]), dtype=np.float32)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = fn(txt_embs[start:stop], vis_embs).float().cpu().numpy()
    return out


def rank_path_for(t_block: int, v: int, dtype: torch.dtype, device_type: str,
                  rank_path: str = "auto") -> str:
    """Pick the rank path for a (t_block x v) score regime."""
    if rank_path not in RANK_PATHS:
        raise ValueError(f"rank_path={rank_path!r} is not one of {'|'.join(RANK_PATHS)}")
    if rank_path != "auto":
        return rank_path
    if t_block * v * 4 <= FLAT_SCORE_BUDGET:
        return "flat"
    if dtype != torch.bfloat16:
        return "blockwise"
    return "kernel" if device_type == "cuda" else "blockwise"


@torch.no_grad()
def t2v_ranks(txt_embs: torch.Tensor, vis_embs: torch.Tensor, txt_ids: List[str],
              vis_ids: List[str], block: int = 8192, measure: str = "cosine",
              rank_path: str = "auto") -> np.ndarray:
    """1-based ranks of each caption's ground-truth video, computed on the
    embeddings' device. Embeddings are per-head normalized and flattened
    once (the H-head mean of cosines is one flat dot / H). Exact duplicate
    scores rank the larger gallery index first on every path."""
    if measure != "cosine":
        raise NotImplementedError(f"measure {measure!r} is not ported yet")
    vid_index = {v: i for i, v in enumerate(vis_ids)}
    gt = torch.as_tensor([vid_index[t.split("#")[0]] for t in txt_ids],
                         dtype=torch.int32, device=txt_embs.device)
    heads = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
    tn = flatten_heads(txt_embs)
    vn = flatten_heads(vis_embs)
    n, v = tn.shape[0], vn.shape[0]
    path = rank_path_for(min(block, n), v, tn.dtype, tn.device.type, rank_path)
    if path == "kernel":
        return fused_sim_rank(tn, vn, gt, prenormalized=True).cpu().numpy()
    rows = max(256, (FLAT_SCORE_BUDGET // (v * 4)) // 256 * 256)
    block = min(n, max(block, rows)) if path == "flat" else min(block, rows)
    ranks = np.empty((n,), dtype=np.int32)
    for start in range(0, n, block):
        stop = min(start + block, n)
        scores = (tn[start:stop] @ vn.T) / heads
        ranks[start:stop] = ranks_from_scores(scores, gt[start:stop]).cpu().numpy()
    return ranks


def validate(embedder: Embedder, txt_feed: EvalFeed, vis_feed: EvalFeed,
             measure: str = "cosine", rank_path: str = "auto") -> Dict:
    """Text-to-video metrics over a validation split (``laff_tpu.engine.
    evaluator.validate``): r1, r5, r10, medr, meanr, mir and mAP, with the
    ranks and ids. The model runs in eval mode under no_grad, so on the
    card the towers take the gate kernel, and ``rank_path`` picks the rank
    path as in the predictor."""
    model = embedder.model
    was_training = model.training
    model.eval()
    try:
        vis_embs, vis_ids = embedder.embed_vis(vis_feed)
        txt_embs, txt_ids = embedder.embed_txt(txt_feed)
        ranks = t2v_ranks(txt_embs, vis_embs, txt_ids, vis_ids, measure=measure,
                          rank_path=rank_path)
    finally:
        model.train(was_training)
    names = ("r1", "r5", "r10", "medr", "meanr", "mir", "mAP")
    return {**{k: float(v) for k, v in zip(names, metrics_from_ranks(ranks))}, "ranks": ranks,
            "txt_ids": txt_ids, "vis_ids": vis_ids}
