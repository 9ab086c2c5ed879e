"""Inference: embed galleries and queries, similarity matrices, gt ranks.

Visual embeddings are computed once and kept on the device; text batches
stream through the text tower (float features rounded to bf16 for bf16
towers, the towers' own first op, on the card after an f32 upload; with
``host_cast`` on the host before it); an eval feed with
``stage_on_device`` keeps its uploaded batches on the card after its first
pass and replays them on later ones (validation features do not change
between epochs), up to ``LAFF_TPU_EVAL_STAGE_BUDGET`` bytes (4 GiB) a
feed, every array counted (a FrameLAFF gallery's padded frames and masks
too), above which it streams unstaged as ``laff_tpu`` does; the full
score matrix (for v2t metrics and the rank dump) is built in text blocks;
t2v ranks come from counting on the device, never from a host argsort.

Galleries above ``LARGE_GALLERY`` videos (``LAFF_TPU_LARGE_GALLERY``, read
at import, 50,000 by default: the reference's threshold) are not embedded
whole: ``score_matrix_streaming`` sends each gallery batch through the
video tower and scores it against every query, keeping only the (T, V)
host scores.

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

Measure 'hist' (generalized Jaccard, per-head mean for multi-space
embeddings) never goes to the rank kernel: whatever ``rank_path`` asks,
its scores come from ``ops.hist_scores`` (f64) in text blocks of at most
``HIST_BLOCK_BUDGET`` bytes of (H, block, V) intermediates, and its ranks
are counted on them with the same tie rule. Rows are independent, so the
block moves no value.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..data import EvalFeed, Prefetcher, host_cast_bf16
from ..eval.metrics import metrics_from_ranks, ranks_from_scores
from ..ops import cosine_sim, flatten_heads, fused_sim_rank, hist_scores, multi_head_cosine_sim
from ..utils import get_logger

logger = get_logger(__name__)

RANK_PATHS = ("auto", "flat", "kernel", "blockwise")

# bytes of one materialized f32 score block on the flat rank path
FLAT_SCORE_BUDGET = 2 * 1024**3

# bytes of one text block's f64 (H, block, V) 'hist' intermediates
HIST_BLOCK_BUDGET = 1024**3

# galleries above this stream through score_matrix_streaming instead of being
# embedded whole (reference threshold 5e4, model/model.py:1020)
LARGE_GALLERY = int(os.environ.get("LAFF_TPU_LARGE_GALLERY", 50_000))


STAGE_BUDGET_ENV = "LAFF_TPU_EVAL_STAGE_BUDGET"
STAGE_BUDGET_DEFAULT = 4 * 1024**3  # bytes of device memory per staged feed


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              bf16: bool = False) -> Dict[str, torch.Tensor]:
    return {k: v.to(device, non_blocking=True) for k, v in host_cast_bf16(batch, bf16).items()}


def card_cast_bf16(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``host_cast_bf16`` on tensors already on the card: the same values."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v for k, v in batch.items()}


def device_batches(feed: EvalFeed, device: torch.device, bf16: bool, prefetch_depth: int,
                   host_cast: bool = False, stage: bool = True
                   ) -> Iterator[Tuple[Dict[str, torch.Tensor], List[str], int]]:
    """(device arrays, ids, valid) per batch of ``feed``, float ones rounded
    to bf16 with ``bf16`` (on the card after the upload, or with
    ``host_cast`` on the host before it); with ``stage``, staged on the
    card when the feed asks for it and the batches fit the budget, replayed
    from there on later passes (the same tensors, so the same embeddings)."""
    key = (str(device), bf16)
    stage = stage and feed.stage_on_device
    if stage and feed.staged is not None and feed.staged[0] == key:
        yield from feed.staged[1]
        return
    budget = int(os.environ.get(STAGE_BUDGET_ENV, STAGE_BUDGET_DEFAULT))
    items, nbytes = ([] if stage else None), 0
    for item in Prefetcher(iter(feed), depth=prefetch_depth):
        data = to_device(item["data"], device, bf16 and host_cast)
        if bf16 and not host_cast:
            data = card_cast_bf16(data)
        out = (data, item["ids"], item["valid"])
        if items is not None:
            nbytes += sum(t.numel() * t.element_size() for t in out[0].values())
            if nbytes > budget:
                logger.info("not staging the eval feed on the device: %d batches exceed the "
                            "%d-byte budget (%s to raise)", len(items) + 1, budget,
                            STAGE_BUDGET_ENV)
                items = None
            else:
                items.append(out)
        yield out
    if items is not None:
        feed.staged = (key, items)
        logger.info("staged the eval feed on the device: %d batches, %.1f MB (replayed on "
                    "later passes)", len(items), nbytes / 2**20)


class Embedder:
    """Tower application over eval feeds, grad off, batches featurized on
    the host by a prefetch thread ``prefetch_depth`` batches ahead, or
    replayed from the card for a staged feed. ``host_cast`` rounds float
    features to bf16 for bf16 towers on the host instead of the card
    (``device_batches``): the same embeddings, but a slower pass on an
    H100 machine (``chip_smoke.py``'s ``eval_cast_timing``)."""

    def __init__(self, model, device: torch.device, prefetch_depth: int = 2,
                 host_cast: bool = False):
        self.model = model
        self.device = torch.device(device)
        self.prefetch_depth = max(1, prefetch_depth)
        self.host_cast = host_cast
        spec = model.spec
        self._txt_bf16 = spec.txt.compute_dtype == "bfloat16"
        self._vis_bf16 = spec.vis.compute_dtype == "bfloat16"

    @torch.no_grad()
    def _embed(self, fn, feed: EvalFeed, bf16: bool) -> Tuple[torch.Tensor, List[str]]:
        chunks, ids = [], []
        for data, batch_ids, valid in device_batches(feed, self.device, bf16,
                                                     self.prefetch_depth, self.host_cast):
            emb = fn(data)
            chunks.append(emb[:valid] if valid < emb.shape[0] else emb)
            ids.extend(batch_ids)
        return torch.cat(chunks, dim=0), ids

    def embed_txt(self, feed: EvalFeed):
        return self._embed(self.model.encode_txt, feed, self._txt_bf16)

    def embed_vis(self, feed: EvalFeed):
        return self._embed(self.model.encode_vis, feed, self._vis_bf16)


@torch.no_grad()
def score_matrix_streaming(embedder: Embedder, txt_embs: torch.Tensor,
                           vis_feed: EvalFeed) -> Tuple[np.ndarray, List[str]]:
    """Cosine scores of every query against a gallery too large to embed
    whole (``laff_tpu.engine.evaluator.score_matrix_streaming``): each
    gallery batch goes through the video tower on the embedder's device
    (bf16 rounding as ``embed_vis`` does it, never staged) and is scored
    against all queries as the per-head mean of cosines, one product of the
    flattened unit heads divided by H; no block is kept on the device.
    Returns the host (T, V) f32 scores and the gallery ids in feed order."""
    heads = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
    tn = flatten_heads(txt_embs)
    blocks, vis_ids = [], []
    for data, ids, valid in device_batches(vis_feed, embedder.device, embedder._vis_bf16,
                                           embedder.prefetch_depth, embedder.host_cast,
                                           stage=False):
        vn = flatten_heads(embedder.model.encode_vis(data)[:valid])
        blocks.append((tn @ vn.T / heads).float().cpu().numpy())
        vis_ids.extend(ids)
    return np.concatenate(blocks, axis=1), vis_ids


def hist_block(heads: int, v: int) -> int:
    """Text rows per 'hist' block: three f64 (H, block, V) tensors within
    HIST_BLOCK_BUDGET."""
    return max(1, HIST_BLOCK_BUDGET // (3 * 8 * heads * v))


@torch.no_grad()
def score_matrix(txt_embs: torch.Tensor, vis_embs: torch.Tensor, block: int = 8192,
                 measure: str = "cosine") -> np.ndarray:
    """Full (T, V) f32 similarity matrix on the host, computed on the
    embeddings' device in text blocks."""
    if measure == "hist":
        fn = hist_scores
        heads = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
        block = min(block, hist_block(heads, vis_embs.shape[0]))
    elif measure == "cosine":
        fn = multi_head_cosine_sim if txt_embs.ndim == 3 else cosine_sim
    else:
        raise ValueError(f"measure {measure!r} is not 'cosine' or 'hist'")
    n = txt_embs.shape[0]
    out = np.empty((n, vis_embs.shape[0]), dtype=np.float32)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = fn(txt_embs[start:stop], vis_embs).float().cpu().numpy()
    return out


def rank_path_for(t_block: int, v: int, dtype: torch.dtype, device_type: str,
                  rank_path: str = "auto", measure: str = "cosine") -> str:
    """Pick the rank path for a (t_block x v) score regime; 'hist' always
    takes the blocked plain path."""
    if rank_path not in RANK_PATHS:
        raise ValueError(f"rank_path={rank_path!r} is not one of {'|'.join(RANK_PATHS)}")
    if measure == "hist":
        return "blockwise"
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
    embeddings' device. For 'cosine' the embeddings are per-head normalized
    and flattened once (the H-head mean of cosines is one flat dot / H).
    Exact duplicate scores rank the larger gallery index first on every
    path."""
    if measure not in ("cosine", "hist"):
        raise ValueError(f"measure {measure!r} is not 'cosine' or 'hist'")
    vid_index = {v: i for i, v in enumerate(vis_ids)}
    gt = torch.as_tensor([vid_index[t.split("#")[0]] for t in txt_ids],
                         dtype=torch.int32, device=txt_embs.device)
    n, v = txt_embs.shape[0], vis_embs.shape[0]
    heads = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
    if measure == "hist":
        rows = hist_block(heads, v)

        def scores(start, stop):
            return hist_scores(txt_embs[start:stop], vis_embs)
    else:
        tn, vn = flatten_heads(txt_embs), flatten_heads(vis_embs)
        rows = max(256, (FLAT_SCORE_BUDGET // (v * 4)) // 256 * 256)

        def scores(start, stop):
            return (tn[start:stop] @ vn.T) / heads
    path = rank_path_for(min(block, n), v, txt_embs.dtype, txt_embs.device.type, rank_path,
                         measure)
    if path == "kernel":
        return fused_sim_rank(tn, vn, gt, prenormalized=True).cpu().numpy()
    block = min(n, max(block, rows)) if path == "flat" else min(block, rows)
    ranks = np.empty((n,), dtype=np.int32)
    for start in range(0, n, block):
        stop = min(start + block, n)
        ranks[start:stop] = ranks_from_scores(scores(start, stop), gt[start:stop]).cpu().numpy()
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
