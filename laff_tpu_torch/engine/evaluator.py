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
host scores. Two paths over such galleries keep no host (T, V) matrix at
all (``laff_tpu``'s):

* ``streaming_benchmark_eval``: exact t2v and v2t metrics and a running
  top-k in two passes over the gallery (the second from a device cache of
  the flat gallery when it fits ``LAFF_TPU_STREAM_GALLERY_BUDGET`` bytes,
  9 GiB by default, read at call time);
* ``int8_streaming_topk``: the gallery held on the device as int8 rows
  (``ops.quantized``), candidates nominated on the int8 product and
  re-embedded for exact scores.

Every top-k list these write puts equal scores in decreasing gallery index
order (``ordered_topk``, ``_topk_merge``); ``laff_tpu``'s ``lax.top_k``
puts the lower index first.

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

import math
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..data import EvalFeed, Prefetcher, host_cast_bf16
from ..eval.metrics import metrics_from_ranks, ranks_from_scores
from ..ops import (cosine_sim, flatten_heads, fused_sim_rank, hist_scores, int8_scores,
                   multi_head_cosine_sim, quantize_rows)
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


# bytes of device memory for the flat gallery of streaming_benchmark_eval's
# second pass; above it the gallery is streamed through the tower again
STREAM_BUDGET_ENV = "LAFF_TPU_STREAM_GALLERY_BUDGET"
STREAM_BUDGET_DEFAULT = 9 * 1024**3

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


def _vis_blocks(embedder: Embedder, feed: EvalFeed) -> Iterator[Tuple[torch.Tensor, List[str]]]:
    """(embeddings of the batch's valid rows, their ids) per gallery batch,
    through the video tower on the embedder's device (bf16 rounding as
    ``embed_vis`` does it), never staged."""
    for data, ids, valid in device_batches(feed, embedder.device, embedder._vis_bf16,
                                           embedder.prefetch_depth, embedder.host_cast,
                                           stage=False):
        yield embedder.model.encode_vis(data)[:valid], ids


def _flat_scores(tn: torch.Tensor, vn: torch.Tensor, heads: int) -> torch.Tensor:
    """Per-head mean of cosines from flat unit heads: one f32 product / H
    (bf16 rows are exact in f32, so the products are bf16 x bf16 with f32
    sums, as ``laff_tpu``'s ``preferred_element_type`` gives them)."""
    return (tn.float() @ vn.float().T) / heads


@torch.no_grad()
def score_matrix_streaming(embedder: Embedder, txt_embs: torch.Tensor,
                           vis_feed: EvalFeed) -> Tuple[np.ndarray, List[str]]:
    """Cosine scores of every query against a gallery too large to embed
    whole (``laff_tpu.engine.evaluator.score_matrix_streaming``): each
    gallery batch goes through the video tower and is scored against all
    queries (``_flat_scores``); no block is kept on the device. Returns the
    host (T, V) f32 scores and the gallery ids in feed order."""
    heads = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
    tn = flatten_heads(txt_embs)
    blocks, vis_ids = [], []
    for emb, ids in _vis_blocks(embedder, vis_feed):
        blocks.append(_flat_scores(tn, flatten_heads(emb), heads).cpu().numpy())
        vis_ids.extend(ids)
    return np.concatenate(blocks, axis=1), vis_ids


def ordered_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's top ``k`` (all columns when there are fewer), descending,
    equal scores in decreasing column order: ``torch.topk`` leaves the order
    of ties unspecified, so the columns are reversed and sorted stably."""
    v = scores.shape[1]
    vals, pos = torch.sort(scores.flip(1), dim=1, descending=True, stable=True)
    return vals[:, :k], v - 1 - pos[:, :k]


# ---------------------------------------------------------------------------
# streaming benchmark metrics (large gallery, both axes big)
# ---------------------------------------------------------------------------

def _gather_gt_scores(S: torch.Tensor, gt_cols: torch.Tensor, col_base: int,
                      gt_scores: torch.Tensor) -> torch.Tensor:
    """This block's ground-truth scores folded into the running (T,)
    vector; ``gt_cols`` are global gallery columns, and rows whose column
    lies outside [col_base, col_base + B) keep their value."""
    local = gt_cols - col_base
    hit = (local >= 0) & (local < S.shape[1])
    vals = S.gather(1, local.clamp(0, S.shape[1] - 1)[:, None])[:, 0]
    return torch.where(hit, vals, gt_scores)


def _count_inc(S: torch.Tensor, gt_scores: torch.Tensor, gt_cols: torch.Tensor,
               col_base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, this block's scores above the ground truth's and its ties at
    a larger global column (``ranks_from_scores``' rule)."""
    cols = col_base + torch.arange(S.shape[1], device=S.device)
    g = gt_scores[:, None]
    greater = (S > g).sum(dim=1)
    tie = ((S == g) & (cols[None, :] > gt_cols[:, None])).sum(dim=1)
    return greater, tie


def _topk_merge(run_vals: torch.Tensor, run_idx: torch.Tensor, S: torch.Tensor,
                col_base: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This block's columns merged into the running per-row top k (values,
    global indices), ordered by score descending, then index descending.
    The block's columns, reversed, go before the running list: every block
    index exceeds every running one, and the running list is in that order
    already, so one stable descending sort keeps the rule across blocks."""
    b = S.shape[1]
    blk_idx = torch.arange(col_base + b - 1, col_base - 1, -1, device=S.device)
    vals = torch.cat([S.flip(1), run_vals], dim=1)
    idx = torch.cat([blk_idx.expand(S.shape[0], b), run_idx], dim=1)
    vals, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(idx, 1, pos[:, :k])


def _v2t_block_ranks(S: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Ranks of each block video's positive captions among all T captions.
    S: (T, B) block scores (the caption axis complete), pos: (B, P) global
    caption indices, -1 padding. Returns (B, P) 1-based int32 ranks, 0 where
    padded; equal scores rank the larger caption index first. One slot at a
    time, so memory stays at one (T, B) comparison."""
    caps = torch.arange(S.shape[0], device=S.device)[:, None]
    cols = torch.arange(S.shape[1], device=S.device)
    out = torch.zeros(pos.shape, dtype=torch.int32, device=S.device)
    for p in range(pos.shape[1]):
        slot = pos[:, p]
        s_p = S[slot.clamp(min=0), cols][None, :]
        beats = (S > s_p) | ((S == s_p) & (caps > slot[None, :]))
        out[:, p] = torch.where(slot >= 0, 1 + beats.sum(dim=0), 0).to(torch.int32)
    return out


def metrics_from_positive_ranks(rank_lists: List[np.ndarray]):
    """(r1, r5, r10, medr, meanr, mir, mAP) from each query's sorted
    positive ranks: the multi-positive counterpart of ``eval_label_matrix``
    (reference ``evaluation.py:92-109``)."""
    n = len(rank_lists)
    firsts = np.empty(n)
    aps = np.empty(n)
    for i, pos in enumerate(rank_lists):
        firsts[i] = pos[0]
        aps[i] = np.mean([(j + 1.0) / pos[j] for j in range(len(pos))])
    r1, r5, r10 = [100.0 * np.mean(firsts <= kk) for kk in (1, 5, 10)]
    return (r1, r5, r10, float(np.floor(np.median(firsts))), float(firsts.mean()),
            float((1.0 / firsts).mean()), float(aps.mean()))


def _no_lap(name: str) -> None:
    pass


@torch.no_grad()
def streaming_benchmark_eval(embedder: Embedder, txt_embs: torch.Tensor, txt_ids: List[str],
                             vis_feed: EvalFeed, topk: int = 500, rank_path: str = "auto",
                             lap: Optional[Callable[[str], None]] = None) -> Dict:
    """Exact t2v and v2t benchmark metrics and a top-k rank dump over a
    gallery too large to embed whole, with no host (T, V) matrix
    (``laff_tpu.engine.evaluator.streaming_benchmark_eval``).

    * Pass 1 embeds each gallery block through the video tower and scores
      it against every query (``_flat_scores``). The block's scores give
      the ground-truth scores, the running top ``topk`` and the v2t ranks
      of the block's videos among all T captions.
    * Pass 2 counts each caption's t2v rank against its ground-truth score.
      When the flat gallery fits ``LAFF_TPU_STREAM_GALLERY_BUDGET`` bytes,
      pass 1 keeps it in a preallocated device cache and scores the cached
      rows; pass 2 then rescores the same cache slices with the same
      product, so its scores equal pass 1's bit for bit, or, for a bf16
      cache and bf16 text when ``rank_path_for`` picks 'kernel', hands the
      whole cache to ``fused_sim_rank`` (the tiled kernel at this size).
      Without the cache it streams the gallery through the tower again.

    ``lap(name)`` is called after each pass ('pass1', 'pass2'). Returns
    't2v' and 'v2t' metric tuples, 't2v_ranks', 'v2t_ranks' (each captioned
    video's sorted positive ranks, in gallery order), 'vis_ids', and with
    ``topk`` 'topk_idx' / 'topk_vals' (T, k) on the host, equal scores in
    decreasing gallery index order."""
    lap = lap or _no_lap
    heads = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
    tn = flatten_heads(txt_embs)
    n_txt, hd = tn.shape
    device = tn.device
    vis_ids = list(vis_feed.ids)
    n_vis = len(vis_ids)
    vid_index = {v: i for i, v in enumerate(vis_ids)}
    gt_cols = torch.as_tensor([vid_index[t.split("#")[0]] for t in txt_ids], device=device)
    root_to_caps: Dict[str, List[int]] = {}
    for i, tid in enumerate(txt_ids):
        root_to_caps.setdefault(tid.split("#")[0], []).append(i)
    p_max = max(len(c) for c in root_to_caps.values())
    budget = int(os.environ.get(STREAM_BUDGET_ENV, STREAM_BUDGET_DEFAULT))
    cache: Optional[torch.Tensor] = None  # allocated at the first block, its dtype known
    layout: List[Tuple[int, int]] = []

    def blocks():
        nonlocal cache
        col = 0
        for emb, ids in _vis_blocks(embedder, vis_feed):
            vn = flatten_heads(emb)
            if col == 0 and n_vis * hd * vn.element_size() <= budget:
                cache = torch.empty((n_vis, hd), dtype=vn.dtype, device=vn.device)
            if cache is not None:
                cache[col:col + len(ids)] = vn
                vn = cache[col:col + len(ids)]
                layout.append((col, len(ids)))
            yield col, ids, _flat_scores(tn, vn, heads)
            col += len(ids)

    # pass 1: ground-truth scores, the running top-k, v2t ranks
    k = min(topk, n_vis) if topk else 0
    gt_scores = torch.full((n_txt,), -math.inf, device=device)
    run_vals = torch.empty((n_txt, 0), device=device)
    run_idx = torch.empty((n_txt, 0), dtype=torch.long, device=device)
    v2t_blocks, v2t_counts = [], []
    for col, ids, S in blocks():
        gt_scores = _gather_gt_scores(S, gt_cols, col, gt_scores)
        if k:
            run_vals, run_idx = _topk_merge(run_vals, run_idx, S, col, k)
        have = [(b, root_to_caps[v]) for b, v in enumerate(ids) if v in root_to_caps]
        if have:
            pos = torch.full((len(have), p_max), -1, dtype=torch.long)
            for r, (_, caps) in enumerate(have):
                pos[r, :len(caps)] = torch.as_tensor(caps)
            cols = torch.as_tensor([b for b, _ in have], device=device)
            v2t_blocks.append(_v2t_block_ranks(S[:, cols], pos.to(device)))
            v2t_counts.extend(len(caps) for _, caps in have)
    v2t_ranks = []
    if v2t_blocks:
        ranks = torch.cat(v2t_blocks).cpu().numpy()
        v2t_ranks = [np.sort(ranks[r, :n]) for r, n in enumerate(v2t_counts)]
    lap("pass1")

    # pass 2: t2v counting against the complete ground-truth scores
    if (cache is not None and cache.dtype == torch.bfloat16 and tn.dtype == torch.bfloat16
            and rank_path_for(n_txt, n_vis, tn.dtype, device.type, rank_path) == "kernel"):
        # the kernel casts text to bf16: f32 text takes the rescoring branch
        # even under rank_path 'kernel', since pass 1 scored f32 text
        t2v = fused_sim_rank(tn, cache, gt_cols, prenormalized=True).cpu().numpy()
    else:
        if cache is not None:
            pass2 = ((col, _flat_scores(tn, cache[col:col + w], heads)) for col, w in layout)
        else:
            pass2 = ((col, S) for col, _, S in blocks())
        greater = torch.zeros(n_txt, dtype=torch.long, device=device)
        tie = torch.zeros_like(greater)
        for col, S in pass2:
            g, t = _count_inc(S, gt_scores, gt_cols, col)
            greater += g
            tie += t
        t2v = (greater + tie + 1).to(torch.int32).cpu().numpy()
    lap("pass2")
    out = {"t2v": metrics_from_ranks(t2v), "v2t": metrics_from_positive_ranks(v2t_ranks),
           "t2v_ranks": t2v, "v2t_ranks": v2t_ranks, "vis_ids": vis_ids}
    if k:
        out["topk_idx"] = run_idx.cpu().numpy()
        out["topk_vals"] = run_vals.cpu().numpy()
    return out


@torch.no_grad()
def int8_streaming_topk(embedder: Embedder, txt_embs: torch.Tensor, vis_feed: EvalFeed, k: int,
                        margin_factor: float = 1.5, chunk_t: int = 1024,
                        lap: Optional[Callable[[str], None]] = None) -> Dict:
    """Top-k retrieval over a gallery held on the device as int8 rows, with
    exact final scores (``laff_tpu.engine.evaluator.int8_streaming_topk``).

    One streamed pass embeds the gallery blocks and keeps only their int8
    rows and scales (``quantize_rows``), preallocated; each query nominates
    its top ``ceil(k * margin_factor)`` videos on the int8 product, in
    query chunks of ``chunk_t``; only the union of the nominated videos is
    embedded again (an unstaged feed) and scored exactly, and each query's
    top k is taken from those. ``lap(name)`` is called after each stage
    ('int8_stream', 'nominate', 'reembed', 'exact_topk').

    Returns 'topk_vals' (T, k) f32, the mean of cosines, and 'topk_idx'
    (T, k) into the streamed order, equal scores in decreasing gallery index
    order, on the host; 'vis_ids'; 'int8_bytes', the int8 gallery's bytes
    on the device (rows and scales); and 'union', the videos embedded
    again."""
    lap = lap or _no_lap
    heads = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
    tn = flatten_heads(txt_embs)
    tq, ts = quantize_rows(tn)
    vq = vs = None
    vis_ids: List[str] = []
    for emb, ids in _vis_blocks(embedder, vis_feed):
        q, s = quantize_rows(flatten_heads(emb))
        if vq is None:  # rows padded to a multiple of 8, as the card's int8 product takes
            rows = -(-len(vis_feed) // 8) * 8
            vq = torch.zeros((rows, q.shape[1]), dtype=torch.int8, device=q.device)
            vs = torch.zeros((rows,), dtype=torch.float32, device=q.device)
        vq[len(vis_ids):len(vis_ids) + len(ids)] = q
        vs[len(vis_ids):len(vis_ids) + len(ids)] = s
        vis_ids.extend(ids)
    lap("int8_stream")

    n_vis, n_txt = len(vis_ids), tn.shape[0]
    k = min(k, n_vis)
    c = min(int(math.ceil(k * margin_factor)), n_vis)
    cand = [torch.topk(int8_scores(tq[start:start + chunk_t], ts[start:start + chunk_t], vq,
                                   vs)[:, :n_vis], c, dim=1).indices
            for start in range(0, n_txt, chunk_t)]
    union = torch.unique(torch.cat(cand))  # ascending gallery index
    lap("nominate")
    refeed = EvalFeed([vis_ids[i] for i in union.tolist()], vis_feed.batcher,
                      batch_size=vis_feed.batch_size)
    cn = flatten_heads(embedder.embed_vis(refeed)[0])
    lap("reembed")
    vals, idx = [], []
    for start in range(0, n_txt, chunk_t):
        v, p = ordered_topk(_flat_scores(tn[start:start + chunk_t], cn, heads), k)
        vals.append(v)
        idx.append(union[p])
    out = {"topk_vals": torch.cat(vals).cpu().numpy(), "topk_idx": torch.cat(idx).cpu().numpy(),
           "vis_ids": vis_ids, "union": len(union),
           "int8_bytes": vq.numel() * vq.element_size() + vs.numel() * vs.element_size()}
    lap("exact_topk")
    return out


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
