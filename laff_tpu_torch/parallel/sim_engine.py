"""Sharded similarity engine: gallery-parallel ranking and top-k retrieval
(``laff_tpu.parallel.sim_engine``).

The gallery axis is split over the ranks of a ``Mesh``: each rank holds an
equal slab of rows (the gallery padded to a multiple of the world, as
``_pad_gallery`` pads it; ``shard_gallery`` cuts this rank's slab), the
queries are replicated, and each rank scores its slab with a plain
``torch.matmul`` (``laff_tpu`` leaves the product to XLA). The two
reductions the evaluation needs are cheap collectives:

* rank of the ground truth: its score taken from the shard that owns its
  column and summed over the group, then each rank's count of greater
  scores and of ties at a larger global column, summed over the group:
  ties break larger-index-first across shards, exactly as on one card;
* top k: each rank's top k as the port's (score, global column) int64
  keys (``ops.similarity.order_keys``), all-gathered (k keys a rank) and
  merged by one more top k, so the lists are in the port's order (equal
  scores in decreasing index) across shards too; ``laff_tpu``'s
  ``lax.top_k`` puts the lower index first.

The int8 gallery uses ``ops.quantized`` (``quantize_rows``, the exact int8
product), as the one-card int8 path does. Every function returns host
arrays, the same on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import flatten_heads, int8_scores, quantize_rows
from ..ops.similarity import blocked_topk_keys, decode_keys
from .mesh import Mesh

# gallery rows scored at once in the top-k functions: bounds the f32 block
# (T x 32,768 x 4 bytes) whatever the shard
TOPK_BLOCK = 32768


def shard_gallery(vis: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, int]:
    """(this rank's slab of the gallery padded with zero rows to a multiple
    of the world, the real row count): ``laff_tpu``'s ``_pad_gallery`` and
    the 'dp' sharding of its rows."""
    v = vis.shape[0]
    shard = -(-v // mesh.size)
    lo, hi = mesh.rank * shard, min((mesh.rank + 1) * shard, v)
    local = vis[lo:max(lo, hi)]
    if local.shape[0] < shard:
        pad = vis.new_zeros((shard - local.shape[0], *vis.shape[1:]))
        local = torch.cat([local, pad])
    return local, v


def _real(v_real: Optional[int], shard: int, mesh: Mesh) -> int:
    return shard * mesh.size if v_real is None else int(v_real)


@torch.no_grad()
def sharded_t2v_ranks(txt: torch.Tensor, vis: torch.Tensor, gt_cols, mesh: Mesh,
                      v_real: Optional[int] = None) -> np.ndarray:
    """1-based ground-truth ranks with the gallery sharded over the mesh.

    txt: (T, H, d) or (T, D), replicated; vis: this rank's (shard, ...) rows
    of the padded gallery, whose first ``v_real`` rows are real (all, by
    default); gt_cols: (T,) global gallery columns. Ranks count the scores
    above the ground truth's and its ties at larger global columns."""
    tn, vn = flatten_heads(txt), flatten_heads(vis)
    shard = vn.shape[0]
    v_real = _real(v_real, shard, mesh)
    col0 = mesh.rank * shard
    gt = torch.as_tensor(gt_cols, device=tn.device).long()
    scores = tn.float() @ vn.float().T
    cols = col0 + torch.arange(shard, device=tn.device)
    local = gt - col0
    own = (local >= 0) & (local < shard)
    at_gt = scores.gather(1, local.clamp(0, shard - 1)[:, None])[:, 0]
    gt_scores = mesh.all_reduce(torch.where(own, at_gt, torch.zeros_like(at_gt)))
    valid = cols < v_real
    g = gt_scores[:, None]
    counts = (((scores > g) & valid).sum(dim=1)
              + ((scores == g) & (cols[None, :] > gt[:, None]) & valid).sum(dim=1))
    return (mesh.all_reduce(counts) + 1).to(torch.int32).cpu().numpy()


def _merge(keys: torch.Tensor, k: int, v_real: int, mesh: Mesh
           ) -> Tuple[np.ndarray, np.ndarray]:
    """This rank's (T, k_local) keys -> the global top min(k, v_real)
    (values, indices) on the host, every rank's candidates merged."""
    gathered = mesh.all_gather(keys.T.contiguous()).T  # (T, k_local * size), rank order
    top = torch.topk(gathered, min(k, v_real, gathered.shape[1]), dim=1).values
    vals, idx = decode_keys(top)
    return vals.cpu().numpy(), idx.cpu().numpy()


def sharded_blocked_topk(score_block, queries: int, shard: int, v_real: int, k: int,
                         mesh: Mesh, device: torch.device, block: int = TOPK_BLOCK
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The global top min(k, v_real) (values, indices) on the host over a
    gallery of ``shard`` rows a rank, of which the first ``v_real`` (global)
    are live; ``score_block(start, stop)`` scores this rank's rows
    [start, stop) for the (queries,) rows, ``block`` rows at a time. Each
    rank sends its top min(k, shard) keys, a rank with fewer live rows
    padding with the smallest key, which the merge never takes."""
    col0 = mesh.rank * shard
    live = max(0, min(shard, v_real - col0))
    k_local = min(k, shard)
    parts = [blocked_topk_keys(score_block, live, k_local, block, col0)] if live else []
    pad = k_local - (parts[0].shape[1] if parts else 0)
    if pad:
        parts.append(torch.full((queries, pad), torch.iinfo(torch.int64).min,
                                dtype=torch.int64, device=device))
    return _merge(torch.cat(parts, dim=1), k, v_real, mesh)


@torch.no_grad()
def sharded_topk(txt: torch.Tensor, vis: torch.Tensor, k: int, mesh: Mesh,
                 v_real: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Global top-k gallery items per query with the gallery sharded: (scores
    (T, k), indices (T, k)) on the host, descending, equal scores in
    decreasing global index; each rank sends k keys, not its shard. vis is
    this rank's slab as in ``sharded_t2v_ranks`` (f32 or bf16 rows, scored
    in f32); k is cut to the real row count."""
    tn = flatten_heads(txt).float()
    vn = flatten_heads(vis)
    shard = vn.shape[0]

    def score_block(s: int, e: int) -> torch.Tensor:
        return tn @ vn[s:e].float().T

    return sharded_blocked_topk(score_block, tn.shape[0], shard, _real(v_real, shard, mesh), k,
                                mesh, tn.device)


@torch.no_grad()
def sharded_int8_topk(txt: torch.Tensor, vis_q: torch.Tensor, vis_scale: torch.Tensor,
                      k: int, mesh: Mesh, v_real: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Global top-k nomination over an int8 gallery sharded by rows.

    txt: (T, H, d) or (T, D) full precision, replicated (quantized here);
    vis_q: this rank's (shard, H*d) int8 rows and vis_scale its (shard,) f32
    scales (``quantize_rows`` of the flat embeddings, padded and cut as
    ``shard_gallery`` cuts them). Scores are the int8 approximations
    (``int8_scores``); otherwise as ``sharded_topk``."""
    tq, ts = quantize_rows(flatten_heads(txt))
    shard = vis_q.shape[0]

    def score_block(s: int, e: int) -> torch.Tensor:
        return int8_scores(tq, ts, vis_q[s:e], vis_scale[s:e])

    return sharded_blocked_topk(score_block, tq.shape[0], shard, _real(v_real, shard, mesh), k,
                                mesh, tq.device)
