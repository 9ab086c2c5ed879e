"""int8 gallery scoring (``laff_tpu.ops.quantized``).

Symmetric per-row absmax int8: ``scale = absmax / 127``, ``q = round(x /
scale)`` (half to even) clipped to +-127, so ``x ~= q * scale``. For unit
per-head embeddings the approximate cosines are within about 1e-2: enough
to nominate candidates, whose exact scores are then taken from the
full-precision rows (``int8_topk(..., rescore_embs=...)``).

The int8 x int8 -> int32 product is a library call in both packages
(``lax.dot_general`` there, outside any Pallas kernel): ``torch._int_mm``
(cuBLASLt) on the card, an int32 ``torch.mm`` on the CPU. int32 sums are
exact, so both give ``laff_tpu``'s products bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (q (N, D) int8, scale (N,) f32) with
    x ~= q * scale[:, None]."""
    absmax = x.abs().amax(dim=-1)
    # a tensor divisor: CUDA multiplies by the reciprocal of a number, which
    # can round the scale differently from laff_tpu's division
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), 1.0).float()
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact. ``torch._int_mm``
    takes more than 16 rows of ``a`` and K and N multiples of 8 on the card,
    so short or ragged operands are padded with zeros (which add nothing)
    and the product cut back."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32).T
    m, k = a.shape
    n = b.shape[0]
    pad_k = _round_up(k, 8) - k
    pad_m = max(32, _round_up(m, 8)) - m
    pad_n = _round_up(n, 8) - n
    # only what needs padding is copied: a streamed gallery comes padded
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_k, 0, pad_n))
    return torch._int_mm(a.contiguous(), b.contiguous().T)[:m, :n]


def int8_scores(tq: torch.Tensor, t_scale: torch.Tensor, vq: torch.Tensor,
                v_scale: torch.Tensor) -> torch.Tensor:
    """Approximate (T, V) scores: the int8 product, then the rank-1 rescale."""
    return int8_matmul(tq, vq).float() * t_scale[:, None] * v_scale[None, :]


def _rescore_block(cand_idx: torch.Tensor, txt: torch.Tensor, vis: torch.Tensor, k: int,
                   block_t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 scores of each query's candidates (T, C) and its top k
    among them, gathering (block_t, C, D) gallery rows a text block at a
    time, so memory is bounded whatever V is."""
    vals, idx = [], []
    for start in range(0, txt.shape[0], block_t):
        rows = cand_idx[start:start + block_t]
        exact = torch.einsum("bd,bcd->bc", txt[start:start + block_t].float(),
                             vis[rows].float())
        v, pos = torch.topk(exact, k, dim=1)
        vals.append(v)
        idx.append(torch.gather(rows, 1, pos))
    return torch.cat(vals), torch.cat(idx)


def int8_topk(tq: torch.Tensor, t_scale: torch.Tensor, vq: torch.Tensor,
              v_scale: torch.Tensor, k: int, margin: Optional[int] = None,
              rescore_embs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              block_t: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery items per query from int8 embeddings.

    Without ``rescore_embs``: the int8-approximate scores' top k. With
    ``rescore_embs=(txt, vis)`` (full-precision (T, D) / (V, D) flats):
    (k + margin) candidates nominated on the int8 product, rescored
    exactly, and (values (T, k) f32, indices (T, k)) returned in descending
    exact-score order. The order of exactly equal scores is
    ``torch.topk``'s."""
    v = vq.shape[0]
    k = min(k, v)
    if margin is None:
        margin = max(k // 2, 32)
    c = min(k + margin, v)
    approx = int8_scores(tq, t_scale, vq, v_scale)
    if rescore_embs is None:
        return torch.topk(approx, k, dim=1)
    cand = torch.topk(approx, c, dim=1).indices
    txt, vis = rescore_embs
    return _rescore_block(cand, txt, vis, k, min(block_t, tq.shape[0]))
