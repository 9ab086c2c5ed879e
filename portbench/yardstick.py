"""The yardstick: the card's published peaks and the operations and bytes
of the work the benchmark's cells ask for, counted from shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM. A share is stated against these, with the card's
power limit beside it.

Counts describe the operation, not a kernel: the model's FLOPs at the
batch's real token and frame counts (no padding), each input byte read
once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def linear_flops(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def gru_flops(tokens: int, d_in: int, hidden: int) -> float:
    """One GRU layer over ``tokens`` positions: the three gates' input and
    hidden products."""
    return 2.0 * tokens * 3 * (d_in * hidden + hidden * hidden)


def gate_flops(rows: int, length: int, dim: int) -> float:
    """The multi-head gate over L locals of width D: the logits and the
    weighted sum (a multiply-add per element each)."""
    return 4.0 * rows * length * dim


def tower_forward_flops(side: Dict, common: int, rows: int, tokens: int = 0,
                        frames: int = 0) -> float:
    """The forward FLOPs of one tower over ``rows`` items: every transform's
    Linear, the GRU over ``tokens`` real positions, the frame gate over
    ``frames`` real frame rows, the fusion gate."""
    total, length = 0.0, 0
    for f in side["features"]:
        length += 1
        if f["transform"]:
            total += linear_flops(rows, f["dim"], common)
    gru = side.get("gru")
    if gru:
        total += gru_flops(tokens, gru["we_dim"], gru["hidden"])
    fr = side.get("frames")
    if fr:
        length += 1
        total += 4.0 * frames * fr["dim"]
    return total + gate_flops(rows, length, common)


def train_step_flops(cfg: Dict, batch: int, tokens: int, frames: int = 0) -> float:
    """Model FLOPs of one train step: the forward of both towers and the
    loss's H (B, B) score matrices, then the backward: the gradient of
    every weight (as much as its forward) and of every activation that
    needs one (as much again), which is all but the raw features' input
    to their first Linear."""
    common = cfg["common_dim"]
    fwd = (tower_forward_flops(cfg["text"], common, batch, tokens=tokens)
           + tower_forward_flops(cfg["video"], common, batch, frames=frames))
    loss = 2.0 * batch * batch * common
    raw_dgrad = sum(linear_flops(batch, f["dim"], common)
                    for side in (cfg["text"], cfg["video"]) for f in side["features"]
                    if f["transform"] and f["name"] != "rnn")
    # the GRU's embedded tokens need their gradient (the embedding's), so
    # only the raw features' first products go without one
    return 3.0 * (fwd + loss) - raw_dgrad


def eval_pass_flops(cfg: Dict, n_txt: int, tokens: int, n_vis: int, frames: int = 0) -> float:
    """One validation pass: both towers' forward over every caption and
    video, and the (T, V) score matrix at the flat width."""
    common = cfg["common_dim"]
    return (tower_forward_flops(cfg["text"], common, n_txt, tokens=tokens)
            + tower_forward_flops(cfg["video"], common, n_vis, frames=frames)
            + 2.0 * n_txt * n_vis * common)


def bound_seconds(n_bytes: float, flops: float, peak_flops: float) -> float:
    return max(n_bytes / PEAK_BYTES_S, flops / peak_flops)


def sim_rank_bound(t: int, v: int, hd: int) -> float:
    """Similarity and ground-truth rank of T bf16 caption rows against V
    bf16 video rows of width HD: 2 T V HD operations at the bf16 peak; the
    rows, the T int32 ground truths and the T int32 ranks moved once."""
    return bound_seconds((t + v) * hd * 2 + 2 * t * 4, 2.0 * t * v * hd, PEAK_BF16_FLOPS)


def gate_bound(rows: Sequence[int], length: int, heads: int, dh: int) -> float:
    """The multi-head gate over each batch of ``rows`` f32 rows of L x H x
    dh: the locals read and the (H, dh) outputs written once, the logits
    and weighted sums at the f32 peak."""
    n = sum(rows)
    n_bytes = n * (length * heads * dh + heads * dh) * 4
    return bound_seconds(n_bytes, gate_flops(n, length, heads * dh), PEAK_F32_FLOPS)
