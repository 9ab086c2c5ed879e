"""The yardstick's operation and byte counts against counts made by hand."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT, tiny_config

from portbench import yardstick as Y
from portbench.reference.model import parameter_count
from portbench.world import FILLERS


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_sim_rank_bound_is_the_kernel_tables():
    # 2 x 59,800 x 2,990 x 4,096 operations at 989 TFLOP/s: 1.481 ms
    t = Y.sim_rank_bound(59_800, 2_990, 4_096)
    assert t == pytest.approx(2 * 59_800 * 2_990 * 4_096 / 989e12)
    assert round(t * 1e3, 3) == 1.481


def test_gate_bound_is_the_kernel_tables():
    # B 1,024, L 4, H 8, dh 512, f32: 1,024 x (4 + 1) x 4,096 x 4 bytes: 0.0250 ms
    t = Y.gate_bound([1_024], 4, 8, 512)
    assert t == pytest.approx(1_024 * 5 * 4_096 * 4 / 3.35e12)
    assert round(t * 1e3, 4) == 0.0250
    assert Y.gate_bound([59_800], 4, 8, 512) == pytest.approx(59_800 * 5 * 4_096 * 4 / 3.35e12)


def test_parameter_counts_are_the_configs():
    # the port's config counts at a GRU vocabulary of the bow words, 4 specials
    # and "the"; the captions' 12 function words add a 500-d row each
    for name, port, want in (("laffml-msrvtt", 84_925_644, 84_931_644),
                             ("framelaff-msrvtt", 91_225_805, 91_231_805)):
        cfg = _cfg(name)
        assert cfg["parameters"] == want
        assert parameter_count(cfg, 11_286, 11_291) == port
        assert parameter_count(cfg, 11_286, 11_291 + len(FILLERS)) == want


def test_train_step_flops_by_hand():
    cfg = tiny_config()
    b, tokens, d = 8, 72, cfg["common_dim"]
    lin = {"rnn": 16, "bow": 100, "w2v": 500, "clip_ft": 512, "timesformer": 768,
           "x3d": 2048, "ircsn": 2048}
    fwd = sum(2 * b * k * d for k in lin.values())
    fwd += 2 * tokens * 3 * (500 * 16 + 16 * 16)  # the GRU
    fwd += 4 * b * 4 * d * 2  # two fusion gates over 4 locals
    loss = 2 * b * b * d
    raw = sum(2 * b * k * d for name, k in lin.items() if name != "rnn")
    assert Y.train_step_flops(cfg, b, tokens) == pytest.approx(3 * (fwd + loss) - raw)


def test_eval_pass_flops_by_hand():
    cfg = _cfg("laffml-msrvtt")
    t, v, tokens = 59_800, 2_990, 59_800 * 9
    txt = 2 * t * (1_024 + 11_286 + 500) * 4_096 + 2 * tokens * 3 * (500 + 1_024) * 1_024
    vis = 2 * v * (512 + 768 + 2_048 + 2_048) * 4_096
    gates = 4 * (t + v) * 4 * 4_096
    scores = 2 * t * v * 4_096
    assert Y.eval_pass_flops(cfg, t, tokens, v) == pytest.approx(txt + vis + gates + scores)


def test_frame_gate_counts_real_frames():
    cfg = _cfg("framelaff-msrvtt")
    with_frames = Y.tower_forward_flops(cfg["video"], 4_096, 10, frames=300)
    without = Y.tower_forward_flops(cfg["video"], 4_096, 10, frames=0)
    assert with_frames - without == pytest.approx(4 * 300 * 512)


def test_caption_lengths_follow_the_mix():
    """Every world of n captions has the same multiset of lengths, in a
    seeded order, with MSR-VTT's mean."""
    import numpy as np

    from conftest import caption_words

    from portbench.world import caption_lengths

    spec = caption_words()
    a = caption_lengths(130_260, spec, np.random.default_rng(1))
    b = caption_lengths(130_260, spec, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert abs(a.mean() - spec["mean"]) < 0.05
    assert a.min() >= spec["min"] and a.max() <= spec["max"]


def test_float32_math_is_pinned_from_the_config():
    import torch

    from portbench import program

    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for name in ("laffml-msrvtt", "framelaff-msrvtt"):
            cfg = _cfg(name)
            torch.backends.cudnn.allow_tf32 = not cfg["float32_math"]["cudnn_tf32"]
            torch.backends.cuda.matmul.allow_tf32 = not cfg["float32_math"]["cublas_tf32"]
            program.pin_float32_math(cfg)
            assert torch.backends.cudnn.allow_tf32 == cfg["float32_math"]["cudnn_tf32"]
            assert torch.backends.cuda.matmul.allow_tf32 == cfg["float32_math"]["cublas_tf32"]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
