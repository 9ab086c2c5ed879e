"""The whole validation pass's share of the card's bf16 peak: both towers'
forward FLOPs over every caption and video and the (T, V) score matrix
(portbench/yardstick.py), times the passes in the traced window, over the
window's length times 989 TFLOP/s."""

from portbench.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    passes, flops = ctx.get("passes"), ctx.get("pass_flops")
    if not passes or not flops:
        return None
    return 100.0 * passes * flops / (ctx["trace"]["window_s"] * PEAK_BF16_FLOPS)
