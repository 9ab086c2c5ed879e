"""The whole train step's share of the card's bf16 peak: the model FLOPs of
the steps run in the traced window (portbench/yardstick.py), over the
window's length times 989 TFLOP/s."""

from portbench.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    steps, flops = ctx.get("steps"), ctx.get("step_flops")
    if not steps or not flops:
        return None
    return 100.0 * steps * flops / (ctx["trace"]["window_s"] * PEAK_BF16_FLOPS)
