"""The fusion gate's share of its roofline: the least time the card could
take for the gate over every valid caption and video row of a pass
(portbench/yardstick.py gate_bound) over the device time of the gate
kernels of csrc/gate.cu in the traced window."""

from portbench.yardstick import gate_bound

KERNELS = ("gate_ring_kernel", "gate_simple_kernel")


def read(ctx):
    if not ctx.get("passes") or "gate_rows" not in ctx:
        return None
    seconds = sum(s for name, s in ctx["trace"]["ops"].items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    bound = sum(gate_bound([rows], length, ctx["heads"], ctx["dh"])
                for rows, length in ctx["gate_rows"].values())
    return 100.0 * ctx["passes"] * bound / seconds
