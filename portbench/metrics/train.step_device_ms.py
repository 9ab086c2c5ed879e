"""Device time of the kernels a train step launches: the profiler's kernel
time over the traced window, per step run in it."""


def read(ctx):
    trace, steps = ctx["trace"], ctx.get("steps")
    if not steps or trace["kernel_s"] <= 0:
        return None
    return trace["kernel_s"] / steps * 1e3
