"""Device-idle time while the trainer enqueues a dispatch
(``train.enqueue``: the graph's input fills and K replays, or the eager
step), per ``train.dispatch`` span of the window (portbench/spans.py)."""

from portbench.spans import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "span_idle_s", ["train.enqueue"], "train.dispatch")
