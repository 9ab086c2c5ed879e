"""Host time a training dispatch waits for its K batches from the
``Prefetcher``: the program's ``train.feed_wait`` spans over the window's
``train.dispatch`` spans (portbench/spans.py)."""

from portbench.spans import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "span_host_s", ["train.feed_wait"], "train.dispatch", device=False)
