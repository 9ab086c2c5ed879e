"""Device-idle time under the trainer's loss reads (``train.loss_read``:
the losses' ``torch.cat`` and blocking copy, the meter, the scalar log),
per ``train.dispatch`` span of the window (portbench/spans.py)."""

from portbench.spans import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "span_idle_s", ["train.loss_read"], "train.dispatch")
