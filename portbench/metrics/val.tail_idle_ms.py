"""Device-idle time in the tail of a validation pass, after both towers:
under the program's ``eval.ranks``, ``eval.gt_index``, ``eval.readback``
and ``eval.metrics`` spans, per ``eval.validate`` span of the window
(portbench/spans.py)."""

from portbench.spans import per_unit_ms

TAIL = ["eval.ranks", "eval.gt_index", "eval.readback", "eval.metrics"]


def read(ctx):
    return per_unit_ms(ctx, "span_idle_s", TAIL, "eval.validate")
