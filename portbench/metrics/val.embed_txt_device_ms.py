"""Kernel time of the text tower in a validation pass: the kernels launched
under the program's ``eval.embed_txt`` spans, per ``eval.validate`` span of
the window (portbench/spans.py)."""

from portbench.spans import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "span_device_s", ["eval.embed_txt"], "eval.validate")
