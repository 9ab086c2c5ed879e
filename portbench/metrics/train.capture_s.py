"""Seconds the trainer took to capture its step as a CUDA graph (its warm-up
steps included): ``MultiStep.capture_seconds``, read in set-up."""


def read(ctx):
    return ctx["counters"].get("capture_s")
