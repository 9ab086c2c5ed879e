"""The port's spans: named ranges of host time on the thread that drives
the card, recorded by ``torch.profiler`` while one runs and free of cost
otherwise.

``span(name, args)`` times the block it opens as ``laff.<name>`` in the
profiler's own trace, beside the device's kernels and copies, so span and
device time share one clock. The span is a function-scope range of the
profiler (the scope of a PyTorch operator), not a user annotation: a user
annotation gets a copy on the device's timeline from its first to its last
kernel, which a reader of the trace would count as device work. ``args``
(a string: ``"epoch=<e> dispatch=<i>"`` for a training dispatch,
``"pass=<n>"`` for a validation pass) names the unit of work the span
belongs to; the profiler keeps it where it records operator inputs
(``record_shapes=True``).

With no profiler running, ``span`` returns one shared null context and
makes no profiler call. Both profiler names it uses are private to torch
(``_profiler_enabled``, ``_RecordFunctionFast``); the range's is looked up
only once a profiler runs, so a build without it can still train and
validate untraced. No span goes inside a captured CUDA graph or a
tower's forward: the device trace names that work by kernel.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

PREFIX = "laff."
NULL = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """``laff.<name>`` around a block while a profiler runs, else ``NULL``."""
    if not torch._C._autograd._profiler_enabled():
        return NULL
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(PREFIX + name, (), {"id": args} if args else {})
