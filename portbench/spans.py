"""The program's spans in a traced run: what the host was doing while the
card was idle, and which span launched each kernel.

The port names its host work with ``laff.*`` profiler ranges
(``laff_tpu_torch/utils/trace.py``): function-scope ranges, with no copy on
the device's timeline. The benchmark's own spans are ``portbench.*`` user
ranges (``harness.Spans``), whose copies on the device's timeline are not
device work. ``reduce_spans`` reads the profiler's raw events, as
``harness.reduce_trace`` does, and returns four tables over the
benchmark's window, each keyed by span name less its prefix
('train.enqueue' for the program's, 'dispatch' for the benchmark's):

  span_count     spans started in the window, on the thread that launches
                 (the one that opened the window span)
  span_host_s    their host seconds, up to the window's end
  span_idle_s    device-idle seconds: each instant of the window with no
                 kernel, copy or set on the card goes to the innermost span
                 open on that thread at that instant; the window span
                 covers the window, so these sum to its idle time
  span_device_s  kernel seconds (what ``kernel_s`` counts): each kernel
                 goes to the innermost span open when its launch began
                 (the host's CUDA API call of the same correlation id:
                 ``cudaLaunchKernel``, ``cuLaunchKernel``,
                 ``cudaGraphLaunch``, whose kernels share its id, ...); a
                 kernel whose launch is not in the trace goes to the span
                 whose copy on the device's timeline covers its start

Every span seen in the window has a key in each table. The harness hands
a metric reader the window's reduction, not the profiler: ``of(ctx)`` takes
the profiler from the caller that holds it while the readers run
(``run.py``'s ``run_cell``, as its local ``prof``), raises where a window
with device activity has none, and keeps the tables in ``ctx`` for the
next reader.
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench.harness import SPAN_PREFIX as BENCH
from portbench.harness import _union

PROGRAM = "laff."
WINDOW = BENCH + "window"
LAUNCH = "cu"  # the host's CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...
COPIES = ("Memcpy", "Memset")  # device operations that are not kernels

Segment = Tuple[int, int, str]


def _key(name: str) -> str:
    return name[len(PROGRAM):] if name.startswith(PROGRAM) else name[len(BENCH):]


def innermost(spans: Sequence[Tuple[int, int, str]]) -> List[Segment]:
    """Nested (start, end, key) ranges -> the consecutive (start, end, key)
    stretches of the innermost range open, where any is."""
    segments: List[Segment] = []
    stack: List[Tuple[int, str]] = []  # (end, key) of the open ranges
    t = 0
    for a, b, key in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, name = stack.pop()
            segments.append((t, end, name))
            t = max(t, end)
        if stack:
            segments.append((t, a, stack[-1][1]))
        stack.append((b, key))
        t = a
    while stack:
        end, name = stack.pop()
        segments.append((t, end, name))
        t = max(t, end)
    return [s for s in segments if s[1] > s[0]]


def _at(segments: List[Segment], starts: List[int], t: int) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    return segments[i][2] if i >= 0 and t < segments[i][1] else None


def reduce_spans(events: Iterable) -> Optional[Dict[str, Dict[str, float]]]:
    """The profiler's raw events -> {span_count, span_host_s, span_idle_s,
    span_device_s}, or None without the benchmark's window span."""
    from torch.autograd import DeviceType

    host, copies, device, launches, window = [], [], [], {}, None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith((PROGRAM, BENCH)):
                copies.append((e.start_ns(), e.end_ns(), _key(name)))
            else:
                device.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                               not name.startswith(COPIES)))
        elif name.startswith((PROGRAM, BENCH)):
            span = (e.start_ns(), e.end_ns(), _key(name), e.start_thread_id())
            host.append(span)
            if name == WINDOW:
                window = span
        elif name.startswith(LAUNCH):
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    if window is None:
        return None
    w0, w1, _, thread = window
    host = [s[:3] for s in host if s[3] == thread]
    count: Dict[str, int] = {}
    host_s: Dict[str, float] = {}
    for a, b, key in host:
        if w0 <= a < w1:
            count[key] = count.get(key, 0) + 1
            host_s[key] = host_s.get(key, 0.0) + (min(b, w1) - a) / 1e9
    idle_s = dict.fromkeys(count, 0.0)
    device_s = dict.fromkeys(count, 0.0)

    segments = innermost(host)
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in device if min(b, w1) > max(a, w0)])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    i = 0
    for a, b in zip(edges[::2], edges[1::2]):  # the idle stretches, in order
        while i < len(segments) and segments[i][1] <= a:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < b:
            s0, s1, key = segments[j]
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                idle_s[key] = idle_s.get(key, 0.0) + overlap / 1e9
            j += 1

    starts = [s[0] for s in segments]
    on_card = innermost(copies)
    card_starts = [s[0] for s in on_card]
    for a, b, corr, kernel in device:
        a, b = max(a, w0), min(b, w1)
        if not kernel or b <= a:
            continue
        launch = launches.get(corr)
        if launch is not None:
            key = _at(segments, starts, launch[0]) if launch[1] == thread else None
        else:
            key = _at(on_card, card_starts, a)
        if key is not None:
            device_s[key] = device_s.get(key, 0.0) + (b - a) / 1e9
    return {"span_count": count, "span_host_s": host_s, "span_idle_s": idle_s,
            "span_device_s": device_s}


def _profiler():
    """The ``torch.profiler.profile`` of the nearest caller that holds one
    among its locals (``run_cell``'s ``prof`` while it calls the readers),
    or None; a caller that holds two is an error."""
    from torch.profiler import profile

    frame = sys._getframe(1)
    while frame is not None:
        found = {id(v): v for v in frame.f_locals.values() if isinstance(v, profile)}
        if len(found) > 1:
            raise RuntimeError(f"portbench.spans: {frame.f_code.co_name} holds "
                               f"{len(found)} profilers; the readers cannot tell which is the run's")
        if found:
            return next(iter(found.values()))
        frame = frame.f_back
    return None


def of(ctx: Dict) -> Optional[Dict[str, Dict[str, float]]]:
    """The span tables of the traced run whose readers get ``ctx``:
    ``ctx['spans']`` where present, else reduced from the caller's profiler
    and kept there; None without a profiler or a window span where the
    card was idle throughout. A run with device activity whose readers find
    no stopped profiler with a window span raises, so that the span metrics
    cannot drop out of a traced line unseen."""
    if "spans" not in ctx:
        prof = _profiler()
        results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
        ctx["spans"] = reduce_spans(results.events()) if results is not None else None
        if ctx["spans"] is None and ctx["trace"]["busy_s"] > 0:
            raise RuntimeError("portbench.spans: the traced window holds device activity, but no "
                               "caller of the readers holds a stopped profiler with its window "
                               "span")
    return ctx["spans"]


def per_unit_ms(ctx: Dict, table: str, names: Sequence[str], unit: str,
                device: bool = True) -> Optional[float]:
    """Milliseconds of ``table`` summed over the spans ``names``, per span
    ``unit`` started in the window; None where the trace lacks them (or,
    with ``device``, holds no device activity)."""
    if device and ctx["trace"]["busy_s"] <= 0:
        return None
    tables = of(ctx)
    if tables is None or not tables["span_count"].get(unit):
        return None
    values = tables[table]
    if not any(n in values for n in names):
        return None
    return 1e3 * sum(values.get(n, 0.0) for n in names) / tables["span_count"][unit]
