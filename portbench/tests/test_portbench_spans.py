"""The reduction of a traced run by the program's spans
(``portbench/spans.py``) and its five readers, on hand-built event lists
shaped as the profiler's raw events: the benchmark's user spans and their
copies on the device's timeline, the program's ``laff.*`` ranges, host
launches and the kernels, copies and sets of the card.

* ``harness.reduce_trace`` reads the same window, busy and kernel time,
  operations and gaps with and without the program's spans;
* idle time splits by overlap across the spans open in turn and sums to
  the window's idle time; kernel time follows correlation ids, a graph
  launch's kernels included, and falls back to the device-timeline copy;
* each reader gives the hand-computed value, and nothing for a program
  without spans;
* on the card, the program's spans leave no copy on the device's timeline.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from conftest import need_card
from torch.autograd import DeviceType

from portbench import harness, spans
from portbench.harness import load_module

MS = 1_000_000  # ns


class Event:
    """The methods of a profiler event that the reductions call."""

    def __init__(self, name, start, end, card=False, corr=0, thread=1):
        self._name, self._start, self._end = name, start * MS, end * MS
        self._card, self._corr, self._thread = card, corr, thread

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._card else DeviceType.CPU

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._thread


def _prof(events):
    results = SimpleNamespace(events=lambda: list(events))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def bench_events():
    """A window of 0-100 ms: a benchmark span 'dispatch' at 10-60 with its
    device copy, kernels busy 0-20, 40-50, 70-100 (a graph launch's three
    kernels share id 7), a copy and a kernel with no launch in the trace."""
    return [
        Event("portbench.window", 0, 100, corr=1),
        Event("portbench.dispatch", 10, 60, corr=2),
        Event("portbench.dispatch", 0, 100, card=True),
        Event("aten::copy_", 11, 12, corr=7),  # an operator's id, not a launch's
        Event("cudaGraphLaunch", 12, 13, corr=7),
        Event("kernel_a", 0, 5, card=True, corr=7),
        Event("kernel_b", 5, 15, card=True, corr=7),
        Event("kernel_c", 15, 20, card=True, corr=7),
        Event("cudaLaunchKernel", 32, 33, corr=9),
        Event("kernel_d", 40, 48, card=True, corr=9),
        Event("cudaMemcpyAsync", 34, 35, corr=10),
        Event("Memcpy DtoH (Device -> Pageable)", 48, 50, card=True, corr=10),
        Event("cudaLaunchKernel", 61, 62, corr=12, thread=2),  # another thread's launch
        Event("kernel_e", 70, 80, card=True, corr=12),
        Event("kernel_f", 80, 100, card=True, corr=13),  # no launch: the device copy
    ]


def program_events():
    """The program's spans inside the benchmark's: a dispatch at 10-60
    holding feed_wait 10-11, enqueue 11-30 and loss_read 30-60."""
    return [
        Event("laff.train.dispatch", 10, 60, corr=3),
        Event("laff.train.feed_wait", 10, 11, corr=4),
        Event("laff.train.enqueue", 11, 30, corr=5),
        Event("laff.train.loss_read", 30, 60, corr=6),
    ]


def test_reduce_trace_is_unchanged_by_the_program_spans():
    without = harness.reduce_trace(_prof(bench_events()))
    with_spans = harness.reduce_trace(_prof(bench_events() + program_events()))
    assert with_spans == without
    assert without["window_s"] == pytest.approx(0.1)
    assert without["busy_s"] == pytest.approx(0.06)
    assert [g[1] for g in without["gaps"]] == pytest.approx([0.02, 0.02])


def test_idle_splits_by_overlap_and_sums_to_the_window():
    t = spans.reduce_spans(bench_events() + program_events())
    idle = t["span_idle_s"]
    # idle 20-40: enqueue 20-30, loss_read 30-40; idle 50-70: loss_read 50-60, window 60-70
    assert idle == pytest.approx({"window": 0.01, "dispatch": 0.0, "train.dispatch": 0.0,
                                  "train.feed_wait": 0.0, "train.enqueue": 0.01,
                                  "train.loss_read": 0.02})
    trace = harness.reduce_trace(_prof(bench_events()))
    assert sum(idle.values()) == pytest.approx(trace["window_s"] - trace["busy_s"])
    assert t["span_count"] == {"window": 1, "dispatch": 1, "train.dispatch": 1,
                               "train.feed_wait": 1, "train.enqueue": 1, "train.loss_read": 1}
    assert t["span_host_s"]["train.loss_read"] == pytest.approx(0.03)
    # the benchmark's spans alone: the same idle, named by them
    alone = spans.reduce_spans(bench_events())["span_idle_s"]
    assert alone == pytest.approx({"window": 0.01, "dispatch": 0.03})


def test_device_time_follows_correlation_ids():
    t = spans.reduce_spans(bench_events() + program_events())
    # kernels a-c (graph launch at 12, in enqueue) 20 ms; d (launch at 32, in
    # loss_read) 8 ms; the copy is no kernel; e was launched by another
    # thread; f has no launch and lies under the dispatch span's device copy
    assert t["span_device_s"] == pytest.approx({
        "window": 0.0, "dispatch": 0.02, "train.dispatch": 0.0, "train.feed_wait": 0.0,
        "train.enqueue": 0.02, "train.loss_read": 0.008})
    # the program's device copies, were there any, are neither device work nor spans
    copies = [Event("laff.train.enqueue", 0, 20, card=True),
              Event("laff.train.loss_read", 40, 50, card=True)]
    again = spans.reduce_spans(bench_events() + program_events() + copies)
    assert again["span_idle_s"] == pytest.approx(t["span_idle_s"])
    assert again["span_device_s"] == pytest.approx(t["span_device_s"])


def test_innermost_segments():
    segs = spans.innermost([(0, 100, "w"), (10, 60, "d"), (10, 11, "f"), (11, 30, "e"),
                            (70, 80, "x")])
    assert segs == [(0, 10, "w"), (10, 11, "f"), (11, 30, "e"), (30, 60, "d"), (60, 70, "w"),
                    (70, 80, "x"), (80, 100, "w")]


def _two_dispatches():
    """Two dispatches of the program, the second 100 ms after the first."""
    later = []
    for e in bench_events()[1:] + program_events():
        later.append(Event(e._name, e._start / MS + 100, e._end / MS + 100, e._card,
                           e._corr + 100 if e._corr else 0, e._thread))
    return [Event("portbench.window", 0, 200, corr=1)] + bench_events()[1:] + \
        program_events() + later


def _read(name, events, busy_s=0.12):
    ctx = {"trace": {"window_s": 0.2, "busy_s": busy_s, "kernel_s": 0.1, "ops": {}, "gaps": []},
           "counters": {}, "spans": spans.reduce_spans(events)}
    return load_module("metrics", name).read(ctx)


def test_train_readers():
    events = _two_dispatches()
    assert _read("train.feed_wait_ms", events) == pytest.approx(1.0)
    assert _read("train.enqueue_idle_ms", events) == pytest.approx(10.0)
    assert _read("train.read_idle_ms", events) == pytest.approx(20.0)
    assert _read("train.enqueue_idle_ms", events, busy_s=0.0) is None
    for name in ("train.feed_wait_ms", "train.enqueue_idle_ms", "train.read_idle_ms"):
        assert _read(name, bench_events()) is None  # a program without spans


def test_val_readers():
    e = [Event("portbench.window", 0, 100, corr=1),
         Event("kernel_t", 5, 25, card=True, corr=20),
         Event("kernel_r", 30, 35, card=True, corr=21)]
    for base in (0, 50):  # two passes
        e += [Event("portbench.validate", base, base + 50),
              Event("laff.eval.validate", base, base + 50),
              Event("laff.eval.embed_vis", base, base + 2),
              Event("laff.eval.embed_txt", base + 2, base + 20),
              Event("laff.eval.ranks", base + 20, base + 40),
              Event("laff.eval.gt_index", base + 20, base + 24),
              Event("laff.eval.readback", base + 36, base + 40),
              Event("laff.eval.metrics", base + 40, base + 48)]
    e += [Event("cudaLaunchKernel", 3, 4, corr=20), Event("cudaLaunchKernel", 21, 22, corr=21)]
    # busy 5-25, 30-35: idle 0-5 (embed_vis 0-2, embed_txt 2-5), 25-30 (ranks),
    # 35-100: ranks 35-36, readback 36-40, metrics 40-48, validate 48-50, then
    # the second pass: embed_vis 2, embed_txt 18, gt_index 4, ranks 12,
    # readback 4, metrics 8, validate 2
    assert _read("val.embed_txt_device_ms", e) == pytest.approx(10.0)  # 20 ms over 2 passes
    tail = (5 + 1 + 4 + 8) + (4 + 12 + 4 + 8)
    assert _read("val.tail_idle_ms", e) == pytest.approx(tail / 2)
    assert _read("val.tail_idle_ms", e[:3] + e[3:4]) is None  # no program spans


def test_readers_find_the_profiler_of_their_caller():
    from torch.profiler import ProfilerActivity, profile, record_function

    from laff_tpu_torch.utils.trace import span

    prof = profile(activities=[ProfilerActivity.CPU])
    with prof:
        with record_function("portbench.window"):
            for i in range(3):
                with span("train.dispatch", f"epoch=0 dispatch={i}"):
                    with span("train.feed_wait"):
                        torch.ones(8).sum()
    ctx = {"trace": {"window_s": 1.0, "busy_s": 0.0, "kernel_s": 0.0, "ops": {}, "gaps": []},
           "counters": {}}
    value = load_module("metrics", "train.feed_wait_ms").read(ctx)
    assert value is not None and value > 0
    assert ctx["spans"]["span_count"]["train.dispatch"] == 3
    assert load_module("metrics", "train.read_idle_ms").read(ctx) is None  # no device


def test_readers_raise_on_a_busy_window_without_a_profiler():
    """A traced window with device activity whose readers find no profiler
    is a fault of the harness, not a missing reading."""
    busy = {"trace": {"window_s": 1.0, "busy_s": 0.5, "kernel_s": 0.5, "ops": {}, "gaps": []},
            "counters": {}}
    with pytest.raises(RuntimeError, match="no caller of the readers"):
        load_module("metrics", "train.enqueue_idle_ms").read(busy)
    from torch.profiler import ProfilerActivity, profile

    prof, other = profile(activities=[ProfilerActivity.CPU]), profile(activities=[ProfilerActivity.CPU])
    with pytest.raises(RuntimeError, match="holds 2 profilers"):
        spans.of({"trace": busy["trace"]})
    del prof, other


@pytest.mark.card
def test_program_spans_leave_no_copy_on_the_device_timeline():
    need_card()
    from torch.profiler import ProfilerActivity, profile, record_function

    from laff_tpu_torch.utils.trace import span

    x = torch.randn(256, 256, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.window"):
            with span("train.enqueue"):
                (x @ x).sum().item()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    on_card = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    assert not [n for n in on_card if n.startswith(spans.PROGRAM)], on_card
    t = spans.reduce_spans(events)
    assert t["span_device_s"]["train.enqueue"] > 0
