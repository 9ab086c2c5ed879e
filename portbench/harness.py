"""The benchmark's machinery, shared by every cell: finding a cell's
configuration, traffic mix, limits, driver and metric readers by the names
``BENCHMARK.json`` gives; the host spans around the calls into the
program; the reduction of a profiler trace to busy time, device operations
and idle gaps; and the result line.

A cell is (configuration, traffic mix). Its files:

  portbench/configs/<config>.json   sizes, source and cuts of the model
  portbench/traffic/<mix>.json      the mix's parameters; its "driver"
                                    names portbench/drivers/<driver>.py
  portbench/limits/<cell>.json      the limit of each number the check
                                    compares, with the readings it was
                                    set from
  portbench/metrics/<metric>.py     one reader per per-layer metric:
                                    read(ctx) -> number or None
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "laff_tpu")
SPAN_PREFIX = "portbench."


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    """The workload ``name`` with its configuration, traffic mix and limits
    loaded, and the per-layer metrics it reports."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return {"workload": w, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer}


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 31-bit seeds from any whole ``seed``."""
    import numpy as np

    return [int(s) % 2**31 for s in np.random.SeedSequence(int(seed)).generate_state(n)]


class Spans:
    """The benchmark's own host spans around its calls into the program:
    while a profiler runs, each is a ``record_function`` range, so the
    trace can name the idle gaps by what the host was doing."""

    def __init__(self) -> None:
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.profiling:
            yield
            return
        from torch.profiler import record_function

        with record_function(SPAN_PREFIX + name):
            yield


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_trace(prof) -> Dict:
    """A profiler run over the window -> {window_s, busy_s, kernel_s,
    ops: {name: device seconds}, gaps: [(host span, seconds)]}: device
    activity (kernels, copies, sets) clipped to the benchmark's 'window'
    span, its union as busy time, and each idle stretch between device
    activities named by the innermost host span that covers its start.
    Reads the profiler's raw events: building its event tree would take
    minutes for a window of some hundred thousand kernels."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, on_card = e.name(), e.device_type() == DeviceType.CUDA
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        if name.startswith(SPAN_PREFIX):
            if on_card:  # the span's mirror on the device's timeline
                continue
            name = name[len(SPAN_PREFIX):]
            host.append((name, start, end))
            if name == "window":
                window = (start, end)
        elif on_card:
            device.append((name, start, end))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    ops: Dict[str, float] = {}
    spans, kernel_us = [], 0.0
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
        if not name.startswith(("Memcpy", "Memset")):
            kernel_us += b - a
    busy = _union(spans)
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        covering = [(h1 - h0, n) for n, h0, h1 in host if h0 <= a < h1]
        gaps.append((min(covering)[1], (b - a) / 1e6))
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_s": kernel_us / 1e6, "ops": ops, "gaps": gaps}


def breakdown(trace: Dict) -> Dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps with the host span they fell in."""
    top = sorted(trace["ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["gaps"], key=lambda g: -g[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def judge(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, Dict]:
    """Each number against its limit (at most the limit passes); a number
    that is missing or not finite fails."""
    import math

    checks, ok = {}, True
    details = {k: v for k, v in numbers.items() if k not in limits["numbers"]}
    if details:
        sys.stderr.write(f"not compared: {json.dumps(details)}\n")
    for name, lim in limits["numbers"].items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= lim["limit"]
        ok = ok and good
        checks[name] = {"value": value, "limit": lim["limit"]}
    return ok, checks


def emit(result: Dict, checks: Dict) -> None:
    """The comparisons as the last lines of standard error, then the result
    as the last line of standard output, the checks under its last key."""
    sys.stdout.flush()
    for name, c in checks.items():
        sys.stderr.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
