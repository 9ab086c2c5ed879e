"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start to the first timed dispatch: imports, the
card's context and libraries, the world, ``prepare``, the device caches,
the weights, the kernels, the graph capture or the staging pass), with the
configuration's float32 products pinned first, then a window of
``--seconds``, then
the check against the plain reference. With ``--trace 0`` the metrics are
the cell's end-to-end metrics; with ``--trace 1`` the window (at most
``TRACE_SECONDS``) runs under ``torch.profiler`` and the metrics are its
per-layer metrics, with the device's busy time and a breakdown. The last line of standard output is
one JSON object; the numbers the check compared, each with its limit, are
the last lines of standard error and the line's last key.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, when a module of JAX or of the JAX package is loaded,
or on any error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a traced run's window, at most: stopping the profiler and reading its
# trace take about 3 s a second traced, and a run has 360 s
TRACE_SECONDS = 25.0
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _env() -> None:
    """Caches at fixed paths inside the checkout; no library may pull in
    JAX or flax."""
    build = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    for key in ("USE_FLAX", "USE_JAX"):
        os.environ[key] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device=None, t_start: float = None, cell=None) -> dict:
    """One run of a cell; returns {'result': ..., 'checks': ...}. ``device``
    None looks for the card (and fails without one); a test passes the CPU,
    and a ``cell`` that stands in for the workload's files (a small size)."""
    import torch

    from portbench import harness

    t_start = T_START if t_start is None else t_start
    c = cell or harness.cell(args.workload)
    chips = c["workload"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"portbench: the cell needs {chips} CUDA device(s); "
                             f"torch sees {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    driver = importlib.import_module(f"portbench.drivers.{c['traffic']['driver']}")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    spans = harness.Spans()
    ctx = SimpleNamespace(config=c["config"], traffic=c["traffic"], device=device,
                          workdir=workdir, seeds=harness.sub_seeds(args.seed, 3),
                          parts={}, counters={})
    after = {}  # seconds spent after the window
    try:
        ctx.parts["imports"] = time.perf_counter() - t_start
        t = time.perf_counter()
        from portbench import program

        program.pin_float32_math(c["config"])
        if device.type == "cuda":  # the context, cuBLAS and cuDNN, in a part of their own
            torch.cuda.init()
            one = torch.ones(8, 8, device=device)
            (one @ one).sum().item()
            torch.backends.cudnn.version()
        ctx.parts["device"] = time.perf_counter() - t
        state = driver.setup(ctx)
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        prof, seconds = None, args.seconds
        if args.trace:
            seconds = min(seconds, TRACE_SECONDS)
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            spans.profiling = True
        try:
            win = driver.window(state, seconds, spans)
        finally:
            if prof is not None:
                spans.profiling = False
                t = time.perf_counter()
                prof.__exit__(None, None, None)
                after["profiler stop"] = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        found = harness.forbidden_modules()
        if found:
            raise SystemExit(f"portbench: loaded modules of JAX or the JAX package: {found}")
        device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                       "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                else "cpu"),
                       "count": chips, "memory_peak_bytes": peak}
        result = {"attempted": win["attempted"], "failed": win["failed"]}
        breakdown = None
        if prof is not None:
            t = time.perf_counter()
            trace = harness.reduce_trace(prof)
            after["trace reading"] = time.perf_counter() - t
            rctx = {"trace": trace, "counters": ctx.counters,
                    **driver.trace_context(state, c["config"], win)}
            metrics = {}
            for m in c["per_layer"]:
                value = harness.load_module("metrics", m["name"]).read(rctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
            breakdown = harness.breakdown(trace)
        else:
            values = {**win["metrics"], "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in c["end_to_end"]}
        state = {k: state[k] for k in driver.CHECK_KEYS}  # the program's objects go
        if device.type == "cuda":
            torch.cuda.empty_cache()
        program.strict_fp32()
        t_check = time.perf_counter()
        numbers = driver.check(state, c["config"], device)
        after["check"] = time.perf_counter() - t_check
        correct, checks = harness.judge(numbers, c["limits"])
        correct = correct and win["failed"] == 0
        result = {"correct": correct, **result, "metrics": metrics, "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        sys.stderr.write("set-up parts (s): " + " ".join(
            f"{k} {v:.3f}" for k, v in ctx.parts.items()) + f" total {setup_s:.3f}; after the "
            "window (s): " + " ".join(f"{k} {v:.3f}" for k, v in after.items()) + "\n")
        return {"result": result, "checks": checks}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    _env()
    args = parse(argv)
    try:
        out = run_cell(args)
    except SystemExit as e:
        sys.stderr.write(f"{e}\n")
        return 2
    except BaseException:
        traceback.print_exc()
        return 1
    from portbench import harness

    harness.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
