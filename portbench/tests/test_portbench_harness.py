"""The harness finds every cell, mix, driver, limit and metric of
BENCHMARK.json by name; the file keeps to the benchmark's contract; a
run's last line has exactly the contract's keys."""

from __future__ import annotations

import importlib
import io
import json
import re
import time
from contextlib import redirect_stdout

import pytest
import torch
from conftest import ROOT

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/") and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = harness.cell(name)
    driver = importlib.import_module(f"portbench.drivers.{c['traffic']['driver']}")
    for fn in ("setup", "window", "trace_context", "check"):
        assert callable(getattr(driver, fn))
    assert c["limits"]["numbers"], "a cell compares at least one number"
    assert any(m["name"] == "setup_s" for m in c["end_to_end"]) and len(c["end_to_end"]) >= 2
    assert c["per_layer"], "a cell reports at least one per-layer metric"
    for m in c["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_metric_readers_return_nothing_without_readings():
    empty = {"trace": {"window_s": 1.0, "busy_s": 0.0, "kernel_s": 0.0, "ops": {}, "gaps": []},
             "counters": {}}
    for m in BENCH["per_layer"]:
        assert harness.load_module("metrics", m["name"]).read(empty) is None, m["name"]


def test_sub_seeds_take_large_seeds():
    a = harness.sub_seeds(2**31 + 12345, 3)
    assert a == harness.sub_seeds(2**31 + 12345, 3) and len(set(a)) == 3
    assert all(0 <= s < 2**31 for s in a) and a != harness.sub_seeds(12345, 3)


@pytest.mark.parametrize("kind,trace", [("train", 0), ("val", 1)])
def test_result_line_has_the_contract_keys(tiny, kind, trace):
    from portbench import run

    c = tiny(kind)
    args = run.parse(["--workload", c["workload"]["name"], "--seed", "5", "--seconds", "0.5",
                      "--trace", str(trace)])
    out = run.run_cell(args, device=torch.device("cpu"), t_start=time.perf_counter(), cell=c)
    buf = io.StringIO()
    with redirect_stdout(buf):
        harness.emit(out["result"], out["checks"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == want and list(line)[-1] == "checks"
    assert set(line) == set(want) | {"checks"} | ({"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in (c["per_layer"] if trace else c["end_to_end"])}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
