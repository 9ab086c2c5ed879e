"""The control (the reference one precision step below what the
configuration states, in the program's place) and a training cell's
planted fault come out not correct under each cell's limits: at a small
size on the CPU, and at the cells' own sizes on the card (the readings the
limits were set from, on three seeds each, are in PERF.md; this runs one)."""

from __future__ import annotations

import torch
import pytest
from conftest import need_card, tiny_cell

from portbench import control, harness


def _fails(readings, cell) -> bool:
    ok, _ = harness.judge(readings, cell["limits"])
    return not ok


@pytest.mark.parametrize("what", ["control", "half_batch"])
@pytest.mark.parametrize("frames", [False, True], ids=["laffml", "framelaff"])
def test_train_control_and_fault_fail(tmp_path, what, frames):
    c = tiny_cell("train", frames=frames)
    r = control.train_readings(c["config"], c["traffic"], 21, str(tmp_path),
                               torch.device("cpu"), None if what == "control" else what)
    assert _fails(r, c), r


def test_val_control_fails(tmp_path):
    c = tiny_cell("val")
    r = control.val_readings(c["config"], c["traffic"], 21, str(tmp_path), torch.device("cpu"))
    assert _fails(r, c), r


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(tmp_path, name):
    need_card()
    from portbench import program

    program.strict_fp32()
    c = harness.cell(name)
    device = torch.device("cuda", 0)
    if c["traffic"]["driver"] == "train":
        r = control.train_readings(c["config"], c["traffic"], 31, str(tmp_path), device)
    else:
        r = control.val_readings(c["config"], c["traffic"], 31, str(tmp_path), device)
    assert _fails(r, c), r
