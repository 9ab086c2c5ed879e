"""A run of each cell, at a small size on the CPU, with the timed path
broken underneath, comes out not correct: once for each fault the cell can
have. (The exchange between cards is no fault of these one-card cells.)
The same runs unbroken come out correct (test_portbench_harness)."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import run


def _run(cell) -> dict:
    args = run.parse(["--workload", cell["workload"]["name"], "--seed", "11", "--seconds",
                      "0.5"])
    return run.run_cell(args, device=torch.device("cpu"), t_start=time.perf_counter(),
                        cell=cell)


def _unchanged_state(monkeypatch):
    from laff_tpu_torch.engine import optim

    monkeypatch.setattr(optim.OptaxChain, "step", lambda self: None)


def _half_batch(monkeypatch):
    from laff_tpu_torch.engine import trainer

    real = trainer.make_loss_fn

    def make_loss_fn(spec):
        fn = real(spec)

        def half(txt, vis):
            n = txt.shape[0] // 2
            return 2.0 * fn(txt[:n], vis[:n])

        return half

    monkeypatch.setattr(trainer, "make_loss_fn", make_loss_fn)


def _altered_loss(monkeypatch):
    from laff_tpu_torch.engine import trainer

    real = trainer.TrainStep.__call__
    monkeypatch.setattr(trainer.TrainStep, "__call__",
                        lambda self, *a, **k: real(self, *a, **k) * 1.01)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_loss],
                         ids=["state_unchanged", "half_batch", "loss_altered"])
@pytest.mark.parametrize("frames", [False, True], ids=["laffml", "framelaff"])
def test_train_faults_fail(tiny, monkeypatch, fault, frames):
    cell = tiny("train", frames=frames)
    fault(monkeypatch)
    out = _run(cell)
    assert out["result"]["correct"] is False, out["checks"]


def _altered_ranks(monkeypatch):
    from laff_tpu_torch.engine import evaluator

    real = evaluator.t2v_ranks

    def t2v_ranks(txt, vis, txt_ids, vis_ids, *a, **k):
        ranks = real(txt, vis, txt_ids, vis_ids, *a, **k).copy()
        ranks[::7] = len(vis_ids) + 1 - ranks[::7]
        return ranks

    monkeypatch.setattr(evaluator, "t2v_ranks", t2v_ranks)


def _half_text_batch(monkeypatch):
    from laff_tpu_torch.engine import evaluator

    real = evaluator.Embedder.apply

    def apply(self, fn, data):
        emb = real(self, fn, data)
        if fn == self.model.encode_txt:
            n = emb.shape[0] // 2
            emb = torch.cat([emb[:n], emb[:emb.shape[0] - n]])
        return emb

    monkeypatch.setattr(evaluator.Embedder, "apply", apply)


def _altered_metric(monkeypatch):
    from laff_tpu_torch.engine import evaluator

    real = evaluator.metrics_from_ranks
    monkeypatch.setattr(evaluator, "metrics_from_ranks",
                        lambda ranks: (real(ranks)[0] + 0.1, *real(ranks)[1:]))


@pytest.mark.parametrize("fault", [_altered_ranks, _half_text_batch, _altered_metric],
                         ids=["ranks_altered", "half_batch", "metric_altered"])
def test_val_faults_fail(tiny, monkeypatch, fault):
    cell = tiny("val")
    fault(monkeypatch)
    out = _run(cell)
    assert out["result"]["correct"] is False, out["checks"]
