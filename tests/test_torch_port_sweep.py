"""Seed sweeps (``laff_tpu_torch.engine.sweep``) on the CPU.

* ``sweep_main(seeds=[2, 7])`` against the port's own ``trainer.main`` of
  each seed: every epoch's loss and metrics, the best checkpoint's weights,
  ``val_perf_hist.txt``, ``val_perf.txt`` and ``scalars.tsv`` equal, bit for
  bit, in ``<prefix>_seed_<s>``;
* against ``laff_tpu.engine.sweep.sweep_main``, both warm-started from one
  flax init carried into the port, dropout off: each epoch's loss within
  1e-4 relative (the vmapped sweep tracks its single runs to rounding; the
  trainer, frames and single-space files hold an epoch's loss to the same
  bound) and the metrics equal;
* a seed stopped early: its checkpoint stops changing while the other seed
  trains on, and its weights equal ``trainer.main``'s stopped at the same
  epoch (``laff_tpu``'s ``test_active_mask_freezes_stopped_seed``); each
  seed's learning rates follow its own LR controller;
* what raises: ``trainCollection2``, ``resume``, seeds that do not divide
  over a mesh's ranks, no seeds;
* a sweep checkpoint through the port's predictor;
* ``ScalarLogger`` with ``LAFF_TPU_TENSORBOARD=1``: each seed's TensorBoard
  events, read back with ``EventAccumulator``, equal its ``scalars.tsv``
  (values as float32, the events' type); where TensorBoard does not
  import, one warning and the TSV alone.

The world is ``tests/test_sweep.py``'s (24 x 2 train, 10 x 1 val), built
once for the module.
"""

import dataclasses
import hashlib
import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

from laff_tpu.configs import tiny as jax_tiny
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.checkpoint import save_checkpoint as jax_save
from laff_tpu_torch.configs import tiny as port_tiny
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import sweep as port_sweep
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, load_checkpoint, save_checkpoint
from laff_tpu_torch.engine.optim import LRController
from laff_tpu_torch.engine.predictor import PredictOptions, main as predict_main
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.parallel import Mesh

from helpers import build_collection, build_w2v

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")
jax_sweep = importlib.import_module("laff_tpu.engine.sweep")

SEEDS = [2, 7]
EPOCH_LOSS_RTOL = 1e-4  # an epoch's mean loss after the steps before it
RUN_FILES = ("val_perf_hist.txt", "val_perf.txt", "scalars.tsv")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tiny tensors, so that the workers
    of a parallel test run do not spin against each other; put back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sweep_world"))
    build_collection(root, "toytrain", n_videos=24, caps_per_video=2, seed=0)
    build_collection(root, "toyval", n_videos=10, caps_per_video=1, seed=5)
    build_collection(root, "toytest", n_videos=12, caps_per_video=1, seed=9)
    build_w2v(root)
    return root


def _opt(root, prefix, **kw):
    base = dict(trainCollection="toytrain", valCollection="toyval", rootpath=root, val_set="no",
                config_name="tiny", num_epochs=2, batch_size=8, device="cpu")
    return port_prepare.Options(model_prefix=prefix, **{**base, **kw})


def _read(path):
    with open(path) as fh:
        return fh.read()


def _assert_same_run(got, want):
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert (g["epoch"], g["loss"], g["lr"], g["steps"]) == \
            (w["epoch"], w["loss"], w["lr"], w["steps"])
        for k in port_trainer.METRICS:
            assert g[k] == w[k], (k, g, w)
    assert (got["best_perf"], got["epochs"]) == (want["best_perf"], want["epochs"])
    a = load_checkpoint(os.path.join(got["model_path"], "model_best.pth.tar"))
    b = load_checkpoint(os.path.join(want["model_path"], "model_best.pth.tar"))
    assert a["epoch"] == b["epoch"]
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for name in RUN_FILES:
        assert _read(os.path.join(got["model_path"], name)) == \
            _read(os.path.join(want["model_path"], name)), name


def test_sweep_equals_trainer_main(world):
    results = port_sweep.sweep_main(_opt(world, "sweep"), SEEDS)
    assert [r["model_path"] for r in results] == [
        port_prepare.model_dir_for(_opt(world, f"sweep_seed_{s}")) for s in SEEDS]
    for seed, got in zip(SEEDS, results):
        want = port_trainer.main(_opt(world, f"single_{seed}", random_seed=seed))
        _assert_same_run(got, want)
        assert got["dispatch"]["vis_cache_bytes"] and got["dispatch"]["txt_cache_bytes"]
        assert got["dispatch"]["steps_per_dispatch"] == 6  # min(8, steps an epoch)
    # the seeds' runs differ: their own init, GRU embedding and batch order
    assert results[0]["history"][0]["loss"] != results[1]["history"][0]["loss"]
    # a sweep checkpoint serves the predictor unchanged
    out = predict_main(PredictOptions(
        testCollection="toytest", model_path=os.path.join(results[1]["model_path"],
                                                          "model_best.pth.tar"),
        sim_name="sweep_sim", rootpath=world, overwrite=1, query_sets="toytest.caption.txt",
        batch_size=8, device="cpu",
        predict_result_file=os.path.join(world, "result_log", "sweep.txt")))
    assert "t2v" in out["toytest.caption.txt"]


def _no_dropout(config):
    config.dropout = 0.0
    return config


def test_sweep_matches_laff_tpu(world, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_prepare, "load_config",
                        lambda name: _no_dropout(jax_tiny.config()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _no_dropout(port_tiny.config()))
    jopt = JOptions(trainCollection="toytrain", valCollection="toyval", rootpath=world,
                    val_set="no", config_name="tiny", num_epochs=2, batch_size=8,
                    model_prefix="jsweep")
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec), seed=2)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jax_init = str(tmp_path / "init.pth.tar")
    jax_save({"params": host(init.params), "batch_stats": host(init.batch_stats),
              "schedule": host(init.schedule), "config": jprep.config, "spec": jprep.spec,
              "opt": {}}, jax_init)
    popt = _opt(world, "psweep", pretrained_file_path=str(tmp_path / "init.pt"))
    pprep = port_prepare.prepare(dataclasses.replace(popt, model_prefix="psweep_seed_2",
                                                     random_seed=2))
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), popt.pretrained_file_path)
    jopt.pretrained_file_path = jax_init
    jres = jax_sweep.sweep_main(jopt, SEEDS)
    pres = port_sweep.sweep_main(popt, SEEDS)
    for seed, j, p in zip(SEEDS, jres, pres):
        assert os.path.relpath(p["model_path"], world) == os.path.relpath(j["model_path"], world) \
            .replace("jsweep", "psweep")
        assert len(p["history"]) == len(j["history"]) == 2
        for je, pe in zip(j["history"], p["history"]):
            assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL), (seed, pe, je)
            assert pe["lr"] == pytest.approx(je["lr"], rel=1e-6)
            for k in port_trainer.METRICS:
                assert pe[k] == je[k], (seed, k, pe, je)


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha1(fh.read()).hexdigest()


def test_stopped_seed_is_frozen_and_lrs_are_per_seed(world, monkeypatch):
    """Seed 7 stops after its first epoch (patience -1): its checkpoint does
    not change while seed 2 trains another epoch, and its weights are
    trainer.main's for one epoch. Each seed's learning rates replay its own
    controller over its own validation metric."""
    frozen = {}

    class EarlyStopping(port_trainer.TrainRun):
        def __init__(self, opt, *args, **kw):
            if opt.random_seed == 7:
                opt = dataclasses.replace(opt, early_stop_patience=-1)
            super().__init__(opt, *args, **kw)

        def end_epoch(self, epoch, *args):
            stopped = super().end_epoch(epoch, *args)
            if stopped and self.opt.random_seed == 7:
                frozen[epoch] = _sha(os.path.join(self.model_path, "model_best.pth.tar"))
            return stopped

    monkeypatch.setattr(port_sweep, "TrainRun", EarlyStopping)
    results = port_sweep.sweep_main(_opt(world, "stop"), SEEDS)
    kept, stopped = results
    assert [e["epoch"] for e in kept["history"]] == [0, 1] and kept["epochs"] == 2
    assert [e["epoch"] for e in stopped["history"]] == [0] and stopped["epochs"] == 1
    assert frozen == {0: _sha(os.path.join(stopped["model_path"], "model_best.pth.tar"))}
    files = set(os.listdir(stopped["model_path"]))  # nothing written after epoch 0
    assert {"model_best.pth.tar", *RUN_FILES} <= files <= {
        "model_best.pth.tar", "checkpoint_epoch_0.pth.tar", *RUN_FILES}
    want = port_trainer.main(_opt(world, "stop_single_7", random_seed=7, num_epochs=1))
    _assert_same_run(stopped, want)
    config = port_prepare.load_config("tiny")
    for res in results:
        ctl = LRController(config.lr, config.lr_decay_rate)
        lrs = []
        for e in res["history"]:
            lrs.append(ctl.current())
            ctl.step(e["mir"])
        assert [e["lr"] for e in res["history"]] == pytest.approx(lrs, rel=1e-12)


@pytest.mark.parametrize("change,error", [
    ({"trainCollection2": "toyval"}, NotImplementedError),
    ({"resume": 1}, NotImplementedError),
    # the id a mesh had when it raised NotImplementedError: seeds that do not
    # divide over its ranks raise ValueError now
    pytest.param("mesh", ValueError, id="mesh-NotImplementedError"),
    ("no_seeds", ValueError),
])
def test_sweep_options_that_raise(world, change, error):
    opt, seeds, mesh = _opt(world, "raise"), SEEDS, None
    if change == "mesh":  # 3 seeds over 2 ranks, refused before any collective
        mesh, seeds = Mesh(rank=0, size=2, device=torch.device("cpu")), [1, 2, 3]
    elif change == "no_seeds":
        seeds = []
    else:
        opt = dataclasses.replace(opt, **change)
    with pytest.raises(error, match="divide|trainCollection2|resume|seed"):
        port_sweep.sweep_main(opt, seeds, mesh=mesh)


def _tsv(path):
    rows = {}
    with open(path) as fh:
        for line in fh:
            step, tag, value = line.rstrip("\n").split("\t")
            rows.setdefault(tag, []).append((int(step), float(value)))
    return rows


def test_tensorboard_events_equal_scalars_tsv(world, monkeypatch):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setenv(port_trainer.TENSORBOARD_ENV, "1")
    results = port_sweep.sweep_main(_opt(world, "tb", num_epochs=1), SEEDS)
    for res in results:
        tsv = _tsv(os.path.join(res["model_path"], "scalars.tsv"))
        assert {"train/learning_rate", "train/Loss", "val/mir"} <= set(tsv)
        events = EventAccumulator(res["model_path"])
        events.Reload()
        assert set(events.Tags()["scalars"]) == set(tsv)
        for tag, rows in tsv.items():
            assert [(e.step, e.value) for e in events.Scalars(tag)] == \
                [(step, float(np.float32(v))) for step, v in rows], tag


def test_tensorboard_that_does_not_import_warns(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv(port_trainer.TENSORBOARD_ENV, "1")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(port_trainer.logger, "handlers",
                        [*port_trainer.logger.handlers, caplog.handler])
    log = port_trainer.ScalarLogger(str(tmp_path))
    log.add_scalar("val/mir", 0.25, 3)
    log.close()
    warnings = [r.message for r in caplog.records if r.levelname == "WARNING"]
    assert len(warnings) == 1 and "TensorBoard does not import" in warnings[0]
    assert os.listdir(tmp_path) == ["scalars.tsv"]
    assert _read(str(tmp_path / "scalars.tsv")) == "3\tval/mir\t0.25\n"
