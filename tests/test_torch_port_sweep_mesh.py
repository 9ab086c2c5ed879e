"""Seed sweeps over a mesh (``laff_tpu_torch.engine.sweep.sweep_main(mesh=)``)
and the multi-process resume guard, on the CPU: gloo ranks started by the
port's launcher (its ``FileStore`` under ``tmp_path``, one torch thread a
rank), held against ``laff_tpu``'s sweeps over its virtual CPU devices
(``tests/conftest.py``) and against the port's one-process sweep.

* the seed axis over a 1-D mesh: 4 seeds over 2 ranks, against
  ``laff_tpu``'s ``sweep_main(mesh=data_parallel_mesh(2))`` from one flax
  init carried into the port, dropout off (each epoch's loss within 1e-4
  relative, the trainer-parity bound; r1, r5, r10, medr and mir equal), and
  bit for bit against the port's one-process sweep of the same seeds
  (history, best checkpoint, ``val_perf_hist.txt``, ``val_perf.txt``,
  ``scalars.tsv``); rank 1 returns nothing;
* the seed x dp layout (``parallel.seed_data_mesh(2, 2)``) over 4 ranks:
  its rows (ranks 0-1 and 2-3, a process group each, the 'dp' mesh of
  their ranks) and its refusal of a layout the world does not fit;
  against ``laff_tpu``'s ``seed_data_mesh(2, 2)`` sweep with the same
  bounds, and against the port's one-process sweep within 1e-4 (the
  gradient is summed over the row: another order of the same sums);
* the two ``ValueError``s of a mesh sweep, on meshes built directly (the
  checks come before any collective);
* ``--resume`` under a 2-rank mesh with a root of its own for each rank:
  with a leftover ``model_resume.pth.tar`` in rank 0's root alone both
  ranks raise "shared filesystem" before anything is unpickled; with none,
  both start fresh and train as one data-parallel run.

The world is ``tests/test_sweep.py``'s (24 x 2 train, 10 x 1 val). The
ranks' targets are module-level functions of this file, which imports no
JAX at its top: the spawned ranks import it.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import sweep as port_sweep
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import load_checkpoint
from laff_tpu_torch.parallel import Mesh, SeedDataMesh, launch

EPOCH_LOSS_RTOL = 1e-4  # an epoch's mean loss after the steps before it
RUN_FILES = ("val_perf_hist.txt", "val_perf.txt", "scalars.tsv")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in the ranks, so that the one-process sweep
    sums in their order; put back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet(config):
    config.dropout = 0.0  # the two packages draw dropout from other generators
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_sweep.py's world, and one flax init of the tiny config
    saved for each package (dropout off)."""
    import importlib

    import jax

    from laff_tpu.data.synth import build_collection, build_w2v
    from laff_tpu.engine import Options as JOptions
    from laff_tpu.engine import trainer as jax_trainer
    from laff_tpu.engine.checkpoint import save_checkpoint as jax_save
    from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
    from laff_tpu_torch.engine.weights import from_jax_variables

    root = str(tmp_path_factory.mktemp("sweep_mesh_world"))
    build_collection(root, "toytrain", n_videos=24, caps_per_video=2, seed=0)
    build_collection(root, "toyval", n_videos=10, caps_per_video=1, seed=5)
    build_w2v(root)
    jax_prepare = importlib.import_module("laff_tpu.engine.prepare")
    jax_tiny = _jax_tiny()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_prepare, "load_config", lambda name: _quiet(jax_tiny.config()))
        jprep = jax_prepare.prepare(JOptions(**_base(root), model_prefix="init"))
        init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                      jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                      seed=2)
        host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        jax_init = os.path.join(root, "init.pth.tar")
        jax_save({"params": host(init.params), "batch_stats": host(init.batch_stats),
                  "schedule": host(init.schedule), "config": jprep.config,
                  "spec": jprep.spec, "opt": {}}, jax_init)
        pprep = port_prepare.prepare(port_prepare.Options(device="cpu", model_prefix="init",
                                                          **_base(root)))
        port_init = os.path.join(root, "init.pt")
        save_checkpoint(checkpoint_payload(
            from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
            pprep.spec, pprep.config, pprep.featurizers, {}), port_init)
    finally:
        mp.undo()
    return {"root": root, "jax_init": jax_init, "port_init": port_init}


def _base(root, **kw):
    return {**dict(trainCollection="toytrain", valCollection="toyval", rootpath=root,
                   val_set="no", config_name="tiny", num_epochs=2, batch_size=8), **kw}


def _popt(world, prefix, **kw):
    return port_prepare.Options(model_prefix=prefix, device="cpu",
                                pretrained_file_path=world["port_init"],
                                **_base(world["root"], **kw))


def _jax_tiny():
    """``laff_tpu.configs.tiny`` by its own name. A package attribute may
    hold the module imported as ``configs.tiny`` through the reference
    aliases (``laff_tpu.engine.torch_import``), whose classes do not pickle
    once ``configs`` names another package."""
    import importlib

    return importlib.import_module("laff_tpu.configs.tiny")


def _jax_sweep(world, prefix, seeds, mesh, monkeypatch):
    import importlib

    from laff_tpu.engine import Options as JOptions

    jax_tiny = _jax_tiny()
    jax_prepare = importlib.import_module("laff_tpu.engine.prepare")
    jax_sweep = importlib.import_module("laff_tpu.engine.sweep")
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: _quiet(jax_tiny.config()))
    jopt = JOptions(model_prefix=prefix, **_base(world["root"]))
    jopt.pretrained_file_path = world["jax_init"]
    return jax_sweep.sweep_main(jopt, seeds, mesh=mesh)


def _one_process(world, prefix, seeds, monkeypatch):
    load = port_prepare.load_config
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _quiet(load(name, parm)))
    return port_sweep.sweep_main(_popt(world, prefix), seeds)


def _sweep_rank(mesh, opt, seeds, layout):
    """One rank of a mesh sweep (dropout off); rank 0 returns the results,
    whether every other rank returned an empty list, and for a 2-D layout
    each rank's (row, rank in the row, the row's world ranks) and the error
    of a layout the world does not fit."""
    torch.set_num_threads(1)
    from laff_tpu_torch.parallel import seed_data_mesh

    load = port_prepare.load_config
    port_prepare.load_config = lambda name, parm="None": _quiet(load(name, parm))
    out = {}
    if layout == "1d":
        sweep_mesh = mesh
    else:
        sweep_mesh = seed_data_mesh(*layout)
        row = sweep_mesh.row
        place = (sweep_mesh.seed_index, row.rank, [row.global_rank(r) for r in range(row.size)],
                 row.group is not None, sweep_mesh.shape)
        out["rows"] = [mesh.broadcast_object(place, src=r) for r in range(mesh.size)]
        try:
            seed_data_mesh(layout[0] + 1, layout[1])
        except ValueError as e:
            out["too_big"] = str(e)
    results = port_sweep.sweep_main(opt, seeds, mesh=sweep_mesh)
    others_empty = all(mesh.broadcast_object(results == [], src=r) for r in range(1, mesh.size))
    return {**out, "results": results, "others_empty": others_empty}


def _launch(tmp_path, n, target, *args):
    out = launch(n, target, *args, device="cpu", workdir=str(tmp_path))
    assert not dist.is_initialized()  # no group left behind in this process
    return out


def _assert_near(got, want, seeds):
    """Epoch losses within the trainer-parity bound, ranking metrics equal."""
    assert len(got) == len(want) == len(seeds)
    for seed, g, w in zip(seeds, got, want):
        assert len(g["history"]) == len(w["history"]) == 2, seed
        for ge, we in zip(g["history"], w["history"]):
            assert ge["loss"] == pytest.approx(we["loss"], rel=EPOCH_LOSS_RTOL), (seed, ge, we)
            for k in ("r1", "r5", "r10", "medr", "mir"):
                assert ge[k] == we[k], (seed, k, ge, we)


def _read(path):
    with open(path) as fh:
        return fh.read()


def _assert_same_run(got, want):
    assert [{k: e[k] for k in ("epoch", "loss", "lr", "steps", *port_trainer.METRICS)}
            for e in got["history"]] == \
        [{k: e[k] for k in ("epoch", "loss", "lr", "steps", *port_trainer.METRICS)}
         for e in want["history"]]
    assert (got["best_perf"], got["epochs"]) == (want["best_perf"], want["epochs"])
    a = load_checkpoint(os.path.join(got["model_path"], "model_best.pth.tar"))
    b = load_checkpoint(os.path.join(want["model_path"], "model_best.pth.tar"))
    assert a["epoch"] == b["epoch"] and a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for name in RUN_FILES:
        assert _read(os.path.join(got["model_path"], name)) == \
            _read(os.path.join(want["model_path"], name)), name


def test_seed_axis_mesh_matches_laff_tpu_and_one_process(world, tmp_path, monkeypatch):
    from laff_tpu.parallel import data_parallel_mesh as jax_mesh

    seeds = [11, 12, 13, 14]
    got = _launch(tmp_path, 2, _sweep_rank, _popt(world, "mesh1d"), seeds, "1d")
    assert got["others_empty"]
    mesh = got["results"]
    assert [os.path.basename(r["model_path"]) for r in mesh] == \
        [f"mesh1d_seed_{s}" for s in seeds]
    assert all(r["model"] is None for r in mesh)
    _assert_near(mesh, _jax_sweep(world, "jmesh1d", seeds, jax_mesh(2), monkeypatch), seeds)
    for g, w in zip(mesh, _one_process(world, "one1d", seeds, monkeypatch)):
        _assert_same_run(g, w)


def test_seed_data_mesh_matches_laff_tpu(world, tmp_path, monkeypatch):
    from laff_tpu.parallel import seed_data_mesh as jax_seed_data_mesh

    seeds = [21, 22]
    got = _launch(tmp_path, 4, _sweep_rank, _popt(world, "mesh2d"), seeds, (2, 2))
    assert got["others_empty"]
    # rows of the world, each a process group of its own
    shape = {"seed": 2, "dp": 2}
    assert got["rows"] == [(0, 0, [0, 1], True, shape), (0, 1, [0, 1], True, shape),
                           (1, 0, [2, 3], True, shape), (1, 1, [2, 3], True, shape)]
    assert got["too_big"] == "need 6 devices, have 4"
    mesh = got["results"]
    assert [os.path.basename(r["model_path"]) for r in mesh] == \
        [f"mesh2d_seed_{s}" for s in seeds]
    for r in mesh:  # each row's first rank wrote its seed's files
        assert {"model_best.pth.tar", *RUN_FILES} <= set(os.listdir(r["model_path"]))
    _assert_near(mesh, _jax_sweep(world, "jmesh2d", seeds, jax_seed_data_mesh(2, 2),
                                  monkeypatch), seeds)
    _assert_near(mesh, _one_process(world, "one2d", seeds, monkeypatch), seeds)


@pytest.mark.parametrize("layout,match", [("1d", "divide"), ("2d", "batch_size")])
def test_mesh_sweep_value_errors(world, layout, match):
    if layout == "1d":
        mesh, seeds, opt = Mesh(rank=0, size=2, device=CPU), [1, 2, 3], _popt(world, "bad")
    else:
        mesh = SeedDataMesh(n_seed=2, n_dp=2, row=Mesh(rank=0, size=2, device=CPU),
                            world=Mesh(rank=0, size=4, device=CPU))
        seeds, opt = [1, 2], _popt(world, "bad", batch_size=9)
    with pytest.raises(ValueError, match=match):
        port_sweep.sweep_main(opt, seeds, mesh=mesh)


def _resume_rank(mesh, roots, leftover):
    """``trainer.main(resume=1)`` on this rank's own root; rank 0's holds a
    leftover ``model_resume.pth.tar`` when ``leftover``. Rank 0 returns each
    rank's outcome (the error's text, or the run's history)."""
    torch.set_num_threads(1)
    from laff_tpu_torch.engine import prepare, trainer

    opt = prepare.Options(device="cpu", model_prefix="resume", resume=1,
                          **_base(roots[mesh.rank], batch_size=16))
    if leftover and mesh.rank == 0:
        path = prepare.model_dir_for(opt)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model_resume.pth.tar"), "wb") as fh:
            fh.write(b"leftover")  # not a checkpoint: the guard must fire before a load
    try:
        result = trainer.main(opt, mesh=mesh)
        outcome = {"history": [(e["epoch"], e["loss"]) for e in result["history"]],
                   "model_path": result["model_path"]}
    except RuntimeError as e:
        outcome = {"error": str(e)}
    return [mesh.broadcast_object(outcome, src=r) for r in range(mesh.size)]


@pytest.mark.parametrize("leftover", [True, False], ids=["split", "neither"])
def test_resume_guard_under_a_mesh(tmp_path, leftover):
    from laff_tpu_torch.data.synth import build_collection, build_w2v

    roots = []
    for i in range(2):
        root = str(tmp_path / f"root{i}")
        build_collection(root, "toytrain", n_videos=32, caps_per_video=2, seed=0)
        build_collection(root, "toyval", n_videos=16, caps_per_video=1, seed=5)
        build_w2v(root)
        roots.append(root)
    outcomes = _launch(tmp_path, 2, _resume_rank, roots, leftover)
    if leftover:
        for outcome in outcomes:
            assert "shared filesystem" in outcome.get("error", ""), outcome
            assert "1/2 processes" in outcome["error"]
        return
    assert [o.get("error") for o in outcomes] == [None, None]
    # one data-parallel run: the same epochs and losses on both ranks, and
    # the resume checkpoint written by rank 0 alone
    assert outcomes[0]["history"] == outcomes[1]["history"]
    assert [e for e, _ in outcomes[0]["history"]] == [0, 1]
    paths = [o["model_path"] for o in outcomes]
    assert paths[0].startswith(roots[0]) and paths[1].startswith(roots[1])
    assert os.path.exists(os.path.join(paths[0], "model_resume.pth.tar"))
    assert not os.path.exists(os.path.join(paths[1], "model_resume.pth.tar"))
