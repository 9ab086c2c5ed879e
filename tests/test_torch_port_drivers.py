"""The port's repo-level scripts on the CPU, held against ``laff_tpu``'s
``shell/`` scripts (each loaded from its file, with no ``sys.modules``
entry):

* ``cli/reproduce_mvtest3k.py --dry_run`` (``device='cpu'``) against
  ``shell/reproduce_mvtest3k.py``'s dry run on the same mirror world, both
  from one flax init carried into the port (``pretrained_file_path`` set
  on each package's ``SweepOptions``), dropout off: the t2v row equal
  within 1e-4; and the data check's exit code 2 with the missing paths
  listed on an empty root;
* ``cli/do_pretrain_gcc_train_avs.py`` against
  ``shell/do_pretrain_gcc_train_avs.py`` on ``tests/test_orchestrate.py``'s
  two-stage world, stage 1 warm-started from one carried init in both,
  dropout off: the stage-1 checkpoints' weights within the trainer-parity
  bound (1e-5), the fine-tune started from the port's own stage-1
  checkpoint, its epochs' losses within 1e-4 relative and metrics equal
  (the trainer-parity bounds on a run), infAP equal within 1e-6; a second
  call skips stage 1 and leaves its checkpoint as it was;
* ``cli/multihost_smoke.py`` over 2 gloo worker processes (torchrun's
  variables, ``parallel.initialize_multihost``): its three checks pass.
"""

import functools
import importlib
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from laff_tpu.configs import tiny as jax_tiny
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.checkpoint import load_checkpoint as jax_load
from laff_tpu.engine.checkpoint import save_checkpoint as jax_save
from laff_tpu_torch.cli import do_pretrain_gcc_train_avs as port_two_stage
from laff_tpu_torch.cli import multihost_smoke
from laff_tpu_torch.cli import reproduce_mvtest3k as port_repro
from laff_tpu_torch.engine import orchestrate as port_orchestrate
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, load_checkpoint, save_checkpoint
from laff_tpu_torch.engine.weights import from_jax_variables

from helpers import WORDS, build_collection, build_w2v

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")
jax_orchestrate = importlib.import_module("laff_tpu.engine.orchestrate")
jax_predictor = importlib.import_module("laff_tpu.engine.predictor")

SHELL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "shell")
T2V_ATOL = 1e-4
PARAM_ATOL = 1e-5  # the trainer-parity files' bound on parameters after two epochs
EPOCH_LOSS_RTOL = 1e-4  # and on an epoch's mean loss
INFAP_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tiny tensors, so that the workers
    of a parallel test run do not spin against each other; put back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shell_module(name):
    """A ``shell/`` script as a module, not entered in ``sys.modules``."""
    spec = importlib.util.spec_from_file_location(f"_shell_{name}", os.path.join(SHELL,
                                                                                f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quiet(config):
    config.dropout = 0.0  # the two packages draw dropout from other generators
    return config


def _quiet_configs(monkeypatch):
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: _quiet(jax_tiny.config()))
    load = port_prepare.load_config
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _quiet(load(name, parm)))


def _carried_init(jax_root, port_root, out_dir, **opt):
    """One flax init of the tiny config on ``jax_root``'s collections, saved
    for laff_tpu and, carried, for the port on ``port_root``'s; the init
    runs' model directories are removed."""
    import shutil

    common = dict(val_set="no", config_name="tiny", model_prefix="carried_init", **opt)
    jprep = jax_prepare.prepare(JOptions(rootpath=jax_root, **common))
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec), seed=2)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jax_init = os.path.join(out_dir, "init.pth.tar")
    jax_save({"params": host(init.params), "batch_stats": host(init.batch_stats),
              "schedule": host(init.schedule), "config": jprep.config, "spec": jprep.spec,
              "opt": {}}, jax_init)
    pprep = port_prepare.prepare(port_prepare.Options(rootpath=port_root, device="cpu",
                                                      **common))
    port_init = os.path.join(out_dir, "init.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), port_init)
    for prep in (jprep, pprep):
        shutil.rmtree(prep.model_path)
    return jax_init, port_init


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# ---------------------------------------------------------------------------
# reproduce_mvtest3k
# ---------------------------------------------------------------------------

def test_reproduce_dry_run_matches_laff_tpu(tmp_path, monkeypatch, capsys):
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    for coll, n, seed in port_repro.DRY_WORLD:  # shell/reproduce_mvtest3k.py's world
        build_collection(jroot, coll, n_videos=n, caps_per_video=2, seed=seed)
    build_w2v(jroot)
    port_repro.build_dry_world(proot)
    _quiet_configs(monkeypatch)
    jax_init, port_init = _carried_init(jroot, proot, str(tmp_path),
                                        trainCollection="msrvtt10ktrain",
                                        valCollection="msrvtt10kval", batch_size=16)
    monkeypatch.setattr(jax_orchestrate, "SweepOptions", functools.partial(
        jax_orchestrate.SweepOptions, pretrained_file_path=jax_init,
        result_file=str(tmp_path / "jax_result.txt")))
    monkeypatch.setattr(port_orchestrate, "SweepOptions", functools.partial(
        port_orchestrate.SweepOptions, pretrained_file_path=port_init))
    jax_repro = _shell_module("reproduce_mvtest3k")
    want = jax_repro.run_model("dry", jroot, num_epochs=4, seed=2, batch_size=16,
                               config="tiny", parm="None")
    capsys.readouterr()
    assert port_repro.dry_run(device="cpu", root=proot) == 0
    line = _json_lines(capsys.readouterr().out)[-1]
    assert line["plumbing"] == "ok"
    np.testing.assert_allclose(line["t2v"], [float(x) for x in want], rtol=0, atol=T2V_ATOL)
    assert os.path.exists(os.path.join(proot, "result_log", "TextToVideo", "repro_dry.txt"))


def test_reproduce_missing_data_exits_2(tmp_path, capsys):
    root = str(tmp_path / "empty")
    assert port_repro.main(["--rootpath", root, "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert "missing data" in out
    assert os.path.join(root, "msrvtt10ktrain") in out
    assert os.path.join(root, "word2vec", "flickr", "vec500flickr30m") in out


# ---------------------------------------------------------------------------
# do_pretrain_gcc_train_avs
# ---------------------------------------------------------------------------

def _two_stage_world(root):
    """tests/test_orchestrate.py's two-stage world."""
    build_collection(root, "toytrain", n_videos=24, caps_per_video=2, seed=0)
    build_collection(root, "toyval", n_videos=12, caps_per_video=1, seed=5)
    build_collection(root, "toytest", n_videos=20, caps_per_video=1, seed=9)
    build_w2v(root)
    build_collection(root, "gcctoy", n_videos=24, caps_per_video=2, seed=11)
    tdir = os.path.join(root, "toytest", "TextData")
    with open(os.path.join(tdir, "tv99.queries.txt"), "w") as fh:
        for i in range(3):
            fh.write(f"9{i:02d} the {' '.join(WORDS[i:i + 4])}\n")
    rng = np.random.default_rng(0)
    with open(os.path.join(tdir, "avs.qrels.tv99"), "w") as fh:
        for i in range(3):
            for v in range(20):
                fh.write(f"19{i:02d} 0 video{v} 1 {int(rng.random() < 0.3)}\n")


def _two_stage_argv(root):
    return ["--rootpath", root, "--pretrainCollection", "gcctoy", "--trainCollection",
            "toytrain", "--valCollection", "toyval", "--val_set", "no", "--testCollection",
            "toytest", "--config", "tiny", "--batch_size", "12", "--pretrain_epochs", "2",
            "--num_epochs", "2", "--avs_query_sets", "tv99.queries.txt", "--avs_editions",
            "tv99"]


@pytest.fixture(scope="module")
def two_stage(tmp_path_factory):
    """Both packages' two-stage scripts, each on its copy of the world."""
    tmp = tmp_path_factory.mktemp("two_stage")
    jroot, proot = str(tmp / "jax"), str(tmp / "port")
    for root in (jroot, proot):
        _two_stage_world(root)
    mp = pytest.MonkeyPatch()
    try:
        _quiet_configs(mp)
        for module in (jax_predictor, port_predictor):
            mp.setattr(module, "AVS_COLLECTIONS", ("toytest",))
        jax_init, port_init = _carried_init(jroot, proot, str(tmp), trainCollection="gcctoy",
                                            valCollection="gcc11val", train_strategy="subset",
                                            batch_size=12)
        jax_two_stage = _shell_module("do_pretrain_gcc_train_avs")
        mp.setattr(jax_two_stage, "Options", functools.partial(
            jax_two_stage.Options, pretrained_file_path=jax_init))
        captured = {}
        avs = jax_two_stage.avs_task
        mp.setattr(jax_two_stage, "avs_task", lambda sweep: captured.setdefault("avs", avs(sweep)))
        assert jax_two_stage.main(_two_stage_argv(jroot)) == 0
        mp.setattr(port_two_stage, "Options", functools.partial(
            port_two_stage.Options, pretrained_file_path=port_init))
        got = port_two_stage.run(_two_stage_argv(proot) + ["--device", "cpu"])
    finally:
        mp.undo()
    return {"jax_root": jroot, "port_root": proot, "jax_avs": captured["avs"], "port": got}


def _assert_weights_near(port_ckpt, jax_ckpt):
    got = load_checkpoint(port_ckpt)["state_dict"]
    jck = jax_load(jax_ckpt)
    ref = from_jax_variables(jck["params"], jck["batch_stats"], jck["schedule"])
    assert set(got) == set(ref)
    for k in ref:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


def test_two_stage_matches_laff_tpu(two_stage):
    got = two_stage["port"]
    assert got["pretrained"]
    rel = os.path.relpath(got["pretrain_ckpt"], two_stage["port_root"])
    assert rel == os.path.join("gcctoy", "w2vvpp_train", "gcc11val", "tiny",
                               "gcc_pretrain_None_seed_2", "model_best.pth.tar")
    _assert_weights_near(got["pretrain_ckpt"], os.path.join(two_stage["jax_root"], rel))
    (key, run), = got["avs"].items()
    (jkey, jrun), = two_stage["jax_avs"].items()
    assert key == jkey and key.startswith("gccft_")
    ft_dir = os.path.join("toytrain", "w2vvpp_train", "toyval", "tiny", key)
    ft = os.path.join(two_stage["port_root"], ft_dir, "model_best.pth.tar")
    assert load_checkpoint(ft)["opt"]["pretrained_file_path"] == got["pretrain_ckpt"]
    # the fine-tune from the two stage-1 checkpoints: each epoch as the trainer
    # parity tests hold it (Adam turns their 1e-6 differences into steps of lr)
    history, jhistory = run["train"]["history"], jrun["train"]["history"]
    assert len(history) == len(jhistory) == 2
    for pe, je in zip(history, jhistory):
        assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL)
        for k in port_trainer.METRICS:
            assert pe[k] == je[k], (k, pe, je)
    assert set(run["infAP"]) == set(jrun["infAP"]) == {"tv99"}
    assert run["infAP"]["tv99"] == pytest.approx(jrun["infAP"]["tv99"], rel=0, abs=INFAP_ATOL)
    score = os.path.join(two_stage["port_root"], "toytest", "SimilarityIndex",
                         "tv99.queries.txt", "toytrain", "toyval", "tiny", "id.sent.score.txt")
    assert os.path.exists(score) and os.path.exists(score + ".xml")


def test_two_stage_skips_an_existing_stage_1(two_stage, monkeypatch):
    ckpt = two_stage["port"]["pretrain_ckpt"]
    stat = os.stat(ckpt)

    def no_pretrain(opt, *args, **kw):
        raise AssertionError("stage 1 ran again")

    _quiet_configs(monkeypatch)
    monkeypatch.setattr(port_predictor, "AVS_COLLECTIONS", ("toytest",))
    monkeypatch.setattr(port_trainer, "main", no_pretrain)
    got = port_two_stage.run(_two_stage_argv(two_stage["port_root"]) + ["--device", "cpu"])
    assert not got["pretrained"] and got["pretrain_ckpt"] == ckpt
    assert os.stat(ckpt).st_mtime_ns == stat.st_mtime_ns
    assert set(next(iter(got["avs"].values()))["infAP"]) == {"tv99"}


# ---------------------------------------------------------------------------
# multihost_smoke
# ---------------------------------------------------------------------------

def test_multihost_smoke_over_two_gloo_processes(tmp_path, capsys):
    assert multihost_smoke.main(["--procs", "2", "--device", "cpu", "--workdir",
                                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "multihost smoke: PASS" in out
    assert os.listdir(tmp_path) == []  # its temporary directory is removed
