"""Checkpoint interchange with the reference, on the CPU, held against
laff_tpu's importer and exporter:

* ``convert_state_dict`` on the synthetic reference state dicts of
  ``tests/test_torch_import.py`` (LAFF, and FrameLAFF with a frame fc and a
  frame gate) gives the state dict and towers of laff_tpu's import carried
  by ``from_jax_variables``, within 1e-5;
* ``export_state_dict`` equals laff_tpu's on the same weights (same keys,
  bit-equal tensors), tied towers included; export then import is the
  identity;
* ``load_checkpoint`` tells the port's format from a reference one by the
  payload, and refuses anything else; the unpickler refuses classes a
  checkpoint may not hold and names a config the port has no copy of;
* reference pickles (``configs.<name>``, ``txt2vec``, ``textlib``)
  resolve in one process through the port and through laff_tpu, in both
  orders: each returns its own package's classes, and the port's load adds
  no module to ``sys.modules``;
* a reference ``.pth.tar`` through the port's predictor (and its CLI) and
  ``--pretrained_file_path`` gives what the port-format file of the same
  weights gives, and a file laff_tpu exported ranks in the port as in
  laff_tpu.
"""

import argparse
import dataclasses
import importlib
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.configs import rehearsal as jax_rehearsal
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.predictor import PredictOptions as JPredictOptions
from laff_tpu.engine.predictor import main as jax_predict
from laff_tpu.engine.torch_export import export_state_dict as jax_export
from laff_tpu.engine.torch_export import save_torch_checkpoint as jax_save_torch
from laff_tpu.engine.torch_import import convert_state_dict as jax_convert
from laff_tpu.engine.torch_import import load_torch_checkpoint as jax_load_torch
from laff_tpu.models import AttentionSpec as JAttn
from laff_tpu.models import LAFFModel as JModel
from laff_tpu_torch.cli import do_predictor
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from laff_tpu_torch.engine.torch_export import export_state_dict, save_torch_checkpoint
from laff_tpu_torch.engine.torch_import import convert_state_dict, load_torch_checkpoint
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import LAFFModel
from laff_tpu_torch.models.spec import spec_from_dict
from test_torch_import import reference_style_state_dict, small_spec
from test_torch_port_trainer import TRAIN, VAL, _base, _port_config, _small, world  # noqa: F401

# laff_tpu's importer aliases the reference module names for the whole
# process (``sys.modules.setdefault("configs", laff_tpu.configs)``). Once
# it has run, the repository's root-level experiment configs
# (``configs/e2e_tiny.py``, which ``laff_tpu.engine.prepare.load_config``
# falls back to) stop resolving for every later test in that process.
# Importing the root package here, at collection, which every test process
# does before it runs a test, keeps the name taken; the tests below that
# load through laff_tpu stand it aside for that load only.
import configs as root_configs  # noqa: E402

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

TOL = 1e-5
FRAME = ("clip_frames", 16)
ALIASES = ("configs", "textlib", "txt2vec", "bigfile")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _port_spec(jspec):
    return spec_from_dict(dataclasses.asdict(jspec))


def frame_spec():
    """small_spec with FrameLAFF's vis side: a frame feature through an fc
    and the single-head gate (kind 7), beside the video features."""
    spec = small_spec()
    gate = JAttn(kind="attention_noAveNoAverageMul", heads=4)
    return dataclasses.replace(spec, vis=dataclasses.replace(
        spec.vis, frame_features=(FRAME,), frame_attention=gate, frame_add_fc=True))


def frame_state_dict(rng):
    sd = reference_style_state_dict(rng, frame_laff=True)
    name, d = FRAME

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd[f"vis_net.{name}.fc1.weight"], sd[f"vis_net.{name}.fc1.bias"] = t(32, d), t(32)
    sd[f"vis_net.{name}.bn1.weight"] = t(32).abs()
    sd[f"vis_net.{name}.bn1.bias"], sd[f"vis_net.{name}.bn1.running_mean"] = t(32), t(32)
    sd[f"vis_net.{name}.bn1.running_var"] = t(32).abs() + 0.5
    sd[f"vis_net.{name}.bn1.num_batches_tracked"] = torch.tensor(3)
    base = f"vis_net.frame_attention.{name}."
    sd[base + "0.weight"], sd[base + "0.bias"] = t(d, d), t(d)
    sd[base + "1.embedding_common.0.weight"], sd[base + "1.embedding_common.0.bias"] = t(1, d), t(1)
    return sd


def _batches(rng, spec, b=5):
    txt = {"rnn_ids": rng.integers(1, 30, (b, 6)).astype(np.int32),
           "rnn_len": np.array([6, 3, 4, 1, 5][:b], np.int32),
           "bow": rng.standard_normal((b, 20)).astype(np.float32),
           "w2v": rng.standard_normal((b, 10)).astype(np.float32)}
    vis = {n: rng.standard_normal((b, d)).astype(np.float32) for n, d in spec.vis.features}
    for n, d in spec.vis.frame_features:
        vis[f"{n}@frames"] = rng.standard_normal((b, 4, d)).astype(np.float32)
        mask = np.ones((b, 4), np.float32)
        mask[0, 2:] = 0
        vis[f"{n}@mask"] = mask
    return ({k: torch.from_numpy(v) for k, v in txt.items()},
            {k: torch.from_numpy(v) for k, v in vis.items()})


@torch.no_grad()
def _embed(state_dict, spec, txt, vis):
    model = LAFFModel(spec)
    model.load_state_dict(state_dict)
    return model.eval()(txt, vis)


LAYOUTS = {"laff": (small_spec, lambda rng: reference_style_state_dict(rng)),
           "frame": (frame_spec, frame_state_dict)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_convert_state_dict_matches_laff_tpu(layout):
    make_spec, make_sd = LAYOUTS[layout]
    rng = np.random.default_rng(0)
    jspec, sd = make_spec(), make_sd(rng)
    spec = _port_spec(jspec)
    got = convert_state_dict(sd, spec)
    ref = from_jax_variables(*jax_convert(sd, jspec))
    assert set(got) == set(ref)
    for k in ref:
        if not k.endswith("num_batches_tracked"):  # laff_tpu keeps no BN step count
            assert torch.equal(got[k], ref[k].reshape(got[k].shape)), k
    txt, vis = _batches(rng, spec)
    for a, b in zip(_embed(got, spec, txt, vis), _embed(ref, spec, txt, vis)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


def _flax_variables(jspec, seed=0):
    rng = np.random.default_rng(seed)
    txt, vis = _batches(rng, jspec)
    variables = JModel(jspec).init({"params": jax.random.PRNGKey(seed),
                                    "dropout": jax.random.PRNGKey(seed + 1)},
                                   {k: jnp.asarray(v.numpy()) for k, v in txt.items()},
                                   {k: jnp.asarray(v.numpy()) for k, v in vis.items()})
    # non-trivial BN statistics and residual weights
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.25, _host(variables["batch_stats"]))
    sched = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.6,
                                   _host(variables.get("schedule", {})))
    return _host(variables["params"]), stats, sched


def tied_spec():
    spec = small_spec()
    return dataclasses.replace(
        spec, vis=dataclasses.replace(spec.vis, features=spec.vis.features + (("w2v_like", 10),)),
        tied_transforms=(("w2v", "w2v_like"),))


EXPORTS = {"laff": small_spec, "frame": frame_spec, "tied": tied_spec}


@pytest.mark.parametrize("layout", list(EXPORTS))
def test_export_matches_laff_tpu(layout):
    jspec = EXPORTS[layout]()
    params, stats, sched = _flax_variables(jspec)
    ref = jax_export({"params": params, "batch_stats": stats, "schedule": sched, "spec": jspec})
    got = export_state_dict({"state_dict": from_jax_variables(params, stats, sched),
                             "spec": _port_spec(jspec)})
    assert set(got) == set(ref)
    for k, v in ref.items():
        want = torch.from_numpy(np.array(v, copy=True))  # as save_torch_checkpoint writes it
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


@pytest.mark.parametrize("layout", list(EXPORTS))
def test_export_then_import_is_the_identity(layout):
    """Untied towers come back entry for entry; tied ones come back untied
    (one fc copy per tower, as the reference holds them) with the same
    embeddings."""
    jspec = EXPORTS[layout]()
    spec = _port_spec(jspec)
    model = LAFFModel(spec)
    model.load_state_dict(from_jax_variables(*_flax_variables(jspec)))
    state = model.state_dict()
    back_spec = dataclasses.replace(spec, tied_transforms=())
    back = convert_state_dict(export_state_dict({"state_dict": state, "spec": spec}), back_spec)
    if not spec.tied_transforms:
        assert set(back) == set(state)
        for k in state:
            assert torch.equal(back[k], state[k]), k
    txt, vis = _batches(np.random.default_rng(1), spec)
    for a, b in zip(_embed(back, back_spec, txt, vis), _embed(state, spec, txt, vis)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# reference pickles, without process-wide aliases
# ---------------------------------------------------------------------------

def _alias_modules():
    return {k for k in sys.modules if k.split(".")[0] in ALIASES}


@pytest.fixture
def restore_aliases():
    """laff_tpu's importer aliases the reference module names process-wide:
    put sys.modules back as it was after each test."""
    before = {k: sys.modules[k] for k in _alias_modules()}
    yield
    for k in _alias_modules() - set(before):
        del sys.modules[k]
    sys.modules.update(before)


def _reference_class(base, module):
    cls = type(base.__name__, (base,), {"__module__": module})
    cls.__qualname__ = base.__name__
    return cls


def _reference_object(obj, cls):
    """``obj`` as an instance of ``cls``, its reference-named class."""
    fake = object.__new__(cls)
    fake.__dict__.update(obj.__dict__)
    return fake


def write_reference_file(path, monkeypatch, config_name="tiny_tied", obj=None):
    """A .pth.tar as the reference writes it: a state dict in its layout,
    and a config pickled as ``configs.<config_name>.config`` holding its
    dims and a ``txt2vec.BowVecNSW`` / ``textlib.Vocabulary`` featurizer.
    The reference module names exist only while the file is written."""
    from laff_tpu.configs.tiny_tied import config as TiedConfig
    from laff_tpu.text import BowVecNSW, Vocabulary

    vocab = Vocabulary("bow_nsw")
    for i in range(20):
        vocab.add(f"w{i}")
    txt2vec = types.ModuleType("txt2vec")
    textlib = types.ModuleType("textlib")
    configs = types.ModuleType("configs")
    configs.__path__ = []
    cfg_mod = types.ModuleType(f"configs.{config_name}")
    cfg_mod.config = _reference_class(TiedConfig, cfg_mod.__name__)
    bow = BowVecNSW(vocab)
    txt2vec.BowVecNSW = _reference_class(BowVecNSW, "txt2vec")
    textlib.Vocabulary = _reference_class(Vocabulary, "textlib")
    bow_ref = _reference_object(bow, txt2vec.BowVecNSW)
    bow_ref.vocab = _reference_object(vocab, textlib.Vocabulary)
    config = object.__new__(cfg_mod.config)
    config.__dict__.update(vis_fc_layers=[{"clip_ft": 16, "w2v_like8": 8}, 32],
                           txt_fc_layers=[36, 32], t2v_bow=bow_ref, t2v_idx=None)
    spec = dataclasses.replace(
        small_spec(), vis=dataclasses.replace(small_spec().vis,
                                              features=(("clip_ft", 16), ("w2v_like8", 8))))
    spec = dataclasses.replace(spec, txt=dataclasses.replace(
        spec.txt, features=(("rnn", 8), ("bow", 20), ("w2v", 8)),
        gru=dataclasses.replace(spec.txt.gru, we_dim=8)))  # tiny's widths
    state = LAFFModel(_port_spec(spec)).state_dict()
    model = {k: v.normal_() if v.is_floating_point() else v for k, v in state.items()}
    sd = export_state_dict({"state_dict": model, "spec": _port_spec(spec)})
    with monkeypatch.context() as m:
        for name, mod in (("configs", configs), (cfg_mod.__name__, cfg_mod),
                          ("txt2vec", txt2vec), ("textlib", textlib)):
            m.setitem(sys.modules, name, mod)
        torch.save({"epoch": 3, "model": sd, "best_perf": np.float64(0.5), "config": config,
                    "opt": argparse.Namespace(trainCollection="toytrain"),
                    **({"extra": obj} if obj is not None else {})}, path)
    return sd


@pytest.mark.parametrize("order", ["port_first", "laff_tpu_first"])
def test_reference_pickles_resolve_without_aliases(tmp_path, monkeypatch, restore_aliases,
                                                   order):
    """In one process, in either order: the port's load returns its own
    classes and adds nothing to sys.modules, laff_tpu's returns laff_tpu's."""
    path = str(tmp_path / "model_best.pth.tar")
    write_reference_file(path, monkeypatch)

    def port():
        before = set(sys.modules)
        ckpt = load_checkpoint(path)
        added = {k for k in set(sys.modules) - before if k.split(".")[0] in ALIASES}
        assert not added, added
        assert type(ckpt["config"]).__module__ == "laff_tpu_torch.configs.tiny_tied"
        assert type(ckpt["config"].t2v_bow).__module__ == "laff_tpu_torch.text.txt2vec"
        assert type(ckpt["config"].t2v_bow.vocab).__module__ == "laff_tpu_torch.text.textlib"
        assert ckpt["vocab"]["bow"]["words"] == [f"w{i}" for i in range(20)]
        assert ckpt["spec"].tied_transforms == ()  # the reference's tie is a no-op: untied
        assert ckpt["epoch"] == 3 and ckpt["opt"] == {"trainCollection": "toytrain"}

    def laff_tpu():
        with monkeypatch.context() as m:  # as in a process where nothing took the name
            for k in [k for k in sys.modules if k.split(".")[0] == "configs"]:
                m.delitem(sys.modules, k)
            ckpt = jax_load_torch(path)
        cls = type(ckpt["config"])
        assert os.path.dirname(sys.modules[cls.__module__].__file__) == os.path.dirname(
            importlib.import_module("laff_tpu.configs").__file__)
        assert not type(ckpt["config"].t2v_bow).__module__.startswith("laff_tpu_torch")

    for step in ((port, laff_tpu) if order == "port_first" else (laff_tpu, port)):
        step()
    port()  # and again after laff_tpu's aliases are in place


def test_root_configs_stay_importable_after_reference_loads(tmp_path, monkeypatch):
    """The port's loads leave the root-level ``configs`` package in place."""
    path = str(tmp_path / "ref.pth.tar")
    write_reference_file(path, monkeypatch)
    load_checkpoint(path)
    assert sys.modules["configs"] is root_configs
    e2e = importlib.import_module("configs.e2e_tiny")
    assert os.path.dirname(e2e.__file__) == os.path.dirname(root_configs.__file__)


def test_load_checkpoint_tells_the_formats_apart(tmp_path, monkeypatch):
    ref_path = str(tmp_path / "ref.pth.tar")
    write_reference_file(ref_path, monkeypatch)
    ref = load_checkpoint(ref_path)
    assert ref["imported_from"] == "reference"
    port_path = str(tmp_path / "port.pth.tar")
    save_checkpoint({"format": "laff_tpu_torch_ckpt_v1", "state_dict": ref["state_dict"],
                     "spec": dataclasses.asdict(ref["spec"]), "config": {"measure": "cosine"},
                     "vocab": ref["vocab"], "opt": {}}, port_path)
    port = load_checkpoint(port_path)
    assert "imported_from" not in port and port["spec"] == ref["spec"]
    for k, v in ref["state_dict"].items():
        assert torch.equal(port["state_dict"][k], v)
    for i, other in enumerate(({"weights": 1}, [1, 2], {"model": {}})):
        path = str(tmp_path / f"other{i}.pt")
        torch.save(other, path)
        with pytest.raises(ValueError, match=f"other{i}.pt"):
            load_checkpoint(path)


def test_unpickler_refuses_what_a_checkpoint_may_not_hold(tmp_path, monkeypatch):
    path = str(tmp_path / "bad.pth.tar")
    torch.save({"model": {}, "config": types.SimpleNamespace(a=1)}, path)
    with pytest.raises(pickle.UnpicklingError, match="types.SimpleNamespace"):
        load_checkpoint(path)
    torch.save({"model": {}, "config": argparse.Namespace(a=os.getcwd)}, path)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        load_checkpoint(path)
    missing = str(tmp_path / "missing.pth.tar")
    write_reference_file(missing, monkeypatch, config_name="not_in_the_port")
    with pytest.raises(ModuleNotFoundError, match="configs.not_in_the_port"):
        load_checkpoint(missing)


def test_unknown_layout_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "ref.pth.tar")
    sd = write_reference_file(path, monkeypatch)
    ckpt = load_checkpoint(path)
    extra = dict(sd, **{"txt_net.encoder.NetVLAD_encoder.centroids": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="unknown layout"):
        convert_state_dict(extra, ckpt["spec"])
    short = {k: v for k, v in sd.items() if "bow_encoder_transform.fc1" not in k}
    with pytest.raises(ValueError, match="no entry"):
        convert_state_dict(short, ckpt["spec"])


# ---------------------------------------------------------------------------
# the predictor and --pretrained_file_path on reference files
# ---------------------------------------------------------------------------

def _predict(root, path, sim, **kw):
    popt = port_predictor.PredictOptions(
        testCollection=VAL, model_path=path, sim_name=sim, rootpath=root,
        query_sets=f"{VAL}.caption.txt", overwrite=1, device="cpu", batch_size=8,
        predict_result_file=os.path.join(root, "result_log", f"{sim}.txt"), **kw)
    return port_predictor.main(popt)[f"{VAL}.caption.txt"]


def _rows_equal(a, b):
    assert tuple(a["t2v"]) == tuple(b["t2v"]) and tuple(a["v2t"]) == tuple(b["v2t"])
    np.testing.assert_array_equal(a["t2v_ranks"], b["t2v_ranks"])


def test_reference_file_predicts_and_warm_starts_as_the_port_file(world, monkeypatch):
    """The same weights as a port checkpoint and as a reference .pth.tar:
    equal prediction rows (the library and the CLI), equal first epochs
    warm-started from each."""
    _port_config(monkeypatch, with_ave=True)
    port_path = os.path.join(world, "init_port.pth.tar")
    ref_path = os.path.join(world, "init_ref.pth.tar")
    save_checkpoint(port_prepare.init_checkpoint("rehearsal", world, TRAIN, seed=3), port_path)
    save_torch_checkpoint(load_checkpoint(port_path), ref_path)
    assert load_checkpoint(ref_path)["spec"] == load_checkpoint(port_path)["spec"]
    native = _predict(world, port_path, "native")
    _rows_equal(_predict(world, ref_path, "reference"), native)
    do_predictor.main([VAL, ref_path, "cli", "--rootpath", world, "--query_sets",
                       f"{VAL}.caption.txt", "--overwrite", "1", "--device", "cpu",
                       "--batch_size", "8", "--predict_result_file",
                       os.path.join(world, "result_log", "cli.txt")])
    ranks = os.path.join(world, VAL, "SimilarityIndex", f"{VAL}.caption.txt", "cli", "t2v.pkl")
    assert os.path.exists(ranks)

    losses = []
    for path in (port_path, ref_path):
        opt = port_prepare.Options(device="cpu", num_epochs=1, pretrained_file_path=path,
                                   model_prefix=f"warm_{len(losses)}", **_base(world))
        losses.append(port_trainer.main(opt)["history"][0])
    assert losses[0]["loss"] == losses[1]["loss"]
    assert {k: losses[0][k] for k in port_trainer.METRICS} == \
        {k: losses[1][k] for k in port_trainer.METRICS}


def test_laff_tpu_exported_file_ranks_as_in_laff_tpu(world, monkeypatch, tmp_path,
                                                    restore_aliases):
    """laff_tpu's seeded model, written by laff_tpu's save_torch_checkpoint
    (its config class and featurizers pickled under laff_tpu's module
    names), through laff_tpu's predictor and the port's: equal rows."""
    _port_config(monkeypatch, with_ave=True)
    monkeypatch.setattr(jax_prepare, "load_config",
                        lambda name: _small(jax_rehearsal.config(), with_ave=True))
    jopt = JOptions(model_prefix="export", **_base(world))
    jprep = jax_prepare.prepare(jopt)
    state = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                   jax_trainer.make_optimizer(jprep.config, jprep.spec), seed=4)
    path = str(tmp_path / "laff_tpu_export.pth.tar")
    jax_save_torch({"params": _host(state.params), "batch_stats": _host(state.batch_stats),
                    "schedule": _host(state.schedule), "spec": jprep.spec,
                    "config": jprep.config, "opt": {"trainCollection": TRAIN}, "epoch": 1},
                   path)
    ckpt = load_checkpoint(path)
    assert type(ckpt["config"]) is port_rehearsal.config
    ref = jax_predict(JPredictOptions(
        testCollection=VAL, model_path=path, sim_name="jax_ref", rootpath=world,
        query_sets=f"{VAL}.caption.txt", overwrite=1, batch_size=8,
        predict_result_file=os.path.join(world, "result_log", "jax_ref.txt")))
    ref = ref[f"{VAL}.caption.txt"]
    got = _predict(world, path, "port_ref")
    np.testing.assert_allclose(got["t2v"], ref["t2v"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["v2t"], ref["v2t"], rtol=0, atol=1e-9)
