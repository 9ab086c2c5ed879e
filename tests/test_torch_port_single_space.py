"""The single-space training paths end to end on the CPU, held against
laff_tpu: two epochs of ``laff_tpu.engine.trainer.main`` and of the port's
``main`` from the same init (the flax variables carried by
``from_jax_variables``), dropout off, then both packages' predictors on
their best checkpoints:

* W2VVPP: 'concat' fusion on both towers, the towers tied by
  ``txt_fc_same_with_vis_fc`` (the '__concat__' tie: one linear for both
  concatenations), single-space (B, D) embeddings;
* the 'hist' measure (generalized Jaccard) in the LAFF-ml loss, the
  validation ranks and the prediction scores.

Epoch losses within 1e-4 relative, learning rates and metrics equal, the
prediction rows (t2v and v2t) equal.
"""

import importlib
import os

import jax
import numpy as np
import pytest

from laff_tpu.configs import rehearsal as jax_rehearsal
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.predictor import PredictOptions as JPredictOptions
from laff_tpu.engine.predictor import main as jax_predict
from laff_tpu.store import write_bigfile
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.weights import from_jax_variables
from test_torch_port_trainer import TRAIN, VAL, _base, _small, world  # noqa: F401

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

EPOCH_LOSS_RTOL = 1e-4


def _concat_tied(config):
    """W2VVPP over the small rehearsal features plus 'filler', whose width
    makes the video concatenation as wide as the text one (the '__concat__'
    tie needs both)."""
    config = _small(config)
    config.model_name = "W2VVPP"
    config.txt_attention = config.vis_attention = "concat"
    config.txt_fc_same_with_vis_fc = True
    config.txt_fc_same_with_vis_fc_dict = {}
    config.vid_feats = ["clip_ft", "x3d", "filler"]
    return config


def _hist(config):
    config = _small(config, with_ave=True)
    config.measure = "hist"
    return config


VARIANTS = {"concat_tied": _concat_tied, "hist": _hist}


@pytest.fixture(scope="module")
def filler_world(world):
    """The trainer tests' world with a 'filler' video feature as wide as the
    text concatenation minus clip_ft and x3d."""
    config = _concat_tied(port_rehearsal.config())
    capfile = os.path.join(world, TRAIN, "TextData", f"{TRAIN}.caption.txt")
    txt_dims = port_prepare.build_featurizers(config, world, TRAIN, capfile)[1]
    width = sum(txt_dims.values()) - 16 - 12
    for seed, coll in enumerate((TRAIN, VAL)):
        with open(os.path.join(world, coll, "VideoSets", f"{coll}.txt")) as fh:
            vids = fh.read().split()
        rows = np.random.default_rng(seed + 20).standard_normal((len(vids), width))
        write_bigfile(os.path.join(world, coll, "FeatureData", "filler"), vids,
                      rows.astype(np.float32))
    return world


def _predict_rows(world, variant, jres, pres):
    query = f"{VAL}.caption.txt"
    common = dict(testCollection=VAL, rootpath=world, query_sets=query, overwrite=1,
                  batch_size=8)
    ref = jax_predict(JPredictOptions(
        model_path=os.path.join(jres["model_path"], "model_best.pth.tar"),
        sim_name=f"jax_{variant}", **common,
        predict_result_file=os.path.join(world, "result_log", f"jax_{variant}.txt")))[query]
    got = port_predictor.main(port_predictor.PredictOptions(
        model_path=os.path.join(pres["model_path"], "model_best.pth.tar"),
        sim_name=f"port_{variant}", device="cpu", **common,
        predict_result_file=os.path.join(world, "result_log", f"port_{variant}.txt")))[query]
    return ref, got


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_single_space_trainer_matches_laff_tpu(filler_world, monkeypatch, tmp_path, variant):
    world = filler_world
    make = VARIANTS[variant]
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: make(jax_rehearsal.config()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": make(port_rehearsal.config()))
    base = _base(world, num_epochs=2)
    jopt = JOptions(model_prefix=f"jax_{variant}", **base)
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    jres = jax_trainer.main(jopt, prepared=jprep)

    popt = port_prepare.Options(model_prefix=f"port_{variant}", device="cpu", **base)
    pprep = port_prepare.prepare(popt)
    assert pprep.spec.tied_transforms == jprep.spec.tied_transforms == (
        (("__concat__", "__concat__"),) if variant == "concat_tied" else ())
    assert pprep.spec.measure == jprep.spec.measure == (
        "hist" if variant == "hist" else "cosine")
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), init_path)
    popt.pretrained_file_path = init_path
    pres = port_trainer.main(popt, prepared=pprep)

    assert len(jres["history"]) == len(pres["history"]) == 2
    for je, pe in zip(jres["history"], pres["history"]):
        assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL)
        assert pe["lr"] == je["lr"]
        for k in port_trainer.METRICS:
            assert pe[k] == je[k], (k, pe, je)
    assert pres["best_perf"] == jres["best_perf"]

    ref, got = _predict_rows(world, variant, jres, pres)
    assert tuple(got["t2v"]) == tuple(ref["t2v"])
    assert tuple(got["v2t"]) == tuple(ref["v2t"])
