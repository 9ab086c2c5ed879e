"""task2, the concept-space heads, on the CPU, held against laff_tpu.

* ``prepare`` with ``--task2_intended 1``: the same ``Task2Spec``, the
  same per-video multi-hot labels in ``VisBatcher``'s batches (a zero row
  for a video without an object caption), the checks on
  ``txt_feature_task2``, and ``--task2_caption`` alone inert, with
  laff_tpu's warning;
* ``_task2_loss`` for the 'hist' and the cosine measure, with and without a
  text head: value and gradients within 1e-6 relative to the largest
  magnitude;
* ``LAFFModel.forward_with_concepts`` and ``encode_concepts`` under
  weights carried from flax (dense and sparse bow, dropout off): the
  embeddings and logits in eval mode, and the logits and the heads'
  BatchNorm statistics after a training forward, within 1e-5;
* the first train step from the same init on the same batch: the loss
  within 1e-6 relative and the gradients within 1e-4 of the largest
  magnitude, against ``laff_tpu`` with flax's BatchNorm on its two-pass
  variance. Flax's default, E[x^2] - E[x]^2 in f32, loses about 2e-5 of
  the first step's loss on this world's saturated tanh rows, where the
  port's and the two-pass reference's losses lie within 2e-7 of a float64
  forward;
* ``laff_tpu.engine.trainer.main`` against the port's ``main`` with
  ``--task2_intended 1`` from the same init (dropout off, two epochs): each
  epoch's loss within 1e-4 relative (the bound the trainer, frames and
  single-space files hold an epoch's loss to: the first step's 2e-5 above
  carries through Adam's updates) and the metrics equal, both caches on
  and K = min(8, steps an epoch), as laff_tpu's dispatch takes them;
* a task2 checkpoint exported to the reference layout: its retrieval
  towers in full, the heads left out with a warning.

The world is laff_tpu's small synthetic collection with an object-caption
file keyed by video id, as in ``tests/test_task2.py``, built once per
module.
"""

import dataclasses
import importlib
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.configs import tiny as jax_tiny
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.models import LAFFModel as FlaxLAFF
from laff_tpu.models.spec import Task2Spec
from laff_tpu_torch.configs import tiny as port_tiny
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import torch_export
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import LAFFModel

from helpers import build_collection, build_w2v

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

TRAIN, VAL = "toytrain", "toyval"
LOSS_RTOL = 1e-6
EMB_ATOL = 1e-5
EPOCH_LOSS_RTOL = 1e-4  # an epoch's mean loss after the steps before it
GRAD_RTOL = 1e-4  # a full model's gradients over the largest magnitude


def _tiny(config):
    config.dropout = 0.0
    config.dropout_task2 = 0.0
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("task2_world"))
    build_collection(root, TRAIN, n_videos=24, caps_per_video=2, seed=0)
    build_collection(root, VAL, n_videos=12, caps_per_video=1, seed=5)
    build_w2v(root)
    objects = {}
    with open(os.path.join(root, TRAIN, "TextData", f"{TRAIN}.caption.txt")) as fh:
        for line in fh:
            cap_id, caption = line.strip().split(" ", 1)
            objects.setdefault(cap_id.split("#")[0], " ".join(caption.split()[1:]))
    del objects["video3"]  # a video without an object caption
    with open(os.path.join(root, TRAIN, "TextData", f"{TRAIN}.caption.obj.txt"), "w") as fh:
        fh.write("\n".join(f"{v} {w}" for v, w in objects.items()))
    return root


def _opts(root, **kw):
    return dict(trainCollection=TRAIN, valCollection=VAL, rootpath=root, val_set="no",
                config_name="tiny", batch_size=12, task2_caption="obj", **kw)


@pytest.fixture
def tiny_configs(monkeypatch):
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: _tiny(jax_tiny.config()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _tiny(port_tiny.config()))


def _capture(monkeypatch, logger, caplog):
    """The port's loggers do not propagate: hand ``caplog`` the records of
    one of them for the test."""
    monkeypatch.setattr(logger, "handlers", [*logger.handlers, caplog.handler])


def test_task2_prepare_equals_laff_tpu(world, tiny_configs):
    jprep = jax_prepare.prepare(JOptions(model_prefix="prep_j", task2_intended=1,
                                         **_opts(world)))
    pprep = port_prepare.prepare(port_prepare.Options(model_prefix="prep_p", device="cpu",
                                                      task2_intended=1, **_opts(world)))
    assert dataclasses.asdict(pprep.spec.task2) == dataclasses.asdict(jprep.spec.task2)
    assert pprep.spec.task2.n_concepts > 0
    vids = pprep.train_feed.vis_batcher.source.vis_ids
    got = pprep.train_feed.vis_batcher(vids)["task2_labels"]
    np.testing.assert_array_equal(got, jprep.train_feed.vis_batcher(vids)["task2_labels"])
    assert not got[vids.index("video3")].any() and got.sum(axis=1).min() == 0
    batch = next(iter(pprep.train_feed.epoch(0)))
    assert batch["vis"]["task2_labels"].shape == (12, pprep.spec.task2.n_concepts)


def test_task2_caption_alone_is_inert(world, tiny_configs, monkeypatch, caplog):
    _capture(monkeypatch, port_prepare.logger, caplog)
    pprep = port_prepare.prepare(port_prepare.Options(model_prefix="inert", device="cpu",
                                                      **_opts(world)))
    assert pprep.spec.task2 is None
    assert pprep.train_feed.vis_batcher.task2_labels is None
    assert any("INERT" in r.message for r in caplog.records)


@pytest.mark.parametrize("feature,error", [("w2v_missing", ValueError),
                                           ("gru", NotImplementedError)])
def test_task2_text_feature_checks(world, monkeypatch, feature, error):
    def config(name, parm="None"):
        cfg = _tiny(port_tiny.config())
        if feature == "w2v_missing":
            cfg.txt_feature_task2 = "w2v"
            cfg.text_encoding = dict(cfg.text_encoding, w2v_encoding={"name": "now2v"})
        else:
            cfg.txt_feature_task2 = "gru"
        return cfg

    monkeypatch.setattr(port_prepare, "load_config", config)
    opt = port_prepare.Options(model_prefix="bad", device="cpu", task2_intended=1,
                               **_opts(world))
    with pytest.raises(error, match="txt_feature_task2"):
        port_prepare.prepare(opt)


def _close(port, ref, rtol=LOSS_RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(port - ref).max() <= rtol * scale, (port, ref)


@pytest.mark.parametrize("with_txt", [True, False])
@pytest.mark.parametrize("measure", ["hist", "cosine"])
def test_task2_loss_matches_laff_tpu(measure, with_txt):
    rng = np.random.default_rng(0)
    tl, vl = (rng.normal(size=(6, 9)).astype(np.float32) * 2 for _ in range(2))
    labels = (rng.uniform(size=(6, 9)) > 0.5).astype(np.float32)
    spec = Task2Spec(n_concepts=9, vis_dim_in=8, txt_dim_in=8, alpha=0.3, measure=measure)
    pt, pv = torch.tensor(tl, requires_grad=True), torch.tensor(vl, requires_grad=True)
    value = port_trainer._task2_loss(pt if with_txt else None, pv, torch.tensor(labels), spec)
    value.backward()

    def ref(t, v):
        return jax_trainer._task2_loss(t if with_txt else None, v, jnp.asarray(labels), spec)

    want, (gt, gv) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(tl), jnp.asarray(vl))
    _close(value.detach().numpy(), want)
    _close(pv.grad.numpy(), gv)
    _close(np.zeros_like(tl) if pt.grad is None else pt.grad.numpy(), gt)


@pytest.mark.parametrize("indexed_bow", [False, True])
def test_forward_with_concepts_matches_flax(world, tiny_configs, indexed_bow):
    prep = port_prepare.prepare(port_prepare.Options(
        model_prefix="fwc", device="cpu", task2_intended=1,
        device_text_featurize=int(indexed_bow), **_opts(world)))
    spec = prep.spec
    batch = next(iter(prep.train_feed.epoch(0)))
    txt = {k: v for k, v in batch["txt"].items() if not k.startswith("w2v_")}
    if "w2v_ids" in batch["txt"]:  # the pooled w2v mean, as the step feeds it
        table = prep.w2v_table
        txt["w2v"] = (table[batch["txt"]["w2v_ids"]].sum(axis=1)
                      / batch["txt"]["w2v_len"][:, None]).astype(np.float32)
    vis = {k: v for k, v in batch["vis"].items() if k != "task2_labels"}
    flax = FlaxLAFF(spec)
    jt = {k: jnp.asarray(v) for k, v in txt.items()}
    jv = {k: jnp.asarray(v) for k, v in vis.items()}
    variables = flax.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, jt, jv,
                          method=flax.forward_with_concepts)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    model = LAFFModel(spec)
    model.load_state_dict(from_jax_variables(host(variables["params"]),
                                             host(variables["batch_stats"])))
    pt = {k: torch.from_numpy(v) for k, v in txt.items()}
    pv = {k: torch.from_numpy(v) for k, v in vis.items()}
    out = flax.apply(variables, jt, jv, method=flax.forward_with_concepts)
    got = model.eval().forward_with_concepts(pt, pv)
    for a, b in zip(got, out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=EMB_ATOL)
    # training mode: the heads' logits (the towers' BatchNorm on tanh rows
    # that saturate in this world magnifies f32 rounding past 1e-5; the
    # trainer test holds their losses) and the heads' running statistics
    out, upd = flax.apply(variables, jt, jv, train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.key(2)},
                          method=flax.forward_with_concepts)
    got = model.train().forward_with_concepts(pt, pv)
    for a, b in zip(got[2:], out[2:]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=EMB_ATOL)
    stats = from_jax_variables(host(variables["params"]), host(upd["batch_stats"]))
    for k, v in model.state_dict().items():
        if k.startswith("task2_") and "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), atol=EMB_ATOL, err_msg=k)
    txt_logits, vis_logits = model.eval().encode_concepts(None, pv)
    assert txt_logits is None and vis_logits.shape == (12, spec.task2.n_concepts)


class _TwoPassBatchNorm(flax.linen.BatchNorm):
    use_fast_variance: bool = False


def test_task2_first_step_matches_laff_tpu(world, tiny_configs, monkeypatch):
    kw = _opts(world, task2_intended=1)
    jprep = jax_prepare.prepare(JOptions(model_prefix="t2_first_j", **kw))
    pprep = port_prepare.prepare(port_prepare.Options(model_prefix="t2_first_p", device="cpu",
                                                      **kw))
    spec = jprep.spec
    flax_model = jax_trainer.LAFFModel(spec)
    init = jax_trainer.init_state(flax_model, spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, spec), seed=2)
    batch = next(iter(pprep.train_feed.epoch(0)))
    txt = {k: v for k, v in batch["txt"].items() if not k.startswith("w2v_")}
    if "w2v_ids" in batch["txt"]:
        txt["w2v"] = (pprep.w2v_table[batch["txt"]["w2v_ids"]].sum(axis=1)
                      / batch["txt"]["w2v_len"][:, None]).astype(np.float32)
    vis = {k: v for k, v in batch["vis"].items() if k != "task2_labels"}
    labels = batch["vis"]["task2_labels"]
    loss_fn = jax_trainer.make_loss_fn(spec)

    def jax_loss(params):
        variables = {"params": params, "batch_stats": init.batch_stats}
        if init.schedule:
            variables["schedule"] = init.schedule
        (te, ve, tc, vc), _ = flax_model.apply(
            variables, {k: jnp.asarray(v) for k, v in txt.items()},
            {k: jnp.asarray(v) for k, v in vis.items()}, train=True,
            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"],
            method=flax_model.forward_with_concepts)
        return loss_fn(te, ve) + jax_trainer._task2_loss(tc, vc, jnp.asarray(labels), spec.task2)

    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    want, grads = jax.value_and_grad(jax_loss)(init.params)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    model = port_prepare.seeded_model(pprep.spec, 2, pprep.we)
    model.load_state_dict(from_jax_variables(host(init.params), host(init.batch_stats),
                                             host(init.schedule)))
    step = port_trainer.TrainStep(model, None, pprep.spec)
    got = step.loss({k: torch.from_numpy(v) for k, v in txt.items()},
                    {**{k: torch.from_numpy(v) for k, v in vis.items()},
                     "task2_labels": torch.from_numpy(labels)})
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    ref = from_jax_variables(host(grads), host(init.batch_stats), host(init.schedule))
    named = dict(model.named_parameters())
    scale = max(float(np.abs(ref[k].numpy()).max()) for k in named)
    for k, p in named.items():
        diff = np.abs(p.grad.numpy() - ref[k].numpy()).max()
        assert diff <= GRAD_RTOL * scale, (k, diff, scale)


def test_task2_trainer_matches_laff_tpu(world, tiny_configs, tmp_path):
    kw = _opts(world, task2_intended=1)
    jopt = JOptions(model_prefix="t2_j", num_epochs=2, **kw)
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    jres = jax_trainer.main(jopt, prepared=jprep)
    popt = port_prepare.Options(model_prefix="t2_p", num_epochs=2, device="cpu", **kw)
    pprep = port_prepare.prepare(popt)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), init_path)
    popt.pretrained_file_path = init_path
    pres = port_trainer.main(popt, prepared=pprep)
    chose = pres["dispatch"]
    assert chose["vis_cache_bytes"] and chose["txt_cache_bytes"]
    assert chose["steps_per_dispatch"] == 4  # min(8, steps an epoch)
    for je, pe in zip(jres["history"], pres["history"]):
        assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL)
        for k in port_trainer.METRICS:
            assert pe[k] == je[k], (k, pe, je)
    assert len(pres["history"]) == 2


def test_task2_checkpoint_exports_its_towers_and_warns(world, tiny_configs, monkeypatch,
                                                      caplog):
    prep = port_prepare.prepare(port_prepare.Options(model_prefix="exp", device="cpu",
                                                     task2_intended=1, **_opts(world)))
    model = port_prepare.seeded_model(prep.spec, 0)
    sd = model.state_dict()
    assert any(k.startswith("task2_txt_head.") for k in sd)
    _capture(monkeypatch, torch_export.logger, caplog)
    exported = torch_export.export_state_dict({"state_dict": sd, "spec": prep.spec})
    assert any("NOT exported" in r.message for r in caplog.records)
    assert not any("task2" in k for k in exported)
    plain = dataclasses.replace(prep.spec, task2=None)
    ref = torch_export.export_state_dict(
        {"state_dict": {k: v for k, v in sd.items() if not k.startswith("task2_")},
         "spec": plain})
    assert exported.keys() == ref.keys()
