"""FrameLAFF in the port on the CPU, held against laff_tpu on the same
seeded inputs and the same weights (flax variables carried over by
``from_jax_variables``).

* the single-head ``GateAttention``, kinds 0, 1, 7 and 9, with and without
  a validity mask (one row fully masked: a video without frames), f32 to
  1e-5;
* the FrameLAFF video tower: frame fc on and off, ``frame_feat_with_video_feat``
  on and off, a multi-head frame gate, bf16 towers; f32 to 1e-5, bf16 to
  4e-2 absolute (test_torch_port_models.py's bf16 ulps); padded frame
  values do not move the output, and a video without frames gives
  laff_tpu's embedding, finite;
* ``gather_frames`` and the cached frame rows against laff_tpu's;
* the port's FrameLaff config under the headline sweep string against
  laff_tpu's;
* ``trainer.main`` on a FrameLAFF world (laff_tpu's ``tiny.config_frame``
  settings, dropout off) against ``laff_tpu.engine.trainer.main``: each
  epoch's loss within 1e-4 relative and equal metrics; then the
  predictor's metric rows on the best checkpoints, equal.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.configs import tiny as jax_tiny
from laff_tpu.data import VisBatcher as JVisBatcher
from laff_tpu.data import VisionSource as JVisionSource
from laff_tpu.data.synth import build_collection, build_w2v
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import feature_cache as jax_cache
from laff_tpu.engine import predictor as jax_predictor
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.models.attention import GateAttention as FlaxGateAttention
from laff_tpu.models.laff import LAFFModel as FlaxLAFF
from laff_tpu.models.spec import AttentionSpec, LAFFSpec, TowerSpec
from laff_tpu.store import BigFile as JBigFile
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.data import VisBatcher, VisionSource
from laff_tpu_torch.engine import feature_cache as port_cache
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import (checkpoint_payload, config_to_dict,
                                              load_checkpoint, save_checkpoint)
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import LAFFModel
from laff_tpu_torch.models import spec as port_spec
from laff_tpu_torch.models.attention import GateAttention, get_attention_layer
from laff_tpu_torch.store import BigFile

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=4e-2)
EPOCH_LOSS_RTOL = 1e-4
GATE_KINDS = {0: "attention_noAverageMul_Ave", 1: "average_AverageMul_noAve",
              7: "attention_noAveNoAverageMul", 9: "attention_averageMul"}
TRAIN, VAL = "frametrain", "frameval"


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), jax.device_get(tree))


def _frames(rng, b=6, t=5, d=16):
    """(B, T, D) frames right-padded with zeros and their (B, T) mask; row 1
    has no frame at all, row 0 every frame."""
    counts = np.array([t, 0] + list(rng.integers(1, t + 1, b - 2)))
    mask = (np.arange(t)[None, :] < counts[:, None]).astype(np.float32)
    frames = rng.standard_normal((b, t, d)).astype(np.float32) * mask[:, :, None]
    return frames, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", sorted(GATE_KINDS))
def test_gate_attention_matches_flax(kind, masked):
    rng = np.random.default_rng(kind)
    x, mask = _frames(rng)
    if not masked:
        x, mask = rng.standard_normal(x.shape).astype(np.float32), None
    with_ave, mul = kind in (0, 9), kind in (1, 9)
    flax_gate = FlaxGateAttention(with_ave=with_ave, mul=mul)
    jmask = None if mask is None else jnp.asarray(mask)
    variables = _np_tree(flax_gate.init(jax.random.key(kind), jnp.asarray(x), mask=jmask))
    if with_ave:
        variables["schedule"]["global_emb_weight"] = np.float32(0.6)
    ref = np.asarray(flax_gate.apply(variables, jnp.asarray(x), mask=jmask))

    ours = get_attention_layer(GATE_KINDS[kind], 16, port_spec.AttentionSpec())
    assert isinstance(ours, GateAttention) and (ours.with_ave, ours.mul) == (with_ave, mul)
    ours.load_state_dict(from_jax_variables(variables["params"], None,
                                            variables.get("schedule")))
    with torch.no_grad():
        out = ours(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def _frame_spec(frame_fc, with_video, frame_kind, bf16):
    gate = AttentionSpec(kind="Multi_head_MyApply_Attention", heads=4, with_ave=False)
    frame_attn = AttentionSpec(kind=frame_kind, heads=4, with_ave=True, mul=False)
    dtype = "bfloat16" if bf16 else "float32"
    txt = TowerSpec(features=(("w2v", 8),), common_dim=32, attention=gate, batch_norm=True,
                    compute_dtype=dtype)
    vis = TowerSpec(features=(("c3d", 12), ("x3d", 20)), common_dim=32, attention=gate,
                    no_transform=() if frame_fc else ("frames",), batch_norm=True,
                    frame_features=(("frames", 16),), frame_attention=frame_attn,
                    frame_add_fc=frame_fc, frame_feat_with_video_feat=with_video,
                    compute_dtype=dtype)
    return LAFFSpec(txt=txt, vis=vis)


@pytest.mark.parametrize("frame_fc,with_video,frame_kind,bf16", [
    (False, True, "attention_noAveNoAverageMul", False),  # the headline's shape
    (True, False, "attention_averageMul", False),
    (True, True, "Multi_head_MyApply_Attention", False),
    (False, True, "attention_noAveNoAverageMul", True),
    (True, True, "attention_noAverageMul_Ave", True),
])
def test_frame_towers_match_flax(frame_fc, with_video, frame_kind, bf16):
    rng = np.random.default_rng(3)
    spec = _frame_spec(frame_fc, with_video, frame_kind, bf16)
    frames, mask = _frames(rng)
    vis = {"c3d": rng.standard_normal((6, 12)).astype(np.float32),
           "x3d": rng.standard_normal((6, 20)).astype(np.float32),
           "frames@frames": frames, "frames@mask": mask}
    if bf16:  # what the feed's host cast hands a bf16 tower, masks included
        vis = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in vis.items()}
    jvis = {k: jnp.asarray(v) for k, v in vis.items()}
    jtxt = {"w2v": jnp.zeros((6, 8))}
    flax_model = FlaxLAFF(spec)
    variables = _np_tree(flax_model.init({"params": jax.random.key(1),
                                          "dropout": jax.random.key(2)}, jtxt, jvis))
    schedule = variables.get("schedule", {})
    for name, module in schedule.get("vis_net", {}).items():
        module["global_emb_weight"] = np.float32(0.7)
    ref = np.asarray(flax_model.apply(variables, jvis, method=flax_model.encode_vis))

    ours = LAFFModel(port_spec.spec_from_dict(dataclasses.asdict(spec)))
    ours.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                            schedule))
    ours.eval()
    tvis = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if bf16 else torch.float32) for k, v in vis.items()}
    with torch.no_grad():
        out = ours.encode_vis(tvis)
        # junk in the padded frame slots moves nothing (a video without
        # frames pools its zero padding, as laff_tpu's does: no junk there)
        pad = (1 - tvis["frames@mask"]) * tvis["frames@mask"].amax(dim=1, keepdim=True)
        junk = dict(tvis, **{"frames@frames": tvis["frames@frames"] + 5.0 * pad[:, :, None]})
        assert torch.equal(ours.encode_vis(junk), out)
    assert out.shape == (6, 4, 8) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **(BF16_TOL if bf16 else F32_TOL))
    n_locals = 3 if with_video else 1
    assert len(ours.vis_net.features) == n_locals


# ---------------------------------------------------------------------------
# a FrameLAFF world: sources, caches, config, trainer, predictor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frame_world"))
    for coll, n_videos, caps, seed in ((TRAIN, 32, 2, 0), (VAL, 16, 1, 5)):
        build_collection(root, coll, n_videos=n_videos, caps_per_video=caps, seed=seed,
                         frame_feat=True, max_frames=6)
    build_w2v(root)
    return root


def _sources(world, max_frame):
    path = os.path.join(world, TRAIN, "FeatureData")
    vids = [f"video{i}" for i in range(32)]
    jsrc = JVisionSource({"x3d": JBigFile(os.path.join(path, "x3d"))}, vids,
                         {"clip_frames": JBigFile(os.path.join(path, "frame", "clip_frames"))},
                         max_frame=max_frame)
    psrc = VisionSource({"x3d": BigFile(os.path.join(path, "x3d"))}, vids,
                        {"clip_frames": BigFile(os.path.join(path, "frame", "clip_frames"))},
                        max_frame=max_frame)
    return jsrc, psrc


@pytest.mark.parametrize("max_frame", [4, 8])  # cuts the 2-6 frames / pads them all
def test_gather_frames_and_cached_rows_equal_laff_tpu(world, max_frame):
    jsrc, psrc = _sources(world, max_frame)
    ids = ["video3", "absent", "video0", "video17"]
    ref, got = jsrc.gather_frames(ids), psrc.gather_frames(ids)
    assert set(got) == set(ref) == {"clip_frames@frames", "clip_frames@mask"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])
    assert not got["clip_frames@mask"][1].any() and not got["clip_frames@frames"][1].any()
    assert got["clip_frames@frames"].shape == (4, max_frame, 16)

    jb, pb = JVisBatcher(jsrc, with_frames=True), VisBatcher(psrc)
    jcache = jax_cache.DeviceVisCache(jb, bf16=True, chunk=10)
    pcache = port_cache.DeviceVisCache(pb, torch.device("cpu"), bf16=True, chunk=10)
    assert set(pcache.arrays) == set(jcache.arrays)
    for k, v in jcache.arrays.items():
        np.testing.assert_array_equal(pcache.arrays[k].float().numpy(),
                                      np.asarray(v, np.float32))
    assert pcache.nbytes == jcache.nbytes == port_cache.estimate_vis_cache_bytes(pb, bf16=True)
    fed = port_trainer.host_tensors(pb(ids[2:] + ["video5"]), pin=False, bf16=True)
    rows = pcache.gather(pcache.indices(ids[2:] + ["video5"]))
    for k, v in fed.items():
        assert rows[k].dtype == v.dtype and torch.equal(rows[k], v), k


def test_frame_config_sweep_equals_laff_tpu():
    from laff_tpu.engine.prepare import load_config as jax_load_config

    parm = "0_7_1_12_0_12_0"
    ours = port_prepare.load_config("FrameLaff_NoFrameFc_StrongCLIP_adjust", parm)
    ref = jax_load_config("FrameLaff_NoFrameFc_StrongCLIP_adjust")
    ref.adjust_parm(parm)
    assert config_to_dict(ours) == config_to_dict(ref)
    assert ours.vis_frame_attention == "attention_noAveNoAverageMul"
    assert ours.vid_frame_feats == ours.vis_no_transform == [
        "Frame_clip_finetune_8frame_uniform_1103"]
    # the full-width rehearsal of it differs only in the world's names
    rehearsal = port_prepare.load_config("frame_rehearsal")
    for name in ("vis_frame_attention", "vis_attention", "txt_attention", "max_frame",
                 "frame_feat_input", "frame_feat_with_video_feat", "vis_frame_addFC",
                 "attention_param_each_head", "float16", "dropout", "batch_norm",
                 "vis_fc_layers", "txt_fc_layers", "multi_head_attention"):
        assert getattr(rehearsal, name) == getattr(ours, name), name
    assert [e["name"] for e in rehearsal.text_encoding.values()] == [
        e["name"] for e in ours.text_encoding.values()]


def _tiny_frame(config):
    """``config`` with every plain attribute of laff_tpu's tiny.config_frame,
    dropout off."""
    for name, value in config_to_dict(jax_tiny.config_frame()).items():
        setattr(config, name, value)
    config.dropout = 0.0
    return config


def test_frame_trainer_and_predictor_match_laff_tpu(world, monkeypatch, tmp_path):
    """Two epochs of laff_tpu.engine.trainer.main and the port's main from
    the same init on the FrameLAFF world; then both predictors on the best
    checkpoints, scoring the validation collection."""
    monkeypatch.setattr(jax_prepare, "load_config",
                        lambda name: _tiny_frame(jax_tiny.config_frame()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _tiny_frame(port_rehearsal.config()))
    base = dict(trainCollection=TRAIN, valCollection=VAL, rootpath=world, val_set="no",
                config_name="tiny", batch_size=16, num_epochs=2)
    jopt = JOptions(model_prefix="jax", **base)
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    jres = jax_trainer.main(jopt, prepared=jprep)

    popt = port_prepare.Options(model_prefix="port", device="cpu", **base)
    pprep = port_prepare.prepare(popt)
    assert port_spec.spec_to_dict(pprep.spec) == dataclasses.asdict(jprep.spec)
    assert pprep.spec.vis.frame_features == (("clip_frames", 16),)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), init_path)
    popt.pretrained_file_path = init_path
    pres = port_trainer.main(popt, prepared=pprep)
    assert pres["dispatch"]["vis_cache_bytes"]  # the frames ride the cache
    assert len(jres["history"]) == len(pres["history"]) == 2
    for je, pe in zip(jres["history"], pres["history"]):
        assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL)
        for k in port_trainer.METRICS:
            assert pe[k] == je[k], (k, pe, je)

    rows = {}
    for name, module, path in (("jax", jax_predictor, jres["model_path"]),
                               ("port", port_predictor, pres["model_path"])):
        kw = dict(testCollection=VAL, model_path=os.path.join(path, "model_best.pth.tar"),
                  sim_name=f"frames_{name}", rootpath=world, query_sets=f"{VAL}.caption.txt",
                  batch_size=16, overwrite=1,
                  predict_result_file=os.path.join(world, "result_log", f"{name}.txt"))
        if name == "port":
            kw["device"] = "cpu"
        rows[name] = module.main(module.PredictOptions(**kw))[f"{VAL}.caption.txt"]
    assert rows["port"]["t2v"] == pytest.approx(rows["jax"]["t2v"], rel=0, abs=0)
    assert rows["port"]["v2t"] == pytest.approx(rows["jax"]["v2t"], rel=0, abs=0)
    ck = load_checkpoint(os.path.join(pres["model_path"], "model_best.pth.tar"))
    assert rows["port"]["t2v"][5] == pytest.approx(ck["best_perf"], rel=0, abs=1e-12)
