"""The whole prediction slice on the CPU: laff_tpu's predictor and the
port's predictor over one laff_tpu.data.synth world, from the same init
(the flax variables carried over by ``from_jax_variables``).

Both rank paths are compared: the flat f32 path (JAX default) and the
fused rank kernel's path (JAX ``LAFF_TPU_RANK_PATH=pallas`` in interpret
mode, the port's ``rank_path='kernel'`` on its plain version). The t2v
and v2t metric tuples must be equal: at this size no two scores lie within
the frameworks' f32 rounding difference (about 1e-6) of each other.
"""

import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from laff_tpu.configs import rehearsal as jax_rehearsal
from laff_tpu.data import TextBatcher as JTextBatcher, TextSource as JTextSource
from laff_tpu.data import VisBatcher as JVisBatcher, VisionSource as JVisionSource
from laff_tpu.data.synth import build_collection, build_w2v
from laff_tpu.engine import predictor as jax_predictor
from laff_tpu.engine.checkpoint import save_checkpoint as jax_save
from laff_tpu.engine.prepare import (_text_precomputed, build_featurizers as jax_featurizers,
                                     build_spec as jax_build_spec)
from laff_tpu.models import LAFFModel as FlaxLAFF
from laff_tpu.store import BigFile, write_bigfile
from laff_tpu_torch.cli.do_predictor import parse_args
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.prepare import build_featurizers, build_spec
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import LAFFModel, spec_to_dict

COLL = "toytest"
QUERY = f"{COLL}.caption.txt"


def _small(config):
    """The rehearsal headline config cut to test widths (same options)."""
    config.vid_feats = ["clip_ft", "x3d"]
    config.vis_fc_layers = ["0", 64]
    config.txt_fc_layers = "0-64"
    config.multi_head_attention = {"dropout": 0.0, "heads": 4, "embed_dim_qkv": 16}
    config.clip_opt = dict(config.clip_opt, size=16)
    config.w2v_dir = "word2vec/toy"
    config.we_dim = 8
    config.rnn_size = 16
    config.threshold = 1
    config.float16 = False
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_world"))
    build_collection(root, COLL, n_videos=24, caps_per_video=3, seed=9,
                     feat_dims=(("clip_ft", 16), ("x3d", 12)))
    build_w2v(root)
    capfile = os.path.join(root, COLL, "TextData", QUERY)
    cap_ids = JTextSource(capfile).cap_ids
    rng = np.random.default_rng(11)
    write_bigfile(os.path.join(root, COLL, "TextData", "clip_synth"), cap_ids,
                  rng.standard_normal((len(cap_ids), 16)).astype(np.float32))

    # laff_tpu: featurizers, spec, init, non-trivial BN stats, checkpoint
    jcfg = _small(jax_rehearsal.config())
    feats, txt_dims, gru_spec, _, _ = jax_featurizers(jcfg, root, COLL, capfile)
    files = {n: BigFile(os.path.join(root, COLL, "FeatureData", n)) for n in jcfg.vid_feats}
    vis_dims = {n: f.ndims for n, f in files.items()}
    jspec = jax_build_spec(jcfg, vis_dims, txt_dims, gru_spec)
    tb = JTextBatcher(JTextSource(capfile, precomputed=_text_precomputed(jcfg, capfile)),
                      dict(feats))
    vb = JVisBatcher(JVisionSource(files, [c.split("#")[0] for c in cap_ids]))
    txt = {k: jax.numpy.asarray(v) for k, v in tb(cap_ids[:2]).items()}
    vis = {k: jax.numpy.asarray(v) for k, v in vb([cap_ids[0].split("#")[0]] * 2).items()}
    variables = FlaxLAFF(jspec).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, txt, vis)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    for tower in stats.values():
        for name, mod in tower.items():
            if "bn1" in mod:
                n = mod["bn1"]["mean"].shape[0]
                mod["bn1"]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                mod["bn1"]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jcfg.t2v_bow, jcfg.t2v_idx = feats.get("bow"), feats.get("rnn")
    jax_ckpt = os.path.join(root, "jax_model.pth.tar")
    jax_save({"params": params, "batch_stats": stats, "schedule": {}, "config": jcfg,
              "opt": {"trainCollection": COLL, "parm_adjust_config": "None"},
              "spec": jspec}, jax_ckpt)

    # the port: its own featurizers/spec from the same collection, weights
    # carried over from the flax variables
    pcfg = _small(port_rehearsal.config())
    pfeats, ptxt_dims, pgru, _, _ = build_featurizers(pcfg, root, COLL, capfile)
    pspec = build_spec(pcfg, vis_dims, ptxt_dims, pgru)
    model = LAFFModel(pspec)
    model.load_state_dict(from_jax_variables(params, stats, {}))
    port_ckpt = os.path.join(root, "port_model.pt")
    save_checkpoint(checkpoint_payload(model.state_dict(), pspec, pcfg, pfeats,
                                       {"config_name": "rehearsal"}), port_ckpt)
    return {"root": root, "jax_ckpt": jax_ckpt, "port_ckpt": port_ckpt,
            "jax_spec": jspec, "port_spec": pspec}


def _run_jax(world, sim_name):
    opt = jax_predictor.PredictOptions(
        testCollection=COLL, model_path=world["jax_ckpt"], sim_name=sim_name,
        rootpath=world["root"], query_sets=QUERY, batch_size=16, overwrite=1,
        predict_result_file=os.path.join(world["root"], "result_log", "jax.txt"))
    return jax_predictor.main(opt)[QUERY]


def _run_port(world, sim_name, rank_path):
    opt = parse_args([COLL, world["port_ckpt"], sim_name, "--rootpath", world["root"],
                      "--query_sets", QUERY, "--batch_size", "16", "--overwrite", "1",
                      "--device", "cpu", "--rank_path", rank_path,
                      "--predict_result_file",
                      os.path.join(world["root"], "result_log", "port.txt")])
    return port_predictor.main(opt)[QUERY]


def _dump(world, sim_name):
    path = os.path.join(world["root"], COLL, "SimilarityIndex", QUERY, sim_name, "t2v.pkl")
    with open(path, "rb") as fh:
        return pickle.load(fh)


def test_port_spec_equals_laff_tpu_spec(world):
    assert spec_to_dict(world["port_spec"]) == dataclasses.asdict(world["jax_spec"])


@pytest.mark.parametrize("rank_path", ["flat", "kernel"])
def test_predictor_metrics_equal_laff_tpu(world, monkeypatch, rank_path):
    if rank_path == "kernel":
        monkeypatch.setenv("LAFF_TPU_RANK_PATH", "pallas")
    jax_res = _run_jax(world, f"jax_{rank_path}")
    port_res = _run_port(world, f"port_{rank_path}", rank_path)
    assert port_res["t2v"] == pytest.approx(jax_res["t2v"], rel=0, abs=0)
    assert port_res["v2t"] == pytest.approx(jax_res["v2t"], rel=0, abs=0)
    assert port_res["t2v_ranks"].shape == (72,)
    # the top-500 dump ranks the same videos for every query
    jd, pd = _dump(world, f"jax_{rank_path}"), _dump(world, f"port_{rank_path}")
    assert set(jd) == set(pd)
    for tid in jd:
        assert pd[tid]["rank_list"] == jd[tid]["rank_list"], tid
        assert pd[tid]["query"] == jd[tid]["query"]
        np.testing.assert_allclose(pd[tid]["sim_value"], jd[tid]["sim_value"],
                                   rtol=1e-5, atol=1e-5)


def test_predictor_writes_result_rows(world):
    _run_port(world, "port_rows", "auto")
    for direction in ("TextToVideo", "VideoToText"):
        path = os.path.join(world["root"], "result_log", direction, "port.txt")
        row = open(path).read().strip().split("\n")[-1].split("\t")
        assert len(row) >= 9


def test_predictor_needs_a_card_unless_told_cpu(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = parse_args([COLL, world["port_ckpt"], "x", "--rootpath", world["root"],
                      "--query_sets", QUERY])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_predictor.main(opt)


@pytest.mark.parametrize("name", ["base_config", "laff", "rehearsal"])
def test_port_configs_equal_laff_tpu_configs(name):
    import importlib

    from laff_tpu_torch.engine.checkpoint import config_to_dict

    ours = config_to_dict(importlib.import_module(f"laff_tpu_torch.configs.{name}").config())
    ref = config_to_dict(importlib.import_module(f"laff_tpu.configs.{name}").config())
    assert ours == ref


def test_load_config_applies_the_headline_sweep_string_without_leaking():
    from laff_tpu_torch.engine.prepare import load_config

    cfg = load_config("laff", "0_12_0_12_0_0_1")
    assert cfg.vid_feats == ["clip_finetune_8frame_uniform_1103",
                             "HowTo100M_TimeSformer_divST_96x4_224", "X3D_L",
                             "mean_irCSN_152_ig65m_from_scratch"]
    assert cfg.txt_attention == cfg.vis_attention == "Multi_head_MyApply_Attention"
    assert cfg.text_encoding["CLIP_encoding"]["name"] == "ViT-B/32"
    assert cfg.attention_param_each_head == {"with_ave": False, "mul": False,
                                             "split_head": True}
    assert load_config("laff").text_encoding["CLIP_encoding"]["name"] == "noCLIP"
