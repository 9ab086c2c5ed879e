"""The plain reference agrees with the port (``laff_tpu_torch``) on the CPU
at a small size, in float32: both towers' eval forward, the training
forward's loss under the same generator, one optimizer update, and the
ground-truth ranks. The port is imported here only to be compared with."""

from __future__ import annotations

import pytest
import torch
from conftest import TINY_VOCAB, caption_words, shrink_port, tiny_config

from portbench import program, world
from portbench.reference.model import ReferenceModel, flat_embeddings, triplet_multi_space
from portbench.reference.rank import ranks_from_scores, scores
from portbench.reference.train import train_steps
from portbench.weights import make_weights

COLL = "tiny"


@pytest.fixture(params=[False, True], ids=["laffml", "framelaff"])
def setup(request, monkeypatch, tmp_path):
    from laff_tpu_torch.engine.prepare import prepare
    from laff_tpu_torch.models.laff import LAFFModel

    torch.manual_seed(0)
    cfg = tiny_config(frames=request.param)
    shrink_port(monkeypatch, cfg)
    world.build_world(str(tmp_path), COLL, 24, 6, caption_words(), n_vocab=TINY_VOCAB,
                      seed=3, frame_feat=request.param)
    text, video = program.reference_inputs(cfg, str(tmp_path), COLL)
    opt = program.options(cfg, {"collection": COLL}, str(tmp_path), 9, torch.device("cpu"),
                          batch_size=8)
    prepared = prepare(opt)
    program.check_spec(prepared.spec, cfg, len(text.bow_vocab))
    model = LAFFModel(prepared.spec)
    w0 = make_weights({k: tuple(v.shape) for k, v in model.state_dict().items()}, 4,
                      torch.device("cpu"))
    model.load_state_dict(w0)
    program.check_parameters(model, cfg, text)
    return cfg, prepared, model, w0, text, video


def _port_inputs(prepared, cap_ids, vis_ids):
    from laff_tpu_torch.engine.trainer import host_tensors

    txt = host_tensors(prepared.train_feed.text_batcher(cap_ids), pin=False)
    vis = host_tensors(prepared.train_feed.vis_batcher(vis_ids), pin=False)
    return txt, vis


def _ref_inputs(text, video, cap_ids, vis_ids):
    cpu = torch.device("cpu")
    return program.to_device(text.featurize(cap_ids), cpu), program.to_device(
        video.featurize(vis_ids), cpu)


def test_eval_forward_matches(setup):
    cfg, prepared, model, w0, text, video = setup
    caps = text.ids[:16]
    vids = [c.split("#")[0] for c in caps]
    txt, vis = _port_inputs(prepared, caps, vids)
    rt, rv = _ref_inputs(text, video, caps, vids)
    model.eval()
    ref = ReferenceModel(cfg, w0)
    with torch.no_grad():
        torch.testing.assert_close(model.encode_txt(txt), ref.encode_txt(rt), rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(model.encode_vis(vis), ref.encode_vis(rv), rtol=1e-4,
                                   atol=1e-5)


def test_training_loss_and_one_update_match(setup):
    from laff_tpu_torch.engine.optim import make_optimizer
    from laff_tpu_torch.engine.trainer import TrainStep

    cfg, prepared, model, w0, text, video = setup
    caps = text.ids[8:16]
    vids = [c.split("#")[0] for c in caps]
    txt, vis = _port_inputs(prepared, caps, vids)
    rt, rv = _ref_inputs(text, video, caps, vids)
    step = TrainStep(model, make_optimizer(prepared.config, model), prepared.spec)
    loss = float(step(txt, vis, torch.Generator().manual_seed(77)))
    ref = train_steps(cfg, w0, [(rt, rv)], gen_seed=77)
    assert loss == pytest.approx(ref["losses"][0], rel=1e-5)
    for k, p in model.named_parameters():
        moved, want = p.detach() - w0[k], ref["params"][k] - w0[k]
        torch.testing.assert_close(moved, want, rtol=2e-3, atol=1e-6)
    for k, v in ref["stats"].items():
        torch.testing.assert_close(dict(model.named_buffers())[k], v, rtol=1e-5, atol=1e-6)


def test_reference_loss_reads_the_draws(setup):
    """Another generator seed draws other dropout masks: the loss moves."""
    cfg, prepared, model, w0, text, video = setup
    rt, rv = _ref_inputs(text, video, text.ids[:8], [c.split("#")[0] for c in text.ids[:8]])
    ref = ReferenceModel(cfg, w0)
    losses = [float(triplet_multi_space(
        ref.encode_txt(rt, True, torch.Generator().manual_seed(s)),
        ref.encode_vis(rv, True, torch.Generator().manual_seed(s)), cfg["loss"]))
        for s in (1, 2)]
    assert losses[0] != losses[1]


def test_ranks_match(setup):
    from laff_tpu_torch.engine.evaluator import t2v_ranks

    cfg, prepared, model, w0, text, video = setup
    vids = sorted({c.split("#")[0] for c in text.ids})
    txt_p, vis_p = _port_inputs(prepared, text.ids, vids)
    model.eval()
    with torch.no_grad():
        te, ve = model.encode_txt(txt_p), model.encode_vis(vis_p)
        got = t2v_ranks(te, ve, text.ids, vids, rank_path="flat")
        col = {v: i for i, v in enumerate(vids)}
        gt = torch.tensor([col[c.split("#")[0]] for c in text.ids])
        want = ranks_from_scores(scores(flat_embeddings(te), flat_embeddings(ve), cfg["heads"]),
                                 gt)
    assert got.tolist() == want.tolist()
