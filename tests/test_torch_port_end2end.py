"""End2EndClip on the CPU, held against laff_tpu on the same seeded inputs
and carried weights:

* ``preprocess_image``, ``sample_frame_indices``, ``ImageSource`` and two
  epochs of ``End2EndFeed`` batches over a PNG world: equal;
* the model's forward and gradients (flax init carried by
  ``engine.weights.end2end_from_jax``), frozen and not, and one optimizer
  step (the clip-by-global-norm and Adam-at-lr/20 chain of
  ``laff_tpu.engine.end2end``) from the same weights: within 1e-5 of the
  largest value; frozen towers update nothing in either;
* the registry builds the model; the LAFF trainer's ``prepare`` sends an
  End2EndClip config to ``engine.end2end``;
* ``engine.end2end.main`` through ``cli.do_trainer`` on the PNG world for
  2 epochs (best_perf > 0, ``model_best.pth.tar`` written and loadable),
  and one epoch with validation staged, streamed (``--stage_val_features
  0``) and over the staging budget: equal metrics.
"""

import dataclasses
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

pytest.importorskip("PIL")

from laff_tpu.configs import end2end_clip as jax_e2e_config
from laff_tpu.data import end2end as jax_feed
from laff_tpu.data import frames as jax_frames
from laff_tpu.data.sources import TextSource as JTextSource
from laff_tpu.models import end2end_clip as jax_model
from laff_tpu.models.clip import ClipTextConfig as JText, ClipVisionConfig as JVision
from laff_tpu.ops import triplet_loss as jax_triplet
from laff_tpu_torch.cli import do_trainer
from laff_tpu_torch.configs import e2e_tiny
from laff_tpu_torch.data import TextSource
from laff_tpu_torch.data import end2end as port_feed
from laff_tpu_torch.data import frames as port_frames
from laff_tpu_torch.engine import end2end as port_e2e
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine.weights import end2end_from_jax
from laff_tpu_torch.models import registry
from laff_tpu_torch.models.clip import tokenize
from laff_tpu_torch.models.end2end_clip import End2EndClip, clip_param_labels

COLORS = ["red", "green", "blue", "dark", "light", "grey"]


def build_image_world(root, coll, n_videos, caps, seed, frames=3, size=(40, 48)):
    """Solid-colour PNG frames a video (noise added), captions naming the
    colour: ``id.imagepath.txt``, the caption file and the video set."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, coll, "frames")
    os.makedirs(img_dir, exist_ok=True)
    id_lines, cap_lines, vids = [], [], []
    for i in range(n_videos):
        vid = f"{coll}_v{i}"
        vids.append(vid)
        color = rng.integers(0, 255, 3)
        for f in range(frames):
            path = os.path.join(img_dir, f"{vid}_{f}.png")
            arr = np.full((*size, 3), color, np.uint8) + rng.integers(0, 10, (*size, 3)).astype(
                np.uint8)
            Image.fromarray(arr).save(path)
            id_lines.append(f"{vid}_{f} {path}")
        words = " ".join(COLORS[c * len(COLORS) // 256] for c in color[:2])
        cap_lines += [f"{vid}#{c} a {words} video" for c in range(caps)]
    for rel, lines in (("id.imagepath.txt", id_lines),
                       (f"TextData/{coll}.caption.txt", cap_lines),
                       (f"VideoSets/{coll}.txt", vids)):
        os.makedirs(os.path.dirname(os.path.join(root, coll, rel)), exist_ok=True)
        with open(os.path.join(root, coll, rel), "w") as fh:
            fh.write("\n".join(lines))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("e2e"))
    build_image_world(root, "e2etrain", 12, 2, 0)
    build_image_world(root, "e2eval", 6, 1, 5, frames=5, size=(50, 36))
    return root


def test_frames_equal_laff_tpu(world):
    from PIL import Image

    rng = random.Random(3)
    for n in (1, 3, 7, 100):
        for sample in (1, 4, 8):
            assert port_frames.sample_frame_indices(n, sample, "uniform") == \
                jax_frames.sample_frame_indices(n, sample, "uniform")
            state = rng.getstate()
            a = port_frames.sample_frame_indices(n, sample, "random", rng)
            rng.setstate(state)
            assert a == jax_frames.sample_frame_indices(n, sample, "random", rng)
    path = os.path.join(world, "e2eval", "frames", "e2eval_v0_0.png")
    with Image.open(path) as img:
        np.testing.assert_array_equal(port_frames.preprocess_image(img, 32),
                                      jax_frames.preprocess_image(img, 32))
    ids_file = os.path.join(world, "e2eval", "id.imagepath.txt")
    ours = port_frames.ImageSource(ids_file, sample_frame=4, image_size=32)
    ref = jax_frames.ImageSource(ids_file, sample_frame=4, image_size=32)
    assert ours.vid2paths == ref.vid2paths
    np.testing.assert_array_equal(ours.batch(["e2eval_v1", "e2eval_v4"]),
                                  ref.batch(["e2eval_v1", "e2eval_v4"]))


def test_feed_batches_equal_laff_tpu(world):
    caps = os.path.join(world, "e2etrain", "TextData", "e2etrain.caption.txt")
    ids_file = os.path.join(world, "e2etrain", "id.imagepath.txt")
    ours = port_feed.End2EndFeed(TextSource(caps), port_frames.ImageSource(
        ids_file, 2, "random", 32), batch_size=8, seed=4, context_length=16)
    ref = jax_feed.End2EndFeed(JTextSource(caps), jax_frames.ImageSource(
        ids_file, 2, "random", 32), batch_size=8, seed=4, context_length=16)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 3
    for epoch in range(2):
        for a, b in zip(ours.epoch(epoch), ref.epoch(epoch), strict=True):
            assert a["cap_ids"] == b["cap_ids"] and a["vis_ids"] == b["vis_ids"]
            np.testing.assert_array_equal(a["txt"]["clip_ids"], b["txt"]["clip_ids"])
            np.testing.assert_array_equal(a["vis"]["frames"], b["vis"]["frames"])
    padded = list(port_feed.eval_batches(list("abcde"), lambda ids: {"n": ids}, 2))
    assert padded == list(jax_feed.eval_batches(list("abcde"), lambda ids: {"n": ids}, 2))


CFG = e2e_tiny.config()
TEXT = JText(**CFG.clip_text_config)
VISION = JVision(**CFG.clip_vision_config)


def _batch(b=4, s=2, masked=True):
    rng = np.random.default_rng(9)
    caps = [f"a {COLORS[i % 6]} {COLORS[(i * 5) % 6]} video number {i}" for i in range(b)]
    txt = {"clip_ids": tokenize(caps, TEXT.context_length)}
    vis = {"frames": rng.standard_normal((b, s, 32, 32, 3)).astype(np.float32)}
    if masked:
        vis["frames_mask"] = np.array([[1, 1], [1, 0], [1, 1], [0, 0]][:b], np.float32)
    return txt, vis


def _models(frozen):
    txt, vis = _batch()
    jm = jax_model.End2EndClip(text_config=TEXT, vision_config=VISION, frozen=frozen)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(2), jax.tree.map(jnp.asarray, txt), jax.tree.map(jnp.asarray, vis))[
        "params"])
    pm = End2EndClip(port_e2e.tower_configs(CFG)[0], port_e2e.tower_configs(CFG)[1],
                     frozen=frozen)
    pm.load_state_dict(end2end_from_jax(params))
    return jm, params, pm


def _close(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k in ref:
        a, b = ours[k].detach().numpy(), ref[k].numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, float(np.abs(b).max())),
                                   err_msg=k)


def _jax_loss(jm, cfg):
    def loss_fn(p, txt, vis):
        t, v = jm.apply({"params": p}, txt, vis)
        return jax_triplet(t, v, margin=cfg.margin, direction=cfg.direction,
                           max_violation=cfg.max_violation, cost_style=cfg.cost_style)
    return loss_fn


@pytest.mark.parametrize("frozen", [False, True])
def test_forward_and_gradients_match_laff_tpu(frozen):
    jm, params, pm = _models(frozen)
    txt, vis = _batch()
    jt, jv = jax.jit(jm.apply)({"params": params}, jax.tree.map(jnp.asarray, txt),
                               jax.tree.map(jnp.asarray, vis))
    to_t = {k: torch.from_numpy(v) for k, v in {**txt, **vis}.items()}
    pt, pv = pm({"clip_ids": to_t["clip_ids"]}, {k: to_t[k] for k in vis})
    _close({"t": pt.detach(), "v": pv.detach()}, {"t": torch.from_numpy(np.asarray(jt)),
                                "v": torch.from_numpy(np.asarray(jv))})
    # the masked-out frame of video 1 moves nothing; video 3 has no frame
    loss_fn = _jax_loss(jm, CFG)
    jl, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jax.tree.map(jnp.asarray, txt),
                                                     jax.tree.map(jnp.asarray, vis))
    step = port_e2e.End2EndStep(pm, port_e2e.make_optimizer(CFG, pm), CFG)
    pl = step.loss({"clip_ids": to_t["clip_ids"]}, {k: to_t[k] for k in vis})
    assert abs(float(pl.detach()) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    if frozen:
        assert not pl.requires_grad
        assert all(float(jnp.abs(g).sum()) == 0 for g in jax.tree_util.tree_leaves(grads))
        return
    pm.zero_grad(set_to_none=True)
    pl.backward()
    _close({k: p.grad for k, p in pm.named_parameters()},
           end2end_from_jax(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("frozen", [False, True])
def test_optimizer_step_matches_laff_tpu(frozen):
    """One step of laff_tpu.engine.end2end's chain against the port's."""
    jm, params, pm = _models(frozen)
    txt, vis = _batch(masked=False)
    cfg = jax_e2e_config.config()
    cfg.lr = CFG.lr
    labels = jax_model.clip_param_labels(params)
    tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip or 2.0),
        optax.multi_transform({"clip": optax.adam(learning_rate / 20.0, eps=1e-4),
                               "usual": optax.adam(learning_rate, eps=1e-4)}, labels)))(
        learning_rate=cfg.lr)

    @jax.jit
    def jax_step(params, txt, vis):  # laff_tpu.engine.end2end's train_step
        loss, grads = jax.value_and_grad(_jax_loss(jm, cfg))(params, txt, vis)
        updates, _ = tx.update(grads, tx.init(params))
        return loss, optax.apply_updates(params, updates)

    jl, new = jax_step(params, jax.tree.map(jnp.asarray, txt), jax.tree.map(jnp.asarray, vis))
    new = jax.tree.map(np.asarray, new)

    assert set(clip_param_labels(pm).values()) == {"clip"}
    step = port_e2e.End2EndStep(pm, port_e2e.make_optimizer(CFG, pm), CFG)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    loss = step({k: torch.from_numpy(v) for k, v in txt.items()},
                {k: torch.from_numpy(v) for k, v in vis.items()})
    assert abs(float(loss) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    _close(pm.state_dict(), end2end_from_jax(new))
    moved = any(not torch.equal(before[k], v) for k, v in pm.state_dict().items())
    assert moved != frozen


def test_registry_and_prepare():
    text, vision = port_e2e.tower_configs(CFG)
    assert isinstance(registry.get_model("End2EndClip", text_config=text, vision_config=vision),
                      End2EndClip)
    with pytest.raises(ValueError, match="engine.end2end.main"):
        port_prepare.check_config(CFG)


def _argv(root, prefix, *extra):
    return ["e2etrain", "e2eval", "--rootpath", root, "--val_set", "no", "--config_name",
            "e2e_tiny", "--batch_size", "8", "--device", "cpu", "--model_prefix", prefix,
            *extra]


def test_main_trains_through_the_cli(world):
    assert do_trainer.main(_argv(world, "cli", "--num_epochs", "2", "--rank_path",
                                 "kernel")) == 0
    opt = do_trainer.parse_args(_argv(world, "cli"))
    best = os.path.join(port_prepare.model_dir_for(opt), "model_best.pth.tar")
    model = port_e2e.load_end2end(best, device="cpu")
    assert isinstance(model, End2EndClip) and not model.training
    ckpt = torch.load(best, weights_only=True)
    assert ckpt["model_name"] == "End2EndClip" and ckpt["best_perf"] > 0
    assert ckpt["text_config"] == dataclasses.asdict(port_e2e.tower_configs(CFG)[0])


def test_stage_val_opt_out_matches(world, monkeypatch):
    """Validation staged, streamed again (--stage_val_features 0) and over
    the staging budget (1 byte): the same metrics."""
    def run(prefix, stage, budget=None):
        if budget is None:
            monkeypatch.delenv("LAFF_TPU_EVAL_STAGE_BUDGET", raising=False)
        else:
            monkeypatch.setenv("LAFF_TPU_EVAL_STAGE_BUDGET", str(budget))
        opt = do_trainer.parse_args(_argv(world, prefix, "--num_epochs", "1",
                                          "--stage_val_features", str(stage)))
        res = port_e2e.main(opt)
        assert res["best_perf"] > 0 and len(res["history"]) == 1
        return {k: res["history"][0][k] for k in ("loss", "r1", "r5", "medr", "mir")}

    staged = run("staged", 1)
    assert run("lazy", 0) == staged
    assert run("overflow", 1, budget=1) == staged
