"""End2EndClip training (``laff_tpu.engine.end2end``; reference End2EndClip
flow, ``model/model.py:2261-2498``, and the frame_loader data path).

Raw video frames and raw captions through live CLIP towers: captions are
BPE-tokenized in the feed, frames decoded from ``id.imagepath.txt`` by
``data.frames.ImageSource`` (Pillow), a prefetch thread building the next
batches while the card runs the step. The step is plain PyTorch under
autograd: both towers in float32, the improved triplet loss, backward,
then the optax chain of ``engine/optim.py``, ``clip_by_global_norm(grad_clip
or 2.0)`` then Adam (eps 1e-4) at lr/20: every End2EndClip parameter is a
tower parameter (``clip_param_labels``), and the reference trains those at
a twentieth of the learning rate. Frozen towers (``clip_opt['frozen']``)
give zero gradients, so the step changes nothing, as optax's Adam does.

Validation is epoch-invariant (tokenized captions, decoded frames): its
batches are staged on the device after the first pass while they fit
``LAFF_TPU_EVAL_STAGE_BUDGET`` bytes a feed (read at call time), and
streamed again every epoch with ``--stage_val_features 0`` or above the
budget. t2v ranks go through ``evaluator.t2v_ranks`` on ``rank_path``
('kernel': the fused rank kernel on bf16 operands; ``laff_tpu`` takes
'auto', which is the flat f32 path here). The best epoch's weights go
through the reference's checkpoint dance; training stops after 10 epochs
without a better mir, as in ``laff_tpu``.

A checkpoint is ``{'model_name': 'End2EndClip', 'state_dict', 'epoch',
'best_perf', 'config', 'opt', 'text_config', 'vision_config'}``, tensors
and plain data (``load_end2end`` rebuilds the model).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Tuple

import torch

from ..data import EvalFeed, Prefetcher, TextSource, read_video_set
from ..data.end2end import End2EndFeed
from ..data.frames import ImageSource
from ..eval.metrics import metrics_from_ranks
from ..models.clip import ClipTextConfig, ClipVisionConfig, tokenize
from ..models.end2end_clip import End2EndClip, clip_param_labels
from ..ops.losses import triplet_loss
from ..utils import get_logger, makedirs
from .checkpoint import config_to_dict, save_checkpoint_dance
from .evaluator import device_batches, t2v_ranks
from .optim import LRController, OptaxChain
from .predictor import resolve_device
from .prepare import load_config, model_dir_for
from .trainer import ScalarLogger

logger = get_logger(__name__)

CLIP_LR_DIVISOR = 20.0  # reference model/model.py:2013-2019
NO_IMPROVEMENT_EPOCHS = 10


def tower_configs(config) -> Tuple[ClipTextConfig, ClipVisionConfig]:
    tc = getattr(config, "clip_text_config", {})
    vc = getattr(config, "clip_vision_config", {})
    return ClipTextConfig(**tc), ClipVisionConfig(**vc)


def build_model(config, seed: int = 0) -> End2EndClip:
    """End2EndClip at the config's tower shapes, initialized from ``seed``
    (on the CPU, so the weights do not depend on the device)."""
    text_cfg, vision_cfg = tower_configs(config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return End2EndClip(text_cfg, vision_cfg, frozen=config.clip_opt.get("frozen", False))


def make_optimizer(config, model: End2EndClip) -> OptaxChain:
    """``clip_by_global_norm(grad_clip or 2.0)`` then Adam(eps 1e-4) at
    lr / 20 over the tower parameters, which are all of them."""
    usual = sorted(n for n, label in clip_param_labels(model).items() if label != "clip")
    if usual:
        raise ValueError(f"End2EndClip parameters outside the CLIP towers: {usual}")
    return OptaxChain(model.parameters(), "adam", config.lr / CLIP_LR_DIVISOR,
                      grad_clip=config.grad_clip or 2.0)


class End2EndStep:
    """One optimizer step on a (txt, vis) batch on the model's device;
    returns the loss, on the device."""

    def __init__(self, model: End2EndClip, optimizer: OptaxChain, config) -> None:
        self.model, self.optimizer = model, optimizer
        self.loss_kw = dict(margin=config.margin, direction=config.direction,
                            max_violation=config.max_violation, cost_style=config.cost_style)

    def loss(self, txt: Dict[str, torch.Tensor], vis: Dict[str, torch.Tensor]) -> torch.Tensor:
        t, v = self.model(txt, vis)
        return triplet_loss(t, v, **self.loss_kw)

    def __call__(self, txt: Dict[str, torch.Tensor],
                 vis: Dict[str, torch.Tensor]) -> torch.Tensor:
        self.model.train()
        self.optimizer.zero_grad()
        loss = self.loss(txt, vis)
        if loss.requires_grad:  # frozen towers: no graph, zero gradients
            loss.backward()
        self.optimizer.step()
        return loss.detach()


def _to(arrays: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@torch.no_grad()
def embed(fn, feed: EvalFeed, device: torch.device) -> Tuple[torch.Tensor, List[str]]:
    """``fn`` over ``feed``'s batches (staged on the device when the feed
    asks for it and they fit the budget); the valid rows and their ids."""
    chunks, ids = [], []
    for data, batch_ids, valid in device_batches(feed, device, False, prefetch_depth=2):
        chunks.append(fn(data)[:valid])
        ids.extend(batch_ids)
    return torch.cat(chunks), ids


def validate(model: End2EndClip, txt_feed: EvalFeed, vis_feed: EvalFeed,
             device: torch.device, rank_path: str = "auto") -> Dict:
    model.eval()
    txt_embs, txt_ids = embed(model.encode_txt, txt_feed, device)
    vis_embs, vis_ids = embed(model.encode_vis, vis_feed, device)
    ranks = t2v_ranks(txt_embs, vis_embs, txt_ids, vis_ids, rank_path=rank_path)
    names = ("r1", "r5", "r10", "medr", "meanr", "mir", "mAP")
    return {k: float(v) for k, v in zip(names, metrics_from_ranks(ranks))}


def load_end2end(path: str, device: str = "cuda") -> End2EndClip:
    """The model of an End2EndClip checkpoint, in eval mode, on ``device``
    (the card unless the caller names the CPU)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = End2EndClip(ClipTextConfig(**ckpt["text_config"]),
                        ClipVisionConfig(**ckpt["vision_config"]),
                        frozen=ckpt["config"]["clip_opt"].get("frozen", False))
    model.load_state_dict(ckpt["state_dict"])
    return model.to(resolve_device(device)).eval()


def _images(opt, config, collection: str, sample_type: str) -> ImageSource:
    return ImageSource(os.path.join(os.path.expanduser(opt.rootpath), collection,
                                    "id.imagepath.txt"),
                       sample_frame=config.sample_frame, sample_type=sample_type,
                       image_size=tower_configs(config)[1].image_size)


def train_feed(opt, config) -> End2EndFeed:
    """Epoch-shuffled (caption ids, frames) batches of ``opt.trainCollection``."""
    caps = os.path.join(os.path.expanduser(opt.rootpath), opt.trainCollection, "TextData",
                        f"{opt.trainCollection}.caption.txt")
    return End2EndFeed(TextSource(caps),
                       _images(opt, config, opt.trainCollection, config.frame_sample_type_train),
                       batch_size=opt.batch_size, seed=opt.random_seed,
                       context_length=tower_configs(config)[0].context_length)


def validation_feeds(opt, config) -> Tuple[EvalFeed, EvalFeed]:
    """The caption and video feeds of ``opt.valCollection`` (batches of
    ``batch_size`` captions and ``batch_size // 4`` videos), staged on the
    device with ``opt.stage_val_features``."""
    coll_dir = os.path.join(os.path.expanduser(opt.rootpath), opt.valCollection)
    val_set = "" if opt.val_set == "no" else opt.val_set
    tsource = TextSource(os.path.join(coll_dir, "TextData", val_set,
                                      f"{opt.valCollection}.caption.txt"))
    images = _images(opt, config, opt.valCollection, config.frame_sample_type_test)
    context = tower_configs(config)[0].context_length
    txt_feed = EvalFeed(tsource.cap_ids, lambda ids: {"clip_ids": tokenize(
        tsource.captions_for(ids), context)}, batch_size=opt.batch_size)
    vis_feed = EvalFeed(read_video_set(os.path.join(coll_dir, "VideoSets",
                                                    opt.valCollection + ".txt")),
                        lambda ids: {"frames": images.batch(ids)},
                        batch_size=max(opt.batch_size // 4, 1))
    txt_feed.stage_on_device = vis_feed.stage_on_device = bool(opt.stage_val_features)
    return txt_feed, vis_feed


def main(opt) -> Dict:
    """A training run; returns {best_perf, model_path, parameters, history
    (one entry an epoch: loss, lr, steps, metrics, train / feed-wait /
    validation seconds), model (the trained model)}."""
    device = resolve_device(opt.device)
    config = load_config(opt.config_name, opt.parm_adjust_config)
    model_path = model_dir_for(opt)
    makedirs(model_path)
    text_cfg, vision_cfg = tower_configs(config)
    feed = train_feed(opt, config)
    txt_feed, vis_feed = validation_feeds(opt, config)

    model = build_model(config, opt.random_seed).to(device)
    optimizer = make_optimizer(config, model)
    step = End2EndStep(model, optimizer, config)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("End2EndClip: %d parameters, text %s, vision %s", n_params, text_cfg,
                vision_cfg)

    lr_ctl = LRController(config.lr, config.lr_decay_rate)
    scalar_log = ScalarLogger(model_path)
    opt_dict = dataclasses.asdict(opt) if dataclasses.is_dataclass(opt) else dict(vars(opt))
    best_perf, no_impr = 0.0, 0
    result = {"best_perf": 0.0, "model_path": model_path, "parameters": n_params,
              "history": []}
    try:
        for epoch in range(opt.num_epochs):
            lr = lr_ctl.current()
            optimizer.set_learning_rate(lr / CLIP_LR_DIVISOR)
            t0 = time.time()
            losses, wait = [], 0.0
            batches = Prefetcher(feed.epoch(epoch), depth=max(2, int(opt.workers) + 1))
            while True:
                t_wait = time.time()
                batch = next(batches, None)
                wait += time.time() - t_wait
                if batch is None:
                    break
                losses.append(step(_to(batch["txt"], device), _to(batch["vis"], device)))
            train_loss = float(torch.stack(losses).mean()) if losses else 0.0
            train_seconds = time.time() - t0

            t0 = time.time()
            metrics = validate(model, txt_feed, vis_feed, device, rank_path=opt.rank_path)
            val_seconds = time.time() - t0
            cur = metrics["mir"]
            logger.info("epoch %d: loss=%.3f r1=%.2f r5=%.2f medr=%.0f mir=%.4f (%.1fs train, "
                        "%.1fs validate)", epoch, train_loss, metrics["r1"], metrics["r5"],
                        metrics["medr"], cur, train_seconds, val_seconds)
            scalar_log.add_scalar("val/mir", cur, epoch)
            result["history"].append({"epoch": epoch, "loss": train_loss, "lr": lr,
                                      "steps": len(losses),
                                      "train_seconds": round(train_seconds, 3),
                                      "feed_wait_seconds": round(wait, 3),
                                      "val_seconds": round(val_seconds, 3), **metrics})
            lr_ctl.step(cur)
            is_best = cur > best_perf
            best_perf = max(cur, best_perf)
            if is_best:
                save_checkpoint_dance(
                    {"model_name": "End2EndClip", "epoch": epoch + 1,
                     "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     "best_perf": best_perf, "config": config_to_dict(config),
                     "opt": opt_dict, "text_config": dataclasses.asdict(text_cfg),
                     "vision_config": dataclasses.asdict(vision_cfg)},
                    True, logdir=model_path, filename=f"checkpoint_epoch_{epoch}.pth.tar")
            no_impr = 0 if is_best else no_impr + 1
            if no_impr > NO_IMPROVEMENT_EPOCHS or epoch == opt.num_epochs - 1:
                save_checkpoint_dance({}, is_best=False, logdir=model_path, only_best=True)
                break
    finally:
        scalar_log.close()
    result["best_perf"] = best_perf
    result["model"] = model
    return result
