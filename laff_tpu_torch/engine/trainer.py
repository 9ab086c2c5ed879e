"""Training: the train step, the epoch loop and ``main``
(``laff_tpu.engine.trainer``), for single steps on one device.

* The train step is plain PyTorch under autograd, as the JAX step is plain
  XLA: forward in training mode (BatchNorm on batch statistics, dropout
  and the zero-feature noise from the epoch's generator), the loss of
  ``make_loss_fn``, backward, then the optax chain of ``engine/optim.py``.
  With grad on, the towers take the plain gate, never the forward-only
  gate kernel. The step makes no host synchronisation: the finite check,
  the clip and the skip happen on the card.
* ``train_one_epoch`` keeps the losses on the card and reads them once
  every ``log_every`` steps; the host featurizes and pins the next
  batches in a prefetch thread meanwhile.
* ``main`` runs the reference epoch loop (``trainer.py:315-443``): set the
  learning rate, anneal every ``global_emb_weight``, train, ``validate``
  (eval forward with the gate kernel, ranks on the ``rank_path``), the LR
  controller, the best-model checkpoint dance, mean_last, early stop, and
  a full resume (optimizer state, LR controller and counters).

Left for later slices (ROADMAP Queue 1): the device feature caches and the
K-step dispatch, task2 and task3, FrameLAFF, data_parallel, the BERT lr/20
mask, the 'hist' measure, and TensorBoard (``scalars.tsv`` only).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data import EvalFeed, PairFeed, Prefetcher
from ..ops import multi_head_cosine_sim
from ..ops.losses import (
    cross_entropy_loss,
    cross_entropy_loss_from_scores,
    dual_softmax_loss,
    dual_softmax_loss_from_scores,
    triplet_loss,
    triplet_loss_from_scores,
    triplet_loss_multi_space,
)
from ..utils import AverageMeter, Progress, get_logger
from .checkpoint import (average_states, checkpoint_payload, load_checkpoint, save_checkpoint,
                         save_checkpoint_dance)
from .evaluator import Embedder, validate
from .optim import LRController, OptaxChain, make_optimizer
from .predictor import resolve_device
from .prepare import Options, Prepared, prepare, seeded_model

logger = get_logger(__name__)

METRICS = ("r1", "r5", "r10", "medr", "meanr", "mir", "mAP")


def make_loss_fn(spec):
    """(txt_embs, vis_embs) -> scalar loss, as ``laff_tpu``'s: with
    ``multi_space`` one criterion per head, summed; else the criterion on
    the head-mean score matrix (rows videos, columns captions)."""
    if spec.measure != "cosine":
        raise NotImplementedError(f"measure {spec.measure!r} is not ported yet")
    kwargs = dict(margin=spec.margin, direction=spec.direction,
                  max_violation=spec.max_violation, cost_style=spec.cost_style)

    def loss_fn(txt_embs: torch.Tensor, vis_embs: torch.Tensor) -> torch.Tensor:
        multi_head = txt_embs.ndim == 3
        if spec.loss in ("dsl", "CELoss"):
            if multi_head and not spec.multi_space:
                scores = multi_head_cosine_sim(vis_embs, txt_embs)
                return (dual_softmax_loss_from_scores(scores) if spec.loss == "dsl"
                        else cross_entropy_loss_from_scores(scores))
            fn = dual_softmax_loss if spec.loss == "dsl" else cross_entropy_loss
            return fn(txt_embs, vis_embs).sum()  # per head (H,) -> summed
        if multi_head and spec.multi_space:
            return triplet_loss_multi_space(txt_embs, vis_embs, **kwargs)
        if multi_head:
            return triplet_loss_from_scores(multi_head_cosine_sim(vis_embs, txt_embs), **kwargs)
        return triplet_loss(txt_embs, vis_embs, **kwargs)

    return loss_fn


class TrainStep:
    """One optimizer step on a batch already on the model's device:
    training-mode forward, loss, backward, update. Returns the loss as a
    tensor on the card (reading it is the caller's host sync). Puts the
    model in training mode; ``validate`` leaves it so."""

    def __init__(self, model: torch.nn.Module, optimizer: OptaxChain, spec) -> None:
        self.model = model.train()
        self.optimizer = optimizer
        self.loss_fn = make_loss_fn(spec)

    def __call__(self, txt: Dict[str, torch.Tensor], vis: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self.optimizer.zero_grad()
        loss = self.loss_fn(*self.model(txt, vis, generator))
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def anneal_schedule(model: torch.nn.Module, decay_rate: float) -> None:
    """Linear decay of every mean-pool residual weight, w = max(w + decay
    - 1, 0) (reference ``change_raw_global_emb_weight``)."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("global_emb_weight"):
                buf.copy_(torch.clamp(buf + decay_rate - 1.0, min=0.0))


def epoch_generator(device: torch.device, seed: int, epoch: int) -> torch.Generator:
    """The dropout and noise generator of one epoch: a resumed run draws
    what an uninterrupted one drew."""
    return torch.Generator(device=device).manual_seed(seed * 1000 + epoch)


def host_batch(batch: Dict, pin: bool) -> Dict[str, Dict[str, torch.Tensor]]:
    """A feed batch's arrays as CPU tensors, in pinned memory when the
    copies go to the card (run in the prefetch thread)."""
    def tensors(arrays):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        return {k: v.pin_memory() for k, v in out.items()} if pin else out

    return {"txt": tensors(batch["txt"]), "vis": tensors(batch["vis"])}


def _to(tensors: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device, non_blocking=True) for k, v in tensors.items()}


class ScalarLogger:
    """``scalars.tsv`` in the model directory: step, tag, value per line."""

    def __init__(self, logdir: str) -> None:
        self._fh = open(os.path.join(logdir, "scalars.tsv"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(f"{step}\t{tag}\t{value}\n")

    def close(self) -> None:
        self._fh.close()


def train_one_epoch(step: TrainStep, feed: PairFeed, epoch: int, device: torch.device,
                    generator: Optional[torch.Generator] = None,
                    scalar_log: Optional[ScalarLogger] = None, log_every: int = 50,
                    prefetch_depth: int = 3, step0: int = 0, sync_debug: bool = False):
    """One epoch of single steps. The losses stay on the card and are read
    once every ``log_every`` steps; with ``sync_debug`` (on the card) the
    steps between two reads run under ``set_sync_debug_mode("error")``, so
    any host sync in them raises. Returns (mean loss, steps run)."""
    meter = AverageMeter()
    progress = Progress(feed.steps_per_epoch() * feed.batch_size, f"epoch {epoch}")
    pin = device.type == "cuda"
    debug = sync_debug and device.type == "cuda"
    pending = []
    n = 0

    def read() -> None:
        vals = torch.stack(pending).cpu().numpy()
        for v in vals:
            meter.update(float(v))
        if scalar_log is not None:
            scalar_log.add_scalar("train/Loss", float(vals[-1]), step0 + n)
        pending.clear()

    batches = Prefetcher((host_batch(b, pin) for b in feed.epoch(epoch)), depth=prefetch_depth)
    try:
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        for batch in batches:
            pending.append(step(_to(batch["txt"], device), _to(batch["vis"], device), generator))
            n += 1
            progress.add(feed.batch_size)
            if len(pending) >= log_every:
                if debug:
                    torch.cuda.set_sync_debug_mode(0)
                read()
                if debug:
                    torch.cuda.set_sync_debug_mode("error")
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode(0)
    if pending:
        read()
    return meter.avg, n


def main(opt: Options, prepared: Optional[Prepared] = None) -> Dict:
    """A full training run (reference ``trainer.main``). Returns
    {best_perf, epochs, prepare_seconds, history (one entry per epoch:
    loss, lr, metrics, train/val/wall seconds), model_path}."""
    device = resolve_device(opt.device)
    t_prepare = time.time()
    if prepared is None:
        prepared = prepare(opt)
    prepare_seconds = time.time() - t_prepare
    config, spec, model_path = prepared.config, prepared.spec, prepared.model_path

    model = seeded_model(spec, opt.random_seed, prepared.we)
    if opt.pretrained_file_path != "None":
        model.load_state_dict(load_checkpoint(opt.pretrained_file_path)["state_dict"])
        logger.info("warm-started from %s", opt.pretrained_file_path)
    model.to(device)
    bf16 = "bfloat16" in (spec.txt.compute_dtype, spec.vis.compute_dtype)
    optimizer = make_optimizer(config, model, bf16=bf16)
    step = TrainStep(model, optimizer, spec)
    multiple = int(getattr(config, "device_batch_multiple", 1) or 1)
    if opt.batch_size % multiple:
        raise ValueError(f"batch_size {opt.batch_size} must be a multiple of {multiple} "
                         f"(config.device_batch_multiple)")

    lr_ctl = LRController(config.lr, config.lr_decay_rate)
    eval_batch = getattr(config, "eval_batch_size", 1024)
    val_txt_feed = EvalFeed(prepared.val_txt_source.cap_ids, prepared.val_txt_batcher,
                            batch_size=eval_batch)
    val_vis_feed = EvalFeed(prepared.val_vis_ids, prepared.val_vis_batcher,
                            batch_size=eval_batch)
    prefetch_depth = max(2, int(opt.workers) + 1)
    embedder = Embedder(model, device, prefetch_depth=prefetch_depth)

    best_perf, no_impr, mean_last, start_epoch, global_step = 0.0, 0, [], 0, 0
    resume_path = os.path.join(model_path, "model_resume.pth.tar")
    if opt.resume and os.path.exists(resume_path):
        rk = load_checkpoint(resume_path)
        model.load_state_dict(rk["state_dict"])
        optimizer.load_state_dict(rk["optimizer"])
        lr_ctl.__dict__.update(rk["lr_ctl"])
        best_perf, no_impr, mean_last = rk["best_perf"], rk["no_impr"], rk["mean_last"]
        start_epoch, global_step = rk["epoch"], rk["global_step"]
        logger.info("resumed from %s at epoch %d (best %.4f)", resume_path, start_epoch,
                    best_perf)
    opt_dict = dataclasses.asdict(opt)

    def ckpt_payload(epoch: int) -> Dict:
        payload = checkpoint_payload(model.state_dict(), spec, config, prepared.featurizers,
                                     opt_dict)
        payload.update(epoch=epoch + 1, best_perf=best_perf)
        return payload

    result = {"best_perf": best_perf, "epochs": start_epoch,
              "prepare_seconds": round(prepare_seconds, 1), "history": []}
    scalar_log = ScalarLogger(model_path)
    hist = open(os.path.join(model_path, "val_perf_hist.txt"), "a" if start_epoch else "w")
    try:
        for epoch in range(start_epoch, opt.num_epochs):
            t_epoch = time.time()
            lr = lr_ctl.current()
            optimizer.set_learning_rate(lr)
            anneal_schedule(model, config.txt_attention_global_decay_rate)
            scalar_log.add_scalar("train/learning_rate", lr, epoch)
            logger.info("Epoch %d/%d lr=%.6g", epoch, opt.num_epochs, lr)

            t0 = time.time()
            train_loss, steps = train_one_epoch(
                step, prepared.train_feed, epoch, device,
                generator=epoch_generator(device, opt.random_seed, epoch),
                scalar_log=scalar_log, prefetch_depth=prefetch_depth, step0=global_step,
                sync_debug=bool(opt.sync_debug))
            global_step += steps
            epoch_time = time.time() - t0

            t0 = time.time()
            metrics = validate(embedder, val_txt_feed, val_vis_feed, measure=spec.measure,
                               rank_path=opt.rank_path)
            val_time = time.time() - t0
            cur_perf = metrics[opt.metric]
            for tag in METRICS:
                scalar_log.add_scalar(f"val/{tag}", metrics[tag], epoch)
            logger.info("epoch %d: loss=%.3f r1=%.2f r5=%.2f r10=%.2f medr=%.0f mir=%.4f "
                        "(%.1fs train, %.1fs validate)", epoch, train_loss, metrics["r1"],
                        metrics["r5"], metrics["r10"], metrics["medr"], metrics["mir"],
                        epoch_time, val_time)
            hist.write("epoch_%d:\nText2Video(%s): %f\n" % (epoch, opt.metric, cur_perf))
            hist.flush()
            entry = {"epoch": epoch, "loss": float(train_loss), "lr": float(lr),
                     "train_seconds": round(epoch_time, 2), "val_seconds": round(val_time, 2),
                     **{k: float(metrics[k]) for k in METRICS}}
            result["history"].append(entry)

            lr_ctl.step(cur_perf)
            is_best = cur_perf > best_perf
            best_perf = max(cur_perf, best_perf)
            if is_best:
                save_checkpoint_dance(ckpt_payload(epoch), True, logdir=model_path,
                                      filename=f"checkpoint_epoch_{epoch}.pth.tar")
                no_impr = 0
                mean_last = []
            elif opt.save_mean_last == 1:
                mean_last.append({k: v.detach().cpu().clone()
                                  for k, v in model.named_parameters()})
                if len(mean_last) > 1:
                    payload = ckpt_payload(epoch)
                    payload["state_dict"].update(average_states(mean_last))
                    save_checkpoint(payload, os.path.join(model_path, "mean_last10.pth.tar"))

            no_impr += 1
            entry["wall_seconds"] = round(time.time() - t_epoch, 2)
            if opt.resume:
                payload = ckpt_payload(epoch)
                payload.update(optimizer=optimizer.state_dict(), global_step=global_step,
                               lr_ctl=dict(lr_ctl.__dict__), no_impr=no_impr,
                               mean_last=mean_last)
                save_checkpoint(payload, resume_path)
            if no_impr > opt.early_stop_patience or epoch == opt.num_epochs - 1:
                save_checkpoint_dance(ckpt_payload(epoch), is_best=False, logdir=model_path,
                                      filename=f"checkpoint_epoch_{epoch}.pth.tar",
                                      only_best=True)
                logger.info("Early stopping or finished at epoch %d.", epoch)
                result["epochs"] = epoch + 1
                break
    finally:
        hist.close()
        scalar_log.close()
    message = "best performance on validation:\n Text to video(%s): %f" % (opt.metric,
                                                                           best_perf)
    logger.info(message)
    with open(os.path.join(model_path, "val_perf.txt"), "w") as fh:
        fh.write(message)
    result["best_perf"] = best_perf
    result["model_path"] = model_path
    return result
