"""Training: the train step, the K-step dispatch, the epoch loop and
``main`` (``laff_tpu.engine.trainer``), on one device.

* The train step is plain PyTorch under autograd, as the JAX step is plain
  XLA: forward in training mode (BatchNorm on batch statistics, dropout
  and the zero-feature noise from the epoch's generator), the loss of
  ``make_loss_fn``, backward, then the optax chain of ``engine/optim.py``.
  With grad on, the towers take the plain gate, never the forward-only
  gate kernel. The step makes no host synchronisation: the finite check,
  the clip and the skip happen on the card.
* Step wrappers (``make_cached_train_step``, ``make_txt_cached_train_step``,
  ``make_w2v_pooled_train_step``) take row indices into the device caches
  of ``engine/feature_cache.py`` and gather the rows, or mean-pool w2v row
  ids, on the card inside the step.
* ``MultiStep`` runs K steps per dispatch (``make_multi_train_step``'s
  ``lax.scan``). On the card it is one ``torch.cuda.CUDAGraph`` over a
  step, replayed K times: the batch's inputs are copied into static device
  buffers from pinned memory before each replay and each step's loss into
  a (K,) buffer. The graph is registered with the trainer's own
  generator, which ``epoch_generator`` reseeds each epoch, so replays draw
  the masks that eager steps draw and the process's default CUDA
  generator is left alone. The capture's warm-up steps run on a snapshot
  that is put back afterwards, so they train nothing. On the CPU the K
  steps run eagerly, through the same grouping in ``train_one_epoch``.
* ``train_one_epoch`` keeps the losses on the card and reads them once
  every ``log_every`` steps; the host featurizes (or looks up the row
  indices of) the next batches in a prefetch thread meanwhile. It drains
  an ``EpochStream``, which sends one dispatch at a time, so that a seed
  sweep (``engine/sweep.py``) can take several runs' dispatches in turn.
* ``main`` drives one ``TrainRun`` through the reference epoch loop
  (``trainer.py:315-443``) with ``laff_tpu``'s dispatch rules
  (``trainer.py:862-946``): the caches when their estimate fits
  ``LAFF_TPU_CACHE_BUDGET`` (4 GiB), the text cache only beside the visual
  one, K = min(8, steps) only with both; then set
  the learning rate, anneal every ``global_emb_weight``, train (and
  ``trainCollection2``'s epoch in single steps), ``validate`` (eval forward
  with the gate kernel, ranks on the ``rank_path``, batches staged on the
  card after the first pass), the LR controller, the best-model checkpoint
  dance, mean_last, early stop, and a full resume (optimizer state, LR
  controller and counters).
* Checkpoints are written by ``AsyncSaver`` (``laff_tpu``'s one-slot
  background writer): the epoch loop takes a host copy of every tensor
  of the payload, which the next step's in-place updates cannot reach,
  and hands only the pickling and the disk write to the thread.

* task3 (``--task3_caption``): each batch carries a false caption and its
  mask (``step_text``), the step adds ``_masked_margin2`` over a second
  text forward, and after each validation the negation subset's metrics
  (``<val>.caption.negationset.txt``) become ``task3_*`` history entries
  and ``task3val/*`` scalars. task2 (``--task2_intended 1``): the step
  adds ``_task2_loss`` over the concept heads' logits.

* An in-graph BERT tower (``spec.txt.bert``) starts from its local
  checkout's weights when ``name_or_path`` is one (``seeded_model``), is
  updated at lr/20 (``make_optimizer``), draws its dropout from the epoch's
  generator like every other mask, and rides the default dispatch: its
  int32 token rows sit in the text cache, and the step with it is the CUDA
  graph replayed K times.

``ScalarLogger`` writes ``scalars.tsv``, and TensorBoard events beside it
with ``LAFF_TPU_TENSORBOARD=1``. With ``LAFF_TPU_PROFILE=<dir>`` ``main``
runs epoch 1 (its steps and its validation) under ``torch.profiler`` and
writes a Chrome trace into ``<dir>``, holding the port's ``laff.*`` spans
(``utils.trace``): ``train.dispatch`` around each ``EpochStream.advance``,
inside it ``train.feed_wait`` (the batches from the ``Prefetcher``),
``train.enqueue`` (the fills and graph replays, or the eager step) and
``train.loss_read``; ``train.begin_epoch`` and ``train.open_stream``; and
the ``eval.*`` spans of ``evaluator.validate``.

Data parallelism (``main(opt, mesh=...)``, or ``--data_parallel N`` over
several cards, which launches min(N, cards) ranks through
``parallel.launch``), ``laff_tpu``'s SPMD step over a 'dp' mesh as one
process a card: every rank runs this loop on the same seeded feed and keeps
its rows of each global batch, or of the global index batch into its
replicated caches (``shard_batch(..., from_global=True)``); rank 0's
initial weights are broadcast. In the step, BatchNorm takes the global
batch's statistics and the masks the global batch's draws
(``ShardedGenerator``), the loss runs on the gathered embeddings (so the
hardest negatives range over the global batch; ``gather_rows``), and one
all-reduce of the flat gradient buffer precedes the update
(``OptaxChain``). A CUDA graph of the step captures these collectives; its
warm-up steps run them on every rank, after an eager broadcast has made
the communicator. Validation embeds each batch's rows on their ranks and
gathers them; rank 0 alone ranks, and the metric that drives the LR
controller, early stop and the best checkpoint is rank 0's, broadcast.
Only rank 0 writes files. The mesh may be one row of a seed x dp layout
(``parallel.seed_data_mesh``): "rank 0" is then the row's first rank, and
every collective runs over the row's group. ``--resume`` under a mesh
raises on every rank when only some ranks see ``model_resume.pth.tar``
(``check_shared_resume``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..data import EvalFeed, PairFeed, Prefetcher, host_cast_bf16
from ..eval.metrics import metrics_from_ranks
from ..models.layers import frozen_batch_stats
from ..ops import cosine_sim, hist_sim, l2norm, multi_head_cosine_sim
from ..ops.losses import (
    cross_entropy_loss,
    cross_entropy_loss_from_scores,
    dual_softmax_loss,
    dual_softmax_loss_from_scores,
    triplet_loss,
    triplet_loss_from_scores,
    triplet_loss_multi_space,
)
from ..parallel.mesh import (Mesh, ShardedGenerator, gather_rows, launch, replicate,
                             shard_batch)
from ..utils import AverageMeter, Progress, get_logger
from ..utils.trace import span
from .checkpoint import (average_states, checkpoint_payload, load_checkpoint, save_checkpoint,
                         save_checkpoint_dance)
from .evaluator import Embedder, validate
from .feature_cache import (DeviceTxtCache, DeviceVisCache, estimate_txt_cache_bytes,
                            estimate_vis_cache_bytes)
from .optim import LRController, OptaxChain, make_optimizer
from .predictor import resolve_device
from .prepare import Options, Prepared, check_data_parallel, prepare, seeded_model

logger = get_logger(__name__)

METRICS = ("r1", "r5", "r10", "medr", "meanr", "mir", "mAP")
CACHE_BUDGET_ENV = "LAFF_TPU_CACHE_BUDGET"
CACHE_BUDGET_DEFAULT = 4 * 1024**3  # bytes of device memory for both train caches
GRAPH_WARMUP = 3  # eager steps on a side stream before a capture (torch's advice)
TENSORBOARD_ENV = "LAFF_TPU_TENSORBOARD"  # "1": TensorBoard events beside scalars.tsv
PROFILE_ENV = "LAFF_TPU_PROFILE"  # a directory: a torch.profiler trace of epoch 1 there

Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]  # arrays, or cache row indices
# task3 rides the text batch: the false caption's arrays under this prefix,
# and 'task3_mask' (B,) int32
FALSE_PREFIX = "false_txt."


def make_loss_fn(spec):
    """(txt_embs, vis_embs) -> scalar loss, as ``laff_tpu``'s: with
    ``multi_space`` one criterion per head, summed; else the criterion on
    the head-mean score matrix (rows videos, columns captions). The triplet
    losses and the head-mean scores take ``spec.measure`` ('cosine' or
    'hist'); DSL and CE per head are cosine, as in ``laff_tpu``."""
    if spec.measure not in ("cosine", "hist"):
        raise ValueError(f"measure {spec.measure!r} is not 'cosine' or 'hist'")
    kwargs = dict(margin=spec.margin, direction=spec.direction,
                  max_violation=spec.max_violation, cost_style=spec.cost_style)

    def head_mean_scores(txt_embs: torch.Tensor, vis_embs: torch.Tensor) -> torch.Tensor:
        if spec.measure == "hist":
            return hist_sim(vis_embs.transpose(0, 1), txt_embs.transpose(0, 1)).mean(dim=0)
        return multi_head_cosine_sim(vis_embs, txt_embs)

    def loss_fn(txt_embs: torch.Tensor, vis_embs: torch.Tensor) -> torch.Tensor:
        multi_head = txt_embs.ndim == 3
        if spec.loss in ("dsl", "CELoss"):
            if multi_head and not spec.multi_space:
                scores = head_mean_scores(txt_embs, vis_embs)
                return (dual_softmax_loss_from_scores(scores) if spec.loss == "dsl"
                        else cross_entropy_loss_from_scores(scores))
            fn = dual_softmax_loss if spec.loss == "dsl" else cross_entropy_loss
            return fn(txt_embs, vis_embs).sum()  # per head (H,) -> summed
        if multi_head and spec.multi_space:
            return triplet_loss_multi_space(txt_embs, vis_embs, measure=spec.measure, **kwargs)
        if multi_head:
            return triplet_loss_from_scores(head_mean_scores(txt_embs, vis_embs), **kwargs)
        return triplet_loss(txt_embs, vis_embs, measure=spec.measure, **kwargs)

    return loss_fn


def _masked_margin2(txt_embs: torch.Tensor, vis_embs: torch.Tensor, false_embs: torch.Tensor,
                    mask: torch.Tensor, task3, epoch: torch.Tensor) -> torch.Tensor:
    """task3's per-row dual-margin negation loss (``laff_tpu``'s
    ``_masked_margin2``): cosines of each row's (true caption, video),
    (false caption, video) and (false, true caption) pairs, per head and
    summed over heads for (B, H, d) embeddings; rows with mask -1 (no
    entry) drop out, a row with mask 1 is weighted by ``neg_weight``; the
    sum over rows is scaled by batch / valid rows (reference
    ``model/model.py:942-949``) and by ``retrieval_weight``, and is 0 from
    ``epoch`` (a tensor, so a CUDA graph reads it) ``end_epoch`` on."""
    valid = (mask > -1).float()
    weight = torch.where(mask > -1, mask.float(), torch.zeros((), device=mask.device))
    weight = weight * (task3.neg_weight - 1.0) + 1.0
    t, v, f = l2norm(txt_embs), l2norm(vis_embs), l2norm(false_embs)
    s_t, s_f, s_f2 = (t * v).sum(-1), (f * v).sum(-1), (f * t).sum(-1)
    cost = torch.zeros_like(s_t)
    if task3.bottom_margin is not None:
        cost = cost + torch.clamp(task3.bottom_margin + s_f - s_t, min=0.0)
    if task3.upper_margin is not None:
        cost = cost + torch.clamp(-task3.upper_margin - s_f + s_t, min=0.0)
    if task3.bottom_margin_t2t is not None:
        cost = cost + torch.clamp(task3.bottom_margin_t2t + s_f2 - s_t, min=0.0)
    if task3.upper_margin_t2t is not None:
        cost = cost + torch.clamp(-task3.upper_margin_t2t - s_f2 + s_t, min=0.0)
    if cost.ndim == 2:  # (B, H): summed over heads
        cost = cost.sum(dim=1)
    n_valid = torch.clamp(valid.sum(), min=1.0)
    total = (cost * weight * valid).sum() / n_valid * txt_embs.shape[0]
    active = (epoch < task3.end_epoch).float()
    return total * task3.retrieval_weight * active


def _task2_loss(txt_logits: Optional[torch.Tensor], vis_logits: torch.Tensor,
                labels: torch.Tensor, task2) -> torch.Tensor:
    """task2's concept loss (``laff_tpu``'s ``_task2_loss``): BCE with
    logits of each head against the video's multi-hot labels (summed over
    concepts, averaged over the batch), plus the in-batch triplet (mean
    cost) over the heads' sigmoid probabilities under ``task2.measure``
    ('hist' or cosine), all times ``alpha``."""
    labels = labels.float()

    def bce(logits: torch.Tensor) -> torch.Tensor:
        return F.binary_cross_entropy_with_logits(logits, labels,
                                                  reduction="none").sum(dim=1).mean()

    total = bce(vis_logits)
    if txt_logits is not None:
        total = total + bce(txt_logits)
        t_prob, v_prob = torch.sigmoid(txt_logits), torch.sigmoid(vis_logits)
        scores = hist_sim(v_prob, t_prob) if task2.measure == "hist" else cosine_sim(v_prob,
                                                                                     t_prob)
        total = total + triplet_loss_from_scores(scores, cost_style="mean")
    return task2.alpha * total


def split_task3(txt: Dict[str, torch.Tensor]):
    """A step's text batch -> (txt, false_txt or None, task3_mask or None)."""
    if "task3_mask" not in txt:
        return txt, None, None
    main = {k: v for k, v in txt.items()
            if not k.startswith(FALSE_PREFIX) and k != "task3_mask"}
    false = {k[len(FALSE_PREFIX):]: v for k, v in txt.items() if k.startswith(FALSE_PREFIX)}
    return main, false, txt["task3_mask"]


def step_text(batch: Dict) -> Dict[str, np.ndarray]:
    """A feed batch's text arrays for the step: with task3 the false
    caption's arrays (under ``FALSE_PREFIX``) and 'task3_mask' join them."""
    if "false_txt" not in batch:
        return batch["txt"]
    return {**batch["txt"], **{FALSE_PREFIX + k: v for k, v in batch["false_txt"].items()},
            "task3_mask": batch["task3_mask"]}


class TrainStep:
    """One optimizer step on a batch already on the model's device:
    training-mode forward, loss, backward, update. Returns the loss as a
    tensor on the card (reading it is the caller's host sync). Puts the
    model in training mode; ``validate`` leaves it so.

    With task2 the forward is ``forward_with_concepts`` and the visual
    batch carries 'task2_labels'. With task3 the text batch carries the
    false caption (``step_text``): the text tower runs on it in training
    mode under ``frozen_batch_stats``, so it normalizes by its own batch
    statistics while the running statistics keep the main forward's update
    only, as ``laff_tpu`` keeps; its dropout draws from the same generator.
    The task3 epoch gate reads ``self.epoch``, a tensor on the model's
    device that ``set_epoch`` fills in place, so a CUDA graph of the step
    sees each epoch's value.

    With a ``mesh`` of several ranks the forwards take this rank's rows and
    draw through a ``ShardedGenerator``, and the loss terms take every
    rank's rows (``gather_rows``), so each rank computes the global batch's
    loss."""

    def __init__(self, model: torch.nn.Module, optimizer: OptaxChain, spec,
                 mesh: Optional[Mesh] = None) -> None:
        self.model = model.train()
        self.optimizer = optimizer
        self.spec = spec
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.loss_fn = make_loss_fn(spec)
        device = next(model.parameters()).device
        self.epoch = torch.zeros((), dtype=torch.int64, device=device)

    def set_epoch(self, epoch: int) -> None:
        self.epoch.fill_(epoch)

    def loss(self, txt: Dict[str, torch.Tensor], vis: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        spec, model, mesh = self.spec, self.model, self.mesh
        if mesh is not None:
            generator = ShardedGenerator(generator, mesh)
        txt, false_txt, task3_mask = split_task3(txt)
        if spec.task2 is not None:
            vis = dict(vis)
            labels = vis.pop("task2_labels")
            txt_embs, vis_embs, txt_conc, vis_conc = model.forward_with_concepts(
                txt, vis, generator)
            txt_embs, vis_embs = gather_rows(txt_embs, mesh), gather_rows(vis_embs, mesh)
            if txt_conc is not None:
                txt_conc = gather_rows(txt_conc, mesh)
            loss = self.loss_fn(txt_embs, vis_embs) + _task2_loss(
                txt_conc, gather_rows(vis_conc, mesh), gather_rows(labels, mesh), spec.task2)
        else:
            txt_embs, vis_embs = model(txt, vis, generator)
            txt_embs, vis_embs = gather_rows(txt_embs, mesh), gather_rows(vis_embs, mesh)
            loss = self.loss_fn(txt_embs, vis_embs)
        if spec.task3 is not None and false_txt is not None:
            with frozen_batch_stats(model.txt_net):
                false_embs = model.encode_txt(false_txt, generator)
            loss = loss + _masked_margin2(txt_embs, vis_embs, gather_rows(false_embs, mesh),
                                          gather_rows(task3_mask, mesh), spec.task3, self.epoch)
        return loss

    def __call__(self, txt: Dict[str, torch.Tensor], vis: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self.optimizer.zero_grad()
        loss = self.loss(txt, vis, generator)
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


def epoch_generator(device: torch.device, seed: int, epoch: int,
                    generator: Optional[torch.Generator] = None) -> torch.Generator:
    """The dropout and noise generator of one epoch, seeded by (seed,
    epoch): a resumed run draws what an uninterrupted one drew. Reseeds
    ``generator`` (the run's own, which a CUDA graph of the step is
    registered with) or makes a new one on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device)
    return generator.manual_seed(seed * 1000 + epoch)


def host_tensors(arrays: Dict[str, np.ndarray], pin: bool,
                 bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Feed arrays as CPU tensors, float ones rounded to bf16 for bf16
    towers, in pinned memory when the copies go to the card (run in the
    prefetch thread). A live tower's rows (a frozen BERT's) are on the card
    already and stay there."""
    out = host_cast_bf16(arrays, bf16)
    if not pin:
        return out
    return {k: v.pin_memory() if v.device.type == "cpu" else v for k, v in out.items()}


def host_batch(batch: Dict, pin: bool, cast_txt: bool = False,
               cast_vis: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """A featurized feed batch's arrays as CPU tensors (``host_tensors``;
    the text side through ``step_text``)."""
    return {"txt": host_tensors(step_text(batch), pin, cast_txt),
            "vis": host_tensors(batch["vis"], pin, cast_vis)}


def _map(fn, x: Batch) -> Batch:
    return fn(x) if isinstance(x, torch.Tensor) else {k: fn(v) for k, v in x.items()}


def _to(x: Batch, device: torch.device) -> Batch:
    return _map(lambda t: t.to(device, non_blocking=True), x)


# ---------------------------------------------------------------------------
# step wrappers and the K-step dispatch
# ---------------------------------------------------------------------------

def make_cached_train_step(step, vis_cache: DeviceVisCache):
    """A step that takes (B,) row indices into the visual cache in place of
    the feature arrays and gathers the rows on the card."""
    def cached(txt: Batch, vis_idx: torch.Tensor, generator=None) -> torch.Tensor:
        return step(txt, vis_cache.gather(vis_idx), generator)

    return cached


def make_txt_cached_train_step(step, txt_cache: DeviceTxtCache):
    """A step that takes (B,) caption rows of the text cache; outside the
    visual cache's wrapper a batch is two index vectors."""
    def txt_cached(txt_idx: torch.Tensor, vis: Batch, generator=None) -> torch.Tensor:
        return step(txt_cache.gather(txt_idx), vis, generator)

    return txt_cached


def pool_w2v(txt: Dict[str, torch.Tensor], table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """'w2v_ids' (B, T) rows of ``table`` and 'w2v_len' (B,) -> the mean
    'w2v' (B, D): ``table[ids].sum(1) / n``, padding on the zero sink row;
    a task3 false caption's ids (``FALSE_PREFIX``) likewise. The rows are
    added one position at a time, the order in which the host mean (numpy,
    over a caption's word vectors) adds them, so the pooled mean equals the
    fed path's bit for bit (and so do its bf16 roundings)."""
    if "w2v_ids" not in txt:
        return txt
    txt = dict(txt)
    for prefix in ("", FALSE_PREFIX):
        if prefix + "w2v_ids" not in txt:
            continue
        rows = table[txt.pop(prefix + "w2v_ids").long()]  # (B, T, D)
        n = txt.pop(prefix + "w2v_len")
        total = rows[:, 0]
        for t in range(1, rows.shape[1]):
            total = total + rows[:, t]
        txt[prefix + "w2v"] = total / n[:, None].to(table.dtype)
    return txt


def make_w2v_pooled_train_step(step, table: torch.Tensor):
    """A step whose text batch carries w2v row ids into ``table`` (on the
    step's device) and mean-pools them there."""
    def pooled(txt: Dict[str, torch.Tensor], vis: Batch, generator=None) -> torch.Tensor:
        return step(pool_w2v(txt, table), vis, generator)

    return pooled


def _fill(static: Batch, x: Batch) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(x, non_blocking=True)
        return
    for k, v in static.items():
        v.copy_(x[k], non_blocking=True)


class MultiStep:
    """K train steps per dispatch over ``step_fn`` (the base ``TrainStep``,
    possibly wrapped). Called with up to K (txt, vis) host batches (pinned
    on the card), it returns their K losses on the device.

    On the card: one CUDA graph of ``step_fn``, captured at the first call
    (or by ``capture``) and replayed once per batch. Before the capture,
    ``GRAPH_WARMUP`` eager steps run on a side stream from a snapshot of
    the parameters, buffers, optimizer state and generator, which is then
    put back. The graph is registered with the generator of the capture
    (``register_generator_state``) and replays draw from it, so every later
    call must pass that generator, reseeded by ``epoch_generator`` as the
    epochs go. A failed capture or replay raises.

    On the CPU the K steps run eagerly: the result equals K single steps,
    and the CPU tests drive ``train_one_epoch``'s grouping (K batches a
    dispatch, the short last group, loss reads across dispatches) that the
    card's graph path runs."""

    def __init__(self, step_fn, base: TrainStep, device: torch.device, k: int) -> None:
        self.step_fn = step_fn
        self.base = base
        self.device = torch.device(device)
        self.k = k
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.generator: Optional[torch.Generator] = None
        self.capture_seconds: Optional[float] = None

    def _state(self) -> List[torch.Tensor]:
        opt = self.base.optimizer
        tensors = [*self.base.model.parameters(), *self.base.model.buffers(), opt.grad,
                   opt.count, opt.nu]
        return tensors + ([opt.mu] if opt.mu is not None else [])

    def capture(self, first, generator: torch.Generator) -> None:
        """Capture the step's graph on the batch ``first``, drawing from
        ``generator``; trains nothing and leaves ``generator`` as it was."""
        if self.device.type != "cuda" or self.graph is not None:
            raise RuntimeError("capture runs once, on the card")
        t0 = time.perf_counter()
        debug = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)  # the capture itself synchronizes
        try:
            self.static_in = tuple(_map(lambda t: t.to(self.device, copy=True), x)
                                   for x in first)
            state = self._state()
            saved = [t.detach().clone() for t in state]
            rng = generator.get_state()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    self.step_fn(*self.static_in, generator)
            torch.cuda.current_stream(self.device).wait_stream(side)
            with torch.no_grad():
                for t, v in zip(state, saved):
                    t.copy_(v)
            generator.set_state(rng)
            del saved
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(generator)
            with torch.cuda.graph(graph):
                self.static_loss = self.step_fn(*self.static_in, generator)
            self.graph, self.generator = graph, generator
        finally:
            torch.cuda.set_sync_debug_mode(debug)
        self.capture_seconds = time.perf_counter() - t0
        logger.info("captured the train step as a CUDA graph in %.2f s (%d warm-up steps); "
                    "%d replays per dispatch", self.capture_seconds, GRAPH_WARMUP, self.k)

    def __call__(self, batches, generator: Optional[torch.Generator]) -> torch.Tensor:
        if len(batches) > self.k:
            raise ValueError(f"{len(batches)} batches for a {self.k}-step dispatch")
        if self.device.type != "cuda":
            return torch.stack([self.step_fn(_to(t, self.device), _to(v, self.device),
                                             generator) for t, v in batches])
        if self.graph is None:
            if generator is None:
                raise ValueError("a CUDA graph of the step needs the run's generator "
                                 "(epoch_generator)")
            self.capture(batches[0], generator)
        if generator is not self.generator:
            raise ValueError("the CUDA graph replays draws from the generator it was captured "
                             "with: pass that one, reseeded by epoch_generator")
        losses = torch.empty(len(batches), device=self.device)
        for j, batch in enumerate(batches):
            for static, x in zip(self.static_in, batch):
                _fill(static, x)
            self.graph.replay()
            losses[j].copy_(self.static_loss)
        return losses


class ScalarLogger:
    """``scalars.tsv`` in the model directory (step, tag, value per line),
    and with ``LAFF_TPU_TENSORBOARD=1`` the same scalars as TensorBoard
    events there (``laff_tpu``'s ``ScalarLogger``). Where TensorBoard does
    not import, it logs a warning and writes the TSV alone, where
    ``laff_tpu`` says nothing."""

    def __init__(self, logdir: str) -> None:
        self.path = os.path.join(logdir, "scalars.tsv")
        self._fh = open(self.path, "a")
        self._tb = None
        if os.environ.get(TENSORBOARD_ENV) == "1":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                logger.warning("%s=1 but TensorBoard does not import (%s): writing %s only",
                               TENSORBOARD_ENV, e, self.path)
            else:
                self._tb = SummaryWriter(log_dir=logdir, flush_secs=5)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(f"{step}\t{tag}\t{value}\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


class _NullScalarLogger:
    """A rank other than 0 of a data-parallel run writes no scalars."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class EpochStream:
    """One epoch of ``train_one_epoch``, a dispatch at a time: each
    ``advance`` sends the next K batches (one with no ``multi_step``) to the
    card, the epoch's last group with fewer, and returns False once the
    epoch is through; ``finish`` reads the losses still on the card and
    returns (mean loss, steps run). ``engine.sweep`` advances several runs'
    streams in turn; ``train_one_epoch`` drains one."""

    def __init__(self, step, feed: PairFeed, epoch: int, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 scalar_log: Optional[ScalarLogger] = None, log_every: int = 50,
                 prefetch_depth: int = 3, step0: int = 0, sync_debug: bool = False,
                 multi_step: Optional[MultiStep] = None,
                 vis_cache: Optional[DeviceVisCache] = None,
                 txt_cache: Optional[DeviceTxtCache] = None,
                 cast_txt: bool = False, cast_vis: bool = False,
                 mesh: Optional[Mesh] = None) -> None:
        self.step, self.multi_step, self.device = step, multi_step, device
        self.generator, self.scalar_log = generator, scalar_log
        self.log_every, self.step0 = log_every, step0
        self.batch_size = feed.batch_size
        self.meter = AverageMeter()
        self.progress = Progress(feed.steps_per_epoch() * feed.batch_size, f"epoch {epoch}")
        self.debug = sync_debug and device.type == "cuda"
        self.k = multi_step.k if multi_step is not None else 1
        self.pending: List[torch.Tensor] = []
        self.n = self.n_pending = 0
        self.epoch, self.dispatches = epoch, 0
        self.done = False
        pin = device.type == "cuda"

        def host_args(batch):  # in the prefetch thread
            txt = (txt_cache.indices(batch["cap_ids"]) if txt_cache is not None
                   else host_tensors(step_text(batch), pin, cast_txt))
            vis = (vis_cache.indices(batch["vis_ids"]) if vis_cache is not None
                   else host_tensors(batch["vis"], pin, cast_vis))
            if mesh is not None:  # this rank's rows of the global batch
                txt, vis = (shard_batch(x, mesh, from_global=True) for x in (txt, vis))
            return txt, vis

        self.batches = Prefetcher((host_args(b) for b in feed.epoch(epoch)),
                                  depth=prefetch_depth)

    def _read(self, in_window: bool) -> None:
        with span("train.loss_read"):
            if in_window and self.debug:
                torch.cuda.set_sync_debug_mode(0)
            vals = torch.cat(self.pending).cpu().numpy()
            if in_window and self.debug:
                torch.cuda.set_sync_debug_mode("error")
            for v in vals:
                self.meter.update(float(v))
            if self.scalar_log is not None:
                self.scalar_log.add_scalar("train/Loss", float(vals[-1]), self.step0 + self.n)
            self.pending.clear()
            self.n_pending = 0

    def _dispatch(self, batches) -> None:
        if self.multi_step is not None:
            self.pending.append(self.multi_step(batches, self.generator))
        else:
            txt, vis = batches[0]
            self.pending.append(self.step(_to(txt, self.device), _to(vis, self.device),
                                          self.generator)[None])
        self.n += len(batches)
        self.n_pending += len(batches)

    def advance(self) -> bool:
        if self.done:
            return False
        group = []
        if self.debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with span("train.dispatch", f"epoch={self.epoch} dispatch={self.dispatches}"):
                with span("train.feed_wait"):
                    for args in self.batches:
                        group.append(args)
                        self.progress.add(self.batch_size)
                        if len(group) == self.k:
                            break
                if group:
                    with span("train.enqueue"):
                        self._dispatch(group)
                    if self.n_pending >= self.log_every:
                        self._read(True)
        finally:
            if self.debug:
                torch.cuda.set_sync_debug_mode(0)
        self.dispatches += 1
        self.done = len(group) < self.k  # the prefetcher is through: never read it again
        return bool(group)

    def finish(self):
        if self.pending:
            self._read(False)
        return self.meter.avg, self.n


def train_one_epoch(step, feed: PairFeed, epoch: int, device: torch.device,
                    generator: Optional[torch.Generator] = None,
                    scalar_log: Optional[ScalarLogger] = None, log_every: int = 50,
                    prefetch_depth: int = 3, step0: int = 0, sync_debug: bool = False,
                    multi_step: Optional[MultiStep] = None,
                    vis_cache: Optional[DeviceVisCache] = None,
                    txt_cache: Optional[DeviceTxtCache] = None,
                    cast_txt: bool = False, cast_vis: bool = False,
                    mesh: Optional[Mesh] = None):
    """One epoch (``laff_tpu``'s ``train_one_epoch``). A side held by a cache
    goes to ``step`` as its (B,) row indices, else as its arrays (float
    ones rounded to bf16 on the host with ``cast_txt`` / ``cast_vis``).
    With ``multi_step`` the batches go K at a time to one dispatch, the
    epoch's last group with fewer; else one step each. The losses stay on
    the card and are read once every ``log_every`` steps; with
    ``sync_debug`` (on the card) the steps between two reads run under
    ``set_sync_debug_mode("error")``, so any host sync in them raises.
    With a ``mesh`` each rank steps on its rows of every batch. Returns
    (mean loss, steps run)."""
    stream = EpochStream(step, feed, epoch, device, generator, scalar_log, log_every,
                         prefetch_depth, step0, sync_debug, multi_step, vis_cache, txt_cache,
                         cast_txt, cast_vis, mesh)
    while stream.advance():
        pass
    return stream.finish()


def host_copy(tensors) -> Dict[str, torch.Tensor]:
    """(name, tensor) pairs -> a dict of CPU copies, which in-place updates
    of the originals cannot reach (``.cpu()`` of a CPU tensor would be the
    tensor itself)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors}


class AsyncSaver:
    """One-slot background checkpoint writer (``laff_tpu``'s
    ``_AsyncSaver``): ``submit`` joins the write in flight, then runs
    ``fn(*args)`` in a thread, so writes keep their order and at most one
    is in flight; ``join`` waits for it and raises what it raised. The
    caller hands over host copies: the parameters and the optimizer state
    change in place from the next step on (``OptaxChain.step``, a graph's
    replays)."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn, *args, **kwargs) -> None:
        self.join()

        def run() -> None:
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # re-raised by join in the epoch loop
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def join_quietly(self) -> None:
        """``join`` for a loop already unwinding from its own error: a
        failed write is logged, so the loop's error stays the one raised."""
        try:
            self.join()
        except BaseException as e:
            logger.error("a background checkpoint write failed: %r", e)


def _check_fits(what: str, nbytes: int, device: torch.device) -> None:
    """A cache the caller forced on must fit the card's free memory."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if nbytes > free:
            raise RuntimeError(f"--{what} 1: the cache needs {nbytes} bytes, the card has "
                               f"{free} free")


def setup_dispatch(opt: Options, prepared: Prepared, base: TrainStep, device: torch.device,
                   cast_txt: bool, cast_vis: bool, shared: Optional[Dict] = None) -> Dict:
    """``laff_tpu``'s dispatch rules (``trainer.py:862-946``): the caches,
    the step wrappers around ``base``, K, the prefetch depth. task3 draws
    new false captions and augmented captions every epoch, so its text side
    is not cached: auto declines the text cache and ``--device_text_cache
    1`` raises; task2's labels ride the visual cache. Returns
    {step, fed_step, multi_step, vis_cache, txt_cache, w2v_table,
    steps_per_dispatch, prefetch_depth}; turns the train feed's
    featurization off for the sides a cache holds. ``shared``, another
    run's dispatch over the same prepared data, lends its caches and w2v
    table instead of building new ones (``engine.sweep``)."""
    if shared is not None:
        return _wrap_dispatch(opt, prepared, base, device, shared["vis_cache"],
                              shared["txt_cache"], shared["w2v_table"])
    feed = prepared.train_feed
    w2v_table = None
    if prepared.w2v_table is not None:
        w2v_table = torch.from_numpy(prepared.w2v_table).to(device)
    budget = int(os.environ.get(CACHE_BUDGET_ENV, CACHE_BUDGET_DEFAULT))

    vis_cache = None
    want_vis = int(opt.device_feature_cache)
    if want_vis:
        vis_bytes = estimate_vis_cache_bytes(feed.vis_batcher, bf16=cast_vis)
    if want_vis == -1:
        want_vis = int(vis_bytes <= budget)
        if not want_vis:
            logger.info("device feature cache declined: %d bytes estimated, budget %d (%s)",
                        vis_bytes, budget, CACHE_BUDGET_ENV)
    if want_vis:
        _check_fits("device_feature_cache", vis_bytes, device)
        vis_cache = DeviceVisCache(feed.vis_batcher, device, bf16=cast_vis)

    txt_cache = None
    want_txt = int(opt.device_text_cache)
    txt_deterministic = prepared.spec.task3 is None
    if want_txt and not txt_deterministic:
        if want_txt == 1:
            raise ValueError(
                "--device_text_cache 1 is incompatible with task3 (negation augmentation "
                "substitutes captions per epoch, so a once-built HBM cache would go stale). "
                "Use 0 or -1 (auto).")
        want_txt = 0
        logger.info("device text cache declined: task3 draws the captions each epoch")
    if want_txt == -1 and vis_cache is None:
        want_txt = 0  # text rows alone do not help while the visual features stream
    if want_txt:
        txt_bytes = estimate_txt_cache_bytes(feed.text_batcher, cap_ids=feed.cap_ids,
                                             bf16=cast_txt)
    if want_txt == -1:
        want_txt = int(txt_bytes + vis_cache.nbytes <= budget)
        if not want_txt:
            logger.info("device text cache declined: %d + %d bytes estimated, budget %d (%s)",
                        txt_bytes, vis_cache.nbytes, budget, CACHE_BUDGET_ENV)
    if want_txt:
        _check_fits("device_text_cache", txt_bytes, device)
        txt_cache = DeviceTxtCache(feed.text_batcher, device, cap_ids=feed.cap_ids,
                                   bf16=cast_txt)
    return _wrap_dispatch(opt, prepared, base, device, vis_cache, txt_cache, w2v_table)


def _wrap_dispatch(opt: Options, prepared: Prepared, base: TrainStep, device: torch.device,
                   vis_cache: Optional[DeviceVisCache], txt_cache: Optional[DeviceTxtCache],
                   w2v_table: Optional[torch.Tensor]) -> Dict:
    """``setup_dispatch``'s step wrappers, K and prefetch depth around
    ``base`` over caches already built."""
    feed = prepared.train_feed
    step = base
    if w2v_table is not None:
        step = make_w2v_pooled_train_step(step, w2v_table)
    fed_step = step
    if vis_cache is not None:
        step = make_cached_train_step(step, vis_cache)
    if txt_cache is not None:
        step = make_txt_cached_train_step(step, txt_cache)
    feed.featurize_txt = txt_cache is None
    feed.featurize_vis = vis_cache is None

    both = vis_cache is not None and txt_cache is not None
    spd = int(opt.steps_per_dispatch)
    if spd <= 0:  # auto: K steps per dispatch once batches are index-only
        spd = min(8, max(1, feed.steps_per_epoch())) if both else 1
    multi_step = MultiStep(step, base, device, spd) if spd > 1 else None
    prefetch_depth = max(2, int(opt.workers) + 1)
    if spd > 1 and both:  # index-only batches: keep a whole group (+ slack) queued
        prefetch_depth = max(prefetch_depth, spd + 2)
    logger.info("dispatch: visual cache %s, text cache %s, %d steps per dispatch (%s), "
                "prefetch depth %d", "on" if vis_cache else "off",
                "on" if txt_cache else "off", spd,
                "eager" if multi_step is None or device.type != "cuda" else "CUDA graph",
                prefetch_depth)
    return {"step": step, "fed_step": fed_step, "multi_step": multi_step,
            "vis_cache": vis_cache, "txt_cache": txt_cache, "w2v_table": w2v_table,
            "steps_per_dispatch": spd, "prefetch_depth": prefetch_depth}


def read_negationset(path: Optional[str]) -> Optional[set]:
    """task3's validation subset: the caption ids of
    ``<val>.caption.negationset.txt``; None (with a warning) when the file
    is missing."""
    if not path:
        return None
    if not os.path.exists(path):
        logger.warning("task3 negationset file missing, skipping the in-training negation "
                       "metrics: %s", path)
        return None
    with open(path) as fh:
        ids = {line.strip().split(" ", 1)[0] for line in fh if line.strip()}
    logger.info("task3 negation validation subset: %d caption ids (%s)", len(ids), path)
    return ids


def negation_subset_metrics(metrics: Dict, negationset: set):
    """(metrics, n): the validation metrics over the n captions of the
    negation subset, from the ranks ``validate`` counted (no second
    ranking); (None, 0) when no validation caption is in the set."""
    sel = np.asarray([t in negationset for t in metrics["txt_ids"]])
    if not sel.any():
        return None, 0
    ranks = np.asarray(metrics["ranks"])[sel]
    return dict(zip(METRICS, metrics_from_ranks(ranks))), int(sel.sum())


def warm_start(model: torch.nn.Module, path: str) -> Dict:
    """``--pretrained_file_path``: the parameters, BatchNorm statistics and
    residual weights of a port checkpoint or a reference ``.pth.tar``
    (``laff_tpu/engine/trainer.py:836-845``) into ``model``, strictly.
    Returns the loaded checkpoint."""
    ckpt = load_checkpoint(path)
    model.load_state_dict(ckpt["state_dict"])
    logger.info("warm-started from %s (epoch %s)", path, ckpt.get("epoch"))
    return ckpt


def check_shared_resume(mesh: Mesh, resume_path: str, exists: bool) -> None:
    """``--resume`` under a mesh is decided for every rank together: only
    rank 0 writes ``model_resume.pth.tar``, so on a filesystem the ranks do
    not share, rank 0 would resume at epoch N while the others start at 0
    and their collectives diverge. Raises on every rank unless all of them
    see the file, or none does (``laff_tpu``'s guard)."""
    flags = mesh.all_gather(torch.tensor([int(exists)], dtype=torch.int32, device=mesh.device))
    seen = int(flags.sum())
    if seen not in (0, mesh.size):
        raise RuntimeError(
            f"--resume with {mesh.size} processes: {resume_path} is visible to only "
            f"{seen}/{mesh.size} processes. Multi-process resume requires model_path on a "
            "shared filesystem (process 0 owns the checkpoint writes).")


class TrainRun:
    """One run of ``main``'s epoch loop, an epoch at a time: the seeded model
    (its GRU embedding from ``prepared.we``), the warm start, the optimizer,
    the dispatch, the LR controller, the best / early-stop counters, the
    checkpoints and logs in ``prepared.model_path``. ``main`` drives one;
    ``engine.sweep.sweep_main`` drives several over the same data, each with
    its own seed, feed and model directory, the device caches lent by the
    first (``shared``) and the validation feeds (``val_feeds``) staged once
    for all.

    Per epoch: ``begin_epoch``, then ``train_epoch`` (or the dispatches of
    ``epoch_stream`` and ``finish_stream``), then ``end_epoch``, which
    validates, writes and returns True once the run stops; ``close`` and
    ``result`` at the end.

    With a ``mesh`` of several ranks (on ``mesh.device``) the run is one
    rank of a data-parallel run (see the module docstring); only rank 0
    writes."""

    def __init__(self, opt: Options, prepared: Prepared, device: torch.device,
                 prepare_seconds: float = 0.0, shared: Optional[Dict] = None,
                 val_feeds: Optional[tuple] = None, mesh: Optional[Mesh] = None) -> None:
        self.opt, self.prepared, self.device = opt, prepared, device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.is_main = self.mesh is None or self.mesh.is_main
        config, spec = prepared.config, prepared.spec
        self.config, self.spec, self.model_path = config, spec, prepared.model_path
        model = seeded_model(spec, opt.random_seed, prepared.we)
        bert = model.txt_net.bert
        pretrained_bert = bert.imported_from if bert is not None else None
        if opt.pretrained_file_path != "None":
            warm_start(model, opt.pretrained_file_path)
        self.model = model.to(device)
        if self.mesh is not None:  # an eager collective: it also makes the communicator
            replicate(model, self.mesh)
        bf16 = "bfloat16" in (spec.txt.compute_dtype, spec.vis.compute_dtype)
        self.optimizer = make_optimizer(config, model, bf16=bf16, mesh=self.mesh)
        self.base = TrainStep(model, self.optimizer, spec, mesh=self.mesh)
        # bf16 towers round their inputs to bf16 as their first op: rounding on
        # the host gives the same tensors and halves the bytes to the card
        self.cast_txt = spec.txt.compute_dtype == "bfloat16"
        self.cast_vis = spec.vis.compute_dtype == "bfloat16"
        self.dispatch = setup_dispatch(opt, prepared, self.base, device, self.cast_txt,
                                       self.cast_vis, shared=shared)
        multiple = int(getattr(config, "device_batch_multiple", 1) or 1)
        if self.mesh is not None:  # equal rows on every rank
            multiple = max(multiple, self.mesh.size)
        if opt.batch_size % multiple:
            raise ValueError(f"batch_size {opt.batch_size} must be a multiple of {multiple} "
                             f"(config.device_batch_multiple / the data-parallel ranks)")

        self.lr_ctl = LRController(config.lr, config.lr_decay_rate)
        self.val_feeds = val_feeds or validation_feeds(opt, prepared)
        self.embedder = Embedder(model, device, prefetch_depth=max(2, int(opt.workers) + 1),
                                 mesh=self.mesh)
        self.generator = torch.Generator(device=device)  # reseeded each epoch
        self.negationset = read_negationset(prepared.negationset_path)
        self.best_perf, self.no_impr, self.mean_last = 0.0, 0, []
        self.start_epoch = self.global_step = 0
        self.resume_path = os.path.join(self.model_path, "model_resume.pth.tar")
        resume_exists = os.path.exists(self.resume_path)
        if opt.resume and self.mesh is not None:
            check_shared_resume(self.mesh, self.resume_path, resume_exists)
        if opt.resume and resume_exists:
            rk = load_checkpoint(self.resume_path)
            model.load_state_dict(rk["state_dict"])
            self.optimizer.load_state_dict(rk["optimizer"])
            self.lr_ctl.__dict__.update(rk["lr_ctl"])
            self.best_perf, self.no_impr = rk["best_perf"], rk["no_impr"]
            self.mean_last = rk["mean_last"]
            self.start_epoch, self.global_step = rk["epoch"], rk["global_step"]
            logger.info("resumed from %s at epoch %d (best %.4f)", self.resume_path,
                        self.start_epoch, self.best_perf)
        self.opt_dict = dataclasses.asdict(opt)
        vis_cache, txt_cache = self.dispatch["vis_cache"], self.dispatch["txt_cache"]
        self.stopped = False
        self.results = {
            "best_perf": self.best_perf, "epochs": self.start_epoch,
            "prepare_seconds": round(prepare_seconds, 1), "history": [],
            "pretrained_bert": pretrained_bert,
            "dispatch": {
                "vis_cache_bytes": vis_cache.nbytes if vis_cache else None,
                "vis_cache_seconds": vis_cache.build_seconds if vis_cache else None,
                "txt_cache_bytes": txt_cache.nbytes if txt_cache else None,
                "txt_cache_seconds": txt_cache.build_seconds if txt_cache else None,
                "steps_per_dispatch": self.dispatch["steps_per_dispatch"],
                "graph": self.dispatch["multi_step"] is not None and device.type == "cuda",
                "stage_val_features": bool(opt.stage_val_features)}}
        self.saver = AsyncSaver()
        self.scalar_log = ScalarLogger(self.model_path) if self.is_main else _NullScalarLogger()
        self.hist = (open(os.path.join(self.model_path, "val_perf_hist.txt"),
                          "a" if self.start_epoch else "w") if self.is_main else None)

    def ckpt_payload(self, epoch: int) -> Dict:
        """The checkpoint with host copies of the weights, taken now."""
        payload = checkpoint_payload(host_copy(self.model.state_dict().items()), self.spec,
                                     self.config, self.prepared.featurizers, self.opt_dict)
        payload.update(epoch=epoch + 1, best_perf=self.best_perf)
        return payload

    def begin_epoch(self, epoch: int) -> None:
        with span("train.begin_epoch", f"epoch={epoch}"):
            self.t_epoch = time.time()
            self.lr = self.lr_ctl.current()
            self.optimizer.set_learning_rate(self.lr)
            anneal_schedule(self.model, self.config.txt_attention_global_decay_rate)
            self.base.set_epoch(epoch)
            self.scalar_log.add_scalar("train/learning_rate", self.lr, epoch)
            logger.info("Epoch %d/%d lr=%.6g", epoch, self.opt.num_epochs, self.lr)

    def epoch_stream(self, epoch: int) -> EpochStream:
        """The epoch's main feed as an ``EpochStream`` of this run's dispatch."""
        d, opt = self.dispatch, self.opt
        with span("train.open_stream", f"epoch={epoch}"):
            return EpochStream(
                d["step"], self.prepared.train_feed, epoch, self.device,
                generator=epoch_generator(self.device, opt.random_seed, epoch, self.generator),
                scalar_log=self.scalar_log, prefetch_depth=d["prefetch_depth"],
                step0=self.global_step, sync_debug=bool(opt.sync_debug),
                multi_step=d["multi_step"], vis_cache=d["vis_cache"], txt_cache=d["txt_cache"],
                cast_txt=self.cast_txt, cast_vis=self.cast_vis, mesh=self.mesh)

    def finish_stream(self, stream: EpochStream):
        loss, steps = stream.finish()
        self.global_step += steps
        return loss, steps

    def train_epoch(self, epoch: int):
        """The epoch's steps: the main feed, then ``trainCollection2``'s in
        single fed steps, as laff_tpu. Returns (main feed's mean loss, its
        steps)."""
        stream = self.epoch_stream(epoch)
        while stream.advance():
            pass
        train_loss, steps = self.finish_stream(stream)
        opt = self.opt
        if self.prepared.train2_feed is not None:
            _, steps2 = train_one_epoch(
                self.dispatch["fed_step"], self.prepared.train2_feed, epoch, self.device,
                generator=epoch_generator(self.device, opt.random_seed, epoch, self.generator),
                scalar_log=self.scalar_log, prefetch_depth=max(2, int(opt.workers) + 1),
                step0=self.global_step, sync_debug=bool(opt.sync_debug),
                cast_txt=self.cast_txt, cast_vis=self.cast_vis, mesh=self.mesh)
            self.global_step += steps2
        return train_loss, steps

    def end_epoch(self, epoch: int, train_loss: float, steps: int, epoch_time: float) -> bool:
        """Validation, the logs, the LR controller, the checkpoints and the
        early stop of one epoch; True once the run stops."""
        opt, model_path, scalar_log = self.opt, self.model_path, self.scalar_log
        t0 = time.time()
        val_txt_feed, val_vis_feed = self.val_feeds
        # decided once: under a mesh rank 0 ranks and every rank takes its metrics
        metrics = validate(self.embedder, val_txt_feed, val_vis_feed, measure=self.spec.measure,
                           rank_path=opt.rank_path)
        val_time = time.time() - t0
        cur_perf = metrics[opt.metric]
        for tag in METRICS:
            scalar_log.add_scalar(f"val/{tag}", metrics[tag], epoch)
        logger.info("epoch %d: loss=%.3f r1=%.2f r5=%.2f r10=%.2f medr=%.0f mir=%.4f "
                    "(%.1fs train, %.1fs validate)", epoch, train_loss, metrics["r1"],
                    metrics["r5"], metrics["r10"], metrics["medr"], metrics["mir"],
                    epoch_time, val_time)
        if self.hist is not None:
            self.hist.write("epoch_%d:\nText2Video(%s): %f\n" % (epoch, opt.metric, cur_perf))
            self.hist.flush()
        entry = {"epoch": epoch, "loss": float(train_loss), "lr": float(self.lr), "steps": steps,
                 "train_seconds": round(epoch_time, 2), "val_seconds": round(val_time, 2),
                 **{k: float(metrics[k]) for k in METRICS}}
        if self.negationset is not None and self.is_main:  # from rank 0's ranks
            t3, n_sub = negation_subset_metrics(metrics, self.negationset)
            if n_sub:
                for tag, v in t3.items():
                    scalar_log.add_scalar(f"task3val/{tag}", v, epoch)
                entry.update({f"task3_{k}": float(v) for k, v in t3.items()})
                logger.info("epoch %d negation subset (%d caps): r1=%.2f mir=%.4f", epoch,
                            n_sub, t3["r1"], t3["mir"])
        self.results["history"].append(entry)

        self.lr_ctl.step(cur_perf)
        is_best = cur_perf > self.best_perf
        self.best_perf = max(cur_perf, self.best_perf)
        if is_best:
            if self.is_main:
                self.saver.submit(save_checkpoint_dance, self.ckpt_payload(epoch), True,
                                  logdir=model_path, filename=f"checkpoint_epoch_{epoch}.pth.tar")
            self.no_impr = 0
            self.mean_last = []
        elif opt.save_mean_last == 1:
            self.mean_last.append(host_copy(self.model.named_parameters()))
            if len(self.mean_last) > 1 and self.is_main:
                payload = self.ckpt_payload(epoch)
                payload["state_dict"].update(average_states(self.mean_last))
                self.saver.submit(save_checkpoint, payload,
                                  os.path.join(model_path, "mean_last10.pth.tar"))

        self.no_impr += 1
        entry["wall_seconds"] = round(time.time() - self.t_epoch, 2)
        if opt.resume and self.is_main:
            payload = self.ckpt_payload(epoch)
            payload.update(optimizer=self.optimizer.state_dict(), global_step=self.global_step,
                           lr_ctl=dict(self.lr_ctl.__dict__), no_impr=self.no_impr,
                           mean_last=list(self.mean_last))
            self.saver.submit(save_checkpoint, payload, self.resume_path)
        if self.no_impr > opt.early_stop_patience or epoch == opt.num_epochs - 1:
            self.saver.join()
            if self.is_main:
                save_checkpoint_dance(self.ckpt_payload(epoch), is_best=False, logdir=model_path,
                                      filename=f"checkpoint_epoch_{epoch}.pth.tar",
                                      only_best=True)
            logger.info("Early stopping or finished at epoch %d.", epoch)
            self.results["epochs"] = epoch + 1
            self.stopped = True
        return self.stopped

    def close(self) -> None:
        if self.hist is not None:
            self.hist.close()
        self.scalar_log.close()

    def result(self) -> Dict:
        """Writes ``val_perf.txt``; the run's result (``main``'s)."""
        message = "best performance on validation:\n Text to video(%s): %f" % (
            self.opt.metric, self.best_perf)
        logger.info(message)
        if self.is_main:
            with open(os.path.join(self.model_path, "val_perf.txt"), "w") as fh:
                fh.write(message)
        multi_step = self.dispatch["multi_step"]
        result = self.results
        result["dispatch"]["capture_seconds"] = (multi_step.capture_seconds if multi_step
                                                 else None)
        result["best_perf"] = self.best_perf
        result["model_path"] = self.model_path
        result["model"] = self.model
        return result


def validation_feeds(opt: Options, prepared: Prepared):
    """The validation caption and video feeds; the features do not change
    between epochs, so they are kept on the card after the first pass
    (budget-guarded, the same tensors replayed)."""
    eval_batch = getattr(prepared.config, "eval_batch_size", 1024)
    val_txt_feed = EvalFeed(prepared.val_txt_source.cap_ids, prepared.val_txt_batcher,
                            batch_size=eval_batch)
    val_vis_feed = EvalFeed(prepared.val_vis_ids, prepared.val_vis_batcher,
                            batch_size=eval_batch)
    val_txt_feed.stage_on_device = val_vis_feed.stage_on_device = bool(opt.stage_val_features)
    return val_txt_feed, val_vis_feed


@contextlib.contextmanager
def profiled(path: Optional[str], device: torch.device):
    """The block under ``torch.profiler`` (the card's activity too on a
    card, operator inputs recorded so the spans keep their ids), its Chrome
    trace written to ``path``; with no ``path`` the block alone."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def _main_rank(mesh: Mesh, opt: Options) -> Dict:
    """One rank of a launched data-parallel ``main``: its result without the
    model (rank 0's is returned to the launcher's caller)."""
    result = main(opt, mesh=mesh)
    result.pop("model")
    return result


def prepare_ranks(opt: Options, mesh: Optional[Mesh]) -> Prepared:
    """``prepare`` in every rank, rank 0 first: it may write the
    vocabularies, which the others then read."""
    if mesh is None or mesh.size == 1:
        return prepare(opt)
    prepared = prepare(opt) if mesh.is_main else None
    mesh.barrier()
    return prepared if prepared is not None else prepare(opt)


def main(opt: Options, prepared: Optional[Prepared] = None, mesh: Optional[Mesh] = None
         ) -> Dict:
    """A full training run (reference ``trainer.main``). Returns
    {best_perf, epochs, prepare_seconds, history (one entry per epoch:
    loss, lr, steps, metrics, train/val/wall seconds), dispatch (what the
    dispatch rules chose: cache bytes and build seconds, K, graph, staged
    validation, the graph's capture seconds), pretrained_bert (the checkout an in-graph BERT tower
    started from, or None), model_path, model (the trained model)}.

    With ``mesh``, this process is one rank of a data-parallel run (on
    ``mesh.device``; ``prepared`` must be its own). Without one,
    ``--data_parallel`` over several visible cards launches min(N, cards)
    ranks, each running this with its mesh, and returns rank 0's result,
    whose 'model' is None (the trained weights are in its checkpoints)."""
    if mesh is None:
        ranks = check_data_parallel(opt.data_parallel, opt.device)
        if ranks > 1:
            if prepared is not None:
                raise ValueError("a data-parallel run prepares in each rank: pass no prepared")
            result = launch(ranks, _main_rank, opt, device=opt.device)
            result["model"] = None
            return result
    device = mesh.device if mesh is not None else resolve_device(opt.device)
    t_prepare = time.time()
    if prepared is None:
        prepared = prepare_ranks(opt, mesh)
    run = TrainRun(opt, prepared, device, prepare_seconds=time.time() - t_prepare, mesh=mesh)
    profile_dir = os.environ.get(PROFILE_ENV)
    rank = mesh.rank if mesh is not None else 0
    try:
        for epoch in range(run.start_epoch, opt.num_epochs):
            # epoch 1: the steady state, after epoch 0's first use of every path
            trace = (os.path.join(profile_dir, f"epoch_1.rank_{rank}.json")
                     if profile_dir and epoch == 1 else None)
            with profiled(trace, device):
                run.begin_epoch(epoch)
                t0 = time.time()
                train_loss, steps = run.train_epoch(epoch)
                stopped = run.end_epoch(epoch, train_loss, steps, time.time() - t0)
            if stopped:
                break
        run.saver.join()
    except BaseException:
        run.saver.join_quietly()
        raise
    finally:
        run.close()
    return run.result()
