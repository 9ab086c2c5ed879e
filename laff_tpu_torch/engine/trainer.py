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
  indices of) the next batches in a prefetch thread meanwhile.
* ``main`` runs the reference epoch loop (``trainer.py:315-443``) with
  ``laff_tpu``'s dispatch rules (``trainer.py:862-946``): the caches when
  their estimate fits ``LAFF_TPU_CACHE_BUDGET`` (4 GiB), the text cache
  only beside the visual one, K = min(8, steps) only with both; then set
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

Left for later slices (ROADMAP Queue 1): task2 and task3, data_parallel,
the BERT lr/20 mask, and TensorBoard (``scalars.tsv`` only).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data import EvalFeed, PairFeed, Prefetcher, host_cast_bf16
from ..ops import hist_sim, multi_head_cosine_sim
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
from .feature_cache import (DeviceTxtCache, DeviceVisCache, estimate_txt_cache_bytes,
                            estimate_vis_cache_bytes)
from .optim import LRController, OptaxChain, make_optimizer
from .predictor import resolve_device
from .prepare import Options, Prepared, prepare, seeded_model

logger = get_logger(__name__)

METRICS = ("r1", "r5", "r10", "medr", "meanr", "mir", "mAP")
CACHE_BUDGET_ENV = "LAFF_TPU_CACHE_BUDGET"
CACHE_BUDGET_DEFAULT = 4 * 1024**3  # bytes of device memory for both train caches
GRAPH_WARMUP = 3  # eager steps on a side stream before a capture (torch's advice)

Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]  # arrays, or cache row indices


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
    prefetch thread)."""
    out = host_cast_bf16(arrays, bf16)
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def host_batch(batch: Dict, pin: bool, cast_txt: bool = False,
               cast_vis: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """A featurized feed batch's arrays as CPU tensors (``host_tensors``)."""
    return {"txt": host_tensors(batch["txt"], pin, cast_txt),
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
    'w2v' (B, D): ``table[ids].sum(1) / n``, padding on the zero sink row.
    The rows are added one position at a time, the order in which the host
    mean (numpy, over a caption's word vectors) adds them, so the pooled
    mean equals the fed path's bit for bit (and so do its bf16 roundings)."""
    if "w2v_ids" not in txt:
        return txt
    txt = dict(txt)
    rows = table[txt.pop("w2v_ids").long()]  # (B, T, D)
    n = txt.pop("w2v_len")
    total = rows[:, 0]
    for t in range(1, rows.shape[1]):
        total = total + rows[:, t]
    txt["w2v"] = total / n[:, None].to(table.dtype)
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
    """``scalars.tsv`` in the model directory: step, tag, value per line."""

    def __init__(self, logdir: str) -> None:
        self._fh = open(os.path.join(logdir, "scalars.tsv"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(f"{step}\t{tag}\t{value}\n")

    def close(self) -> None:
        self._fh.close()


def train_one_epoch(step, feed: PairFeed, epoch: int, device: torch.device,
                    generator: Optional[torch.Generator] = None,
                    scalar_log: Optional[ScalarLogger] = None, log_every: int = 50,
                    prefetch_depth: int = 3, step0: int = 0, sync_debug: bool = False,
                    multi_step: Optional[MultiStep] = None,
                    vis_cache: Optional[DeviceVisCache] = None,
                    txt_cache: Optional[DeviceTxtCache] = None,
                    cast_txt: bool = False, cast_vis: bool = False):
    """One epoch (``laff_tpu``'s ``train_one_epoch``). A side held by a cache
    goes to ``step`` as its (B,) row indices, else as its arrays (float
    ones rounded to bf16 on the host with ``cast_txt`` / ``cast_vis``).
    With ``multi_step`` the batches go K at a time to one dispatch, the
    epoch's last group with fewer; else one step each. The losses stay on
    the card and are read once every ``log_every`` steps; with
    ``sync_debug`` (on the card) the steps between two reads run under
    ``set_sync_debug_mode("error")``, so any host sync in them raises.
    Returns (mean loss, steps run)."""
    meter = AverageMeter()
    progress = Progress(feed.steps_per_epoch() * feed.batch_size, f"epoch {epoch}")
    pin = device.type == "cuda"
    debug = sync_debug and device.type == "cuda"
    pending, group = [], []
    n = n_pending = 0

    def host_args(batch):  # in the prefetch thread
        txt = (txt_cache.indices(batch["cap_ids"]) if txt_cache is not None
               else host_tensors(batch["txt"], pin, cast_txt))
        vis = (vis_cache.indices(batch["vis_ids"]) if vis_cache is not None
               else host_tensors(batch["vis"], pin, cast_vis))
        return txt, vis

    def read(in_window: bool) -> None:
        nonlocal n_pending
        if in_window and debug:
            torch.cuda.set_sync_debug_mode(0)
        vals = torch.cat(pending).cpu().numpy()
        if in_window and debug:
            torch.cuda.set_sync_debug_mode("error")
        for v in vals:
            meter.update(float(v))
        if scalar_log is not None:
            scalar_log.add_scalar("train/Loss", float(vals[-1]), step0 + n)
        pending.clear()
        n_pending = 0

    def dispatch(batches) -> None:
        nonlocal n, n_pending
        if multi_step is not None:
            pending.append(multi_step(batches, generator))
        else:
            txt, vis = batches[0]
            pending.append(step(_to(txt, device), _to(vis, device), generator)[None])
        n += len(batches)
        n_pending += len(batches)

    batches = Prefetcher((host_args(b) for b in feed.epoch(epoch)), depth=prefetch_depth)
    k = multi_step.k if multi_step is not None else 1
    try:
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        for args in batches:
            group.append(args)
            if len(group) == k:
                dispatch(group)
                group = []
            progress.add(feed.batch_size)
            if n_pending >= log_every:
                read(True)
        if group:  # the epoch's short last group: fewer replays
            dispatch(group)
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode(0)
    if pending:
        read(False)
    return meter.avg, n


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
                   cast_txt: bool, cast_vis: bool) -> Dict:
    """``laff_tpu``'s dispatch rules (``trainer.py:862-946``): the caches,
    the step wrappers around ``base``, K, the prefetch depth. Returns
    {step, fed_step, multi_step, vis_cache, txt_cache, steps_per_dispatch,
    prefetch_depth}; turns the train feed's featurization off for the sides
    a cache holds."""
    feed = prepared.train_feed
    step = base
    if prepared.w2v_table is not None:
        step = make_w2v_pooled_train_step(step, torch.from_numpy(prepared.w2v_table).to(device))
    fed_step = step
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
        step = make_cached_train_step(step, vis_cache)

    txt_cache = None
    want_txt = int(opt.device_text_cache)
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
            "vis_cache": vis_cache, "txt_cache": txt_cache, "steps_per_dispatch": spd,
            "prefetch_depth": prefetch_depth}


def warm_start(model: torch.nn.Module, path: str) -> Dict:
    """``--pretrained_file_path``: the parameters, BatchNorm statistics and
    residual weights of a port checkpoint or a reference ``.pth.tar``
    (``laff_tpu/engine/trainer.py:836-845``) into ``model``, strictly.
    Returns the loaded checkpoint."""
    ckpt = load_checkpoint(path)
    model.load_state_dict(ckpt["state_dict"])
    logger.info("warm-started from %s (epoch %s)", path, ckpt.get("epoch"))
    return ckpt


def main(opt: Options, prepared: Optional[Prepared] = None) -> Dict:
    """A full training run (reference ``trainer.main``). Returns
    {best_perf, epochs, prepare_seconds, history (one entry per epoch:
    loss, lr, steps, metrics, train/val/wall seconds), dispatch (what the
    dispatch rules chose: cache bytes and build seconds, K, graph, staged
    validation), model_path, model (the trained model)}."""
    device = resolve_device(opt.device)
    t_prepare = time.time()
    if prepared is None:
        prepared = prepare(opt)
    prepare_seconds = time.time() - t_prepare
    config, spec, model_path = prepared.config, prepared.spec, prepared.model_path

    model = seeded_model(spec, opt.random_seed, prepared.we)
    if opt.pretrained_file_path != "None":
        warm_start(model, opt.pretrained_file_path)
    model.to(device)
    bf16 = "bfloat16" in (spec.txt.compute_dtype, spec.vis.compute_dtype)
    optimizer = make_optimizer(config, model, bf16=bf16)
    base = TrainStep(model, optimizer, spec)
    # bf16 towers round their inputs to bf16 as their first op: rounding on
    # the host gives the same tensors and halves the bytes to the card
    cast_txt = spec.txt.compute_dtype == "bfloat16"
    cast_vis = spec.vis.compute_dtype == "bfloat16"
    dispatch = setup_dispatch(opt, prepared, base, device, cast_txt, cast_vis)
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
    # validation features do not change between epochs: kept on the card
    # after the first pass (budget-guarded, the same tensors replayed)
    val_txt_feed.stage_on_device = val_vis_feed.stage_on_device = bool(opt.stage_val_features)
    prefetch_depth = dispatch["prefetch_depth"]
    embedder = Embedder(model, device, prefetch_depth=max(2, int(opt.workers) + 1))

    generator = torch.Generator(device=device)  # reseeded each epoch
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
        """The checkpoint with host copies of the weights, taken now."""
        payload = checkpoint_payload(host_copy(model.state_dict().items()), spec, config,
                                     prepared.featurizers, opt_dict)
        payload.update(epoch=epoch + 1, best_perf=best_perf)
        return payload

    vis_cache, txt_cache = dispatch["vis_cache"], dispatch["txt_cache"]
    result = {"best_perf": best_perf, "epochs": start_epoch,
              "prepare_seconds": round(prepare_seconds, 1), "history": [],
              "dispatch": {
                  "vis_cache_bytes": vis_cache.nbytes if vis_cache else None,
                  "vis_cache_seconds": vis_cache.build_seconds if vis_cache else None,
                  "txt_cache_bytes": txt_cache.nbytes if txt_cache else None,
                  "txt_cache_seconds": txt_cache.build_seconds if txt_cache else None,
                  "steps_per_dispatch": dispatch["steps_per_dispatch"],
                  "graph": dispatch["multi_step"] is not None and device.type == "cuda",
                  "stage_val_features": bool(opt.stage_val_features)}}
    saver = AsyncSaver()
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
                dispatch["step"], prepared.train_feed, epoch, device,
                generator=epoch_generator(device, opt.random_seed, epoch, generator),
                scalar_log=scalar_log, prefetch_depth=prefetch_depth, step0=global_step,
                sync_debug=bool(opt.sync_debug), multi_step=dispatch["multi_step"],
                vis_cache=vis_cache, txt_cache=txt_cache, cast_txt=cast_txt,
                cast_vis=cast_vis)
            global_step += steps
            if prepared.train2_feed is not None:  # single fed steps, as laff_tpu
                _, steps2 = train_one_epoch(
                    dispatch["fed_step"], prepared.train2_feed, epoch, device,
                    generator=epoch_generator(device, opt.random_seed, epoch, generator),
                    scalar_log=scalar_log, prefetch_depth=max(2, int(opt.workers) + 1),
                    step0=global_step, sync_debug=bool(opt.sync_debug), cast_txt=cast_txt,
                    cast_vis=cast_vis)
                global_step += steps2
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
            entry = {"epoch": epoch, "loss": float(train_loss), "lr": float(lr), "steps": steps,
                     "train_seconds": round(epoch_time, 2), "val_seconds": round(val_time, 2),
                     **{k: float(metrics[k]) for k in METRICS}}
            result["history"].append(entry)

            lr_ctl.step(cur_perf)
            is_best = cur_perf > best_perf
            best_perf = max(cur_perf, best_perf)
            if is_best:
                saver.submit(save_checkpoint_dance, ckpt_payload(epoch), True,
                             logdir=model_path, filename=f"checkpoint_epoch_{epoch}.pth.tar")
                no_impr = 0
                mean_last = []
            elif opt.save_mean_last == 1:
                mean_last.append(host_copy(model.named_parameters()))
                if len(mean_last) > 1:
                    payload = ckpt_payload(epoch)
                    payload["state_dict"].update(average_states(mean_last))
                    saver.submit(save_checkpoint, payload,
                                 os.path.join(model_path, "mean_last10.pth.tar"))

            no_impr += 1
            entry["wall_seconds"] = round(time.time() - t_epoch, 2)
            if opt.resume:
                payload = ckpt_payload(epoch)
                payload.update(optimizer=optimizer.state_dict(), global_step=global_step,
                               lr_ctl=dict(lr_ctl.__dict__), no_impr=no_impr,
                               mean_last=list(mean_last))
                saver.submit(save_checkpoint, payload, resume_path)
            if no_impr > opt.early_stop_patience or epoch == opt.num_epochs - 1:
                saver.join()
                save_checkpoint_dance(ckpt_payload(epoch), is_best=False, logdir=model_path,
                                      filename=f"checkpoint_epoch_{epoch}.pth.tar",
                                      only_best=True)
                logger.info("Early stopping or finished at epoch %d.", epoch)
                result["epochs"] = epoch + 1
                break
        saver.join()
    except BaseException:
        saver.join_quietly()
        raise
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
    result["model"] = model
    return result
