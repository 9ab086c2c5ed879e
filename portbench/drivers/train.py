"""Driver of the training mixes: ``TrainRun``'s epoch stream at the
trainer's default dispatch (both device caches, K steps a dispatch, on the
card one CUDA graph of the step replayed K times).

Set-up builds the world and one ``TrainRun``, loads the seed's weights
into its model, opens the epoch-0 stream and, on the card, captures the
graph (``MultiStep.capture``, which trains nothing). The window advances
that stream K steps a dispatch, epoch after epoch, and ends with a loss
read that waits for the card. It keeps a copy of the model's state dict,
made on the card after its first dispatch, and the losses of those K
steps.

The check runs the reference's K steps from the same weights on the same
rows (the feed's documented epoch-0 order: ``default_rng(seed)``'s
permutation of the caption ids, batches of B in turn), with dropout and
noise drawn from a generator seeded as the trainer seeds its epoch's
(seed * 1000 + epoch), and compares each step's loss, each leaf's change
over the K steps and the move of the BatchNorm running statistics.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import program, world
from ..reference.train import is_param, train_steps
from ..weights import make_weights


class _Meter:
    """Stands in for the stream's loss meter: counts the losses it reads
    and those that are not finite, and keeps the first ``keep``."""

    def __init__(self, keep: int = 0) -> None:
        self.n = self.bad = 0
        self.total = 0.0
        self.keep, self.first = keep, []

    def update(self, value: float, n: int = 1) -> None:
        self.n += 1
        if len(self.first) < self.keep:
            self.first.append(value)
        if math.isfinite(value):
            self.total += value
        else:
            self.bad += 1

    @property
    def avg(self) -> float:
        return self.total / max(1, self.n - self.bad)


# what the check reads once the window has closed; the rest is freed first
CHECK_KEYS = ("w0", "after_first", "losses", "batch_ids", "text", "video", "run_seed")


def _vid(cap_id: str) -> str:
    return cap_id.split("#", 1)[0]


def first_batches(cap_ids: List[str], seed: int, batch: int, steps: int) -> List[List[str]]:
    """The caption ids of the feed's first ``steps`` batches of epoch 0."""
    order = np.random.default_rng(seed).permutation(len(cap_ids))[: batch * steps]
    return [[cap_ids[i] for i in order[s * batch:(s + 1) * batch]] for s in range(steps)]


def setup(ctx) -> Dict:
    from laff_tpu_torch.engine import trainer
    from laff_tpu_torch.engine.prepare import prepare

    cfg, tr, device, parts = ctx.config, ctx.traffic, ctx.device, ctx.parts
    world_seed, weight_seed, run_seed = ctx.seeds
    t = time.perf_counter()
    world.build_world(ctx.workdir, tr["collection"], tr["videos"], tr["captions_per_video"],
                      tr["caption_words"], n_vocab=cfg["vocab_words"], seed=world_seed,
                      frame_feat=bool(cfg["video"].get("frames")))
    text, video = program.reference_inputs(cfg, ctx.workdir, tr["collection"])
    parts["world"] = time.perf_counter() - t

    t = time.perf_counter()
    opt = program.options(cfg, tr, ctx.workdir, run_seed, device, batch_size=tr["batch_size"])
    prepared = prepare(opt)
    program.check_spec(prepared.spec, cfg, len(text.bow_vocab))
    feed = prepared.train_feed
    if feed.seed != run_seed or list(feed.cap_ids) != text.ids:
        raise RuntimeError("the train feed is not the seeded one over the world's captions")
    parts["prepare"] = time.perf_counter() - t

    t = time.perf_counter()
    run = trainer.TrainRun(opt, prepared, device)
    d = run.dispatch
    parts["caches"] = time.perf_counter() - t
    want_graph = device.type == "cuda"
    if (d["vis_cache"] is None or d["txt_cache"] is None
            or d["steps_per_dispatch"] != tr["steps_per_dispatch"] or d["multi_step"] is None
            or run.results["dispatch"]["graph"] != want_graph
            or not run.results["dispatch"]["stage_val_features"]):
        raise RuntimeError(f"not the default dispatch: {run.results['dispatch']}")

    t = time.perf_counter()
    shapes = {k: tuple(v.shape) for k, v in run.model.state_dict().items()}
    w0 = make_weights(shapes, weight_seed, device)
    run.model.load_state_dict(w0)
    program.check_parameters(run.model, cfg, text)
    w0 = {k: v.to("cpu", copy=True) for k, v in w0.items()}
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    k = d["steps_per_dispatch"]
    batch_ids = first_batches(text.ids, run_seed, tr["batch_size"], k)
    run.begin_epoch(0)
    stream = run.epoch_stream(0)
    stream.meter = _Meter(keep=k)
    ms = d["multi_step"]
    if device.type == "cuda":
        first = (d["txt_cache"].indices(batch_ids[0]),
                 d["vis_cache"].indices([_vid(c) for c in batch_ids[0]]))
        ms.capture(first, run.generator)
        torch.cuda.synchronize()
    parts["capture"] = time.perf_counter() - t
    ctx.counters["capture_s"] = ms.capture_seconds
    tokens = sum(len(text.captions[c].split()) + 2 for c in text.ids) / len(text.ids)
    frames = 0.0
    if video.frames is not None:
        _, tmax, rows, _ = video.frames
        frames = sum(min(len(r), tmax) for r in rows.values()) / len(rows)
    return {"run": run, "stream": stream, "epoch": 0, "meters": [stream.meter],
            "after_first": None, "w0": w0, "batch_ids": batch_ids, "text": text,
            "video": video, "run_seed": run_seed, "tokens_per_caption": tokens,
            "frames_per_video": frames}


def window(state: Dict, seconds: float, spans) -> Dict:
    run, stream = state["run"], state["stream"]
    batch = run.opt.batch_size
    steps = 0
    t0 = time.perf_counter()
    with spans("window"):
        while True:
            before = stream.n
            with spans("dispatch"):
                more = stream.advance()
            steps += stream.n - before
            if state["after_first"] is None:  # a copy on the card, for the check
                state["after_first"] = {k: v.clone() for k, v in run.model.state_dict().items()}
            if not more:
                with spans("loss_read"):
                    run.finish_stream(stream)
                state["epoch"] += 1
                with spans("epoch_begin"):
                    run.begin_epoch(state["epoch"])
                    stream = run.epoch_stream(state["epoch"])
                    stream.meter = _Meter()
                    state["meters"].append(stream.meter)
            if time.perf_counter() - t0 >= seconds:
                break
        with spans("loss_read"):
            stream.finish()
            if run.device.type == "cuda":
                torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    state["stream"] = stream
    state["losses"] = state["meters"][0].first
    attempted = sum(m.n for m in state["meters"])
    failed = sum(m.bad for m in state["meters"])
    return {"elapsed": elapsed, "steps": steps, "attempted": attempted, "failed": failed,
            "metrics": {"train_pairs_per_s": steps * batch / elapsed}}


def trace_context(state: Dict, cfg: Dict, run_window: Dict) -> Dict:
    """What the per-layer readers of a training cell read besides the trace."""
    from ..yardstick import train_step_flops

    batch = state["run"].opt.batch_size
    flops = train_step_flops(cfg, batch, round(state["tokens_per_caption"] * batch),
                             round(state["frames_per_video"] * batch))
    return {"steps": run_window["steps"], "step_flops": flops}


def check(state: Dict, cfg: Dict, device: torch.device) -> Dict[str, float]:
    text, video = state["text"], state["video"]
    batches = [(program.to_device(text.featurize(caps), device),
                program.to_device(video.featurize([_vid(c) for c in caps]), device))
               for caps in state["batch_ids"]]
    w0 = {k: v.to(device) for k, v in state["w0"].items()}
    ref = train_steps(cfg, w0, batches, gen_seed=state["run_seed"] * 1000)
    return compare(state["losses"], state["after_first"], ref, w0)


def compare(losses: List[float], after: Dict[str, torch.Tensor], ref: Dict,
            w0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of a training cell, from the program's losses of the
    checked steps and its state dict after them: the widest relative loss
    gap of the steps; the worst leaf's gap of the norms of the change over
    the steps, over the leaves whose reference gradient is above a
    thousandth of the median leaf's (the others move by round-off alone);
    the worst relative difference of a BatchNorm running statistic's move,
    a reading of the forward's activations that no ranking of hardest
    negatives touches."""
    if len(losses) != len(ref["losses"]):
        raise RuntimeError(f"the program read {len(losses)} losses of the checked steps, "
                           f"the reference ran {len(ref['losses'])}")
    device = next(iter(w0.values())).device
    after = {k: v.to(device) for k, v in after.items()}
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))}
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad1"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    moving = {k for k, n in norms.items() if n > 1e-3 * med}
    d_prog = {k: after[k] - w0[k] for k in ref["params"] if is_param(k)}
    d_ref = {k: ref["params"][k] - w0[k] for k in ref["params"]}
    out["update_gap"] = max(program.leaf_gaps(d_prog, d_ref, moving).values())
    moved = {k: after[k] - w0[k] for k in ref["stats"]}
    moved_ref = {k: v - w0[k] for k, v in ref["stats"].items()}
    out["stats_gap"] = max(float(torch.linalg.vector_norm(moved[k] - moved_ref[k])
                                 / torch.linalg.vector_norm(moved_ref[k])) for k in moved_ref)
    return out
