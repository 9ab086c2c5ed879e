"""Driver of the validation mix: ``evaluator.validate`` over the staged
feeds of ``trainer.validation_feeds``, as the trainer runs it after every
epoch (eval forward of both towers with the gate kernel, the similarity
and ground-truth ranks on the wide rank kernel, the metrics).

Set-up builds the collection, prepares it, puts the seed's weights into
the port's model and runs one pass, which stages both feeds on the card,
then one replayed pass as the window runs them.
The window replays the pass until its time is up. Every pass's ranks must
equal the first's (a pass that differs counts as failed).

The check embeds every caption and video with the reference in float32,
scores them and holds the window's last ranks against those scores
(``reference.rank.rank_gaps``), and recomputes the reported metrics from
the reported ranks.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import program, world
from ..reference.model import ReferenceModel, flat_embeddings
from ..reference.rank import METRICS, metrics_from_ranks, rank_gaps, scores
from ..weights import make_weights

TXT_BLOCK = 4096  # captions the reference embeds and scores at once
VIS_BLOCK = 512

# what the check reads once the window has closed; the rest is freed first
CHECK_KEYS = ("last", "w0", "text", "video")


def setup(ctx) -> Dict:
    from laff_tpu_torch.engine import trainer
    from laff_tpu_torch.engine.evaluator import Embedder
    from laff_tpu_torch.engine.prepare import prepare
    from laff_tpu_torch.models.laff import LAFFModel
    from laff_tpu_torch.ops import kernels as K

    cfg, tr, device, parts = ctx.config, ctx.traffic, ctx.device, ctx.parts
    world_seed, weight_seed, run_seed = ctx.seeds
    t = time.perf_counter()
    world.build_world(ctx.workdir, tr["collection"], tr["videos"], tr["captions_per_video"],
                      tr["caption_words"], n_vocab=cfg["vocab_words"], seed=world_seed,
                      frame_feat=bool(cfg["video"].get("frames")))
    text, video = program.reference_inputs(cfg, ctx.workdir, tr["collection"])
    parts["world"] = time.perf_counter() - t

    t = time.perf_counter()
    opt = program.options(cfg, tr, ctx.workdir, run_seed, device)
    prepared = prepare(opt)
    program.check_spec(prepared.spec, cfg, len(text.bow_vocab))
    parts["prepare"] = time.perf_counter() - t

    t = time.perf_counter()
    if device.type == "cuda":
        K.build_kernels()
    parts["kernel_load"] = time.perf_counter() - t

    t = time.perf_counter()
    with torch.device("meta"):
        model = LAFFModel(prepared.spec)
    model = model.to_empty(device=device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w0 = make_weights(shapes, weight_seed, device)
    model.load_state_dict(w0)
    program.check_parameters(model, cfg, text)
    w0 = {k: v.to("cpu", copy=True) for k, v in w0.items()}
    model.eval()
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    embedder = Embedder(model, device, prefetch_depth=max(2, int(opt.workers) + 1))
    txt_feed, vis_feed = trainer.validation_feeds(opt, prepared)
    first = _pass(embedder, txt_feed, vis_feed, tr, prepared.spec.measure)
    if device.type == "cuda" and (txt_feed.staged is None or vis_feed.staged is None):
        raise RuntimeError("the validation feeds were not staged on the card")
    parts["staging_pass"] = time.perf_counter() - t
    t = time.perf_counter()
    _pass(embedder, txt_feed, vis_feed, tr, prepared.spec.measure)  # the window's path, warm
    parts["replayed_pass"] = time.perf_counter() - t
    n_caps = len(first["txt_ids"])
    tokens = sum(len(text.captions[c].split()) + 2 for c in first["txt_ids"])
    frames = 0
    if video.frames is not None:
        _, tmax, rows, _ = video.frames
        frames = sum(min(len(rows.get(v, [])), tmax) for v in first["vis_ids"])
    K.reset_launches()
    return {"embedder": embedder, "feeds": (txt_feed, vis_feed), "measure": prepared.spec.measure,
            "traffic": tr, "first": first, "last": first, "text": text, "video": video,
            "w0": w0, "tokens": tokens, "frames": frames, "n_caps": n_caps, "kernels": K}


def _pass(embedder, txt_feed, vis_feed, tr: Dict, measure: str) -> Dict:
    from laff_tpu_torch.engine.evaluator import validate

    return validate(embedder, txt_feed, vis_feed, measure=measure, rank_path=tr["rank_path"])


def window(state: Dict, seconds: float, spans) -> Dict:
    txt_feed, vis_feed = state["feeds"]
    first = state["first"]["ranks"]
    passes = failed = 0
    t0 = time.perf_counter()
    with spans("window"):
        while True:
            with spans("validate"):
                out = _pass(state["embedder"], txt_feed, vis_feed, state["traffic"],
                            state["measure"])
            passes += 1
            if not np.array_equal(out["ranks"], first):
                failed += 1
            state["last"] = out
            if time.perf_counter() - t0 >= seconds:
                break
    elapsed = time.perf_counter() - t0
    _check_launches(state, passes)
    return {"elapsed": elapsed, "passes": passes, "attempted": passes, "failed": failed,
            "metrics": {"val_captions_per_s": passes * state["n_caps"] / elapsed}}


def _check_launches(state: Dict, passes: int) -> None:
    """Every pass of the window ran the wide rank kernel once and the gate
    kernel once a batch of each feed: a cell that measured another path
    would say nothing of these kernels."""
    if state["embedder"].device.type != "cuda":
        return
    txt_feed, vis_feed = state["feeds"]
    batches = sum(-(-len(f) // f.batch_size) for f in (txt_feed, vis_feed))
    got = state["kernels"].LAUNCHES
    if got["sim_rank_wide"] != passes or got["gate_attention"] != passes * batches:
        raise RuntimeError(f"{passes} passes launched {got}, not 1 wide rank kernel and "
                           f"{batches} gate kernels a pass")


def trace_context(state: Dict, cfg: Dict, run_window: Dict) -> Dict:
    from ..yardstick import eval_pass_flops

    n_vis, n_txt = len(state["last"]["vis_ids"]), state["n_caps"]
    return {"passes": run_window["passes"],
            "pass_flops": eval_pass_flops(cfg, n_txt, state["tokens"], n_vis, state["frames"]),
            "sim_rank": (n_txt, n_vis, cfg["common_dim"]),
            "gate_rows": {"text": (n_txt, len(cfg["text"]["features"])),
                          "video": (n_vis, len(cfg["video"]["features"])
                                    + int(bool(cfg["video"].get("frames"))))},
            "heads": cfg["heads"], "dh": cfg["common_dim"] // cfg["heads"]}


@torch.no_grad()
def reference_embeddings(cfg: Dict, w0: Dict, text, video, txt_ids, vis_ids, device,
                         precision: str = "f32"):
    """Flat (per-head normalized) reference embeddings of the captions and
    videos, in blocks."""
    model = ReferenceModel(cfg, w0, precision)
    vis = [flat_embeddings(model.encode_vis(program.to_device(
        video.featurize(vis_ids[s:s + VIS_BLOCK]), device)))
        for s in range(0, len(vis_ids), VIS_BLOCK)]
    txt = [flat_embeddings(model.encode_txt(program.to_device(
        text.featurize(txt_ids[s:s + TXT_BLOCK]), device)))
        for s in range(0, len(txt_ids), TXT_BLOCK)]
    return torch.cat(txt), torch.cat(vis)


def gt_columns(txt_ids, vis_ids, device) -> torch.Tensor:
    col = {v: i for i, v in enumerate(vis_ids)}
    return torch.tensor([col[t.split("#")[0]] for t in txt_ids], device=device)


@torch.no_grad()
def check(state: Dict, cfg: Dict, device: torch.device) -> Dict[str, float]:
    out = state["last"]
    txt_ids, vis_ids = out["txt_ids"], out["vis_ids"]
    w0 = {k: v.to(device) for k, v in state["w0"].items()}
    tf, vf = reference_embeddings(cfg, w0, state["text"], state["video"], txt_ids, vis_ids,
                                  device)
    gt = gt_columns(txt_ids, vis_ids, device)
    ranks = torch.as_tensor(np.asarray(out["ranks"]), device=device)
    gap = 0.0
    for s in range(0, len(txt_ids), TXT_BLOCK):
        sc = scores(tf[s:s + TXT_BLOCK], vf, cfg["heads"])
        gap = max(gap, float(rank_gaps(sc, gt[s:s + TXT_BLOCK], ranks[s:s + TXT_BLOCK]).max()))
    want = metrics_from_ranks(out["ranks"])
    metric_gap = max(abs(out[k] - want[k]) / max(1.0, abs(want[k])) for k in METRICS)
    return {"rank_gap": gap, "metric_gap": metric_gap}
