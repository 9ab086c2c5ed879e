"""Prediction driver for benchmark collections (``laff_tpu.engine.predictor``
main, benchmark branch).

Loads a port checkpoint, or a reference ``.pth.tar`` (imported by
``engine.torch_import``), rebuilds the model and the text featurizers,
embeds the test collection once, and per query set:

* t2v ranks on the device (``rank_path``: auto | flat | kernel |
  blockwise, see ``evaluator``) -> R@1/5/10, MedR, MeanR, MIR;
* the full score matrix -> v2t metrics and the top-500 ``t2v.pkl`` dump;
* t2v and v2t rows appended to the result_log TSVs (reference format).

AVS collections, re-ranking, negation scoring, large-gallery streaming,
int8 galleries, StrongCLIP and per-head dumps come with later slices.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import EvalFeed, TextBatcher, TextSource, VisBatcher, read_video_set
from ..eval.metrics import eval_v2t, metrics_from_ranks
from ..models import LAFFModel
from ..text.txt2vec import BowVec, BowVecNSW, IndexVec, get_txt2vec
from ..utils import ROOT_PATH, check_to_skip, get_logger, makedirs
from .checkpoint import load_checkpoint, vocab_from_dict
from .evaluator import LARGE_GALLERY, Embedder, score_matrix, t2v_ranks
from .prepare import build_featurizers, text_precomputed, vision_source, w2v_dir_for

logger = get_logger(__name__)

AVS_COLLECTIONS = ("iacc.3", "v3c1")
_BOW_CLASSES = {"BowVec": BowVec, "BowVecNSW": BowVecNSW}


@dataclasses.dataclass
class PredictOptions:
    testCollection: str
    model_path: str
    sim_name: str
    rootpath: str = ROOT_PATH
    overwrite: int = 0
    query_sets: str = "tv16.avs.txt"
    predict_result_file: str = "result_log/result_test.txt"
    batch_size: int = 1024
    num_workers: int = 0
    device: str = "cuda"
    rank_path: str = "auto"


def resolve_device(device: str) -> torch.device:
    """The card unless the caller names the CPU; never a silent fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rebuild_model(ckpt: Dict, device: torch.device) -> LAFFModel:
    model = LAFFModel(ckpt["spec"])
    model.load_state_dict(ckpt["state_dict"])
    return model.to(device).eval()


def rebuild_featurizers(ckpt: Dict, rootpath: str) -> Dict:
    """The text featurizer bank from the checkpoint's vocabularies (w2v
    vectors come from the word2vec dump under ``rootpath``). A reference
    checkpoint without its pickled vocabularies gets them rebuilt from its
    train collection's captions (``opt['trainCollection']``), as
    ``laff_tpu``'s predictor does."""
    config = ckpt["config"]
    vocab = ckpt.get("vocab")
    if vocab is None:
        train = ckpt.get("opt", {}).get("trainCollection", "")
        capfile = os.path.join(rootpath, train, "TextData", f"{train}.caption.txt")
        return build_featurizers(config, rootpath, train, capfile)[0]
    te = config.text_encoding
    featurizers: Dict[str, object] = {}
    if te["rnn_encoding"]["name"].split("_", 1)[0] in ("gru", "bigru"):
        featurizers["rnn"] = IndexVec(vocab_from_dict(vocab["rnn"]))
    if "no" not in te["bert_encoding"]["name"]:
        featurizers["bert"] = None
    if "no" not in te["bow_encoding"]["name"]:
        bow = vocab["bow"]
        featurizers["bow"] = _BOW_CLASSES[bow["class"]](vocab_from_dict(bow), norm=bow["norm"])
    if "no" not in te["w2v_encoding"]["name"]:
        featurizers["w2v"] = get_txt2vec(te["w2v_encoding"]["name"])(
            w2v_dir_for(rootpath, config))
    if "no" not in te["CLIP_encoding"]["name"]:
        featurizers["clip"] = None
    if "no" not in te.get("NetVLAD_encoding", {"name": "no"})["name"]:
        featurizers["netvlad"] = get_txt2vec("w2v_nsw")(w2v_dir_for(rootpath, config))
    return featurizers


def build_test_feeds(opt: PredictOptions, config, query_set: str, featurizers):
    """Vision + text feeds for a test collection and query set; the
    gallery feed carries the frame features of a FrameLAFF config."""
    coll_dir = os.path.join(opt.rootpath, opt.testCollection)
    vis_ids = read_video_set(os.path.join(coll_dir, "VideoSets", opt.testCollection + ".txt"))
    vis_feed = EvalFeed(vis_ids, VisBatcher(vision_source(opt.rootpath, opt.testCollection,
                                                          config, vis_ids)),
                        batch_size=opt.batch_size)
    capfile = os.path.join(coll_dir, "TextData", query_set)
    tsrc = TextSource(capfile, precomputed=text_precomputed(config, capfile))
    tb = TextBatcher(tsrc, dict(featurizers), max_txtlength=config.max_txtlength)
    txt_feed = EvalFeed(tsrc.cap_ids, tb, batch_size=opt.batch_size)
    return vis_feed, txt_feed, tsrc, vis_ids


def write_rank_dump(pkl_path: str, scores: np.ndarray, txt_ids: List[str],
                    vis_ids: List[str], captions: Dict[str, str], device: torch.device,
                    threshold: int = 500) -> None:
    """Per-query descending top-``threshold`` ranking pickled as
    {txt_id: {query, rank_list, sim_value}} (reference
    ``txt2video_write_to_file``); the top-k runs on ``device``."""
    k = min(threshold, len(vis_ids))
    vals, idx = torch.topk(torch.from_numpy(scores).to(device), k, dim=1)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    vis_arr = np.asarray(vis_ids)
    shot_dict = {}
    for q, tid in enumerate(txt_ids):
        shot_dict[tid] = {
            "query": captions.get(tid, ""),
            "rank_list": vis_arr[idx[q]].tolist(),
            "sim_value": vals[q].tolist(),
        }
    with open(pkl_path, "wb") as fh:
        pickle.dump(shot_dict, fh)


def append_result_row(path: str, model_tag: str, parm_adjust: str, result_tuple) -> None:
    """Reference TSV row format (``predictor.py:91-126``)."""
    makedirs(os.path.dirname(path) or ".")
    r1, r5, r10, medr, meanr, mir, mAP = result_tuple
    with open(path, "a") as fh:
        fh.write(time.asctime(time.localtime(time.time())) + "\t")
        for each in [model_tag, round(r1, 3), round(r5, 3), round(r10, 3),
                     round(medr, 3), round(meanr, 3), round(mir, 3), round(mAP, 3)]:
            fh.write(str(each) + "\t")
        fh.write(parm_adjust.replace("_", "\t"))
        fh.write("\n")


def main(opt: PredictOptions) -> Dict:
    """Returns {query_set: {'t2v', 'v2t' metric tuples, 't2v_ranks',
    'seconds' per phase}}."""
    device = resolve_device(opt.device)
    ckpt = load_checkpoint(opt.model_path)
    config = ckpt["config"]
    model = rebuild_model(ckpt, device)
    embedder = Embedder(model, device, prefetch_depth=max(2, opt.num_workers))
    featurizers = rebuild_featurizers(ckpt, opt.rootpath)
    parm_adjust = str(ckpt.get("opt", {}).get("parm_adjust_config", "None"))
    coll = opt.testCollection
    measure = getattr(config, "measure", "cosine")
    result_dir = os.path.dirname(opt.predict_result_file)
    result_name = os.path.basename(opt.predict_result_file)
    model_tag = opt.model_path + "\t" + coll
    results: Dict[str, Dict] = {}
    vis_embs: Optional[torch.Tensor] = None

    for query_set in opt.query_sets.split(","):
        if coll in AVS_COLLECTIONS or query_set == "simple_query.txt":
            raise NotImplementedError("AVS score files are not ported yet: ROADMAP Queue 1 item 3")
        output_dir = os.path.join(opt.rootpath, coll, "SimilarityIndex", query_set,
                                  opt.sim_name)
        if check_to_skip(os.path.join(output_dir, "id.sent.score.txt"), opt.overwrite):
            continue
        makedirs(output_dir)
        seconds: Dict[str, float] = {}
        tick = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal tick
            _sync(device)
            now = time.perf_counter()
            seconds[name] = now - tick
            tick = now

        vis_feed, txt_feed, tsrc, vis_ids = build_test_feeds(opt, config, query_set, featurizers)
        if len(vis_ids) > LARGE_GALLERY:
            raise NotImplementedError(
                f"gallery of {len(vis_ids)} videos: large-gallery streaming is not ported yet: "
                f"ROADMAP Queue 1 item 3")
        txt_embs, txt_ids = embedder.embed_txt(txt_feed)
        lap("embed_txt")
        if vis_embs is None:  # cached across query sets
            vis_embs, vis_ids = embedder.embed_vis(vis_feed)
        lap("embed_vis")
        scores = score_matrix(txt_embs, vis_embs, measure=measure)
        lap("score_matrix")
        ranks = t2v_ranks(txt_embs, vis_embs, txt_ids, vis_ids, measure=measure,
                          rank_path=opt.rank_path)
        t2v = metrics_from_ranks(ranks)
        lap("t2v_ranks")
        append_result_row(os.path.join(result_dir, "TextToVideo", result_name),
                          model_tag, parm_adjust, t2v)
        write_rank_dump(os.path.join(output_dir, "t2v.pkl"), scores, txt_ids, vis_ids,
                        tsrc.captions, device)
        lap("rank_dump")
        v2t = eval_v2t(scores, txt_ids, vis_ids)
        lap("v2t")
        append_result_row(os.path.join(result_dir, "VideoToText", result_name),
                          model_tag, parm_adjust, v2t)
        results[query_set] = {"t2v": t2v, "v2t": v2t, "t2v_ranks": ranks,
                              "seconds": seconds}
        logger.info("%s t2v r1=%.2f r5=%.2f r10=%.2f medr=%.0f mir=%.4f",
                    query_set, t2v[0], t2v[1], t2v[2], t2v[3], t2v[5])
    return results
