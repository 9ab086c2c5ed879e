"""Prediction driver (``laff_tpu.engine.predictor`` main).

Loads a port checkpoint, or a reference ``.pth.tar`` (imported by
``engine.torch_import``), rebuilds the model and the text featurizers, and
answers each query set against the test collection's gallery.

The gallery is embedded once and kept on the device, or, above
``LARGE_GALLERY`` videos, streamed through the video tower for every query
set, as ``laff_tpu`` does: through ``evaluator.streaming_benchmark_eval``
for a benchmark collection without post-processing (two passes of device
counting; ``t2v.pkl`` holds the streamed top 2,000), through
``evaluator.int8_streaming_topk`` for an AVS query set with
``int8_gallery`` and no post-processing (an int8 gallery on the device
nominates candidates, which are embedded again for exact scores), and
through ``evaluator.score_matrix_streaming`` (host (T, V) scores)
otherwise.

Benchmark collections, per query set:

* t2v ranks on the device (``rank_path``: auto | flat | kernel |
  blockwise, see ``evaluator``) -> R@1/5/10, MedR, MeanR, MIR;
* the full score matrix -> v2t metrics and the top-500 ``t2v.pkl`` dump;
* t2v and v2t rows appended to the result_log TSVs (reference format).

AVS collections (``AVS_COLLECTIONS``) and ``simple_query.txt``: the query
ids are topic numbers with no ground-truth video, so there are no metrics
and no TSV rows; each query set writes its top-2,000 ranking to
``id.sent.score.txt`` ('<txt_id> <vis_id> <score> ...', one line a query,
what ``laff_tpu_torch.cli.avs_eval`` scores) and its top 500 to
``t2v.pkl``.

The post-processing options of ``laff_tpu``'s predictor:

* ``task3_caption`` (any value but the default): boolean negation scoring.
  Each query is split on its negation cue (``split_negation``); the
  positive and the negated clause go through the text tower, and
  ``negation_adjusted_scores`` demotes the videos the negated clause
  matches (``neg_method`` 'sub' or 'mul'). A streamed gallery is streamed
  for each clause.
* ``rerank``: 'kreciprocal' and 'tkb' (``eval.rerank``, host numpy; the
  query-query and gallery-gallery products are taken on the embeddings'
  device), or 'concept' with a concept pkl (``concept_*`` options).
* ``each_head``: per-head score matrices, their metric rows, one
  ``head<h>.id.sent.score.txt`` (the top 2,000 of each query) per head and
  a ``perf.txt``; benchmark collections whose gallery is embedded whole.

When the scores are adjusted or re-ranked, or the gallery was streamed, t2v
comes from the score matrix (its ranks counted by ``ranks_from_scores`` on
the device, ties larger-index-first), as ``laff_tpu`` takes ``eval_t2v`` of
it, and not from the embeddings' rank kernel; v2t always comes from the
score matrix. Every top-K list puts equal scores in decreasing gallery
index order (``score_rankings``).

A StrongCLIP checkpoint (the config's module, model name or the
checkpoint's ``opt['config_name']`` says 'StrongCLIP', as
``FrameLaff_NoFrameFc_StrongCLIP_adjust``, the LAFF-ml headline) swaps in
the fine-tuned CLIP text tower stored at ``<root>/<test>/TextData/<CLIP
dir_name>/model_best.pth.tar`` (reference ``predictor.py:170-186``): its
keys lose the leading ``clip_model.``, a ``ClipModel.`` prefix is detected,
the tower's shape comes from ``infer_clip_config`` (the ViT-B/32 text tower
when a key is missing), and the 'clip' rows of every query (and of every
negation clause) are that tower's output on the card, not the precomputed
BigFile rows. The file is read through ``torch_import.ReferenceUnpickler``.

Raising instead of running (each names its ROADMAP item or the reason):
``data_parallel`` over two or more visible cards (item 5; over one device
it logs ``laff_tpu``'s warning and predicts there). Three results differ from ``laff_tpu`` on
purpose: above the threshold 'kreciprocal' and 'tkb' raise a ``ValueError``
(they need the gallery-gallery product, which a streamed gallery never
forms; ``laff_tpu`` crashes there), and so does measure 'hist' (``laff_tpu``
scores cosine there without a word); a StrongCLIP tower file that exists
but does not load raises (``laff_tpu`` logs a warning and predicts on the
precomputed rows, which would hide a failure on the card), while a missing
file logs ``laff_tpu``'s warning and predicts on the precomputed rows.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import EvalFeed, TextBatcher, TextSource, VisBatcher, read_video_set
from ..eval.metrics import eval_t2v, eval_v2t, metrics_from_ranks, ranks_from_scores
from ..eval.rerank import ConceptRerank, k_reciprocal_rerank, load_word_counts, tkb_rerank
from ..models import LAFFModel
from ..models.clip import (ClipTextConfig, ClipTextTower, infer_clip_config, text_state_dict,
                           tokenize)
from ..ops import flatten_heads, l2norm
from ..text.textlib import split_negation
from ..text.txt2vec import BowVec, BowVecNSW, IndexVec, get_txt2vec
from ..utils import ROOT_PATH, check_to_skip, get_logger, makedirs
from .checkpoint import load_checkpoint, vocab_from_dict
from .evaluator import (LARGE_GALLERY, Embedder, int8_streaming_topk, ordered_topk,
                        score_matrix, score_matrix_streaming, streaming_benchmark_eval,
                        t2v_ranks)
from .prepare import (bert_tokens_featurizer, build_featurizers, check_data_parallel,
                      text_precomputed, vision_source, w2v_dir_for)
from .torch_import import read_reference

logger = get_logger(__name__)

AVS_COLLECTIONS = ("iacc.3", "v3c1")
AVS_SCORE_TOPK = 2000  # the reference's Threshold in txt2video_write_to_file
DUMP_TOPK = 500  # t2v.pkl
STRONGCLIP_DIR = "clip_finetune_8frame_uniform_1103"
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
    adjust_weight_predict: int = 0  # parity: parsed and never read, as in the reference
    data_parallel: int = 0  # one device: a warning; several: raises (item 5)
    int8_gallery: int = 0  # an AVS gallery above LARGE_GALLERY held as int8 rows
    task3_caption: str = "no_task3_caption"  # any other value: negation scoring
    neg_method: str = "sub"  # negation adjustment: sub | mul
    each_head: int = 0  # also per-head metrics, score files and perf.txt
    rerank: str = "none"  # none | kreciprocal | tkb | concept
    # concept re-ranking (reference predict_concept_rerank, model/model.py:1352-1406)
    concept_pkl: str = ""  # video <-> concept similarity pkl
    concept_weight: float = 2.0
    concept_topk: int = 1000
    concept_bow_counts: str = ""  # vocabulary count file ('word count' lines)
    concept_caption: str = ""  # caption file for the substring-count fallback


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


def rebuild_featurizers(ckpt: Dict, rootpath: str, device="cuda") -> Dict:
    """The text featurizer bank from the checkpoint's vocabularies (w2v
    vectors come from the word2vec dump under ``rootpath``; an in-graph
    BERT tower's tokenizer from the config's vocab file or checkout, a
    frozen BERT's rows precomputed). A reference checkpoint without its
    pickled vocabularies gets them rebuilt from its train collection's
    captions (``opt['trainCollection']``), as ``laff_tpu``'s predictor
    does; a frozen BERT of a local checkout then runs on ``device``."""
    config = ckpt["config"]
    vocab = ckpt.get("vocab")
    if vocab is None:
        train = ckpt.get("opt", {}).get("trainCollection", "")
        capfile = os.path.join(rootpath, train, "TextData", f"{train}.caption.txt")
        return build_featurizers(config, rootpath, train, capfile, device=device)[0]
    te = config.text_encoding
    featurizers: Dict[str, object] = {}
    if te["rnn_encoding"]["name"].split("_", 1)[0] in ("gru", "bigru"):
        featurizers["rnn"] = IndexVec(vocab_from_dict(vocab["rnn"]))
    if "no" not in te["bert_encoding"]["name"]:
        featurizers["bert"] = None  # the precomputed rows
        if not getattr(config, "bert_frozen", True):  # the in-graph tower: its tokens
            featurizers["bert"] = bert_tokens_featurizer(config)
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


def write_rank_dump(pkl_path: str, vals: np.ndarray, idx: np.ndarray, txt_ids: List[str],
                    vis_ids: List[str], captions: Dict[str, str]) -> None:
    """Each query's ranking (``score_rankings``' values and indices)
    pickled as {txt_id: {query, rank_list, sim_value}} (reference
    ``txt2video_write_to_file``). The rank lists hold the gallery's own id
    strings (an object array indexes them), so pickle writes each id once
    and refers to it after: the dump pickles about 5x faster than with a
    fresh string per entry, and loads equal."""
    vis_arr = np.asarray(vis_ids, dtype=object)
    shot_dict = {}
    for q, tid in enumerate(txt_ids):
        shot_dict[tid] = {
            "query": captions.get(tid, ""),
            "rank_list": vis_arr[idx[q]].tolist(),
            "sim_value": vals[q].tolist(),
        }
    with open(pkl_path, "wb") as fh:
        pickle.dump(shot_dict, fh)


# elements of one row block sorted at once by score_rankings
RANKING_BLOCK = 1 << 26


@torch.no_grad()
def score_rankings(scores: np.ndarray, device: torch.device, threshold: int = AVS_SCORE_TOPK):
    """Each query's top ``threshold`` videos (all when the gallery is
    smaller), descending, equal scores in decreasing gallery index order
    (``ordered_topk``), ranked on ``device`` in row blocks: (values,
    indices) on the host."""
    n, v = scores.shape
    k = min(threshold, v)
    vals, idx = np.empty((n, k), np.float32), np.empty((n, k), np.int64)
    rows = max(1, RANKING_BLOCK // max(v, 1))
    for start in range(0, n, rows):
        top_vals, top_idx = ordered_topk(torch.from_numpy(scores[start:start + rows]).to(device),
                                         k)
        vals[start:start + rows] = top_vals.cpu().numpy()
        idx[start:start + rows] = top_idx.cpu().numpy()
    return vals, idx


def _write_score_lines(path: str, vals: np.ndarray, idx: np.ndarray, txt_ids: List[str],
                       vis_ids: List[str]) -> None:
    vis_arr = np.asarray(vis_ids)
    row = [""] * (2 * idx.shape[1])
    with open(path, "w") as fout:
        for q, tid in enumerate(txt_ids):
            row[0::2] = vis_arr[idx[q]].tolist()
            row[1::2] = vals[q].astype(str).tolist()
            fout.write(f"{tid} {' '.join(row)}\n")


def write_score_files(files, txt_ids: List[str], vis_ids: List[str]) -> None:
    """The text branch of the reference's ``txt2video_write_to_file`` for
    each (path, values, indices) of ``files`` (``score_rankings``): one
    line per query, '<txt_id> <vis_id> <score> ...', scores in numpy's
    shortest float32 form, as ``laff_tpu`` writes them. The formatting is
    host-bound Python (about a microsecond a score), so several files are
    written by as many processes at once."""
    if len(files) == 1:
        _write_score_lines(*files[0], txt_ids, vis_ids)
        return
    workers = min(len(files), os.cpu_count() or 1)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = [pool.submit(_write_score_lines, *f, txt_ids, vis_ids) for f in files]
        for d in done:
            d.result()


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


@torch.no_grad()
def per_head_scores(txt_embs: torch.Tensor, vis_embs: torch.Tensor) -> np.ndarray:
    """(H, T, V) per-space cosine matrices on the host (reference
    ``get_txt2vis_matrix_each_head``), one head at a time on the
    embeddings' device."""
    out = np.empty((txt_embs.shape[1], txt_embs.shape[0], vis_embs.shape[0]), np.float32)
    for h in range(txt_embs.shape[1]):
        out[h] = (l2norm(txt_embs[:, h]) @ l2norm(vis_embs[:, h]).T).float().cpu().numpy()
    return out


@torch.no_grad()
def apply_rerank(kind: str, scores: np.ndarray, txt_embs: torch.Tensor,
                 vis_embs: torch.Tensor) -> np.ndarray:
    """'kreciprocal' (minus the re-ranked distance) or 'tkb' (scores plus
    the popularity boost) of the score matrix (reference
    ``predict_rerank``, model/model.py:1130-1406). The head-mean query-query
    and gallery-gallery similarities are products on the embeddings'
    device, in float64 and then rounded to float32, so the card and the CPU
    give the re-rankers the same similarities (in float32 they would differ
    in the last bits and move neighbour lists at near ties); the
    re-rankers run on the host."""
    if kind == "none":
        return scores
    tn, vn = flatten_heads(txt_embs).double(), flatten_heads(vis_embs).double()
    h = txt_embs.shape[1] if txt_embs.ndim == 3 else 1
    g_g = (torch.matmul(vn, vn.T) / h).float().cpu().numpy()
    if kind == "kreciprocal":
        q_q = (torch.matmul(tn, tn.T) / h).float().cpu().numpy()
        return -k_reciprocal_rerank(scores, q_q, g_g)
    if kind == "tkb":
        return scores + tkb_rerank(scores, g_g)
    raise ValueError(f"unknown rerank {kind!r}")


def concept_rerank_scores(opt: PredictOptions, scores: np.ndarray, txt_ids: List[str],
                          vis_ids: List[str], tsrc: TextSource) -> np.ndarray:
    """Concept-space re-scoring (reference ``predict_concept_rerank``): this
    gallery's columns of the concept pkl, ``scores + weight *
    concept_sim``, rows l2-normalized."""
    if not opt.concept_pkl:
        raise ValueError("--rerank concept needs --concept_pkl")
    with open(opt.concept_pkl, "rb") as fh:
        blob = pickle.load(fh)
    col_of = {v: i for i, v in enumerate(np.asarray(blob["vis_ids"]).tolist())}
    missing = [v for v in vis_ids if v not in col_of]
    if missing:
        raise KeyError(f"gallery video {missing[0]!r} missing from concept pkl "
                       f"{opt.concept_pkl} vis_ids")
    word_counts = load_word_counts(opt.concept_bow_counts) if opt.concept_bow_counts else None
    caption_text = ""
    if opt.concept_caption:
        with open(opt.concept_caption) as fh:
            caption_text = fh.read()
    rr = ConceptRerank(opt.concept_pkl, [col_of[v] for v in vis_ids], scores,
                       [tsrc.captions[t] for t in txt_ids], topK=opt.concept_topk,
                       word_counts=word_counts, caption_text=caption_text)
    return rr.rerank(weight=opt.concept_weight)


def negation_adjusted_scores(scores: np.ndarray, neg_scores: np.ndarray, neg_mask: np.ndarray,
                             method: str = "sub") -> np.ndarray:
    """Boolean negation scoring (reference ``predictneg_adhoc``,
    model/model.py:1473-1565): cosines mapped to [0, 1], less (or scaled
    down by) the negated clause's similarity, clipped at 0 first, for the
    queries with a negation; the others lose a constant 0.5."""
    s = (scores + 1.0) / 2.0
    ns = (np.clip(neg_scores, 0.0, None) + 1.0) / 2.0
    ns = ns * neg_mask[:, None] + 0.5 * (1.0 - neg_mask[:, None])
    if method == "sub":
        return s - ns
    if method == "mul":
        return s * (1.0 - ns)
    raise ValueError(f"neg_method {method!r} is not 'sub' or 'mul'")


def embed_negation_split(embedder: Embedder, txt_feed: EvalFeed, tsrc: TextSource,
                         txt_ids: List[str]):
    """Each query split on its negation cue, both halves through the text
    tower: the positive clause (the reference scores it, not the full
    query, model/model.py:1530) and the negated one. Returns (pos_embs,
    neg_embs, mask), mask 1 where the query has a negation; (None, None,
    mask) when none has. Precomputed text rows (CLIP/BERT BigFiles) are
    keyed by caption id, so a clause reuses its query's rows there; the
    signal comes from the live features (bow, w2v, GRU, a StrongCLIP text
    tower), and with none a warning says the scoring is inert."""
    batcher = txt_feed.batcher
    pos_by_id: Dict[str, str] = {}
    neg_by_id: Dict[str, str] = {}
    mask = np.zeros(len(txt_ids), np.float32)
    for i, tid in enumerate(txt_ids):
        positive, negated, has_neg = split_negation(tsrc.captions[tid])
        pos_by_id[tid], neg_by_id[tid] = positive, negated if has_neg else ""
        mask[i] = 1.0 if has_neg else 0.0
    if not mask.any():
        return None, None, mask
    if all(name in TextBatcher._PRECOMPUTED_KEYS and t2v is None
           for name, t2v in batcher.featurizers.items()):
        logger.warning(
            "NEGATION SCORING IS INERT: every text modality (%s) is a precomputed feature "
            "store keyed by cap_id, so the synthesized positive/negated clauses reuse the full "
            "query's rows and the negation adjustment carries no signal. Add a live text "
            "encoder (bow/w2v/gru or a StrongCLIP text tower) to make --task3_caption "
            "effective (the reference drops precomputed CLIP in its task3 loaders, "
            "data_provider.py:517-518).",
            ", ".join(sorted(batcher.featurizers)))

    def clause_feed(clause_by_id):
        return EvalFeed(list(txt_ids), lambda ids: batcher.encode_captions(
            [clause_by_id[c] for c in ids], ids), batch_size=txt_feed.batch_size)

    pos_embs, _ = embedder.embed_txt(clause_feed(pos_by_id))
    neg_embs, _ = embedder.embed_txt(clause_feed(neg_by_id))
    return pos_embs, neg_embs, mask


def t2v_from_scores(scores: np.ndarray, txt_ids: List[str], vis_ids: List[str],
                    device: torch.device):
    """t2v metrics of an adjusted or re-ranked score matrix: each caption's
    video ranked in its row on ``device`` (ties larger-index-first)."""
    col = {v: i for i, v in enumerate(vis_ids)}
    gt = torch.tensor([col[t.split("#", 1)[0]] for t in txt_ids])
    ranks = ranks_from_scores(torch.from_numpy(scores).to(device), gt).cpu().numpy()
    return metrics_from_ranks(ranks), ranks


def each_head_outputs(opt: PredictOptions, output_dir: str, txt_embs: torch.Tensor,
                      vis_embs: torch.Tensor, txt_ids: List[str], vis_ids: List[str],
                      model_tag: str, parm_adjust: str, device: torch.device) -> List:
    """``--each_head 1`` (reference ``get_multi_predict_file``,
    predictor.py:290-405): each head's t2v row in ``head<h>_<result
    file>``, its score file ``head<h>.id.sent.score.txt`` and its block of
    ``perf.txt``. The reference overwrites one file per head, so only the
    last head's survives; as in ``laff_tpu`` every file is named by its
    head. Returns the heads' metric tuples."""
    result_dir = os.path.dirname(opt.predict_result_file)
    result_name = os.path.basename(opt.predict_result_file)
    head_scores = per_head_scores(txt_embs, vis_embs)
    per_head, blocks, files = [], [], []
    for h in range(head_scores.shape[0]):
        m = eval_t2v(head_scores[h], txt_ids, vis_ids)
        per_head.append(m)
        append_result_row(os.path.join(result_dir, "TextToVideo", f"head{h}_" + result_name),
                          model_tag, parm_adjust, m)
        r1, r5, r10, medr, meanr, mir, mAP = m
        blocks.append(f" * Text to video head{h}:\n"
                      f" * r_1_5_10: {[round(r1, 3), round(r5, 3), round(r10, 3)]}\n"
                      f" * medr, meanr, mir: {[round(medr, 3), round(meanr, 3), round(mir, 3)]}"
                      f"\n * mAP: {round(mAP, 3)}\n * " + "-" * 10)
        files.append((os.path.join(output_dir, f"head{h}.id.sent.score.txt"),
                      *score_rankings(head_scores[h], device)))
    write_score_files(files, txt_ids, vis_ids)
    with open(os.path.join(output_dir, "perf.txt"), "w") as fh:
        fh.write("\n".join(blocks) + "\n")
    return per_head


def check_options(opt: PredictOptions) -> None:
    """Options whose paths are not ported raise before any work."""
    check_data_parallel(opt.data_parallel, opt.device)


class ClipTextFeaturizer:
    """A live CLIP text tower as a text featurizer (``TextBatcher``'s live
    branch): captions tokenized at context 77, encoded on the tower's
    device under no_grad (the feed calls it from its prefetch thread), (B,
    embed_dim) float32 rows left there. ``rows`` counts the captions it
    encoded."""

    def __init__(self, tower: torch.nn.Module, device: torch.device) -> None:
        self.tower = tower.to(device).eval()
        self.device = device
        self.rows = 0

    def encode_batch(self, captions) -> torch.Tensor:
        ids = torch.from_numpy(tokenize(list(captions))).to(self.device)
        with torch.no_grad():
            out = self.tower(ids)
        self.rows += len(captions)
        return out


def strongclip_text_featurizer(rootpath: str, test_collection: str,
                               dir_name: str = STRONGCLIP_DIR,
                               device: torch.device = torch.device("cuda")) -> ClipTextFeaturizer:
    """The fine-tuned CLIP text tower of ``<root>/<test>/TextData/<dir_name>/
    model_best.pth.tar`` (``laff_tpu``'s ``strongclip_text_featurizer``), on
    ``device``."""
    path = os.path.join(rootpath, test_collection, "TextData", dir_name, "model_best.pth.tar")
    ckpt = read_reference(path)
    sd = {k[11:]: v for k, v in ckpt["model"].items()}  # strip 'clip_model.'
    prefix = "ClipModel." if any(k.startswith("ClipModel.") for k in sd) else ""
    try:  # the reference build_model's shape sniffing (model/clip/model.py:401-438)
        cfg = infer_clip_config(sd, prefix=prefix).text
    except KeyError:  # a partial dump: the ViT-B/32 text tower
        cfg = ClipTextConfig()
    tower = ClipTextTower(cfg)
    tower.load_state_dict(text_state_dict(sd, layers=cfg.layers, prefix=prefix))
    logger.info("StrongCLIP text tower loaded from %s: %s", path, cfg)
    return ClipTextFeaturizer(tower, device)


def strongclip_swap(ckpt: Dict, featurizers: Dict, rootpath: str, collection: str,
                    device: torch.device) -> None:
    """For a StrongCLIP checkpoint, ``featurizers['clip']`` becomes the
    fine-tuned live text tower when its file exists; a missing file logs
    ``laff_tpu``'s warning and leaves the precomputed rows; a file that
    does not load raises (see the module docstring)."""
    config = ckpt["config"]
    named = str(type(config).__module__) + str(getattr(config, "model_name", ""))
    if "StrongCLIP" not in named + str(ckpt.get("opt", {}).get("config_name", "")):
        return
    dir_name = config.text_encoding["CLIP_encoding"].get("dir_name", STRONGCLIP_DIR)
    path = os.path.join(rootpath, collection, "TextData", dir_name, "model_best.pth.tar")
    if not os.path.exists(path):
        logger.warning("StrongCLIP text tower load failed: [Errno 2] No such file or "
                       "directory: %r", path)
        return
    featurizers["clip"] = strongclip_text_featurizer(rootpath, collection, dir_name, device)


def check_streamable(opt: PredictOptions, measure: str, n_videos: int) -> None:
    """What the streamed (large-gallery) path does not serve raises before
    the gallery is read."""
    if measure != "cosine":
        raise ValueError(f"measure {measure!r} over a gallery of {n_videos} videos (above "
                         f"LARGE_GALLERY {LARGE_GALLERY}): streamed galleries are scored by "
                         f"cosine only")
    if opt.rerank in ("kreciprocal", "tkb"):
        raise ValueError(f"--rerank {opt.rerank} over a gallery of {n_videos} videos (above "
                         f"LARGE_GALLERY {LARGE_GALLERY}): it needs the gallery-gallery "
                         f"product, which is not formed for streamed galleries")


def main(opt: PredictOptions) -> Dict:
    """Returns {query_set: ...}: for a benchmark collection the 't2v' and
    'v2t' metric tuples, 't2v_ranks', 'negated_queries' (None without
    negation scoring), with each_head 'per_head', and over a streamed
    gallery without post-processing 'v2t_ranks' (each captioned video's
    sorted positive ranks, in gallery order); for an AVS query set
    'score_file', 'negated_queries' and with the int8 gallery 'int8' (its
    'int8_bytes' on the device and the 'union' of nominated videos); both
    with 'seconds' per phase (the streamed benchmark's 'pass1' and 'pass2',
    the int8 gallery's 'int8_stream', 'nominate', 'reembed' and
    'exact_topk')."""
    check_options(opt)
    device = resolve_device(opt.device)
    ckpt = load_checkpoint(opt.model_path)
    config = ckpt["config"]
    model = rebuild_model(ckpt, device)
    embedder = Embedder(model, device, prefetch_depth=max(2, opt.num_workers))
    featurizers = rebuild_featurizers(ckpt, opt.rootpath, device)
    strongclip_swap(ckpt, featurizers, opt.rootpath, opt.testCollection, device)
    parm_adjust = str(ckpt.get("opt", {}).get("parm_adjust_config", "None"))
    coll = opt.testCollection
    measure = getattr(config, "measure", "cosine")
    result_dir = os.path.dirname(opt.predict_result_file)
    result_name = os.path.basename(opt.predict_result_file)
    model_tag = opt.model_path + "\t" + coll
    results: Dict[str, Dict] = {}
    vis_embs: Optional[torch.Tensor] = None

    for query_set in opt.query_sets.split(","):
        is_avs = coll in AVS_COLLECTIONS or query_set == "simple_query.txt"
        output_dir = os.path.join(opt.rootpath, coll, "SimilarityIndex", query_set,
                                  opt.sim_name)
        score_file = os.path.join(output_dir, "id.sent.score.txt")
        if check_to_skip(score_file, opt.overwrite):
            continue
        makedirs(output_dir)
        seconds: Dict[str, float] = {}
        tick = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal tick
            _sync(device)
            now = time.perf_counter()
            seconds[name] = seconds.get(name, 0.0) + now - tick
            tick = now

        vis_feed, txt_feed, tsrc, vis_ids = build_test_feeds(opt, config, query_set, featurizers)
        streamed = len(vis_ids) > LARGE_GALLERY
        if streamed:
            check_streamable(opt, measure, len(vis_ids))
        # no post-processing over a streamed gallery: no host (T, V) scores
        counted = streamed and opt.rerank == "none" and opt.task3_caption == "no_task3_caption"
        txt_embs, txt_ids = embedder.embed_txt(txt_feed)
        lap("embed_txt")
        if not streamed and vis_embs is None:  # cached across query sets
            vis_embs, vis_ids = embedder.embed_vis(vis_feed)
            lap("embed_vis")

        def scores_of(embs: torch.Tensor) -> np.ndarray:
            nonlocal vis_ids
            if streamed:  # every query set and clause streams the gallery again
                out, vis_ids = score_matrix_streaming(embedder, embs, vis_feed)
                lap("stream")
                return out
            out = score_matrix(embs, vis_embs, measure=measure)
            lap("score_matrix")
            return out

        adjusted, negated, streamed_eval = False, None, None
        if counted and not is_avs:
            streamed_eval = streaming_benchmark_eval(embedder, txt_embs, txt_ids, vis_feed,
                                                     topk=AVS_SCORE_TOPK,
                                                     rank_path=opt.rank_path, lap=lap)
            vis_ids = streamed_eval["vis_ids"]
        elif counted and opt.int8_gallery:
            streamed_eval = int8_streaming_topk(embedder, txt_embs, vis_feed, AVS_SCORE_TOPK,
                                                lap=lap)
            vals, idx, vis_ids = (streamed_eval[k] for k in ("topk_vals", "topk_idx", "vis_ids"))
        else:
            if opt.task3_caption != "no_task3_caption":
                pos_embs, neg_embs, neg_mask = embed_negation_split(embedder, txt_feed, tsrc,
                                                                    txt_ids)
                negated = int(neg_mask.sum())
                lap("negation")
                if neg_embs is None:
                    logger.warning("task3_caption=%s set but no query contains a negation "
                                   "cue; scores unchanged", opt.task3_caption)
                else:
                    adjusted = True
                    scores = negation_adjusted_scores(scores_of(pos_embs), scores_of(neg_embs),
                                                      neg_mask, method=opt.neg_method)
                    logger.info("negation scoring (%s): %d/%d queries carry a negation",
                                opt.neg_method, negated, len(txt_ids))
            if not adjusted:
                scores = scores_of(txt_embs)
            if opt.rerank == "concept":
                scores = concept_rerank_scores(opt, scores, txt_ids, vis_ids, tsrc)
                lap("rerank")
            elif opt.rerank != "none":
                scores = apply_rerank(opt.rerank, scores, txt_embs, vis_embs)
                lap("rerank")
            if is_avs:
                vals, idx = score_rankings(scores, device, AVS_SCORE_TOPK)
                lap("topk")

        if is_avs:
            write_score_files([(score_file, vals, idx)], txt_ids, vis_ids)
            lap("score_file")
            write_rank_dump(os.path.join(output_dir, "t2v.pkl"), vals[:, :DUMP_TOPK],
                            idx[:, :DUMP_TOPK], txt_ids, vis_ids, tsrc.captions)
            lap("rank_dump")
            logger.info("wrote %s", score_file)
            results[query_set] = {"score_file": score_file, "seconds": seconds,
                                  "negated_queries": negated}
            if streamed_eval is not None:
                results[query_set]["int8"] = {k: streamed_eval[k]
                                              for k in ("int8_bytes", "union")}
            continue

        if streamed_eval is not None:
            t2v, ranks = streamed_eval["t2v"], streamed_eval["t2v_ranks"]
            ranking = streamed_eval["topk_vals"], streamed_eval["topk_idx"]
        else:
            if adjusted or opt.rerank != "none" or streamed:
                t2v, ranks = t2v_from_scores(scores, txt_ids, vis_ids, device)
            else:
                ranks = t2v_ranks(txt_embs, vis_embs, txt_ids, vis_ids, measure=measure,
                                  rank_path=opt.rank_path)
                t2v = metrics_from_ranks(ranks)
            lap("t2v_ranks")
            ranking = score_rankings(scores, device, DUMP_TOPK)
        append_result_row(os.path.join(result_dir, "TextToVideo", result_name),
                          model_tag, parm_adjust, t2v)
        write_rank_dump(os.path.join(output_dir, "t2v.pkl"), *ranking, txt_ids, vis_ids,
                        tsrc.captions)
        lap("rank_dump")
        if streamed_eval is not None:
            v2t = streamed_eval["v2t"]
        else:
            v2t = eval_v2t(scores, txt_ids, vis_ids)
            lap("v2t")
        append_result_row(os.path.join(result_dir, "VideoToText", result_name),
                          model_tag, parm_adjust, v2t)
        results[query_set] = {"t2v": t2v, "v2t": v2t, "t2v_ranks": ranks,
                              "seconds": seconds, "negated_queries": negated}
        if streamed_eval is not None:
            results[query_set]["v2t_ranks"] = streamed_eval["v2t_ranks"]
        if opt.each_head and txt_embs.ndim == 3 and vis_embs is not None:
            results[query_set]["per_head"] = each_head_outputs(
                opt, output_dir, txt_embs, vis_embs, txt_ids, vis_ids, model_tag, parm_adjust,
                device)
            lap("each_head")
        logger.info("%s t2v r1=%.2f r5=%.2f r10=%.2f medr=%.0f mir=%.4f",
                    query_set, t2v[0], t2v[1], t2v[2], t2v[3], t2v[5])
    return results
