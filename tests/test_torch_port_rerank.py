"""The predictor's post-processing on the CPU, held against laff_tpu:
re-ranking, negation scoring and per-head dumps.

* ``k_reciprocal_rerank`` and ``tkb_rerank`` on seeded data without ties:
  equal to laff_tpu's within 1e-6; the port's tie rules (neighbour lists
  in increasing index order among equal distances, top-K in decreasing
  index order among equal scores) pinned on matrices with exact ties;
* ``_lemmatize_query``, ``ConceptRerank`` and ``load_word_counts``: equal
  (both packages take the same lemmatizer branch in one process);
* ``predictor.main`` of both packages on one checkpoint carried over from
  flax, for ``--task3_caption`` (both ``neg_method``s), each ``--rerank``
  kind and ``--each_head 1``: the t2v and v2t rows equal, the per-head
  rows equal, and the ``head<h>.id.sent.score.txt`` files equal line for
  line (the same caption and video ids in the same order, the scores
  within 1e-6 as numbers); the t2v row of re-ranked scores equals
  ``eval_t2v`` of the port's score matrix;
* negation scoring with precomputed text features only: the clause
  embeddings equal the query's and the "NEGATION SCORING IS INERT"
  warning is logged.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from laff_tpu.configs import rehearsal as jax_rehearsal
from laff_tpu.data import TextBatcher as JTextBatcher, TextSource as JTextSource
from laff_tpu.data import VisBatcher as JVisBatcher, VisionSource as JVisionSource
from laff_tpu.data.synth import build_collection, build_w2v, make_word_pool
from laff_tpu.engine import predictor as jax_predictor
from laff_tpu.engine.checkpoint import save_checkpoint as jax_save
from laff_tpu.engine.prepare import (_text_precomputed, build_featurizers as jax_featurizers,
                                     build_spec as jax_build_spec)
from laff_tpu.eval import rerank as jax_rerank
from laff_tpu.models import LAFFModel as FlaxLAFF
from laff_tpu.store import BigFile, write_bigfile
from laff_tpu_torch.cli.do_predictor import parse_args
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.data import EvalFeed, TextBatcher, TextSource
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.prepare import build_featurizers, build_spec
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.eval import rerank as port_rerank
from laff_tpu_torch.eval.metrics import eval_t2v
from laff_tpu_torch.models import LAFFModel

COLL = "toyneg"
QUERY = f"{COLL}.caption.txt"
WORD_POOL = make_word_pool(40)
RERANK_RTOL = 1e-6


def _unit(rng, n, d=24):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _sims(seed, t, v):
    rng = np.random.default_rng(seed)
    tn, vn = _unit(rng, t), _unit(rng, v)
    return tn @ vn.T, tn @ tn.T, vn @ vn.T


# ---------------------------------------------------------------------------
# the re-rankers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,v,k1,k2", [(30, 20, 20, 6), (90, 40, 10, 3), (50, 60, 20, 1)])
def test_k_reciprocal_equals_laff_tpu(t, v, k1, k2):
    qg, qq, gg = _sims(t + v, t, v)
    want = jax_rerank.k_reciprocal_rerank(qg, qq, gg, k1=k1, k2=k2)
    got = port_rerank.k_reciprocal_rerank(qg, qq, gg, k1=k1, k2=k2)
    np.testing.assert_allclose(got, want, rtol=RERANK_RTOL, atol=RERANK_RTOL)


@pytest.mark.parametrize("topk", [5, 1000])
def test_tkb_equals_laff_tpu(topk):
    qg, _, gg = _sims(3, 40, 25)
    np.testing.assert_allclose(port_rerank.tkb_rerank(qg, gg, topK=topk, k1=4),
                               jax_rerank.tkb_rerank(qg, gg, topK=topk, k1=4),
                               rtol=RERANK_RTOL, atol=RERANK_RTOL)


def test_tie_rules():
    """Exact ties: the k-reciprocal neighbour lists take equal distances in
    increasing index order, the top-K lists equal scores in decreasing
    index order, whatever numpy's unstable sorts would do."""
    dist = np.array([[0.0, 0.5, 0.2, 0.5, 0.5, 0.9],
                     [0.3, 0.3, 0.3, 0.3, 0.1, 0.3]], np.float32)
    np.testing.assert_array_equal(port_rerank._nearest(dist, 3), [[0, 2, 1, 3], [4, 0, 1, 2]])
    np.testing.assert_array_equal(port_rerank._descending(dist, 3), [[5, 4, 3], [5, 3, 2]])
    # tkb: equal gallery similarities count the larger index as the nearer
    gg = np.ones((4, 4), np.float32)
    qg = np.array([[0.5, 0.5, 0.5, 0.1]], np.float32)
    counts = 1.0 + np.bincount(np.array([[3, 2]] * 4).ravel(), minlength=4)
    expect = np.zeros((1, 4))
    expect[0, [2, 1]] = np.log(counts[[2, 1]] + 1.0)
    expect /= np.sqrt((expect ** 2).sum()) + 1e-13 + 1e-14
    np.testing.assert_allclose(port_rerank.tkb_rerank(qg, gg, topK=2, k1=2), expect)
    # k-reciprocal on duplicated rows (every distance tied with its twin):
    # the result is the one of neighbour lists in increasing index order
    rng = np.random.default_rng(0)
    tn, vn = np.repeat(_unit(rng, 6), 2, axis=0), np.repeat(_unit(rng, 5), 2, axis=0)
    qg, qq, gg = tn @ vn.T, tn @ tn.T, vn @ vn.T
    got = port_rerank.k_reciprocal_rerank(qg, qq, gg, k1=5, k2=3)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, port_rerank.k_reciprocal_rerank(qg, qq, gg, k1=5, k2=3))


QUERIES = ["The dogs are running in the park", "a red car without wheels",
           "two women eating cakes quickly", "nothing", "cats sat on big tables"]


def test_lemmatizer_and_concept_rerank_equal_laff_tpu(tmp_path):
    assert [port_rerank._lemmatize_query(q) for q in QUERIES] == \
        [jax_rerank._lemmatize_query(q) for q in QUERIES]
    assert port_rerank.LEMMATIZER["branch"] in ("nltk", "stopwords")
    rng = np.random.default_rng(1)
    concepts = ["dog", "park", "car", "wheel", "woman", "cake", "cat", "table", "red"]
    pkl = tmp_path / "concepts.pkl"
    with open(pkl, "wb") as fh:
        pickle.dump({"txt2video_cos_sim_matrix": rng.uniform(size=(len(concepts), 12)),
                     "txt_ids": concepts, "vis_ids": [f"v{i}" for i in range(12)]}, fh)
    counts_file = tmp_path / "counts.txt"
    counts_file.write_text("dog 7\npark 3\ncar 11\n")
    counts = port_rerank.load_word_counts(str(counts_file))
    assert counts == jax_rerank.load_word_counts(str(counts_file))
    scores = rng.standard_normal((len(QUERIES), 8)).astype(np.float32)
    cols = [11, 0, 3, 5, 7, 2, 9, 4]
    kw = dict(topK=5, word_counts=counts, caption_text=" ".join(QUERIES) + " woman woman")
    got = port_rerank.ConceptRerank(str(pkl), cols, scores, QUERIES, **kw)
    want = jax_rerank.ConceptRerank(str(pkl), cols, scores, QUERIES, **kw)
    assert got.query_list == want.query_list and got.concept_freq == want.concept_freq
    np.testing.assert_allclose(got.rerank(weight=1.5), want.rerank(weight=1.5), rtol=1e-12)


# ---------------------------------------------------------------------------
# the predictor of both packages on one carried checkpoint
# ---------------------------------------------------------------------------

def _small(config):
    """The rehearsal headline config cut to test widths."""
    config.vid_feats = ["clip_ft", "x3d"]
    config.vis_fc_layers = ["0", 64]
    config.txt_fc_layers = "0-64"
    config.multi_head_attention = {"dropout": 0.0, "heads": 4, "embed_dim_qkv": 16}
    config.clip_opt = dict(config.clip_opt, size=16)
    config.w2v_dir = "word2vec/toy"
    config.we_dim = 8
    config.rnn_size = 16
    config.threshold = 1
    config.float16 = False
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 30-video collection over a 40-word pool whose every third caption
    carries a negation ('... not <word>'), its CLIP rows, a concept pkl, and
    one flax init with non-trivial BatchNorm statistics saved by both
    packages."""
    root = str(tmp_path_factory.mktemp("rerank_world"))
    _, vids, lines = build_collection(root, COLL, n_videos=30, caps_per_video=2, seed=4,
                                      word_pool=WORD_POOL)
    build_w2v(root, word_pool=WORD_POOL)
    capfile = os.path.join(root, COLL, "TextData", QUERY)
    lines = [line + f" not {WORD_POOL[(7 * i) % len(WORD_POOL)]}" if i % 3 == 0 else line
             for i, line in enumerate(lines)]
    with open(capfile, "w") as fh:
        fh.write("\n".join(lines))
    cap_ids = [line.split(" ", 1)[0] for line in lines]
    rng = np.random.default_rng(11)
    write_bigfile(os.path.join(root, COLL, "TextData", "clip_synth"), cap_ids,
                  rng.standard_normal((len(cap_ids), 16)).astype(np.float32))
    concept_pkl = os.path.join(root, "concepts.pkl")
    with open(concept_pkl, "wb") as fh:
        pickle.dump({"txt2video_cos_sim_matrix": rng.uniform(size=(12, len(vids) + 3)),
                     "txt_ids": WORD_POOL[:12], "vis_ids": ["extra0", *vids, "x1", "x2"]}, fh)

    jcfg = _small(jax_rehearsal.config())
    feats, txt_dims, gru_spec, _, _ = jax_featurizers(jcfg, root, COLL, capfile)
    files = {n: BigFile(os.path.join(root, COLL, "FeatureData", n)) for n in jcfg.vid_feats}
    vis_dims = {n: f.ndims for n, f in files.items()}
    jspec = jax_build_spec(jcfg, vis_dims, txt_dims, gru_spec)
    tb = JTextBatcher(JTextSource(capfile, precomputed=_text_precomputed(jcfg, capfile)),
                      dict(feats))
    vb = JVisBatcher(JVisionSource(files, vids))
    txt = {k: jax.numpy.asarray(v) for k, v in tb(cap_ids[:2]).items()}
    vis = {k: jax.numpy.asarray(v) for k, v in vb(vids[:2]).items()}
    variables = FlaxLAFF(jspec).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, txt, vis)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    for tower in stats.values():
        for mod in tower.values():
            if "bn1" in mod:
                n = mod["bn1"]["mean"].shape[0]
                mod["bn1"]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                mod["bn1"]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jcfg.t2v_bow, jcfg.t2v_idx = feats.get("bow"), feats.get("rnn")
    jax_ckpt = os.path.join(root, "jax_model.pth.tar")
    jax_save({"params": params, "batch_stats": stats, "schedule": {}, "config": jcfg,
              "opt": {"trainCollection": COLL, "parm_adjust_config": "None"},
              "spec": jspec}, jax_ckpt)
    pcfg = _small(port_rehearsal.config())
    pfeats, ptxt_dims, pgru, _, _ = build_featurizers(pcfg, root, COLL, capfile)
    model = LAFFModel(build_spec(pcfg, vis_dims, ptxt_dims, pgru))
    model.load_state_dict(from_jax_variables(params, stats, {}))
    port_ckpt = os.path.join(root, "port_model.pt")
    save_checkpoint(checkpoint_payload(model.state_dict(), model.spec, pcfg, pfeats,
                                       {"config_name": "rehearsal"}), port_ckpt)
    return {"root": root, "jax_ckpt": jax_ckpt, "port_ckpt": port_ckpt,
            "concept_pkl": concept_pkl, "capfile": capfile}


OPTIONS = {
    "negation_sub": {"task3_caption": "negation"},
    "negation_mul": {"task3_caption": "negation", "neg_method": "mul"},
    "kreciprocal": {"rerank": "kreciprocal"},
    "tkb": {"rerank": "tkb"},
    "concept": {"rerank": "concept", "concept_topk": 20, "concept_weight": 1.5},
    "each_head": {"each_head": 1},
}


def _result_dir(world, who, name):
    return os.path.join(world["root"], "result_log", f"{who}_{name}")


def _score_dir(world, sim_name):
    return os.path.join(world["root"], COLL, "SimilarityIndex", QUERY, sim_name)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_predictor_postprocessing_equals_laff_tpu(world, name):
    extra = dict(OPTIONS[name])
    if name == "concept":
        extra.update(concept_pkl=world["concept_pkl"], concept_caption=world["capfile"])
    jopt = jax_predictor.PredictOptions(
        testCollection=COLL, model_path=world["jax_ckpt"], sim_name=f"jax_{name}",
        rootpath=world["root"], query_sets=QUERY, batch_size=16, overwrite=1,
        predict_result_file=os.path.join(_result_dir(world, "jax", name), "r.txt"), **extra)
    want = jax_predictor.main(jopt)[QUERY]
    argv = [COLL, world["port_ckpt"], f"port_{name}", "--rootpath", world["root"],
            "--query_sets", QUERY, "--batch_size", "16", "--overwrite", "1", "--device", "cpu",
            "--predict_result_file", os.path.join(_result_dir(world, "port", name), "r.txt")]
    for k, v in extra.items():
        argv += [f"--{k}", str(v)]
    got = port_predictor.main(parse_args(argv))[QUERY]
    assert got["t2v"] == pytest.approx(want["t2v"], rel=1e-12)
    assert got["v2t"] == pytest.approx(want["v2t"], rel=1e-12)
    if name == "each_head":
        assert len(got["per_head"]) == 4
        for a, b in zip(got["per_head"], want["per_head"]):
            assert a == pytest.approx(b, rel=1e-12)
        for h in range(4):
            files = [os.path.join(_score_dir(world, f"{who}_{name}"), f"head{h}.id.sent.score.txt")
                     for who in ("port", "jax")]
            port_lines, jax_lines = (open(f).read().splitlines() for f in files)
            assert len(port_lines) == len(jax_lines) == 60
            for pl, jl in zip(port_lines, jax_lines):
                # '<txt_id> <vis_id> <score> ...': the ids equal, the scores
                # as numbers (laff_tpu's text of a score depends on its float
                # width; the port writes float32's shortest form)
                p, j = pl.split(), jl.split()
                assert [p[0], *p[1::2]] == [j[0], *j[1::2]]
                np.testing.assert_allclose(np.asarray(p[2::2], np.float64),
                                           np.asarray(j[2::2], np.float64), atol=1e-6)
        for who in ("port", "jax"):
            perf = open(os.path.join(_score_dir(world, f"{who}_{name}"), "perf.txt")).read()
            assert perf.count("Text to video head") == 4
            assert os.path.exists(os.path.join(_result_dir(world, who, name), "TextToVideo",
                                               "head3_r.txt"))


def test_rerank_t2v_comes_from_the_score_matrix(world):
    """The re-ranked t2v row is eval_t2v of the re-ranked scores (the
    port's device count, ties larger-index-first, equals the host label
    matrix here)."""
    ckpt = port_predictor.load_checkpoint(world["port_ckpt"])
    device = torch.device("cpu")
    model = port_predictor.rebuild_model(ckpt, device)
    feats = port_predictor.rebuild_featurizers(ckpt, world["root"])
    opt = port_predictor.PredictOptions(testCollection=COLL, model_path=world["port_ckpt"],
                                        sim_name="direct", rootpath=world["root"],
                                        device="cpu", batch_size=16)
    vis_feed, txt_feed, _, vis_ids = port_predictor.build_test_feeds(opt, ckpt["config"], QUERY,
                                                                    feats)
    embedder = port_predictor.Embedder(model, device)
    txt_embs, txt_ids = embedder.embed_txt(txt_feed)
    vis_embs, vis_ids = embedder.embed_vis(vis_feed)
    scores = port_predictor.score_matrix(txt_embs, vis_embs)
    for kind in ("kreciprocal", "tkb"):
        reranked = port_predictor.apply_rerank(kind, scores, txt_embs, vis_embs)
        got, _ = port_predictor.t2v_from_scores(reranked, txt_ids, vis_ids, device)
        assert got == pytest.approx(eval_t2v(reranked, txt_ids, vis_ids), rel=1e-12)


def test_negation_scoring_with_precomputed_text_only_is_inert(tmp_path, monkeypatch, caplog):
    cap_path = tmp_path / "caps.txt"
    cap_path.write_text("video1#0 a man not wearing a hat\nvideo2#0 a dog runs\n")
    rows = {f"video{i}#0": np.random.default_rng(i).normal(size=8).astype(np.float32)
            for i in (1, 2)}

    class FakeBigFile:
        def gather(self, cap_ids):
            return list(cap_ids), np.stack([rows[c] for c in cap_ids])

    tsrc = TextSource(str(cap_path), precomputed={"CLIP_encoding": FakeBigFile()})
    feed = EvalFeed(tsrc.cap_ids, TextBatcher(tsrc, {"clip": None}), batch_size=2)

    class FakeEmbedder:
        def embed_txt(self, f):
            chunks, ids = [], []
            for item in f:
                chunks.append(torch.from_numpy(item["data"]["clip"][: item["valid"]]))
                ids.extend(item["ids"])
            return torch.cat(chunks), ids

    logger = port_predictor.logger
    monkeypatch.setattr(logger, "handlers", [*logger.handlers, caplog.handler])
    pos, neg, mask = port_predictor.embed_negation_split(FakeEmbedder(), feed, tsrc,
                                                         tsrc.cap_ids)
    assert mask.tolist() == [1.0, 0.0]
    assert any("NEGATION SCORING IS INERT" in r.message for r in caplog.records)
    assert torch.equal(pos, neg)
    adjusted = port_predictor.negation_adjusted_scores(np.zeros((2, 3), np.float32),
                                                       np.ones((2, 3), np.float32), mask)
    np.testing.assert_allclose(adjusted, [[-0.5] * 3, [0.0] * 3])
