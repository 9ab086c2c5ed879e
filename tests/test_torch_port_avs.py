"""AVS ad-hoc search and large galleries on the CPU, held against laff_tpu.

One flax init, carried into the port by ``from_jax_variables`` and saved by
both packages, answers the same query sets in both predictors:

* an AVS collection named ``iacc.3`` (``build_avs_world``: 40 shots, two
  editions of 3 topics, their CLIP rows and qrels) with its gallery embedded
  whole, and streamed (``LARGE_GALLERY`` 5 in both predictor modules, two
  query sets, so the gallery streams once a set), and streamed with
  --int8_gallery 1 (int8 nomination, exact rescoring); negation scoring
  over the streamed gallery; ``simple_query.txt`` on a benchmark
  collection; a benchmark collection above the threshold with negation
  scoring or concept re-ranking (t2v and v2t from the streamed scores); and
  ``ibench``, a benchmark caption set over iacc.3's gallery, above the
  threshold without post-processing (``streaming_benchmark_eval``: two
  passes of device counting, ``t2v.pkl`` the streamed top 2,000). The
  ``id.sent.score.txt`` ids are equal and the scores within 1e-5, the
  ``t2v.pkl`` keys, queries and rank lists equal, the TSV rows equal;
* the port's streamed scores against its cached ones; top-K ties in
  decreasing gallery index order on a gallery of duplicated rows (the
  streamed benchmark's running top-k keeps the same rule across gallery
  blocks, where ``laff_tpu`` puts the lower index first:
  ``tests/test_torch_port_large_gallery.py``);
* a StrongCLIP checkpoint whose fine-tuned CLIP text tower is on disk
  (plain or 'ClipModel.'-prefixed keys, and with --task3_caption): the
  live tower's rows in both predictors, equal score files; without the
  file, laff_tpu's warning; a file that does not load raises in the port
  (laff_tpu warns);
* what raises: 'kreciprocal', 'tkb' and measure 'hist' above the threshold
  (ValueError, where laff_tpu crashes or scores cosine); and what runs now:
  a large benchmark gallery without post-processing and --int8_gallery 1,
  which raised naming ROADMAP item 3b until the port served them, and
  --data_parallel 2 on one device, which raised naming item 5;
* --data_parallel 1 and 2 through both CLIs on one device: laff_tpu's
  warning, then the single-device run; with two or more cards visible both
  raise naming item 5;
* ``build_avs_world``'s layout, relevance rule and chunked writes, its
  benchmark over the gallery, and the package data an installed port needs.
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
from laff_tpu.engine import predictor as jax_predictor
from laff_tpu.engine.checkpoint import save_checkpoint as jax_save
from laff_tpu.engine.prepare import (_text_precomputed, build_featurizers as jax_featurizers,
                                     build_spec as jax_build_spec)
from laff_tpu.models import LAFFModel as FlaxLAFF
from laff_tpu.store import BigFile
from laff_tpu_torch.cli.do_predictor import parse_args
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.data import synth
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.evaluator import Embedder, score_matrix_streaming
from laff_tpu_torch.engine.prepare import build_featurizers, build_spec
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import LAFFModel
from laff_tpu_torch.models.clip import ClipTextConfig, ClipTextTower

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVS, BENCH, TRAIN, IBENCH = "iacc.3", "avsbench", "avstrain", "ibench"
N_VOCAB = 60
SCORE_ATOL = 1e-5  # the packages' f32 towers and products, summed in other orders
EDITIONS = ("tv16", "tv17")
AVS_SETS = ",".join(f"{e}.avs.txt" for e in EDITIONS)


def _small(config):
    """The rehearsal headline config cut to test widths: two video features,
    a common space as wide as the CLIP rows it passes through, 8 heads."""
    config.vid_feats = ["clip_ft", "x3d"]
    config.vis_fc_layers = ["0", synth.CLIP_DIM]
    config.txt_fc_layers = f"0-{synth.CLIP_DIM}"
    config.multi_head_attention = {"dropout": 0.0, "heads": 8, "embed_dim_qkv": 64}
    config.rnn_size = 16
    config.threshold = 1
    config.float16 = False
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A train collection, the AVS collection, and a benchmark collection
    with negated captions, a concept pkl and a simple_query.txt, all over
    one 60-word vocabulary; one flax init with non-trivial BatchNorm
    statistics saved by both packages."""
    root = str(tmp_path_factory.mktemp("avs_world"))
    synth.build_world(root, TRAIN, n_videos=30, caps_per_video=2, n_vocab=N_VOCAB, seed=1)
    avs = synth.build_avs_world(root, AVS, n_videos=40, editions=EDITIONS, topics_per_edition=3,
                                n_vocab=N_VOCAB, seed=2, relevant=(2, 5),
                                benchmark=(IBENCH, 8, 2))
    synth.build_world(root, BENCH, n_videos=30, caps_per_video=2, n_vocab=N_VOCAB, seed=3,
                      negations=True, concept_pkl=True)
    tdir = os.path.join(root, AVS, "TextData")
    topics = open(os.path.join(tdir, "tv16.avs.txt")).read().splitlines()
    # the first topic's query with a negated clause, the others plain
    with open(os.path.join(tdir, "neg.avs.txt"), "w") as fh:
        fh.write("\n".join([topics[0] + " not w00007", *topics[1:]]))
    bench_caps = open(os.path.join(root, BENCH, "TextData", f"{BENCH}.caption.txt")).read()
    with open(os.path.join(root, BENCH, "TextData", "simple_query.txt"), "w") as fh:
        fh.write("\n".join(bench_caps.splitlines()[:5]))

    capfile = os.path.join(root, TRAIN, "TextData", f"{TRAIN}.caption.txt")
    jcfg = _small(jax_rehearsal.config())
    feats, txt_dims, gru_spec, _, _ = jax_featurizers(jcfg, root, TRAIN, capfile)
    files = {n: BigFile(os.path.join(root, TRAIN, "FeatureData", n)) for n in jcfg.vid_feats}
    vis_dims = {n: f.ndims for n, f in files.items()}
    jspec = jax_build_spec(jcfg, vis_dims, txt_dims, gru_spec)
    tsrc = JTextSource(capfile, precomputed=_text_precomputed(jcfg, capfile))
    tb = JTextBatcher(tsrc, dict(feats))
    vids = [f"{TRAIN}_v{i}" for i in range(2)]
    txt = {k: jax.numpy.asarray(v) for k, v in tb(tsrc.cap_ids[:2]).items()}
    vis = {k: jax.numpy.asarray(v) for k, v in JVisBatcher(JVisionSource(files, vids))(vids).items()}
    variables = FlaxLAFF(jspec).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, txt, vis)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    rng = np.random.default_rng(11)
    for tower in stats.values():
        for mod in tower.values():
            if "bn1" in mod:
                n = mod["bn1"]["mean"].shape[0]
                mod["bn1"]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                mod["bn1"]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jcfg.t2v_bow, jcfg.t2v_idx = feats.get("bow"), feats.get("rnn")
    jax_ckpt = os.path.join(root, "jax_model.pth.tar")
    jax_payload = {"params": params, "batch_stats": stats, "schedule": {}, "config": jcfg,
                   "opt": {"trainCollection": TRAIN, "parm_adjust_config": "None"},
                   "spec": jspec}
    jax_save(jax_payload, jax_ckpt)
    jax_strong_ckpt = os.path.join(root, "jax_strong_model.pth.tar")
    jax_save(dict(jax_payload, opt={**jax_payload["opt"],
                                    "config_name": "FrameLaff_NoFrameFc_StrongCLIP_adjust"}),
             jax_strong_ckpt)
    pcfg = _small(port_rehearsal.config())
    pfeats, ptxt_dims, pgru, _, _ = build_featurizers(pcfg, root, TRAIN, capfile)
    model = LAFFModel(build_spec(pcfg, vis_dims, ptxt_dims, pgru))
    model.load_state_dict(from_jax_variables(params, stats, {}))
    payload = checkpoint_payload(model.state_dict(), model.spec, pcfg, pfeats,
                                 {"config_name": "rehearsal"})
    port_ckpt = os.path.join(root, "port_model.pt")
    save_checkpoint(payload, port_ckpt)
    # the same weights under a StrongCLIP config name, and with measure 'hist'
    strong_ckpt = os.path.join(root, "strong_model.pt")
    save_checkpoint(dict(payload, opt={"config_name": "FrameLaff_NoFrameFc_StrongCLIP_adjust"}),
                    strong_ckpt)
    hist_ckpt = os.path.join(root, "hist_model.pt")
    save_checkpoint(dict(payload, config=dict(payload["config"], measure="hist")), hist_ckpt)
    return {"root": root, "jax_ckpt": jax_ckpt, "port_ckpt": port_ckpt, "avs": avs,
            "strong_ckpt": strong_ckpt, "jax_strong_ckpt": jax_strong_ckpt,
            "hist_ckpt": hist_ckpt}


def _port_opt(world, coll, query_sets, sim_name, ckpt=None, **extra):
    argv = [coll, ckpt or world["port_ckpt"], sim_name, "--rootpath", world["root"],
            "--query_sets", query_sets, "--batch_size", "16", "--overwrite", "1",
            "--device", "cpu", "--predict_result_file",
            os.path.join(world["root"], "result_log", sim_name, "r.txt")]
    for k, v in extra.items():
        argv += [f"--{k}", str(v)]
    return parse_args(argv)


def _score_dir(world, coll, query_set, sim_name):
    return os.path.join(world["root"], coll, "SimilarityIndex", query_set, sim_name)


def _read_scores(path):
    """{txt_id: (vis_ids, scores)} of an id.sent.score.txt."""
    out = {}
    for line in open(path).read().splitlines():
        parts = line.split()
        out[parts[0]] = (parts[1::2], np.asarray(parts[2::2], np.float64))
    return out


def _assert_same_ranking_files(got_dir, want_dir, score_file):
    if score_file:
        got = _read_scores(os.path.join(got_dir, "id.sent.score.txt"))
        want = _read_scores(os.path.join(want_dir, "id.sent.score.txt"))
        assert list(got) == list(want)
        for tid in want:
            assert got[tid][0] == want[tid][0], tid
            np.testing.assert_allclose(got[tid][1], want[tid][1], atol=SCORE_ATOL)
    got_pkl, want_pkl = (pickle.load(open(os.path.join(d, "t2v.pkl"), "rb"))
                         for d in (got_dir, want_dir))
    assert list(got_pkl) == list(want_pkl)
    for tid, w in want_pkl.items():
        assert got_pkl[tid]["query"] == w["query"]
        assert got_pkl[tid]["rank_list"] == w["rank_list"], tid
        np.testing.assert_allclose(got_pkl[tid]["sim_value"], w["sim_value"], atol=SCORE_ATOL)


# name: (collection, query sets, LARGE_GALLERY or None, options)
CASES = {
    "avs_cached": (AVS, AVS_SETS, None, {}),
    "avs_streamed": (AVS, AVS_SETS, 5, {}),
    "avs_int8_streamed": (AVS, AVS_SETS, 5, {"int8_gallery": 1}),
    "benchmark_counted_streamed": (IBENCH, f"{IBENCH}.caption.txt", 5, {}),
    "avs_negation_streamed": (AVS, "neg.avs.txt", 5, {"task3_caption": "negation"}),
    "simple_query": (BENCH, "simple_query.txt", None, {}),
    "benchmark_negation_streamed": (BENCH, f"{BENCH}.caption.txt", 5,
                                    {"task3_caption": "negation"}),
    "benchmark_concept_streamed": (BENCH, f"{BENCH}.caption.txt", 5,
                                   {"rerank": "concept", "concept_topk": 20}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_predictor_equals_laff_tpu(world, monkeypatch, name):
    coll, query_sets, large, extra = CASES[name]
    extra = dict(extra)
    if extra.get("rerank") == "concept":
        extra["concept_pkl"] = os.path.join(world["root"], BENCH, "TextData", "concept_sim.pkl")
    if large is not None:
        monkeypatch.setattr(jax_predictor, "LARGE_GALLERY", large)
        monkeypatch.setattr(port_predictor, "LARGE_GALLERY", large)
    jopt = jax_predictor.PredictOptions(
        testCollection=coll, model_path=world["jax_ckpt"], sim_name=f"jax_{name}",
        rootpath=world["root"], query_sets=query_sets, batch_size=16, overwrite=1,
        predict_result_file=os.path.join(world["root"], "result_log", f"jax_{name}", "r.txt"),
        **extra)
    want = jax_predictor.main(jopt)
    got = port_predictor.main(_port_opt(world, coll, query_sets, f"port_{name}", **extra))
    assert list(got) == list(want) == query_sets.split(",")
    for query_set in want:
        is_avs = "score_file" in want[query_set]
        assert ("score_file" in got[query_set]) == is_avs
        seconds = set(got[query_set]["seconds"])
        if is_avs and extra.get("int8_gallery"):
            assert seconds >= {"embed_txt", "int8_stream", "nominate", "reembed", "exact_topk",
                               "score_file", "rank_dump"}
        elif is_avs:
            assert seconds >= {"embed_txt", "topk", "score_file", "rank_dump"}
            assert ("stream" in seconds) == (large is not None)
        else:
            assert got[query_set]["t2v"] == pytest.approx(want[query_set]["t2v"], rel=1e-12)
            assert got[query_set]["v2t"] == pytest.approx(want[query_set]["v2t"], rel=1e-12)
            counted = large is not None and not extra
            assert ({"pass1", "pass2"} <= seconds) == counted
            assert ("stream" in seconds) == (large is not None and not counted)
        _assert_same_ranking_files(_score_dir(world, coll, query_set, f"port_{name}"),
                                   _score_dir(world, coll, query_set, f"jax_{name}"), is_avs)
    if name == "avs_negation_streamed":
        assert got["neg.avs.txt"]["negated_queries"] == 1
    if not is_avs:
        for side in ("TextToVideo", "VideoToText"):
            rows = [open(os.path.join(world["root"], "result_log", f"{who}_{name}", side,
                                      "r.txt")).read().split("\t")[2:]
                    for who in ("port", "jax")]
            assert rows[0] == rows[1]


def test_streamed_equals_cached(world, monkeypatch):
    """The port's streamed scores (one flat product per gallery block) equal
    its cached ones (per-head cosines averaged) within f32 rounding."""
    port_predictor.main(_port_opt(world, AVS, AVS_SETS, "cached"))
    monkeypatch.setattr(port_predictor, "LARGE_GALLERY", 5)
    port_predictor.main(_port_opt(world, AVS, AVS_SETS, "streamed"))
    for query_set in AVS_SETS.split(","):
        cached, streamed = (_read_scores(os.path.join(_score_dir(world, AVS, query_set, s),
                                                      "id.sent.score.txt"))
                            for s in ("cached", "streamed"))
        assert list(cached) == list(streamed)
        for tid in cached:
            assert streamed[tid][0] == cached[tid][0]
            np.testing.assert_allclose(streamed[tid][1], cached[tid][1], atol=1e-6)


def test_topk_ties_in_decreasing_index_order(world, monkeypatch):
    """A gallery of duplicated rows scores each pair exactly alike; every
    top-K list (streamed scores, several row blocks) takes the larger gallery
    index first, and keeps the order of the scores."""
    ckpt = port_predictor.load_checkpoint(world["port_ckpt"])
    device = torch.device("cpu")
    model = port_predictor.rebuild_model(ckpt, device)
    feats = port_predictor.rebuild_featurizers(ckpt, world["root"])
    opt = port_predictor.PredictOptions(AVS, world["port_ckpt"], "ties", rootpath=world["root"],
                                        device="cpu", batch_size=8)
    vis_feed, txt_feed, _, vis_ids = port_predictor.build_test_feeds(
        opt, ckpt["config"], "tv16.avs.txt", feats)
    embedder = Embedder(model, device)
    txt_embs, _ = embedder.embed_txt(txt_feed)
    vis_feed.ids = [v for v in vis_ids[:10] for _ in range(2)]  # each shot twice, side by side
    scores, ids = score_matrix_streaming(embedder, txt_embs, vis_feed)
    assert ids == vis_feed.ids and scores.shape == (3, 20)
    np.testing.assert_array_equal(scores[:, 0::2], scores[:, 1::2])
    monkeypatch.setattr(port_predictor, "RANKING_BLOCK", 40)  # two rows a block
    vals, idx = port_predictor.score_rankings(scores, device, threshold=7)
    assert vals.shape == idx.shape == (3, 7)
    for q in range(3):
        np.testing.assert_array_equal(vals[q], scores[q, idx[q]])
        assert (np.diff(vals[q]) <= 0).all()
        expect = sorted(range(20), key=lambda j: (-scores[q, j], -j))[:7]
        assert idx[q].tolist() == expect
        assert all(idx[q][i] == idx[q][i + 1] + 1 for i in range(0, 7 - 1, 2))


# name: (checkpoint key, collection, query set, options, error, text in its
# message); error None: the options run (both raised naming ROADMAP item 3b
# until the port served them), and these seconds' phases show the path taken
RAISES = {
    "kreciprocal_streamed": ("port_ckpt", AVS, "tv16.avs.txt", {"rerank": "kreciprocal"},
                             ValueError, "gallery-gallery product"),
    "tkb_streamed": ("port_ckpt", BENCH, f"{BENCH}.caption.txt", {"rerank": "tkb"},
                     ValueError, "gallery-gallery product"),
    "hist_streamed": ("hist_ckpt", AVS, "tv16.avs.txt", {}, ValueError, "cosine only"),
    "benchmark_streamed": ("port_ckpt", BENCH, f"{BENCH}.caption.txt", {}, None,
                           {"pass1", "pass2"}),
    "int8_gallery": ("port_ckpt", AVS, "tv16.avs.txt", {"int8_gallery": 1}, None,
                     {"int8_stream", "nominate", "reembed", "exact_topk"}),
    "data_parallel": ("port_ckpt", AVS, "tv16.avs.txt", {"data_parallel": 2}, None,
                      {"stream", "score_file"}),
}


@pytest.mark.parametrize("name", sorted(RAISES))
def test_not_served_raises(world, monkeypatch, name):
    key, coll, query_set, extra, error, text = RAISES[name]
    monkeypatch.setattr(port_predictor, "LARGE_GALLERY", 5)
    opt = _port_opt(world, coll, query_set, f"raise_{name}", ckpt=world[key], **extra)
    dump = os.path.join(_score_dir(world, coll, query_set, f"raise_{name}"), "t2v.pkl")
    if error is None:
        assert set(port_predictor.main(opt)[query_set]["seconds"]) >= text
        assert os.path.exists(dump)
        return
    with pytest.raises(error, match=text):
        port_predictor.main(opt)
    assert not os.path.exists(dump)


def test_cli_accepts_laff_tpu_flags(world):
    opt = _port_opt(world, AVS, "tv16.avs.txt", "flags", adjust_weight_predict=1,
                    data_parallel=0, int8_gallery=0)
    assert (opt.adjust_weight_predict, opt.data_parallel, opt.int8_gallery) == (1, 0, 0)
    assert set(port_predictor.main(opt)) == {"tv16.avs.txt"}


def _capture_warnings(monkeypatch, caplog, *loggers):
    """The port's loggers do not propagate: hand ``caplog`` their records."""
    for log in loggers:
        monkeypatch.setattr(log, "handlers", [*log.handlers, caplog.handler])


def _trainer_argv(world, prefix, value):
    return [TRAIN, TRAIN, "--rootpath", world["root"], "--config_name", "rehearsal",
            "--val_set", "no", "--device", "cpu", "--num_epochs", "1", "--batch_size", "16",
            "--overwrite", "1",
            "--model_prefix", prefix, "--data_parallel", str(value)]


@pytest.mark.parametrize("value", [1, 2])
@pytest.mark.parametrize("entry", ["do_predictor", "do_trainer"])
def test_data_parallel_on_one_device(world, monkeypatch, caplog, entry, value):
    """laff_tpu's one-device behaviour: its warning, then the single-device
    run, through either CLI."""
    from laff_tpu_torch.cli import do_predictor, do_trainer
    from laff_tpu_torch.engine import prepare as port_prepare

    _capture_warnings(monkeypatch, caplog, port_prepare.logger)
    if entry == "do_predictor":
        sim = f"dp_{value}"
        opt = _port_opt(world, AVS, "tv16.avs.txt", sim, data_parallel=value)
        assert set(port_predictor.main(opt)) == {"tv16.avs.txt"}
        assert os.path.exists(os.path.join(_score_dir(world, AVS, "tv16.avs.txt", sim),
                                           "id.sent.score.txt"))
    else:
        monkeypatch.setattr(port_prepare, "load_config",
                            lambda name, parm="None": _small(port_rehearsal.config()))
        assert do_trainer.main(_trainer_argv(world, f"dp_{value}", value)) == 0
        opt = do_trainer.parse_args(_trainer_argv(world, f"dp_{value}", value))
        assert os.path.exists(os.path.join(port_prepare.model_dir_for(opt),
                                           "model_best.pth.tar"))
    assert [r.message for r in caplog.records
            if "data_parallel" in r.message] == ["data_parallel requested but only 1 device(s)"]
    assert do_predictor.parse_args([AVS, "m", "s", "--data_parallel", str(value)]).data_parallel


@pytest.mark.parametrize("entry", ["do_predictor", "do_trainer"])
def test_data_parallel_over_several_cards_raises(world, monkeypatch, entry):
    from laff_tpu_torch.cli import do_trainer
    from laff_tpu_torch.engine import prepare as port_prepare

    monkeypatch.setattr(port_prepare, "visible_devices", lambda device: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        if entry == "do_predictor":
            port_predictor.main(_port_opt(world, AVS, "tv16.avs.txt", "dp_raise",
                                          data_parallel=2))
        else:
            do_trainer.main(_trainer_argv(world, "dp_raise", 2))
    assert not os.path.exists(_score_dir(world, AVS, "tv16.avs.txt", "dp_raise"))


def _strongclip_tower_file(path, prefix=""):
    """A seeded text tower in the reference's layout ({'model':
    {'clip_model.<key>': tensor}}), width 64 (one head, as shape inference
    gives), one layer, embedding as wide as the world's CLIP rows, the real
    49,408-token vocabulary. Its initial weights come from a seed of their
    own, not from whatever the process's global generator holds, so the
    world does not change with the tests run before it."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        tower = ClipTextTower(ClipTextConfig(width=64, heads=1, layers=1,
                                             embed_dim=synth.CLIP_DIM))
    gen = torch.Generator().manual_seed(5)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in tower.state_dict().items()}
    torch.save({"model": {f"clip_model.{prefix}{k}": v for k, v in sd.items()}}, path)


# present: False (no file), True (the tower file), 'ClipModel' (its keys under
# a 'ClipModel.' prefix), 'unreadable' (a file torch cannot load), 'negation'
# (the tower file and --task3_caption on a query with a negated clause)
@pytest.mark.parametrize("present", [False, True, "ClipModel", "unreadable", "negation"])
def test_strongclip_tower(world, monkeypatch, caplog, present):
    """A StrongCLIP checkpoint: both predictors swap in the fine-tuned CLIP
    text tower stored under the CLIP features' directory, whose rows then
    feed every query (and every negation clause): the port's score file and
    t2v.pkl equal laff_tpu's. Without the file both log laff_tpu's warning
    and predict on the precomputed rows. A file that does not load raises in
    the port, where laff_tpu warns and predicts (ROADMAP Queue 3)."""
    path = os.path.join(world["root"], AVS, "TextData", "clip_synth", "model_best.pth.tar")
    if present == "unreadable":
        with open(path, "wb") as fh:
            fh.write(b"placeholder")
    elif present:
        _strongclip_tower_file(path, "ClipModel." if present == "ClipModel" else "")
    logger = port_predictor.logger
    monkeypatch.setattr(logger, "handlers", [*logger.handlers, caplog.handler])
    made = []

    def featurizer(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    real = port_predictor.strongclip_text_featurizer
    monkeypatch.setattr(port_predictor, "strongclip_text_featurizer", featurizer)
    query_set, extra = (("neg.avs.txt", {"task3_caption": "negation"}) if present == "negation"
                        else ("tv16.avs.txt", {}))
    opt = _port_opt(world, AVS, query_set, f"strong_{present}", ckpt=world["strong_ckpt"],
                    **extra)
    try:
        if present == "unreadable":
            with pytest.raises(pickle.UnpicklingError):
                port_predictor.main(opt)
            assert not made
            jax_logs = []
            monkeypatch.setattr(jax_predictor.logger, "warning",
                                lambda msg, *a: jax_logs.append(msg % a))
            jax_predictor.main(jax_predictor.PredictOptions(
                testCollection=AVS, model_path=world["jax_strong_ckpt"],
                sim_name="jax_strong_unreadable", rootpath=world["root"],
                query_sets=query_set, batch_size=16, overwrite=1))
            assert any(m.startswith("StrongCLIP text tower load failed") for m in jax_logs)
            return
        got = port_predictor.main(opt)
        assert set(got) == {query_set}
        if not present:
            assert not made
            assert any(r.message.startswith("StrongCLIP text tower load failed")
                       for r in caplog.records)
            return
        # every clip row of the pass came from the live tower: the queries'
        # batch of 16 (3 topics padded), and with negation both clauses' too
        assert len(made) == 1 and made[0].rows == 16 * (3 if extra else 1)
        assert made[0].tower.config == ClipTextConfig(width=64, heads=1, layers=1,
                                                      embed_dim=synth.CLIP_DIM)
        jopt = jax_predictor.PredictOptions(
            testCollection=AVS, model_path=world["jax_strong_ckpt"],
            sim_name=f"jax_strong_{present}", rootpath=world["root"], query_sets=query_set,
            batch_size=16, overwrite=1,
            predict_result_file=os.path.join(world["root"], "result_log", "jax_strong", "r.txt"),
            **extra)
        jax_predictor.main(jopt)
        assert got[query_set]["negated_queries"] == (1 if extra else None)
        _assert_same_ranking_files(_score_dir(world, AVS, query_set, f"strong_{present}"),
                                   _score_dir(world, AVS, query_set, f"jax_strong_{present}"),
                                   True)
        # the live rows moved the ranking away from the precomputed rows'
        plain = _read_scores(os.path.join(_score_dir(world, AVS, "tv16.avs.txt", "strong_False"
                                                     ), "id.sent.score.txt"))
        live = _read_scores(os.path.join(_score_dir(world, AVS, query_set, f"strong_{present}"
                                                    ), "id.sent.score.txt"))
        if not extra:
            assert any(not np.allclose(plain[t][1], live[t][1]) for t in live)
    finally:
        if present:
            os.remove(path)


def test_build_avs_world(tmp_path, monkeypatch):
    """The layout, the relevance rule (a shot is relevant when its words
    hold all the topic's words, judged or left unjudged in stratum 2),
    features that do not depend on the chunk size, and an AVS world built
    with a benchmark over its gallery equal to one without (the benchmark
    drawn after it): the gallery linked, its shots the video set, captions
    for shots spread evenly over it."""
    def build(where, chunk):
        monkeypatch.setattr(synth, "AVS_CHUNK", chunk)
        return synth.build_avs_world(str(where), n_videos=50, editions=("tv17",),
                                     topics_per_edition=4, n_vocab=80, seed=5, relevant=(2, 6))

    info = build(tmp_path / "a", 7)
    monkeypatch.setattr(synth, "AVS_CHUNK", 10_000)
    with_bench = synth.build_avs_world(str(tmp_path / "b"), n_videos=50, editions=("tv17",),
                                       topics_per_edition=4, n_vocab=80, seed=5,
                                       relevant=(2, 6), benchmark=("ib", 5, 3))
    assert with_bench == {**info, "benchmark": {"collection": "ib", "captioned_videos": 5,
                                                "captions": 15}}
    bdir = tmp_path / "b" / "ib"
    assert os.path.realpath(bdir / "FeatureData") == str(tmp_path / "b" / "iacc.3" /
                                                         "FeatureData")
    assert (bdir / "VideoSets" / "ib.txt").read_text().split() == [
        f"iacc.3_v{i}" for i in range(50)]
    caps = [line.split() for line in open(bdir / "TextData" / "ib.caption.txt")]
    assert [c[0] for c in caps] == [f"iacc.3_v{v}#{j}" for v in (0, 12, 24, 37, 49)
                                    for j in range(3)]
    assert all(len(c) == 8 and c[1] == "the" for c in caps)
    assert BigFile(str(bdir / "TextData" / "clip_synth")).names == [c[0] for c in caps]
    cdir = tmp_path / "a" / "iacc.3"
    assert info["feature_bytes"] == 50 * sum(synth.FEATS.values()) * 4
    for feat, dim in synth.FEATS.items():
        a, b = (BigFile(str(where / "iacc.3" / "FeatureData" / feat))
                for where in (tmp_path / "a", tmp_path / "b"))
        assert a.shape() == [50, dim] and a.names == b.names
        np.testing.assert_array_equal(np.asarray(a._mmap), np.asarray(b._mmap))
    topics = [line.split() for line in open(cdir / "TextData" / "tv17.avs.txt")]
    assert [t[0] for t in topics] == ["501", "502", "503", "504"]
    clip = BigFile(str(cdir / "TextData" / "clip_synth"))
    assert clip.names == ["501", "502", "503", "504"] and clip.ndims == synth.CLIP_DIM
    qrels = [line.split() for line in open(cdir / "TextData" / "avs.qrels.tv17")]
    assert {q[0] for q in qrels} == {"1501", "1502", "1503", "1504"}
    assert {q[3] for q in qrels} <= {"1", "2"} and {q[4] for q in qrels} <= {"-1", "0", "1"}
    assert all(q[4] != "-1" for q in qrels if q[3] == "1")
    # every relevant shot is pooled: judged relevant, or left unjudged
    assert info["relevant_min"] >= 2  # the planted ones at least
    assert info["relevant_total"] <= sum(q[4] != "0" for q in qrels)
    assert any(q[4] == "1" for q in qrels)


def test_package_data_ships_the_port_sources():
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    assert data["laff_tpu_torch.native"] == ["fastfeat.cpp"]
    assert data["laff_tpu_torch.eval.trecvid"] == ["sample_eval.pl"]
    assert data["laff_tpu_torch.models.clip"] == ["assets/*"]  # the BPE merge table
    assert os.path.exists(os.path.join(ROOT, "laff_tpu_torch", "models", "clip", "assets",
                                       "bpe_simple_vocab_16e6.txt.gz"))
    for package, files in data.items():
        if package.startswith("laff_tpu_torch"):
            base = os.path.join(ROOT, *package.split("."))
            for pattern in files:
                assert os.path.exists(os.path.join(base, pattern)) or "*" in pattern
