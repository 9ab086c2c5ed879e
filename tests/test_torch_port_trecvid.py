"""The port's TRECVID AVS harness and eval_qry2retro against laff_tpu's.

* ``sample_eval`` (xinfAP), ``format_report`` and ``parse_infap`` on seeded
  stratified qrels and runs with ties: result dicts and reports equal;
* ``scores_to_xml`` and ``xml_to_treceval``: the files byte-equal, with the
  topic and shot checks, a cut at ``topk`` and an out-of-order entry;
* ``evaluate_xml``: the same infAP; with ``use_perl=True`` the port finds
  its own vendored ``sample_eval.pl``, byte-equal to laff_tpu's, and agrees
  with the Python scorer within 2e-4;
* ``cli/avs_eval.main`` in-process on the predictor's dump layout prints
  the infAP of laff_tpu's chain;
* ``eval_qry2retro``: equal, ties and several queries per item included;
  ``label_matrix_from_scores`` and ``eval_v2t`` (which compare integer
  codes of the ids) equal on scores with ties, a repeated gallery id and a
  query whose video is not in the gallery.
"""

import os
import shutil

import numpy as np
import pytest

from laff_tpu.eval import metrics as jax_metrics
from laff_tpu.eval import trecvid as jax_trecvid
from laff_tpu.eval.trecvid import infap as jax_infap
from laff_tpu_torch.cli import avs_eval
from laff_tpu_torch.eval import metrics as port_metrics
from laff_tpu_torch.eval import trecvid as port_trecvid
from laff_tpu_torch.eval.trecvid import infap as port_infap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PERL = os.path.join(ROOT, "laff_tpu_torch", "eval", "trecvid", "sample_eval.pl")
JAX_PERL = os.path.join(ROOT, "laff_tpu", "eval", "trecvid", "sample_eval.pl")


def _qrels_and_run(where, seed, n_topics=4, n_docs=300, topk=150):
    """Stratified qrels (stratum 1 fully judged, stratum 2 sampled with -1
    for the unjudged, graded relevance) and a run whose scores hold ties."""
    rng = np.random.default_rng(seed)
    qrels, run = [], []
    for t in range(n_topics):
        topic = str(1501 + t)
        docs = [f"shot{t}_{i}" for i in range(n_docs)]
        for i, d in enumerate(docs):
            if i < 100:
                rel = int(rng.random() < 0.3) * int(rng.integers(1, 3))
                qrels.append(f"{topic} 0 {d} 1 {rel}")
            else:
                u = rng.random()
                rel = -1 if u < 0.5 else int(u > 0.85) * int(rng.integers(1, 3))
                qrels.append(f"{topic} 0 {d} 2 {rel}")
        chosen = rng.permutation(n_docs)[:topk]
        scores = np.round(np.sort(rng.random(topk))[::-1], 2)  # rounding makes ties
        run += [f"{topic} 0 {docs[c]} {r + 1} {s:.2f} TEAM"
                for r, (c, s) in enumerate(zip(chosen, scores))]
    os.makedirs(where, exist_ok=True)
    paths = os.path.join(where, "qrels.txt"), os.path.join(where, "run.treceval")
    for path, lines in zip(paths, (qrels, run)):
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return paths


@pytest.mark.parametrize("seed,max_result_size", [(0, 1000), (1, 1000), (2, 50)])
def test_sample_eval_equals_laff_tpu(tmp_path, seed, max_result_size):
    qrels, run = _qrels_and_run(str(tmp_path), seed)
    got = port_trecvid.sample_eval(qrels, run, max_result_size=max_result_size)
    want = jax_trecvid.sample_eval(qrels, run, max_result_size=max_result_size)
    assert got == want
    report = port_infap.format_report(got)
    assert report == jax_infap.format_report(want)
    assert port_infap.format_report(got, False) == jax_infap.format_report(want, False)
    assert port_trecvid.parse_infap(report) == jax_trecvid.parse_infap(report)


def _score_file(path, topics, shots, rng, unsorted_at=None):
    lines = []
    for t in topics:
        pick = rng.permutation(len(shots))[:40]
        scores = np.sort(rng.random(40))[::-1]
        if unsorted_at is not None:
            scores[unsorted_at] = scores[0] + 1.0  # out of order: the XML skips it
        lines.append(f"{t} " + " ".join(f"{shots[i]} {s}" for i, s in zip(pick, scores)))
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


@pytest.mark.parametrize("topk,checked", [(1000, True), (25, False)])
def test_xml_and_treceval_files_equal(tmp_path, topk, checked):
    rng = np.random.default_rng(topk)
    topics, shots = ["601", "602", "603"], [f"s{i}" for i in range(60)]
    topics_file, shots_file = tmp_path / "tv19.avs.txt", tmp_path / "shots.txt"
    topics_file.write_text("\n".join(f"{t} find shots of something" for t in topics))
    shots_file.write_text("\n".join(shots))
    kw = dict(topk=topk, priority=1, etime=1.0, desc="a run", overwrite=True)
    if checked:
        kw.update(topics_file=str(topics_file), shots_file=str(shots_file))
    outputs = {}
    for who, pkg in (("port", port_trecvid), ("jax", jax_trecvid)):
        txt = str(tmp_path / f"{who}.id.sent.score.txt")
        _score_file(txt, topics, shots, np.random.default_rng(7), unsorted_at=5)
        xml = pkg.scores_to_xml(txt, **kw)
        outputs[who] = open(xml).read(), open(pkg.xml_to_treceval(xml, overwrite=True)).read()
    assert outputs["port"] == outputs["jax"]
    assert outputs["port"][0].count("<item ") == 3 * (min(topk, 40) - (1 if topk > 5 else 0))
    if checked:
        bad = tmp_path / "bad.txt"
        bad.write_text("601 nope 0.5")
        with pytest.raises(ValueError):
            port_trecvid.scores_to_xml(str(bad), topics_file=str(topics_file),
                                       shots_file=str(shots_file), overwrite=True)


def test_vendored_nist_script_is_laff_tpus():
    with open(PORT_PERL, "rb") as a, open(JAX_PERL, "rb") as b:
        assert a.read() == b.read()


def _avs_layout(root, rng):
    """A collection in the predictor's dump layout: topics, shots, qrels,
    and a run of its score file for edition tv18."""
    coll = os.path.join(root, "iacc.3")
    topics, shots = ["561", "562"], [f"shot{i}" for i in range(80)]
    for sub in ("TextData", "VideoSets"):
        os.makedirs(os.path.join(coll, sub), exist_ok=True)
    with open(os.path.join(coll, "TextData", "tv18.avs.txt"), "w") as fh:
        fh.write("\n".join(f"{t} the w00001 w00002" for t in topics))
    with open(os.path.join(coll, "VideoSets", "iacc.3.txt"), "w") as fh:
        fh.write("\n".join(shots))
    qrels = [f"1{t} 0 {s} {1 if i < 30 else 2} "
             f"{int(rng.random() < 0.3) if i < 30 or rng.random() < 0.5 else -1}"
             for t in topics for i, s in enumerate(shots)]
    with open(os.path.join(coll, "TextData", "avs.qrels.tv18"), "w") as fh:
        fh.write("\n".join(qrels))
    run_dir = os.path.join(coll, "SimilarityIndex", "tv18.avs.txt", "run")
    os.makedirs(run_dir)
    _score_file(os.path.join(run_dir, "id.sent.score.txt"), topics, shots, rng)
    return run_dir


def test_avs_eval_cli_equals_laff_tpu(tmp_path, capsys):
    run_dir = _avs_layout(str(tmp_path / "port"), np.random.default_rng(3))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    assert avs_eval.main(["iacc.3", "tv18", "run", "--rootpath", str(tmp_path / "port")]) == 0
    printed = capsys.readouterr().out.splitlines()
    edition, label, value = printed[-1].split()
    assert (edition, label) == ("tv18", "infAP")
    # laff_tpu's chain, as tv_avs_eval/do_eval.py runs it, on a copy
    jax_coll = tmp_path / "jax" / "iacc.3"
    jax_txt = str(jax_coll / "SimilarityIndex" / "tv18.avs.txt" / "run" / "id.sent.score.txt")
    xml = jax_trecvid.scores_to_xml(
        jax_txt, topics_file=str(jax_coll / "TextData" / "tv18.avs.txt"),
        shots_file=str(jax_coll / "VideoSets" / "iacc.3.txt"), priority=1,
        desc=avs_eval.DESC, etime=1.0)
    want = jax_trecvid.evaluate_xml(xml, str(jax_coll / "TextData" / "avs.qrels.tv18"))
    assert float(value) == want > 0
    port_xml = os.path.join(run_dir, "id.sent.score.txt.xml")
    assert open(port_xml).read() == open(xml).read()
    assert open(port_xml + "_perf.txt").read() == open(xml + "_perf.txt").read()
    assert avs_eval.main(["iacc.3", "tv18", "absent", "--rootpath", str(tmp_path / "port")]) == 1


def test_perl_scorer_parity(tmp_path):
    """evaluate_xml(use_perl=True) runs the port's own sample_eval.pl; the
    Python scorer agrees with it within 2e-4 (its report rounds to 1e-4)."""
    if shutil.which("perl") is None or not os.path.exists(PORT_PERL):
        pytest.skip("perl or NIST script unavailable")
    run_dir = _avs_layout(str(tmp_path), np.random.default_rng(4))
    xml = port_trecvid.scores_to_xml(os.path.join(run_dir, "id.sent.score.txt"), etime=1.0)
    qrels = str(tmp_path / "iacc.3" / "TextData" / "avs.qrels.tv18")
    python = port_trecvid.evaluate_xml(xml, qrels, overwrite=True)
    perl = port_trecvid.evaluate_xml(xml, qrels, overwrite=True, use_perl=True)
    assert "num_ret" in open(xml + "_perf.txt").read()  # the NIST report, not ours
    assert perl == pytest.approx(python, abs=2e-4) and perl > 0


@pytest.mark.parametrize("n_qry", [1, 3])
def test_eval_qry2retro_equals_laff_tpu(n_qry):
    rng = np.random.default_rng(n_qry)
    sim = np.round(rng.standard_normal((12 * n_qry, 12)), 1)  # rounding makes ties
    got = port_metrics.eval_qry2retro(sim, n_qry)
    assert got == jax_metrics.eval_qry2retro(sim, n_qry)
    with pytest.raises(AssertionError):
        port_metrics.eval_qry2retro(sim[:-1], n_qry)


def test_label_matrices_equal_laff_tpu():
    rng = np.random.default_rng(9)
    vis_ids = [f"v{i}" for i in range(12)] + ["v3"]  # v3 twice
    txt_ids = [f"v{i % 12}#{i // 12}" for i in range(36)] + ["absent#0"]
    scores = np.round(rng.standard_normal((len(txt_ids), len(vis_ids))), 1).astype(np.float32)
    got = port_metrics.label_matrix_from_scores(scores, txt_ids, vis_ids)
    np.testing.assert_array_equal(got, jax_metrics.label_matrix_from_scores(scores, txt_ids,
                                                                            vis_ids))
    assert got[3].sum() == 2 and got[-1].sum() == 0
    keep = slice(0, 36)  # eval_v2t needs a caption for every video
    assert port_metrics.eval_v2t(scores[keep], txt_ids[keep], vis_ids) == \
        jax_metrics.eval_v2t(scores[keep], txt_ids[keep], vis_ids)
