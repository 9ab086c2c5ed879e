"""Extended inferred AP (xinfAP) scorer — a Python reimplementation of
NIST's ``sample_eval.pl`` (the only non-Python executable in the reference;
reference ``tv_avs_eval/sample_eval.pl``, 472 LoC Perl).

Implements Yilmaz, Kanoulas & Aslam's stratified-sampling estimators for
AP and NDCG with the exact NIST semantics:

* qrels records are ``topic dummy doc_id stratum rel``; rel >= 0 means the
  document was *sampled* (judged), rel > 0 relevant, rel < 0 pooled but
  unsampled.
* run documents are ranked by (score desc, doc_id lexicographically DESC)
  — the Perl tie-break — and truncated at ``max_result_size``.
* per-stratum precision estimates use the Perl's +1e-5 / +3e-5 smoothing
  constants verbatim so scores match the official tool bit-for-bit.

Output metrics per topic and averaged over topics ('all'): infAP, infNDCG,
iP10/iP100/iP1000, inum_rel_ret, inum_rel.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

PRECISION_RANKS = (10, 100, 1000)
_EPS_NUM = 0.00001
_EPS_DEN = 0.00003


def read_qrels(path: str) -> Dict:
    """topic -> {doc_id: (stratum, rel)}"""
    with open(path) as fh:
        tokens = fh.read().split()
    qrels: Dict[str, Dict[str, Tuple[str, int]]] = defaultdict(dict)
    for i in range(0, len(tokens) - 4, 5):
        topic, _dummy, doc_id, stratum, rel = tokens[i : i + 5]
        qrels[topic][doc_id] = (stratum, int(rel))
    return qrels


def read_run(path: str) -> Dict:
    """topic -> {doc_id: score} from treceval-format lines
    ('topic 0 doc rank score team')."""
    with open(path) as fh:
        tokens = fh.read().split()
    run: Dict[str, Dict[str, float]] = defaultdict(dict)
    for i in range(0, len(tokens) - 5, 6):
        topic, _d1, doc_id, _rank, score, _team = tokens[i : i + 6]
        run[topic][doc_id] = float(score)
    return run


def _topic_statistics(judgments: Dict[str, Tuple[str, int]]):
    """Per-stratum pool counts and sampled/relevant counts."""
    docs_per_stratum: Dict[str, int] = defaultdict(int)
    sampled_docs: Dict[str, int] = defaultdict(int)
    sampled_rel: Dict[str, int] = defaultdict(int)
    rels_per_grade: Dict[str, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for doc_id, (stratum, rel) in judgments.items():
        docs_per_stratum[stratum] += 1
        if rel >= 0:
            sampled_docs[stratum] += 1
        if rel > 0:
            sampled_rel[stratum] += 1
            rels_per_grade[stratum][rel] += 1
    return docs_per_stratum, sampled_docs, sampled_rel, rels_per_grade


def _estimated_num_rel(docs_per_stratum, sampled_docs, sampled_rel) -> float:
    total = 0.0
    for stratum, n_docs in docs_per_stratum.items():
        if sampled_docs[stratum]:
            total += sampled_rel[stratum] * n_docs / sampled_docs[stratum]
    return total


def _optimal_dcg(docs_per_stratum, sampled_docs, rels_per_grade,
                 max_result_size: int) -> float:
    """Ideal DCG over estimated per-grade relevant counts (Perl 150-169)."""
    num_rels_per_grade: Dict[int, float] = defaultdict(float)
    for stratum, grades in rels_per_grade.items():
        if not sampled_docs[stratum]:
            continue
        scale = docs_per_stratum[stratum] / sampled_docs[stratum]
        for grade, count in grades.items():
            num_rels_per_grade[grade] += count * scale

    optimal = 0.0
    start_rank = 0
    for grade in sorted(num_rels_per_grade, reverse=True):
        count = num_rels_per_grade[grade]
        r = start_rank + 1
        while r <= start_rank + count:
            optimal += grade / (math.log(r + 1) / math.log(2))
            if r >= max_result_size:
                break
            r += 1
        start_rank += count
    return optimal


def _score_topic(judgments, ranked_docs: List[str], max_result_size: int):
    (docs_per_stratum, sampled_docs, sampled_rel,
     rels_per_grade) = _topic_statistics(judgments)
    num_rels = _estimated_num_rel(docs_per_stratum, sampled_docs, sampled_rel)
    optimal_dcg = _optimal_dcg(
        docs_per_stratum, sampled_docs, rels_per_grade, max_result_size
    )

    sap: Dict[str, float] = defaultdict(float)          # sum of est. precisions
    gain: Dict[str, float] = defaultdict(float)          # discounted gains
    num_sampled: Dict[str, int] = defaultdict(int)
    num_relevant: Dict[str, int] = defaultdict(int)
    num_docs: Dict[str, int] = defaultdict(int)
    num_depth100 = 0
    num_rel_ret = 0.0
    precision_at: Dict[int, float] = {}

    for rank, doc_id in enumerate(ranked_docs[:max_result_size], start=1):
        entry = judgments.get(doc_id)
        if entry is not None:
            stratum, rel = entry
            if rel > 0:
                prec_above = 0.0
                if num_depth100:
                    for s in docs_per_stratum:
                        prob = num_docs[s] / num_depth100
                        if prob:
                            prec_above += prob * (num_relevant[s] + _EPS_NUM) / (
                                num_sampled[s] + _EPS_DEN
                            )
                prec = 1.0 / rank + (num_depth100 / rank) * prec_above
                sap[stratum] += prec
                num_relevant[stratum] += 1
                gain[stratum] += rel / (math.log(rank + 1) / math.log(2))
            num_depth100 += 1
            num_docs[stratum] += 1
            if rel >= 0:
                num_sampled[stratum] += 1

        est = 0.0
        for s in docs_per_stratum:
            est += num_docs[s] * (num_relevant[s] + _EPS_NUM) / (
                num_sampled[s] + _EPS_DEN
            )
        num_rel_ret = est
        if rank in PRECISION_RANKS or rank == max_result_size:
            precision_at[rank] = est / rank

    for cutoff in list(PRECISION_RANKS) + [max_result_size]:
        if cutoff not in precision_at:
            precision_at[cutoff] = num_rel_ret / cutoff

    # inferred AP: stratum-probability weighted expected precisions
    ap = 0.0
    for s in docs_per_stratum:
        if not sampled_docs[s] or not num_rels:
            continue
        rel_est = sampled_rel[s] * docs_per_stratum[s] / sampled_docs[s]
        prob = rel_est / num_rels
        ap_s = sap[s] / sampled_rel[s] if sampled_rel[s] else 0.0
        ap += prob * ap_s
    if num_rels > max_result_size:
        ap = ap * num_rels / max_result_size

    # inferred NDCG
    dcg = 0.0
    for s in docs_per_stratum:
        if num_depth100 and num_sampled[s]:
            dcg += (num_docs[s] / num_depth100) * gain[s] / num_sampled[s]
    ndcg = num_depth100 * dcg / optimal_dcg if optimal_dcg else 0.0

    return {
        "infAP": ap,
        "infNDCG": ndcg,
        **{f"iP{c}": precision_at[c] for c in PRECISION_RANKS},
        "inum_rel_ret": num_rel_ret,
        "inum_rel": num_rels,
    }


def sample_eval(qrels_path: str, run_path: str, max_result_size: int = 1000) -> Dict:
    """Score a treceval run against stratified qrels. Returns
    {topic: metrics, ..., 'all': mean-metrics}."""
    qrels = read_qrels(qrels_path)
    run = read_run(run_path)
    results: Dict[str, Dict[str, float]] = {}
    sums: Dict[str, float] = defaultdict(float)
    n = 0
    for topic in sorted(run, key=lambda t: (float(t) if t.isdigit() else t)):
        if topic not in qrels:
            continue
        # Perl tie-break: score desc, doc_id lexicographically DESC
        ranked = sorted(run[topic], key=lambda d: (-run[topic][d], _rev_key(d)))
        results[topic] = _score_topic(qrels[topic], ranked, max_result_size)
        n += 1
        for k, v in results[topic].items():
            sums[k] += v
    results["all"] = {k: (v / n if n else 0.0) for k, v in sums.items()}
    return results


class _rev_key(str):
    """Reversed lexicographic comparison for the Perl '$b cmp $a' tie-break."""

    def __lt__(self, other):
        return str.__gt__(self, other)


def format_report(results: Dict, print_all_queries: bool = True) -> str:
    """Text report matching the Perl tool's grep-able layout (the reference
    parses 'infAP ... all ... <value>' lines, trec_eval.py:19-26)."""
    lines = []
    topics = [t for t in results if t != "all"]
    if print_all_queries:
        for topic in topics:
            m = results[topic]
            lines.append("infAP\t\t%s\t\t%6.4f" % (topic, m["infAP"]))
            lines.append("infNDCG\t\t%s\t\t%6.4f" % (topic, m["infNDCG"]))
            for c in PRECISION_RANKS:
                lines.append("iP%d\t\t%s\t\t%6.4f" % (c, topic, m[f"iP{c}"]))
            lines.append("inum_rel_ret\t%s\t%14.4f" % (topic, m["inum_rel_ret"]))
    m = results["all"]
    lines.append("num_q\t\tall\t%14d" % len(topics))
    lines.append("infAP\t\tall\t\t%6.4f" % m["infAP"])
    lines.append("infNDCG\t\tall\t\t%6.4f" % m["infNDCG"])
    for c in PRECISION_RANKS:
        lines.append("iP%d\t\tall\t\t%6.4f" % (c, m[f"iP{c}"]))
    lines.append("inum_rel_ret\tall\t%14.4f" % m["inum_rel_ret"])
    return "\n".join(lines) + "\n"


def parse_infap(report: str) -> float:
    """Extract 'infAP all' from a report (reference trec_eval.py:19-26)."""
    for line in report.split("\n"):
        elems = line.split()
        if elems and elems[0] == "infAP" and "all" in line:
            return float(elems[-1])
    raise ValueError("no 'infAP all' line found")
