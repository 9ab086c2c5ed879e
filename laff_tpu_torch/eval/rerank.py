"""Post-processing re-rankers (``laff_tpu.eval.rerank``; reference
``model/ReRank.py``), host numpy code.

* ``k_reciprocal_rerank``: the CVPR'17 person-reID k-reciprocal encoding
  blend (reference 19-104): the neighbour expansion in host loops, the
  distance and weight algebra vectorized.
* ``tkb_rerank``: a gallery-popularity log-count boost over each query's
  top-K (reference 107-159).
* ``ConceptRerank``: idf-weighted query-concept matching against a video
  concept matrix, added to the model's scores (reference 161-371).
  ``_lemmatize_query`` uses nltk when it imports and its corpora load, and
  otherwise filters stop words; ``LEMMATIZER`` says which branch the last
  call took.

Tie rules. The reference leaves the order of equal values to numpy's
unstable sorts (``argpartition`` over the first k1 + 1 distances, the
quicksort ``argsort`` reversed for the top-K); the port fixes them. The
k-reciprocal neighbour lists put equal distances in increasing index
order; the descending top-K of ``tkb_rerank`` and ``ConceptRerank`` put
equal scores in decreasing index order (a reversed stable ascending sort),
the rule the port's ranks follow. On data without ties both give
``laff_tpu``'s results.
"""

from __future__ import annotations

import functools
import pickle
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..text.textlib import ENGLISH_STOP_WORDS

LEMMATIZER = {"branch": None}  # 'nltk' or 'stopwords', set by _lemmatize_query


def _nearest(dist: np.ndarray, k: int) -> np.ndarray:
    """(N, k + 1): each row's k + 1 smallest distances' columns, ascending,
    equal distances in increasing column order. A partition finds each
    row's k + 1 smallest, sorted by (distance, column); a row with more
    candidates tied at its bound is taken again from all of them."""
    k = min(k, dist.shape[1] - 1)
    sel = np.argpartition(dist, k, axis=1)[:, : k + 1]
    vals = np.take_along_axis(dist, sel, axis=1)
    order = np.lexsort((sel, vals), axis=1)
    out = np.take_along_axis(sel, order, axis=1)
    bound = vals.max(axis=1, keepdims=True)
    for i in np.flatnonzero((dist <= bound).sum(axis=1) > k + 1):
        row = dist[i]
        cand = np.flatnonzero(row <= bound[i])
        out[i] = cand[np.argsort(row[cand], kind="stable")[: k + 1]]
    return out


def _descending(x: np.ndarray, k: int) -> np.ndarray:
    """Each row's top-``k`` columns by descending value, equal values in
    decreasing column order."""
    return np.argsort(x, axis=1, kind="stable")[:, ::-1][:, :k]


def _k_reciprocal_neighbours(initial_rank: np.ndarray, k: int):
    """For every node i, as a list of arrays: its k + 1 nearest nodes j
    that have i among their own k + 1 nearest, in i's nearest order."""
    forward = initial_rank[:, : k + 1]
    backward = initial_rank[forward, : k + 1]  # (N, k + 1, k + 1)
    mutual = (backward == np.arange(len(initial_rank))[:, None, None]).any(axis=2)
    return [f[m] for f, m in zip(forward, mutual)]


def k_reciprocal_rerank(q_g_sim: np.ndarray, q_q_sim: np.ndarray, g_g_sim: np.ndarray,
                        k1: int = 20, k2: int = 6, lambda_value: float = 0.3) -> np.ndarray:
    """k-reciprocal re-ranking over cosine similarities -> the re-ranked
    (Q, G) distance matrix (lower is better), as the reference returns.
    Memory: two (Q + G)^2 f32 matrices."""
    query_num = q_g_sim.shape[0]
    original_dist = np.concatenate([np.concatenate([q_q_sim, q_g_sim], axis=1),
                                    np.concatenate([q_g_sim.T, g_g_sim], axis=1)], axis=0)
    original_dist = 2.0 - 2.0 * original_dist  # cosine -> squared euclidean
    # rows made contiguous: the loops below read and write by row
    original_dist = np.ascontiguousarray((original_dist / np.max(original_dist, axis=0)).T)
    all_num = original_dist.shape[0]
    V = np.zeros(original_dist.shape, dtype=np.float32)
    initial_rank = _nearest(original_dist, max(k1, k2 - 1))

    neigh = _k_reciprocal_neighbours(initial_rank, k1)
    neigh_half = [set(n.tolist()) for n in
                  _k_reciprocal_neighbours(initial_rank, int(np.around(k1 / 2)))]
    for i in range(all_num):
        k_reciprocal_index = neigh[i]
        own = set(k_reciprocal_index.tolist())
        expansion = set(own)
        for candidate in k_reciprocal_index:
            cand = neigh_half[candidate]
            if len(cand & own) > 2.0 / 3 * len(cand):
                expansion |= cand
        expansion = np.fromiter(sorted(expansion), dtype=np.int64, count=len(expansion))
        weight = np.exp(-original_dist[i, expansion])
        V[i, expansion] = weight / np.sum(weight)

    original_dist = original_dist[:query_num]
    if k2 != 1:  # query expansion: the mean of each row's k2 nearest rows,
        # added in order and divided in f32, as np.mean over them does
        V_qe = V[initial_rank[:, 0]]
        for j in range(1, k2):
            V_qe += V[initial_rank[:, j]]
        V_qe /= k2
        V = V_qe

    # V by column (rows ascending in each), to gather every row sharing a
    # column with row i; the contributions are added in the reference's
    # order (column by column), in f32
    cols, rows = np.nonzero(V.T)
    col_start = np.searchsorted(cols, np.arange(all_num + 1))
    col_vals = V[rows, cols]
    jaccard_dist = np.zeros(original_dist.shape, dtype=np.float32)
    for i in range(query_num):
        inds = np.flatnonzero(V[i])
        starts, ends = col_start[inds], col_start[inds + 1]
        n = ends - starts
        pos = np.repeat(ends - n.cumsum(), n) + np.arange(n.sum())
        temp_min = np.zeros((all_num,), dtype=np.float32)
        np.add.at(temp_min, rows[pos], np.minimum(np.repeat(V[i, inds], n), col_vals[pos]))
        jaccard_dist[i] = 1 - temp_min / (2.0 - temp_min)

    final_dist = jaccard_dist * (1 - lambda_value) + original_dist * lambda_value
    return final_dist[:, query_num:]


def tkb_rerank(q_g_sim: np.ndarray, g_g_sim: np.ndarray, topK: int = 3000,
               k1: int = 20) -> np.ndarray:
    """Gallery-popularity boost: how often each video is among the k1
    nearest videos of every video (itself counted once more), and each
    query's top-K re-scored by log(count + 1), rows l2-normalized
    (reference 107-159)."""
    n_g = q_g_sim.shape[1]
    counts = np.ones(n_g, dtype=np.float64)  # self counts
    counts += np.bincount(_descending(g_g_sim, k1).ravel(), minlength=n_g)
    reranked = np.zeros_like(q_g_sim, dtype=np.float64)
    top_idx = _descending(q_g_sim, topK)
    log_counts = np.log(counts + 1.0)
    rows = np.arange(q_g_sim.shape[0])[:, None]
    reranked[rows, top_idx] = log_counts[top_idx]
    norms = np.sqrt((reranked ** 2).sum(axis=1, keepdims=True)) + 1e-13 + 1e-14
    return reranked / norms


_CLEAN_RE = re.compile(r"[^A-Za-z0-9]")


@functools.lru_cache(maxsize=None)
def _nltk():
    """nltk's tagger, tokenizer, wordnet and lemmatizer, or None when nltk
    does not import (looked up once: a failed import searches the whole
    path again)."""
    try:
        from nltk import pos_tag, word_tokenize
        from nltk.corpus import wordnet
        from nltk.stem import WordNetLemmatizer
    except ImportError:
        return None
    return pos_tag, word_tokenize, wordnet, WordNetLemmatizer


def _lemmatize_query(text: str) -> str:
    """POS-filtered lemmatization (adjectives, verbs, nouns) when nltk
    imports and its corpora load, stop-word-filtered tokens otherwise (any
    error of nltk takes the fallback, as in ``laff_tpu``)."""
    text = _CLEAN_RE.sub(" ", text).strip().lower()
    nltk = _nltk()
    if nltk is not None:
        pos_tag, word_tokenize, wordnet, WordNetLemmatizer = nltk
        try:
            tagged = pos_tag(word_tokenize(text))
            wnl = WordNetLemmatizer()
            out = []
            for word, tag in tagged:
                if tag.startswith("J"):
                    pos = wordnet.ADJ
                elif tag.startswith("V"):
                    pos = wordnet.VERB
                elif tag.startswith("N"):
                    pos = wordnet.NOUN
                else:
                    continue
                w = wnl.lemmatize(word, pos=pos)
                if w not in ENGLISH_STOP_WORDS:
                    out.append(w)
            LEMMATIZER["branch"] = "nltk"
            return " ".join(out)
        except Exception:
            pass
    LEMMATIZER["branch"] = "stopwords"
    return " ".join(t for t in text.split() if t not in ENGLISH_STOP_WORDS)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / (np.sqrt((x * x).sum(1, keepdims=True)) + 1e-13 + 1e-14)


class ConceptRerank:
    """Concept-space re-scoring (reference ``ReRank.py:161-371``).

    The concept pkl holds {'txt2video_cos_sim_matrix': (C, V_all),
    'txt_ids': the C concept strings, 'vis_ids': the V_all video ids};
    ``video_index_list`` picks this gallery's columns."""

    def __init__(self, video_concept_pkl_path: str, video_index_list: Sequence[int],
                 model_sim_matrix: np.ndarray, query_txts: List[str], topK: int = 2000,
                 idf_log_base: float = np.e, word_counts: Optional[Dict[str, int]] = None,
                 caption_text: str = "") -> None:
        with open(video_concept_pkl_path, "rb") as fh:
            blob = pickle.load(fh)
        self.concept_ids = list(blob["txt_ids"])
        video_concept = np.asarray(blob["txt2video_cos_sim_matrix"])[
            :, list(video_index_list)].T  # (V, C)
        # idf from the train corpus's word counts, a concept's substring
        # count in the caption text where the counts lack it
        counts = dict(word_counts or {})
        freq = {c: counts[c] if c in counts else caption_text.count(c)
                for c in self.concept_ids}
        total = sum(freq.values())
        idf = np.array([np.log((1 + total) / (freq[c] + 1)) / np.log(idf_log_base)
                        for c in self.concept_ids])
        self.concept_freq = freq
        self.video_concept = video_concept * idf[None, :]
        self.model_sim_matrix = np.asarray(model_sim_matrix)
        self.top_idx = _descending(self.model_sim_matrix, topK)
        self.query_list = [_lemmatize_query(q) for q in query_txts]
        self.query_concept = np.array(
            [[1.0 if c in q else 0.0 for c in self.concept_ids] for q in self.query_list]
        ).reshape(len(self.query_list), len(self.concept_ids))

    def concept_sim_matrix(self) -> np.ndarray:
        """Cosine between the queries' concept indicators and the
        idf-weighted video concepts, zero outside each query's model top-K."""
        sims = _l2n(self.query_concept) @ _l2n(self.video_concept).T
        out = np.zeros_like(sims)
        rows = np.arange(sims.shape[0])[:, None]
        out[rows, self.top_idx] = sims[rows, self.top_idx]
        return out

    def rerank(self, weight: float = 2.0, l2norm_rows: bool = True) -> np.ndarray:
        """model_sim + weight * concept_sim, rows l2-normalized (reference
        ``predict_concept_rerank``, model/model.py:1391-1405)."""
        out = self.model_sim_matrix + weight * self.concept_sim_matrix()
        return _l2n(out) if l2norm_rows else out


def load_word_counts(path: str) -> Dict[str, int]:
    """A vocabulary count file ('word count' per line, the ``bow_nsw_5.txt``
    format the reference's build_vocab writes)."""
    counts: Dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if len(parts) >= 2:
                counts[parts[0]] = int(parts[1])
    return counts
