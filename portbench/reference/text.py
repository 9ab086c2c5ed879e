"""Plain text inputs of the reference: the caption file, the published
LAFF vocabulary rule and the four text features of a caption, worked out
from the world's files alone.

* Tokens: every character outside ``[A-Za-z0-9]`` becomes a space, the
  line is lower-cased and split; the ``_nsw`` encodings drop the English
  stop words (``stopwords_en.txt``, the reference's list).
* A vocabulary keeps the words seen at least ``threshold`` times in the
  training captions, in descending count (ties in order of first
  appearance); the GRU's starts with ``<pad> <start> <end> <unk>``.
* bow: counts over the bow vocabulary; w2v: the mean of the word2vec rows
  of the caption's words that have one; rnn: ``<start> words <end>`` as
  GRU vocabulary ids (``<unk>`` for others), right-padded with 0 to
  ``max_len``, with the length; clip: the caption's row of the
  precomputed ``clip_synth`` file.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..world import read_bigfile

_NON_ALNUM = re.compile(r"[^A-Za-z0-9]")
_CONFIDENCE = re.compile(r"#\d\.\d+")
with open(os.path.join(os.path.dirname(__file__), "stopwords_en.txt")) as _fh:
    STOP_WORDS = frozenset(line.strip() for line in _fh)
GRU_SPECIALS = ("<pad>", "<start>", "<end>", "<unk>")


def tokenize(text: str, remove_stop: bool = False) -> List[str]:
    tokens = _NON_ALNUM.sub(" ", text.replace("\r", " ")).strip().lower().split()
    return [t for t in tokens if t not in STOP_WORDS] if remove_stop else tokens


def read_captions(path: str) -> Tuple[List[str], Dict[str, str]]:
    """(caption ids in file order, id -> caption) of an ``id caption`` file."""
    ids, caps = [], {}
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split(" ", 1)
            if not parts[0]:
                continue
            ids.append(parts[0])
            caps[parts[0]] = _CONFIDENCE.sub("", parts[1] if len(parts) == 2 else "").strip()
    return ids, caps


def build_vocab(captions: Sequence[str], threshold: int, remove_stop: bool,
                specials: Sequence[str] = ()) -> Dict[str, int]:
    counts: Counter = Counter()
    for c in captions:
        counts.update(tokenize(c, remove_stop))
    kept = sorted(((w, n) for w, n in counts.items() if n >= threshold),
                  key=lambda wn: wn[1], reverse=True)
    words = list(specials) + [w for w, _ in kept]
    return {w: i for i, w in enumerate(words)}


class TextInputs:
    """The four text features of any caption of ``collection``, with
    vocabularies built from ``vocab_capfile``."""

    def __init__(self, root: str, collection: str, vocab_capfile: str, threshold: int,
                 w2v_dir: str, clip_dir: str, max_len: int) -> None:
        _, train_caps = read_captions(vocab_capfile)
        train = list(train_caps.values())
        self.bow_vocab = build_vocab(train, threshold, remove_stop=True)
        self.gru_vocab = build_vocab(train, threshold, remove_stop=False, specials=GRU_SPECIALS)
        self.ids, self.captions = read_captions(
            os.path.join(root, collection, "TextData", f"{collection}.caption.txt"))
        names, self.w2v = read_bigfile(os.path.join(root, w2v_dir))
        self.w2v_row = {n: i for i, n in enumerate(names)}
        names, self.clip = read_bigfile(os.path.join(root, collection, "TextData", clip_dir))
        self.clip_row = {n: i for i, n in enumerate(names)}
        self.max_len = max_len

    def featurize(self, cap_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        n = len(cap_ids)
        bow = np.zeros((n, len(self.bow_vocab)), np.float32)
        w2v = np.zeros((n, self.w2v.shape[1]), np.float32)
        rnn_ids = np.zeros((n, self.max_len), np.int64)
        rnn_len = np.zeros((n,), np.int64)
        unk = self.gru_vocab["<unk>"]
        for i, cid in enumerate(cap_ids):
            text = self.captions[cid]
            words = tokenize(text, remove_stop=True)
            for w in words:
                if w in self.bow_vocab:
                    bow[i, self.bow_vocab[w]] += 1.0
            rows = [self.w2v_row[w] for w in words if w in self.w2v_row]
            if rows:
                w2v[i] = np.asarray(self.w2v[rows]).mean(axis=0)
            seq = ([self.gru_vocab["<start>"]]
                   + [self.gru_vocab.get(w, unk) for w in tokenize(text)]
                   + [self.gru_vocab["<end>"]])[: self.max_len]
            rnn_ids[i, : len(seq)] = seq
            rnn_len[i] = len(seq)
        clip = np.asarray(self.clip[[self.clip_row[c] for c in cap_ids]])
        return {"bow": bow, "w2v": w2v, "rnn_ids": rnn_ids, "rnn_len": rnn_len, "clip": clip}
