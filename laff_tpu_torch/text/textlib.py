"""Tokenizer, stopword filtering, vocabulary wrapper, negation augmentation.

Tokenization semantics match the reference exactly (reference
``textlib.py:26-59``) because BoW vectors, the GRU index stream and the
word2vec mean-pool all depend on the precise token sequence — any drift
here silently changes every downstream metric.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

with open(os.path.join(_ASSET_DIR, "stopwords_en.txt")) as _fh:
    ENGLISH_STOP_WORDS = set(line.strip() for line in _fh)
with open(os.path.join(_ASSET_DIR, "stopwords_zh.txt"), encoding="utf-8") as _fh:
    CHINESE_STOP_WORDS = set(line.strip() for line in _fh)

_NON_ALNUM = re.compile(r"[^A-Za-z0-9]")
_CHN_DEL_SET = "， 。 、 ！ 《 》 “ ” ； ？ ‘ ’".split()


class TextTool:
    @staticmethod
    def tokenize(
        input_str: str,
        clean: bool = True,
        language: str = "en",
        remove_stopword: bool = False,
    ) -> List[str]:
        if language == "en":
            sent = input_str
            if clean:
                sent = sent.replace("\r", " ")
                sent = _NON_ALNUM.sub(" ", sent).strip().lower()
            tokens = sent.split()
            if remove_stopword:
                tokens = [t for t in tokens if t not in ENGLISH_STOP_WORDS]
        else:
            sent = input_str
            if clean:
                for ch in _CHN_DEL_SET:
                    sent = sent.replace(ch, "")
            sent = re.sub("[A-Za-z]", "", sent)
            tokens = sent.split()
            if remove_stopword:
                tokens = [t for t in tokens if t not in CHINESE_STOP_WORDS]
        return tokens


# contraction <-> expansion pairs used by the negation-aware ("task3") data
# pipeline (reference ``textlib.py:60-79``)
_NEGATION_PAIRS = [
    ("don t", "do not"), ("doesn t", "does not"), ("didn t", "did not"),
    ("isn t", "is not"), ("aren t", "are not"), ("wasn t", "was not"),
    ("weren t", "were not"), ("won t", "will not"), ("hasn t", "has not"),
    ("haven t", "have not"), ("can t", "can not"), ("couldn t", "could not"),
    ("don't", "do not"), ("doesn't", "does not"), ("didn't", "did not"),
    ("isn't", "is not"), ("aren't", "are not"), ("won't", "will not"),
    ("hasn't", "has not"), ("haven't", "have not"), ("can't", "can not"),
    ("couldn't", "could not"),
]


def negation_augmentation(input_str: str) -> List[str]:
    """Return [original, *augmented] where contractions are swapped with
    their expansions (first matching pair in each direction only)."""
    res = [input_str]
    for contracted, expanded in _NEGATION_PAIRS:
        if contracted in input_str:
            res.append(input_str.replace(contracted, expanded))
            break
    for contracted, expanded in _NEGATION_PAIRS:
        if expanded in input_str:
            res.append(input_str.replace(expanded, contracted))
            break
    return res


# keep the reference's (mis)spelling importable for drop-in compatibility
negation_augumentation = negation_augmentation

_NEGATION_CUES = (" not ", " no ", " without ", " never ")


def split_negation(caption: str):
    """Split a query into (positive part, negated clause, has_negation) for
    boolean negation scoring. The clause after the first negation cue is
    the negated content; the positive part keeps everything before it."""
    padded = f" {caption.strip()} "
    lower = padded.lower()
    for cue in _NEGATION_CUES:
        pos = lower.find(cue)
        if pos >= 0:
            positive = padded[:pos].strip()
            negated = padded[pos + len(cue):].strip()
            if positive and negated:
                return positive, negated, True
    return caption.strip(), "", False


class Vocabulary:
    """word <-> index mapping (reference ``textlib.py:81-112``).

    ``encoding`` records what the vocab was built for; GRU-style vocabs map
    OOV words to ``<unk>`` while BoW-style vocabs raise.
    """

    def __init__(self, encoding: str) -> None:
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        self.encoding = encoding

    def add(self, word: str) -> None:
        if word not in self.word2idx:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word

    def find(self, word: str) -> int:
        return self.word2idx.get(word, -1)

    def __getitem__(self, index: int) -> str:
        return self.idx2word[index]

    def __call__(self, word: str) -> int:
        if word not in self.word2idx:
            if "gru" in self.encoding:
                return self.word2idx["<unk>"]
            raise KeyError(f"word out of vocab: {word}")
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.word2idx)
