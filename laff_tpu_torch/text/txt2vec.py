"""Caption -> vector featurizers (host-side, numpy).

Parity targets: reference ``txt2vec.py:12-157`` and ``laff_tpu.text.txt2vec``.
The key design change is batching: the reference encodes one caption at a time *inside the
torch forward pass*; here every featurizer also exposes ``encode_batch``
producing a fixed-shape (B, D) array in one shot, so featurization lives in
the input pipeline and the device graph only sees dense arrays.
"""

from __future__ import annotations

import pickle
from typing import List, Sequence

import numpy as np

from ..store import BigFile
from ..utils import get_logger
from .textlib import TextTool, Vocabulary

logger = get_logger(__name__)


class _CompatUnpickler(pickle.Unpickler):
    """Load vocab pickles produced by the reference codebase, whose
    Vocabulary class lives at module path ``textlib``."""

    def find_class(self, module, name):
        if name == "Vocabulary":
            return Vocabulary
        return super().find_class(module, name)


def load_vocab_pickle(path: str) -> Vocabulary:
    with open(path, "rb") as fh:
        return _CompatUnpickler(fh).load()


class Txt2Vec:
    """norm: 0 none, 1 L1, 2 L2."""

    def __init__(self, data_path: str, norm: int = 0, clean: bool = True) -> None:
        if norm not in (0, 1, 2):
            raise ValueError(f"invalid norm {norm}")
        self.data_path = data_path
        self.norm = norm
        self.lang = "en"
        self.clean = clean
        self.ndims = 0

    _remove_stopword = False

    def _preprocess(self, query: str) -> List[str]:
        return TextTool.tokenize(
            query, clean=self.clean, language=self.lang,
            remove_stopword=self._remove_stopword,
        )

    def _do_norm(self, vec: np.ndarray) -> np.ndarray:
        norm = np.linalg.norm(vec, self.norm)
        return vec / (norm + 1e-10)

    def _encoding(self, words: List[str]) -> np.ndarray:
        raise NotImplementedError

    def encoding(self, query: str) -> np.ndarray:
        vec = self._encoding(self._preprocess(query))
        if self.norm > 0:
            vec = self._do_norm(vec)
        return vec

    def encode_batch(self, queries: Sequence[str]) -> np.ndarray:
        out = np.empty((len(queries), self.ndims), dtype=np.float32)
        for i, q in enumerate(queries):
            out[i] = self.encoding(q)
        return out


class BowVec(Txt2Vec):
    """Bag-of-words count vector over a pickled Vocabulary."""

    def __init__(self, data_path: str, norm: int = 0, clean: bool = True) -> None:
        super().__init__(data_path, norm, clean)
        if isinstance(data_path, Vocabulary):
            self.vocab = data_path
        else:
            self.vocab = load_vocab_pickle(data_path)
        self.ndims = len(self.vocab)
        logger.info("vocab size %d, vec dim %d", len(self.vocab), self.ndims)

    def _encoding(self, words: List[str]) -> np.ndarray:
        vec = np.zeros(self.ndims, dtype=np.float32)
        for word in words:
            idx = self.vocab.find(word)
            if idx >= 0:
                vec[idx] += 1
        return vec

    def __len__(self) -> int:
        return self.ndims


class W2Vec(Txt2Vec):
    """Mean-pooled word2vec lookup backed by a BigFile of word vectors."""

    def __init__(self, data_path: str, norm: int = 0, clean: bool = True) -> None:
        super().__init__(data_path, norm, clean)
        self.w2v = data_path if isinstance(data_path, BigFile) else BigFile(data_path)
        vocab_size, self.ndims = self.w2v.shape()
        logger.info("vocab size %d, vec dim %d", vocab_size, self.ndims)

    def _encoding(self, words: List[str]) -> np.ndarray:
        _, vectors = self.w2v.gather(words)
        if vectors.shape[0] > 0:
            return vectors.mean(axis=0)
        return np.zeros(self.ndims, dtype=np.float32)


class IndexVec(Txt2Vec):
    """Caption -> <start> w1 ... wn <end> index sequence for the GRU."""

    def __init__(self, data_path, clean: bool = True) -> None:
        super().__init__(data_path, 0, clean)
        if isinstance(data_path, Vocabulary):
            self.vocab = data_path
        else:
            self.vocab = load_vocab_pickle(data_path)
        self.ndims = len(self.vocab)
        logger.info("vocab size %d", len(self.vocab))

    def _preprocess(self, query: str) -> List[str]:
        words = TextTool.tokenize(query, clean=self.clean, language=self.lang)
        return ["<start>"] + words + ["<end>"]

    def _encoding(self, words: List[str]) -> np.ndarray:
        return np.array([self.vocab(w) for w in words], dtype=np.int32)

    def encode_batch_padded(self, queries: Sequence[str], max_len: int):
        """Fixed-shape (B, max_len) int32 ids + (B,) lengths."""
        ids = np.zeros((len(queries), max_len), dtype=np.int32)
        lengths = np.zeros((len(queries),), dtype=np.int32)
        for i, q in enumerate(queries):
            seq = self.encoding(q)[:max_len]
            ids[i, : len(seq)] = seq
            lengths[i] = len(seq)
        return ids, lengths


class BowVecNSW(BowVec):
    _remove_stopword = True

    def __init__(self, data_path, norm: int = 0, clean: bool = True) -> None:
        super().__init__(data_path, norm, clean)
        if isinstance(data_path, str) and "_nsw" not in data_path:
            logger.error("WARNING: loaded a vocabulary that contains stopwords")


class W2VecNSW(W2Vec):
    _remove_stopword = True


NAME_TO_T2V = {
    "bow": BowVec,
    "bow_nsw": BowVecNSW,
    "w2v": W2Vec,
    "w2v_nsw": W2VecNSW,
    "idxvec": IndexVec,
}


def get_txt2vec(name: str):
    return NAME_TO_T2V[name]
