"""Caption -> vector featurizers (host-side, numpy).

Parity targets: reference ``txt2vec.py:12-157`` and ``laff_tpu.text.txt2vec``.
The key design change is batching: the reference encodes one caption at a time *inside the
torch forward pass*; here every featurizer also exposes ``encode_batch``
producing a fixed-shape (B, D) array in one shot, so featurization lives in
the input pipeline and the device graph only sees dense arrays.

``BowVec.encode_batch`` (norm 0, clean) and ``IndexVec.encode_batch_padded``
(clean, ``<unk>`` in the vocabulary) run in the native featurizer
(``laff_tpu_torch.native``) when it is built, under ``laff_tpu``'s
conditions, with the same arrays as the Python path.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence

import numpy as np

from .. import native
from ..store import BigFile
from ..utils import get_logger
from .textlib import ENGLISH_STOP_WORDS, TextTool, Vocabulary

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

    def encode_batch(self, queries: Sequence[str]) -> np.ndarray:
        ff = native.get_fastfeat()
        if ff is not None and self.norm == 0 and self.clean:
            out = np.zeros((len(queries), self.ndims), dtype=np.float32)
            stop = ENGLISH_STOP_WORDS if self._remove_stopword else None
            ff.encode_bow(list(queries), self.vocab.word2idx, stop, out)
            native.count("encode_bow")
            return out
        return super().encode_batch(queries)

    def encode_batch_indexed(self, queries: Sequence[str], max_tokens: int = 77):
        """Sparse form of ``encode_batch`` for densifying on the card: ids
        (B, T) int32, padded with ``self.ndims`` (the scatter's sink
        column), and counts (B, T) float32, normalized when ``self.norm >
        0`` so the scatter reproduces ``encoding``. Only a caption with more
        than ``max_tokens`` distinct in-vocabulary words is cut."""
        ids = np.full((len(queries), max_tokens), self.ndims, np.int32)
        cnt = np.zeros((len(queries), max_tokens), np.float32)
        for i, q in enumerate(queries):
            c: Dict[int, float] = {}
            for word in self._preprocess(q):
                idx = self.vocab.find(word)
                if idx >= 0:
                    c[idx] = c.get(idx, 0.0) + 1.0
            if not c:
                continue
            vals = np.fromiter(c.values(), np.float32, len(c))
            if self.norm > 0:
                vals = vals / (np.linalg.norm(vals, self.norm) + 1e-10)
            keys = np.fromiter(c.keys(), np.int32, len(c))
            t = min(len(keys), max_tokens)
            ids[i, :t] = keys[:t]
            cnt[i, :t] = vals[:t]
        return ids, cnt

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

    def build_row_index(self, captions: Sequence[str]) -> np.ndarray:
        """Restrict the w2v vocabulary to the words of ``captions`` and build
        the gather table for pooling on the card: (K+1, D) float32 with a
        zero sink row at K. ``encode_batch_indexed`` then gives row ids."""
        if self.norm > 0:
            raise ValueError("indexed w2v supports norm=0 only")
        words: List[str] = []
        seen = set()
        for q in captions:
            for w in self._preprocess(q):
                if w not in seen and w in self.w2v.name2index:
                    seen.add(w)
                    words.append(w)
        _, table = self.w2v.gather(words)
        self._row_of: Dict[str, int] = {w: i for i, w in enumerate(words)}
        self.table = np.concatenate([table, np.zeros((1, self.ndims), np.float32)])
        logger.info("w2v table for the card: %d words x %d dims (%.1f MB)",
                    len(words), self.ndims, self.table.nbytes / 1e6)
        return self.table

    def encode_batch_indexed(self, queries: Sequence[str], max_tokens: int = 77):
        """(ids (B, T) int32, n (B,) int32) for the mean pool
        ``table[ids].sum(1) / n`` on the card. Rows come in ``gather``'s
        order, so the sum takes the host mean's operands in its order;
        padding hits the zero sink row. Needs ``build_row_index``."""
        sink = len(self._row_of)
        ids = np.full((len(queries), max_tokens), sink, np.int32)
        n = np.ones((len(queries),), np.int32)
        for i, q in enumerate(queries):
            rows = [self._row_of[w] for w in self._preprocess(q) if w in self._row_of]
            t = min(len(rows), max_tokens)
            if t:
                ids[i, :t] = rows[:t]
                n[i] = t
        return ids, n


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
        ff = native.get_fastfeat()
        w2i = self.vocab.word2idx
        if ff is not None and self.clean and "<unk>" in w2i:
            ff.encode_idx(list(queries), w2i, w2i["<unk>"], w2i["<start>"], w2i["<end>"],
                          ids, lengths)
            native.count("encode_idx")
            return ids, lengths
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
