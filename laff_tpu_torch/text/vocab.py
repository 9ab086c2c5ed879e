"""Vocabulary builder: captions file -> thresholded Vocabulary.

Parity target: reference ``build_vocab.py:20-101``. Caption files are
``cap_id caption...`` lines; inline confidence markers (``#0.95``) are
stripped. Words below the count threshold are discarded; GRU vocabs get the
four special tokens first, then words in descending-count order.
"""

from __future__ import annotations

import pickle
import re
from collections import Counter
from typing import List, Tuple

from ..utils import get_logger, makedirs_for_file
from .textlib import TextTool, Vocabulary

logger = get_logger(__name__)

_CONFIDENCE_RE = re.compile(r"#\d\.\d+")


def read_captions(cap_file: str) -> List[str]:
    """Extract caption strings from an ``id caption`` file."""
    captions = []
    with open(cap_file, "r") as fh:
        for line in fh:
            parts = line.strip().split(" ", 1)
            caption = parts[1] if len(parts) == 2 else ""
            captions.append(_CONFIDENCE_RE.sub("", caption).strip())
    return captions


def build_vocab(
    cap_file: str, encoding: str, threshold: int = 5, lang: str = "en"
) -> Tuple[Vocabulary, List[Tuple[str, int]]]:
    nosw = "_nsw" in encoding
    logger.info("building vocabulary from %s (encoding=%s)", cap_file, encoding)
    counter: Counter = Counter()
    for caption in read_captions(cap_file):
        counter.update(TextTool.tokenize(caption, language=lang, remove_stopword=nosw))

    word_counts = [(w, c) for w, c in counter.items() if c >= threshold]
    word_counts.sort(key=lambda x: x[1], reverse=True)

    vocab = Vocabulary(encoding)
    if "gru" in encoding:
        for tok in ("<pad>", "<start>", "<end>", "<unk>"):
            vocab.add(tok)
    for word, _ in word_counts:
        vocab.add(word)
    return vocab, word_counts


def save_vocab(vocab: Vocabulary, vocab_file: str) -> None:
    makedirs_for_file(vocab_file)
    with open(vocab_file, "wb") as fh:
        pickle.dump(vocab, fh, pickle.HIGHEST_PROTOCOL)
    logger.info("saved vocabulary of %d words to %s", len(vocab), vocab_file)
