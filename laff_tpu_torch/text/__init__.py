from .textlib import TextTool, Vocabulary, negation_augmentation, split_negation
from .txt2vec import (
    NAME_TO_T2V,
    BowVec,
    BowVecNSW,
    IndexVec,
    Txt2Vec,
    W2Vec,
    W2VecNSW,
    get_txt2vec,
)
from .vocab import build_vocab, read_captions

__all__ = [
    "TextTool",
    "Vocabulary",
    "negation_augmentation",
    "split_negation",
    "NAME_TO_T2V",
    "BowVec",
    "BowVecNSW",
    "IndexVec",
    "Txt2Vec",
    "W2Vec",
    "W2VecNSW",
    "get_txt2vec",
    "build_vocab",
    "read_captions",
]
