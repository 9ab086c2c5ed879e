"""The BERT text tower (``laff_tpu.models.bert``; reference BertTxtEncoder,
``model/model.py:437-466``), with no ``transformers`` import.

* ``BertModel``: the encoder ``laff_tpu`` builds as transformers'
  ``FlaxBertModule`` from ``BertConfig(**spec.bert.config_kwargs)``, with the
  parameter names of Hugging Face's PyTorch BERT
  (``embeddings.word_embeddings.weight``,
  ``encoder.layer.<i>.attention.self.query.weight``, ..., ``pooler.dense``),
  so a checkout's state dict loads with no renames. Exact (erf) GELU,
  LayerNorm eps 1e-12, the padding mask as an additive bias of
  ``finfo(float32).min``, position ids ``arange(L)``, token types zero when
  absent; in training, dropout on the hidden states and, with one mask
  shared by the batch and the heads as flax draws it, on the attention
  probabilities, from the caller's generator. The feature is the pooler's
  ``tanh(dense(h[:, 0]))``. It runs in float32 with the attention written
  out (no ``scaled_dot_product_attention``, whose fused kernels sum in
  another order) and sets no TF32 flag: ``FlaxBertModule`` computes in f32
  even when the towers are bf16.
* ``WordPieceTokenizer``: transformers' ``BertTokenizer`` (the basic
  tokenizer, then greedy longest-first WordPiece) over a ``vocab.txt``.
* ``BertTokensFeaturizer``: captions -> 'bert_ids', 'bert_mask',
  'bert_type' (int32) for the in-graph tower (``bert_frozen=False``).
* ``LiveBertTextFeaturizer``: the frozen tower of a local checkout as a
  featurizer; its pooler rows stay on the tower's device.
* ``import_bert_params``: a local checkout's weights (``model.safetensors``,
  read by a small reader here, or ``pytorch_model.bin``) as a state dict of
  ``BertModel``; None unless the name is a local directory (no downloads).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import rand_rows, torch_generator
from ..utils import get_logger

logger = get_logger(__name__)

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """transformers' ``BertConfig`` defaults (bert-base-uncased)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_kwargs(cls, kwargs) -> "BertConfig":
        """The fields of ``kwargs`` (a ``config_kwargs`` tuple or a
        checkout's config.json) that shape the encoder; others are ignored,
        as ``BertConfig`` keeps them without using them here."""
        kwargs = dict(kwargs)
        config = cls(**{f.name: kwargs[f.name] for f in dataclasses.fields(cls)
                        if f.name in kwargs})
        if config.hidden_act != "gelu":
            raise ValueError(f"hidden_act {config.hidden_act!r}: only 'gelu' (erf) is ported")
        return config


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
             shape=None) -> torch.Tensor:
    keep = 1.0 - p
    if shape is None:  # over batch rows
        mask = rand_rows(x.shape, generator, x.device) < keep
    else:  # one mask for every row
        mask = torch.rand(shape, generator=torch_generator(generator), device=x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.word_embeddings = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings,
                                                config.hidden_size)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.query = nn.Linear(config.hidden_size, config.hidden_size)
        self.key = nn.Linear(config.hidden_size, config.hidden_size)
        self.value = nn.Linear(config.hidden_size, config.hidden_size)


class BertDenseOutput(nn.Module):
    """dense -> dropout -> LayerNorm(x + residual)."""

    def __init__(self, dim_in: int, config: BertConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(dim_in, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)


class BertAttention(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = BertDenseOutput(config.hidden_size, config)


class BertIntermediate(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = BertDenseOutput(config.intermediate_size, config)


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(config) for _ in range(config.num_hidden_layers))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)


class BertModel(nn.Module):
    """ids (B, L), mask (B, L) -> (last hidden state (B, L, W), pooler
    output (B, W)), as ``FlaxBertModule`` computes them. ``imported_from``
    names the checkout whose weights were loaded, if any."""

    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        self.pooler = BertPooler(config)
        self.imported_from: Optional[str] = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: every kernel and embedding N(0, initializer_range),
        biases zero, LayerNorms at the identity."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, self.config.initializer_range, generator=generator)
                if isinstance(module, nn.Linear):
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.reset_parameters()

    def _attention(self, layer: BertLayer, h: torch.Tensor, bias: torch.Tensor,
                   drop: bool, generator) -> torch.Tensor:
        cfg = self.config
        b, length, width = h.shape
        heads = cfg.num_attention_heads
        dh = width // heads
        sa = layer.attention.self

        def split(x):  # (B, L, W) -> (B, heads, L, dh)
            return x.reshape(b, length, heads, dh).transpose(1, 2)

        q = split(sa.query(h)) / math.sqrt(dh)
        k, v = split(sa.key(h)), split(sa.value(h))
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
        if drop and cfg.attention_probs_dropout_prob > 0:
            weights = _dropout(weights, cfg.attention_probs_dropout_prob, generator,
                               (1, 1, length, length))
        ctx = torch.matmul(weights, v).transpose(1, 2).reshape(b, length, width)
        return self._dense_output(layer.attention.output, ctx, h, drop, generator)

    def _dense_output(self, out: BertDenseOutput, x: torch.Tensor, residual: torch.Tensor,
                      drop: bool, generator) -> torch.Tensor:
        x = out.dense(x)
        if drop and self.config.hidden_dropout_prob > 0:
            x = _dropout(x, self.config.hidden_dropout_prob, generator)
        return out.LayerNorm(x + residual)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        drop = self.training
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.embeddings
        h = (emb.word_embeddings(input_ids) + emb.token_type_embeddings(token_type_ids.long())
             + emb.position_embeddings(positions)[None])
        h = emb.LayerNorm(h)
        if drop and cfg.hidden_dropout_prob > 0:
            h = _dropout(h, cfg.hidden_dropout_prob, generator)
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        low = torch.full((), torch.finfo(torch.float32).min, dtype=h.dtype, device=h.device)
        bias = torch.where(attention_mask[:, None, None, :] > 0, zero, low)
        for layer in self.encoder.layer:
            h = self._attention(layer, h, bias, drop, generator)
            inter = F.gelu(layer.intermediate.dense(h))
            h = self._dense_output(layer.output, inter, h, drop, generator)
        pooled = torch.tanh(self.pooler.dense(h[:, 0]))
        return h, pooled


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def _is_whitespace(char: str) -> bool:
    return char in " \t\n\r" or unicodedata.category(char) == "Zs"


def _is_control(char: str) -> bool:
    return char not in "\t\n\r" and unicodedata.category(char).startswith("C")


def _is_punctuation(char: str) -> bool:
    cp = ord(char)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(char).startswith("P")


_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(char: str) -> bool:
    cp = ord(char)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def load_vocab(path: str) -> Dict[str, int]:
    """``vocab.txt``: one token a line, its id the line's index (a repeated
    token keeps its last line, as ``BertTokenizer`` reads it)."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as fh:
        for index, line in enumerate(fh):
            vocab[line.rstrip("\n")] = index
    return vocab


class WordPieceTokenizer:
    """transformers' ``BertTokenizer`` with its defaults (basic tokenization
    of Chinese characters, accents stripped with lower case, no
    ``never_split`` beyond the special tokens): the text is cleaned (control
    characters dropped, whitespace made spaces), CJK characters spaced out,
    NFC-normalized, split on whitespace, lower-cased and stripped of accents
    (NFD, 'Mn' dropped), split on punctuation, then each word matched
    greedily longest-first against the vocabulary with '##' continuation
    pieces ('[UNK]' for a word with no match or over 100 characters). A
    special token standing alone in the text is kept whole."""

    max_input_chars_per_word = 100

    def __init__(self, vocab_file: str, do_lower_case: bool = True) -> None:
        self.vocab = load_vocab(vocab_file)
        self.do_lower_case = do_lower_case
        missing = [t for t in SPECIAL_TOKENS[:4] if t not in self.vocab]
        if missing:
            raise ValueError(f"{vocab_file} lacks the special tokens {missing}")
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = (self.vocab[t]
                                                              for t in SPECIAL_TOKENS[:4])
        self._pieces: Dict[str, List[int]] = {}

    def basic_tokens(self, text: str) -> List[str]:
        text = "".join(" " if _is_whitespace(c) else c for c in text
                       if not (ord(c) in (0, 0xFFFD) or _is_control(c)))
        text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
        out: List[str] = []
        for token in unicodedata.normalize("NFC", text).split():
            if token in SPECIAL_TOKENS:
                out.append(token)
                continue
            if self.do_lower_case:
                token = "".join(c for c in unicodedata.normalize("NFD", token.lower())
                                if unicodedata.category(c) != "Mn")
            word = ""
            for c in token:
                if _is_punctuation(c):
                    if word:
                        out.append(word)
                    out.append(c)
                    word = ""
                else:
                    word += c
            if word:
                out.append(word)
        return out

    def word_ids(self, word: str) -> List[int]:
        if word in self._pieces:
            return self._pieces[word]
        ids: List[int] = []
        if word in SPECIAL_TOKENS and word in self.vocab:
            ids = [self.vocab[word]]
        elif len(word) > self.max_input_chars_per_word:
            ids = [self.unk_id]
        else:
            start = 0
            while start < len(word):
                end = len(word)
                while start < end:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    if piece in self.vocab:
                        ids.append(self.vocab[piece])
                        break
                    end -= 1
                if start == end:  # no piece matched: the whole word is unknown
                    ids = [self.unk_id]
                    break
                start = end
        self._pieces[word] = ids
        return ids

    def encode(self, captions: Sequence[str], max_length: int):
        """(ids, mask) (N, max_length) int32: [CLS] pieces [SEP], the pieces
        truncated to max_length - 2, padded with [PAD]."""
        ids = np.full((len(captions), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(captions), max_length), np.int32)
        for row, caption in enumerate(captions):
            pieces = [i for w in self.basic_tokens(caption) for i in self.word_ids(w)]
            seq = [self.cls_id] + pieces[:max_length - 2] + [self.sep_id]
            ids[row, :len(seq)] = seq
            mask[row, :len(seq)] = 1
        return ids, mask


def vocab_file_for(name_or_path: str, vocab_file: str = "") -> str:
    """The ``vocab.txt`` to read: the config's ``bert_vocab_file``, else the
    checkout's own; a name that is neither raises (nothing is downloaded)."""
    if vocab_file:
        return vocab_file
    path = os.path.join(os.path.expanduser(name_or_path), "vocab.txt")
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(f"no vocab.txt for BERT {name_or_path!r}: give a local checkout "
                            f"directory or the config's bert_vocab_file (nothing is downloaded)")


class BertTokensFeaturizer:
    """captions -> token arrays for the in-graph tower (``bert_frozen=False``):
    the feed ships 'bert_ids', 'bert_mask' and 'bert_type' (int32, (B,
    max_length)) and the text tower runs BERT inside the step."""

    emit_tokens = True

    def __init__(self, name_or_path: str = "bert-base-uncased", do_lower_case: bool = True,
                 max_length: int = 64, vocab_file: str = "") -> None:
        self.tokenizer = WordPieceTokenizer(vocab_file_for(name_or_path, vocab_file),
                                            do_lower_case=do_lower_case)
        self.max_length = max_length

    def encode_tokens(self, captions) -> Dict[str, np.ndarray]:
        ids, mask = self.tokenizer.encode(list(captions), self.max_length)
        return {"bert_ids": ids, "bert_mask": mask, "bert_type": np.zeros_like(ids)}


# ---------------------------------------------------------------------------
# checkouts
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
                       "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
                       "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header {name: {dtype, shape, data_offsets}}, then the raw
    little-endian buffers. BF16 tensors come back as bfloat16."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        raw = data[begin:end]
        if entry["dtype"] == "BF16":
            arr = np.frombuffer(raw, dtype="<u2").astype(np.int16)
            t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
        elif entry["dtype"] in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(raw, dtype=np.dtype(_SAFETENSORS_DTYPES[entry["dtype"]])
                                .newbyteorder("<"))
            t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=True))
        else:
            raise ValueError(f"{path}: tensor {name} of dtype {entry['dtype']} is not read")
        out[name] = t.reshape(entry["shape"])
    return out


def _checkout_state_dict(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkout's tensors in ``BertModel``'s names: a 'bert.' prefix (a
    pre-training checkpoint) dropped with the heads beside it, old
    LayerNorm names ('gamma', 'beta') renamed, the position-id buffer
    dropped."""
    prefixed = any(k.startswith("bert.") for k in raw)
    out = {}
    for key, value in raw.items():
        if prefixed:
            if not key.startswith("bert."):
                continue
            key = key[len("bert."):]
        if key.endswith(("position_ids", "token_type_ids")):
            continue
        key = key.replace("LayerNorm.gamma", "LayerNorm.weight").replace(
            "LayerNorm.beta", "LayerNorm.bias")
        out[key] = value.float()
    return out


def import_bert_params(name_or_path: str) -> Optional[Dict[str, torch.Tensor]]:
    """A local checkout's weights as a ``BertModel`` state dict (float32),
    or None when ``name_or_path`` is not a local directory. Inside one,
    ``model.safetensors`` is read, else ``pytorch_model.bin``
    (``torch.load(weights_only=True)``); a directory with neither raises."""
    path = os.path.expanduser(name_or_path)
    if not os.path.isdir(path):
        return None
    st = os.path.join(path, "model.safetensors")
    pt = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(st):
        raw = read_safetensors(st)
    elif os.path.isfile(pt):
        raw = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"BERT checkout {path} holds neither model.safetensors nor "
                                f"pytorch_model.bin")
    logger.info("imported pretrained BERT params from %s", path)
    return _checkout_state_dict(raw)


def checkout_config(name_or_path: str) -> BertConfig:
    """The encoder shape of a local checkout (its config.json)."""
    with open(os.path.join(os.path.expanduser(name_or_path), "config.json")) as fh:
        return BertConfig.from_kwargs(json.load(fh))


class LiveBertTextFeaturizer:
    """The frozen BERT of a local checkout as a text featurizer
    (``TextBatcher``'s live branch): captions tokenized at ``max_length``,
    the pooler output computed on ``device`` with grad off (the feed calls
    it from its prefetch thread, and grad mode is per thread), the (B, W)
    float32 rows left there. ``rows`` counts the captions it encoded."""

    def __init__(self, name_or_path: str, do_lower_case: bool = True, max_length: int = 64,
                 device: torch.device = torch.device("cuda")) -> None:
        path = os.path.expanduser(name_or_path)
        self.tokenizer = WordPieceTokenizer(vocab_file_for(path), do_lower_case=do_lower_case)
        self.model = BertModel(checkout_config(path))
        self.model.load_state_dict(import_bert_params(path))
        self.model.imported_from = path
        self.device = torch.device(device)
        self.model.to(self.device).eval()
        self.max_length = max_length
        self.rows = 0
        logger.info("live BERT featurizer loaded from %s on %s", path, self.device)

    def encode_batch(self, captions) -> torch.Tensor:
        ids, mask = self.tokenizer.encode(list(captions), self.max_length)
        with torch.no_grad():
            _, pooled = self.model(torch.from_numpy(ids).to(self.device),
                                   torch.from_numpy(mask).to(self.device))
        self.rows += len(captions)
        return pooled
