"""Fixed-shape batchers and prefetching host feeds for training and
evaluation.

* Text featurization (BoW counts, w2v mean-pool, GRU index padding) is
  vectorized host work done in the feed, not inside the model forward.
* The train feed (``PairFeed``) drops the trailing partial batch; eval
  feeds pad the final batch to the batch size and report the valid count,
  so every tower call sees one shape.
* ``Prefetcher`` overlaps the host featurization of batch k+1 with the
  card's work on batch k.
* With the trainer's device caches on, ``PairFeed`` skips featurization
  and a batch carries only its ``cap_ids`` and ``vis_ids``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..text.txt2vec import IndexVec, Txt2Vec
from .sources import TextSource, VisionSource, vis_id_of


def host_cast_bf16(arrays: Dict[str, np.ndarray], bf16: bool = True) -> Dict[str, torch.Tensor]:
    """Feature arrays as CPU tensors; with ``bf16`` float32 ones are rounded
    to bfloat16 on the host (torch's cast: round to nearest even, as the
    towers' first op on the card rounds). For bf16 towers the result is the
    same and the bytes to the card are halved; integer arrays pass
    unchanged."""
    out = {}
    for k, v in arrays.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(torch.bfloat16) if bf16 and t.dtype == torch.float32 else t
    return out


class TextBatcher:
    """cap_ids -> model-ready text arrays.

    featurizers:
      'bow' / 'w2v': Txt2Vec instances -> (B, D); with ``indexed_bow`` the
      bow goes as sparse 'bow_ids' / 'bow_cnt' (B, max_txtlength) pairs that
      the tower densifies on the card, with ``indexed_w2v`` the w2v goes as
      'w2v_ids' (B, max_txtlength) rows of the featurizer's
      ``build_row_index`` table and 'w2v_len' (B,), mean-pooled in the step
      'rnn': IndexVec -> 'rnn_ids' (B, max_txtlength) + 'rnn_len' (B,)
      'netvlad': W2Vec -> 'netvlad_tokens' (B, max_txtlength, D), each
      caption's per-token vectors, + 'netvlad_mask' (B, max_txtlength);
      ``laff_tpu`` pads to the batch's longest caption, the port to
      max_txtlength, so every batch has one shape (masked tokens add zero)
      'clip' / 'bert': taken from TextSource.precomputed ('CLIP_encoding',
      'bert_encoding' BigFiles) -> (B, D)
    """

    _PRECOMPUTED_KEYS = {"clip": "CLIP_encoding", "bert": "bert_encoding"}

    def __init__(
        self,
        source: TextSource,
        featurizers: Dict[str, Txt2Vec],
        max_txtlength: int = 77,
        indexed_bow: bool = False,
        indexed_w2v: bool = False,
    ) -> None:
        self.source = source
        self.featurizers = featurizers
        self.max_txtlength = max_txtlength
        self.indexed_bow = indexed_bow
        self.indexed_w2v = indexed_w2v

    def __call__(self, cap_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        captions = self.source.captions_for(cap_ids)
        batch: Dict[str, np.ndarray] = {}
        precomputed = None
        for name, t2v in self.featurizers.items():
            if name == "rnn":
                if not isinstance(t2v, IndexVec):
                    raise TypeError(f"'rnn' featurizer must be IndexVec, got {type(t2v)}")
                ids, lengths = t2v.encode_batch_padded(captions, self.max_txtlength)
                batch["rnn_ids"] = ids
                batch["rnn_len"] = lengths
            elif name == "netvlad":
                batch["netvlad_tokens"], batch["netvlad_mask"] = t2v.encode_tokens_padded(
                    captions, self.max_txtlength)
            elif name in self._PRECOMPUTED_KEYS:
                if t2v is not None:
                    raise NotImplementedError(
                        f"live '{name}' text towers are not ported yet: ROADMAP Queue 1 item 4")
                if precomputed is None:
                    precomputed = self.source.gather_precomputed(cap_ids)
                batch[name] = precomputed[self._PRECOMPUTED_KEYS[name]]
            elif name == "bow" and self.indexed_bow:
                batch["bow_ids"], batch["bow_cnt"] = t2v.encode_batch_indexed(
                    captions, self.max_txtlength)
            elif name == "w2v" and self.indexed_w2v:
                batch["w2v_ids"], batch["w2v_len"] = t2v.encode_batch_indexed(
                    captions, self.max_txtlength)
            else:
                batch[name] = t2v.encode_batch(captions)
        return batch


class VisBatcher:
    """vis_ids -> model-ready visual arrays: the video-level features and
    each of the source's frame features padded to its ``max_frame`` with
    its mask (one shape for every batch)."""

    def __init__(self, source: VisionSource) -> None:
        self.source = source

    def __call__(self, vis_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        batch = self.source.gather(vis_ids)
        batch.update(self.source.gather_frames(vis_ids))
        return batch


class PairFeed:
    """Training feed: shuffled (caption, video) pairs in fixed-size batches,
    ``{'txt': {...}, 'vis': {...}, 'cap_ids': [...], 'vis_ids': [...]}``.
    Epoch e's order is ``default_rng(seed + e).permutation`` of the caption
    ids and the trailing partial batch is dropped, as in
    ``laff_tpu.data.PairFeed``, so both packages see the same batches in
    the same order. ``cap_ids`` restricts the feed to a subset of the
    captions. (The task3 negation captions come with task3.)"""

    def __init__(self, text_batcher: TextBatcher, vis_batcher: VisBatcher,
                 batch_size: int = 128, seed: int = 0,
                 cap_ids: Optional[Sequence[str]] = None) -> None:
        self.text_batcher = text_batcher
        self.vis_batcher = vis_batcher
        self.batch_size = batch_size
        self.seed = seed
        self.cap_ids = list(text_batcher.source.cap_ids if cap_ids is None else cap_ids)
        self.featurize_txt = True
        self.featurize_vis = True

    def steps_per_epoch(self) -> int:
        return len(self.cap_ids) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict]:
        order = np.random.default_rng(self.seed + epoch).permutation(len(self.cap_ids))
        shuffled = [self.cap_ids[i] for i in order]
        for start in range(0, self.steps_per_epoch() * self.batch_size, self.batch_size):
            chunk = shuffled[start : start + self.batch_size]
            vis_ids = [vis_id_of(c) for c in chunk]
            batch = {"cap_ids": chunk, "vis_ids": vis_ids}
            if self.featurize_vis:
                batch["vis"] = self.vis_batcher(vis_ids)
            if self.featurize_txt:
                batch["txt"] = self.text_batcher(chunk)
            yield batch


class EvalFeed:
    """Deterministic feed over all items; final batch padded to the batch
    size (repeating its last id) with 'valid' giving the real count. With
    ``stage_on_device`` the evaluator keeps the batches it uploaded on the
    card and replays them on later passes (the features do not change
    between epochs)."""

    def __init__(
        self,
        ids: Sequence[str],
        batcher: Callable[[Sequence[str]], Dict[str, np.ndarray]],
        batch_size: int = 512,
    ) -> None:
        self.ids = list(ids)
        self.batcher = batcher
        self.batch_size = batch_size
        self.stage_on_device = False
        self.staged = None  # (key, device batches) once staged by the evaluator

    def __len__(self) -> int:
        return len(self.ids)

    def __iter__(self) -> Iterator[Dict]:
        for start in range(0, len(self.ids), self.batch_size):
            chunk = self.ids[start : start + self.batch_size]
            valid = len(chunk)
            padded = chunk + [chunk[-1]] * (self.batch_size - valid)
            yield {"data": self.batcher(padded), "ids": chunk, "valid": valid}


class Prefetcher:
    """Runs an iterator in a background thread, keeping ``depth`` items in
    flight; an exception in the worker is raised in the consumer."""

    _DONE = object()

    def __init__(self, iterator: Iterable, depth: int = 2) -> None:
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterator:
                    self._queue.put(item)
            except BaseException as e:  # re-raised in the consumer thread
                self._err = e
            finally:
                self._queue.put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            self._thread.join(timeout=10)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
