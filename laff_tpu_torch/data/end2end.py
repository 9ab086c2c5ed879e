"""End-to-end CLIP feed: raw frames + tokenized captions
(``laff_tpu.data.end2end``).

The training feed for End2EndClip (reference frame_loader path,
``data_provider.py:215-377`` + End2EndClip collate): captions tokenize
through the CLIP BPE; videos load sampled frames via ImageSource with the
CLIP preprocess. Frame sampling is random per epoch in training
(frame_sample_type_train) and uniform for eval. Epoch e's caption order is
``default_rng(seed + e).permutation`` and its frame draws come from
``random.Random(seed * 7919 + e)``, as in ``laff_tpu``, so both packages
build the same batches.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, Sequence

import numpy as np

from ..models.clip import tokenize
from .frames import ImageSource
from .sources import TextSource, vis_id_of


class End2EndFeed:
    """Shuffled (caption, video-frames) pair batches for End2EndClip."""

    def __init__(
        self,
        text_source: TextSource,
        image_source: ImageSource,
        batch_size: int = 32,
        seed: int = 0,
        context_length: int = 77,
        train: bool = True,
    ) -> None:
        self.text_source = text_source
        self.image_source = image_source
        self.batch_size = batch_size
        self.seed = seed
        self.context_length = context_length
        self.train = train
        self.cap_ids = list(text_source.cap_ids)

    def steps_per_epoch(self) -> int:
        return len(self.cap_ids) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict]:
        order = np.random.default_rng(self.seed + epoch).permutation(len(self.cap_ids))
        shuffled = [self.cap_ids[i] for i in order]
        pyrng = random.Random(self.seed * 7919 + epoch) if self.train else None
        end = (len(shuffled) // self.batch_size) * self.batch_size
        for start in range(0, end, self.batch_size):
            chunk = shuffled[start : start + self.batch_size]
            vis_ids = [vis_id_of(c) for c in chunk]
            captions = self.text_source.captions_for(chunk)
            yield {
                "txt": {"clip_ids": tokenize(captions, self.context_length)},
                "vis": {"frames": self.image_source.batch(vis_ids, pyrng)},
                "cap_ids": chunk,
                "vis_ids": vis_ids,
            }


def eval_batches(
    ids: Sequence[str],
    encode,
    batch_size: int,
) -> Iterator[Dict]:
    """Generic padded eval batching for end-to-end feeds."""
    ids = list(ids)
    for start in range(0, len(ids), batch_size):
        chunk = ids[start : start + batch_size]
        valid = len(chunk)
        padded = chunk + [chunk[-1]] * (batch_size - valid)
        yield {"data": encode(padded), "ids": chunk, "valid": valid}
