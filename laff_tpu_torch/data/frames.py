"""Raw-frame loading for end-to-end CLIP training (``laff_tpu.data.frames``;
reference ImageDataset, ``data_provider.py:215-377``).

``id.imagepath.txt`` lines are ``<frame_id> <image_path>``; frame ids are
``<video_id>_<frame_idx>``. Frames are sampled uniformly (eval) or
uniformly-random within strata (train), then preprocessed with the CLIP
recipe (resize shorter side to 224 bicubic, center crop, normalize).
Pillow is imported where a frame is decoded, never at import.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(img, size: int = 224) -> np.ndarray:
    """PIL image -> (size, size, 3) float32, CLIP normalization."""
    from PIL import Image

    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    img = img.crop((left, top, left + size, top + size)).convert("RGB")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def sample_frame_indices(
    n_frames: int, sample: int, sample_type: str, rng: Optional[random.Random] = None
) -> List[int]:
    """Uniform strata; 'random' picks one random frame per stratum, 'uniform'
    the stratum midpoint (reference ``data_provider.py:313-347``)."""
    if n_frames <= 0:
        return []
    edges = np.linspace(0, n_frames, sample + 1)
    idx = []
    for i in range(sample):
        lo, hi = int(edges[i]), max(int(edges[i + 1]) - 1, int(edges[i]))
        if sample_type == "random" and rng is not None:
            idx.append(rng.randint(lo, hi))
        else:
            idx.append((lo + hi) // 2)
    return [min(i, n_frames - 1) for i in idx]


class ImageSource:
    """video id -> (S, 224, 224, 3) preprocessed frame stack."""

    def __init__(
        self,
        id_path_file: str,
        sample_frame: int = 8,
        sample_type: str = "uniform",
        image_size: int = 224,
    ) -> None:
        self.sample_frame = sample_frame
        self.sample_type = sample_type
        self.image_size = image_size
        self.vid2paths: Dict[str, List[Tuple[int, str]]] = {}
        with open(id_path_file) as fh:
            for line in fh:
                parts = line.strip().split()
                if len(parts) != 2:
                    continue
                frame_id, path = parts
                vid = "_".join(frame_id.split("_")[:-1])
                fidx = int(frame_id.split("_")[-1])
                self.vid2paths.setdefault(vid, []).append((fidx, path))
        for paths in self.vid2paths.values():
            paths.sort()

    def frames_for(
        self, vis_id: str, rng: Optional[random.Random] = None
    ) -> np.ndarray:
        from PIL import Image

        entries = self.vid2paths.get(vis_id, [])
        idx = sample_frame_indices(
            len(entries), self.sample_frame, self.sample_type, rng
        )
        out = np.zeros(
            (self.sample_frame, self.image_size, self.image_size, 3), np.float32
        )
        for slot, i in enumerate(idx):
            with Image.open(entries[i][1]) as img:
                out[slot] = preprocess_image(img, self.image_size)
        return out

    def batch(self, vis_ids: Sequence[str], rng=None) -> np.ndarray:
        return np.stack([self.frames_for(v, rng) for v in vis_ids])
