"""Data sources: captions and feature stores for one collection.

Plain numpy-backed sources in place of the reference torch Datasets
(``data_provider.py:380-698``): batching is vectorized gathers against
memory-mapped BigFiles, run ahead of the card by the prefetch thread in
``laff_tpu_torch.data.feed``.

Collection layout (unchanged from the reference, so existing dumps work):
  <root>/<collection>/FeatureData/<feat_name>/{feature.bin,id.txt,shape.txt}
  <root>/<collection>/FeatureData/frame/<feat_name>/  (frame rows, ids
                                                       '<videoid>_<frameidx>')
  <root>/<collection>/TextData/<capfile>.caption.txt    ("cap_id caption")
  <root>/<collection>/TextData/<dir_name>/              (precomputed text feats)
  <root>/<collection>/VideoSets/<collection>.txt        (video id list)
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..store import BigFile
from ..text.textlib import negation_augmentation


class VisionSource:
    """Video-level (and optionally frame-level) feature access for a set of
    video ids."""

    def __init__(self, feat_files: Dict[str, BigFile], vis_ids: Sequence[str],
                 frame_feat_files: Optional[Dict[str, BigFile]] = None,
                 max_frame: int = 200) -> None:
        self.feat_files = feat_files
        self.vis_ids = list(vis_ids)
        self.max_frame = max_frame
        self.frame_feat_files = frame_feat_files or {}
        # frame ids are '<videoid>_<frameidx>': grouped by video, sorted by
        # frame index as a number (reference data_provider.py:430-446)
        self.vid2frames: Dict[str, Dict[str, List[str]]] = {}
        for fname, bf in self.frame_feat_files.items():
            groups: Dict[str, List[str]] = {}
            for frame_id in bf.names:
                groups.setdefault("_".join(frame_id.split("_")[:-1]), []).append(frame_id)
            for ids in groups.values():
                ids.sort(key=lambda x: int(x.split("_")[-1]))
            self.vid2frames[fname] = groups

    def __len__(self) -> int:
        return len(self.vis_ids)

    def gather(self, vis_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        """Video-level features: feature name -> (B, D)."""
        out = {}
        for name, bf in self.feat_files.items():
            found, arr = bf.gather(vis_ids)
            if len(found) != len(vis_ids):
                missing = set(vis_ids) - set(found)
                raise KeyError(f"feature '{name}' missing ids: {sorted(missing)[:5]}")
            out[name] = arr
        return out

    def gather_frames(self, vis_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        """Frame features: '<name>@frames' (B, max_frame, D) float32 holding
        each video's first ``max_frame`` frames, right-padded with zeros,
        and '<name>@mask' (B, max_frame) float32, 1 on a frame. A video with
        no frame in the file gets an all-zero row and mask."""
        out = {}
        for fname, bf in self.frame_feat_files.items():
            groups = self.vid2frames[fname]
            frames = np.zeros((len(vis_ids), self.max_frame, bf.ndims), dtype=np.float32)
            mask = np.zeros((len(vis_ids), self.max_frame), dtype=np.float32)
            for i, vid in enumerate(vis_ids):
                ids = groups.get(vid, [])[: self.max_frame]
                if ids:
                    frames[i, : len(ids)] = bf.gather(ids)[1]
                    mask[i, : len(ids)] = 1.0
            out[f"{fname}@frames"] = frames
            out[f"{fname}@mask"] = mask
        return out


class TextSource:
    """Caption file access, with optional precomputed text features
    (CLIP/BERT BigFiles keyed by caption id) and the negation ('task3')
    caption set."""

    def __init__(self, capfile: str, precomputed: Optional[Dict[str, BigFile]] = None,
                 task3: bool = False, shuffle_seed: Optional[int] = None) -> None:
        self.capfile = capfile
        self.precomputed = precomputed or {}
        self.task3 = task3
        self.captions: Dict[str, str] = {}
        self.cap_ids: List[str] = []
        self.mask_task3: Dict[str, int] = {}
        self.captions_multi: Dict[str, List[str]] = {}
        with open(capfile, "r") as fh:
            lines = [line for line in fh if line.strip()]
        if task3:
            # negation set: ids like 'video1#3F0p' / 'video1#3Fn', p for a
            # positive pair (reference data_provider.py:529-549); the
            # optional shuffle draws from the same random.Random stream as
            # laff_tpu's
            if shuffle_seed is not None:
                random.Random(shuffle_seed).shuffle(lines)
            for line in lines:
                cap_idfull, caption = line.strip().split(None, 1)
                base, tail = cap_idfull.split("#")
                cap_id = base + "#" + tail.split("F")[0]
                self.mask_task3[cap_id] = 1 if "p" in cap_idfull else 0
                if cap_id not in self.captions_multi:
                    self.captions_multi[cap_id] = [caption]
                    self.cap_ids.append(cap_id)
                else:
                    self.captions_multi[cap_id].append(caption)
        else:
            for line in lines:
                parts = line.strip().split(None, 1)
                self.captions[parts[0]] = parts[1] if len(parts) == 2 else ""
                self.cap_ids.append(parts[0])

    def __len__(self) -> int:
        return len(self.cap_ids)

    def captions_for(self, cap_ids: Sequence[str]) -> List[str]:
        return [self.captions[c] for c in cap_ids]

    def gather_precomputed(self, cap_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        out = {}
        for name, bf in self.precomputed.items():
            found, arr = bf.gather(cap_ids)
            if len(found) != len(cap_ids):
                missing = set(cap_ids) - set(found)
                raise KeyError(
                    f"precomputed text feature '{name}' missing: {sorted(missing)[:5]}"
                )
            out[name] = arr
        return out


    def false_caption(self, cap_id: str, rng: random.Random) -> Tuple[Optional[str], int]:
        """A random false caption and its mask for the negation loss
        (reference ``data_provider.py:598-615``): 1 for a positive pair, 0
        for a negative one, -1 (and no caption) for an id without an entry."""
        if not self.task3 or cap_id not in self.captions_multi:
            return None, -1
        return rng.choice(self.captions_multi[cap_id]), self.mask_task3[cap_id]

    def negation_augmented(self) -> Dict[str, List[str]]:
        """Each positive id's captions with their contractions swapped
        (``negation_augmentation``), for the vocabulary."""
        return {
            cap_id: [aug for cap in self.captions_multi[cap_id]
                     for aug in negation_augmentation(cap)]
            for cap_id, mask in self.mask_task3.items() if mask
        }


def vis_id_of(cap_id: str) -> str:
    """cap_id 'video123#5' -> vis_id 'video123' (reference
    ``data_provider.py:686-688``)."""
    return cap_id.split("#", 1)[0]


def read_video_set(path: str) -> List[str]:
    with open(path, "r") as fh:
        return [line.strip().split()[0] for line in fh if line.strip()]
