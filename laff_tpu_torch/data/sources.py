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

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..store import BigFile


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
    (CLIP/BERT BigFiles keyed by caption id)."""

    def __init__(self, capfile: str, precomputed: Optional[Dict[str, BigFile]] = None) -> None:
        self.capfile = capfile
        self.precomputed = precomputed or {}
        self.captions: Dict[str, str] = {}
        self.cap_ids: List[str] = []
        with open(capfile, "r") as fh:
            for line in fh:
                if not line.strip():
                    continue
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


def vis_id_of(cap_id: str) -> str:
    """cap_id 'video123#5' -> vis_id 'video123' (reference
    ``data_provider.py:686-688``)."""
    return cap_id.split("#", 1)[0]


def read_video_set(path: str) -> List[str]:
    with open(path, "r") as fh:
        return [line.strip().split()[0] for line in fh if line.strip()]
