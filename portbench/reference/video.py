"""Plain video inputs of the reference: each video-level feature's row,
and a frame feature's first ``max_frame`` rows (by frame index) padded
with zeros, with a mask of 1 on a frame, read from the world's files."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..world import read_bigfile


class VideoInputs:
    def __init__(self, root: str, collection: str, features: Sequence[str],
                 frames: Optional[Dict] = None) -> None:
        fdir = os.path.join(root, collection, "FeatureData")
        self.feats = {}
        for name in features:
            names, mat = read_bigfile(os.path.join(fdir, name))
            self.feats[name] = ({n: i for i, n in enumerate(names)}, mat)
        self.frames = None
        if frames:
            names, mat = read_bigfile(os.path.join(fdir, "frame", frames["name"]))
            groups: Dict[str, List] = {}
            for i, fid in enumerate(names):
                vid, k = fid.rsplit("_", 1)
                groups.setdefault(vid, []).append((int(k), i))
            rows = {v: [i for _, i in sorted(g)] for v, g in groups.items()}
            self.frames = (frames["name"], int(frames["max_frame"]), rows, mat)

    def featurize(self, vis_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        out = {}
        for name, (row, mat) in self.feats.items():
            out[name] = np.asarray(mat[[row[v] for v in vis_ids]], dtype=np.float32)
        if self.frames is not None:
            name, t, rows, mat = self.frames
            frames = np.zeros((len(vis_ids), t, mat.shape[1]), np.float32)
            mask = np.zeros((len(vis_ids), t), np.float32)
            for i, v in enumerate(vis_ids):
                idx = rows.get(v, [])[:t]
                if idx:
                    frames[i, : len(idx)] = mat[idx]
                    mask[i, : len(idx)] = 1.0
            out[name + "@frames"], out[name + "@mask"] = frames, mask
        return out
