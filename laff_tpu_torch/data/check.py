"""Collection layout checks (``laff_tpu.data.check``; reference
``data/check_data.py`` and ``test_env.py``): the on-disk layout verified
before a long run."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from ..store import BigFile
from ..utils import get_logger

logger = get_logger(__name__)


def check_collection(rootpath: str, collection: str, feat_names: Sequence[str] = (),
                     frame_feat_names: Sequence[str] = (),
                     caption_suffixes: Sequence[str] = ("caption.txt",),
                     require_video_set: bool = True) -> Dict[str, List[str]]:
    """Returns {'ok': [...], 'missing': [...], 'broken': [...]}."""
    cdir = os.path.join(rootpath, collection)
    report: Dict[str, List[str]] = {"ok": [], "missing": [], "broken": []}

    def check_bigfile(path: str, tag: str) -> None:
        if not os.path.isdir(path):
            report["missing"].append(f"{tag}: {path}")
            return
        try:
            bf = BigFile(path)
        except (OSError, ValueError) as e:
            report["broken"].append(f"{tag}: {path} ({e})")
            return
        report["ok"].append(f"{tag}: {bf.nr_of_images}x{bf.ndims}")

    for feat in feat_names:
        check_bigfile(os.path.join(cdir, "FeatureData", feat), f"feature {feat}")
    for feat in frame_feat_names:
        check_bigfile(os.path.join(cdir, "FeatureData", "frame", feat), f"frame-feature {feat}")
    for suffix in caption_suffixes:
        cap = os.path.join(cdir, "TextData", f"{collection}.{suffix}")
        report["ok" if os.path.exists(cap) else "missing"].append(f"captions: {cap}")
    if require_video_set:
        vs = os.path.join(cdir, "VideoSets", f"{collection}.txt")
        report["ok" if os.path.exists(vs) else "missing"].append(f"video set: {vs}")
    return report


def check_environment(rootpath: str, collections: Sequence[str],
                      feat_names: Sequence[str] = ()) -> bool:
    """Log a full report; True when nothing is missing or broken."""
    ok = True
    w2v = os.path.join(rootpath, "word2vec", "flickr", "vec500flickr30m")
    if not os.path.isdir(w2v):
        logger.warning("word2vec missing: %s", w2v)
        ok = False
    for coll in collections:
        report = check_collection(rootpath, coll, feat_names)
        for line in report["ok"]:
            logger.info("[%s] OK %s", coll, line)
        for line in report["missing"] + report["broken"]:
            logger.warning("[%s] PROBLEM %s", coll, line)
            ok = False
    return ok
