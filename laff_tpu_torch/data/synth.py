"""Synthetic benchmark collection at the LAFF-ml headline widths.

Writes one collection in the reference layout, in the shape of
``shell/make_rehearsal_world.py``:

  <root>/<collection>/FeatureData/{clip_ft 512, timesformer 768,
                                   x3d 2048, ircsn 2048}
  <root>/<collection>/TextData/<collection>.caption.txt   ("vid#k caption")
  <root>/<collection>/TextData/clip_synth                 (512-d CLIP rows)
  <root>/<collection>/VideoSets/<collection>.txt
  <root>/word2vec/synth500                                (500-d w2v)

With ``frame_feat`` (the FrameLAFF world) also

  <root>/<collection>/FeatureData/c3d                     (2048-d)
  <root>/<collection>/FeatureData/frame/clip_frames       (512-d frame rows,
                                                           ids '<vid>_<k>')
  <root>/<collection>/FeatureData/clip_frames             (the same rows)

with 8-60 frames a video, so that a ``max_frame`` of 50 both cuts and
pads; these are drawn after everything else, so the rest of the world is
the one ``frame_feat=False`` builds.

The auxiliary tasks' files, each from a generator of its own drawn after
everything else (the rest of the world is the one the options off build):

* ``false_captions`` (task3 training): ``<collection>.caption.false.txt``,
  the negation caption set. A third of the captions get two positive
  entries ``<cap>F0p`` / ``<cap>F1p``, the caption's first five words
  with "does not" / "doesn't" and its sixth (a false statement about the
  video), a third one negative entry ``<cap>Fn`` naming six words of
  another video, the rest none.
* ``negations`` (task3 evaluation): a third of the captions end in "not
  <w>", a word of another video, and ``<collection>.caption.negationset.txt``
  lists them.
* ``objects`` (task2): ``<collection>.caption.obj.txt``, one line per video
  naming the concepts ``c<k>`` (k the word's index modulo ``n_concepts``)
  of its 8 words.
* ``concept_pkl`` (concept re-ranking): ``TextData/concept_sim.pkl`` in the
  reference layout, {'txt2video_cos_sim_matrix' (C, V), 'txt_ids' C
  vocabulary words, 'vis_ids'}: 1 where the video has the word, plus noise.

Each video draws 8 distinct words from the vocabulary (every word is used
by some video, so the BoW vocabulary has ``n_vocab`` entries, 11,286 like
the headline's); its features are a fixed projection of the summed word
codes plus noise, and each caption names 6 of its 8 words, so retrieval is
learnable. Every number comes from ``seed``.
"""

from __future__ import annotations

import os
import pickle
import zlib

import numpy as np

from ..store import write_bigfile

FEATS = {"clip_ft": 512, "timesformer": 768, "x3d": 2048, "ircsn": 2048}
FRAME_FEATS = {"c3d": 2048}  # video-level features of the FrameLAFF world
FRAME_NAME, FRAME_DIM = "clip_frames", 512
FRAMES_PER_VIDEO = (8, 60)
LATENT = 24
CLIP_DIM = 512
W2V_DIM = 500
N_CONCEPTS = 300  # task2 concepts and concept re-ranking words of a world


def _video_words(rng: np.random.Generator, n_videos: int, n_vocab: int) -> np.ndarray:
    """(n_videos, 8) distinct word ids per row, covering the vocabulary
    when there are enough slots."""
    flat = rng.integers(0, n_vocab, n_videos * 8)
    cover = min(n_vocab, flat.size)
    flat[:cover] = rng.permutation(n_vocab)[:cover]
    words = flat.reshape(n_videos, 8)
    for row in words:
        while len(set(row.tolist())) < 8:
            _, first = np.unique(row, return_index=True)
            dup = np.setdiff1d(np.arange(8), first)
            row[dup] = rng.integers(0, n_vocab, dup.size)
    return words


def _projection(name: str, dim: int) -> np.ndarray:
    # crc32 keeps projections stable across processes (str hash is salted)
    return np.random.default_rng(zlib.crc32(name.encode()) % 1000).standard_normal(
        (LATENT, dim)).astype(np.float32) * 0.3


def _write_lines(path: str, lines) -> None:
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def _task_files(cdir: str, collection: str, vocab, words: np.ndarray, cap_words: np.ndarray,
                lines, seed: int, false_captions: bool, negations: bool, objects: bool,
                concept_pkl: bool) -> dict:
    """The auxiliary tasks' files (module docstring); rewrites the caption
    file when ``negations``."""
    rng = np.random.default_rng(seed + 7919)
    n_videos, caps = cap_words.shape[:2]
    tdir = os.path.join(cdir, "TextData")
    other = (np.arange(n_videos) + rng.integers(1, n_videos, n_videos)) % n_videos
    summary = {}
    if false_captions:
        out = []
        for i in range(n_videos):
            for c in range(caps):
                cap, w = f"{lines[i * caps + c].split(' ', 1)[0]}", cap_words[i, c]
                kind = (i * caps + c) % 3
                first = " ".join(vocab[x] for x in w[:5])
                if kind == 0:
                    out.append(f"{cap}F0p the {first} does not {vocab[w[5]]}")
                    out.append(f"{cap}F1p the {first} doesn't {vocab[w[5]]}")
                elif kind == 1:
                    out.append(f"{cap}Fn the " + " ".join(vocab[x] for x in words[other[i], :6]))
        _write_lines(os.path.join(tdir, f"{collection}.caption.false.txt"), out)
        summary["false_captions"] = len(out)
    if negations:
        negated = []
        for j in range(0, len(lines), 3):
            lines[j] += f" not {vocab[words[other[j // caps], 7]]}"
            negated.append(lines[j])
        _write_lines(os.path.join(tdir, f"{collection}.caption.txt"), lines)
        _write_lines(os.path.join(tdir, f"{collection}.caption.negationset.txt"), negated)
        summary["negated_captions"] = len(negated)
    vids = [lines[i * caps].split("#", 1)[0] for i in range(n_videos)]
    if objects:
        _write_lines(os.path.join(tdir, f"{collection}.caption.obj.txt"),
                     [f"{v} " + " ".join(f"c{w % N_CONCEPTS:03d}" for w in words[i])
                      for i, v in enumerate(vids)])
        summary["concepts"] = N_CONCEPTS
    if concept_pkl:
        concept_words = rng.choice(len(vocab), min(N_CONCEPTS, len(vocab)), replace=False)
        has = (words[:, :, None] == concept_words[None, None, :]).any(axis=1)  # (V, C)
        sim = has.T.astype(np.float32) + 0.1 * rng.standard_normal(
            has.T.shape).astype(np.float32)
        with open(os.path.join(tdir, "concept_sim.pkl"), "wb") as fh:
            pickle.dump({"txt2video_cos_sim_matrix": sim,
                         "txt_ids": [vocab[w] for w in concept_words], "vis_ids": vids}, fh)
    return summary


def build_world(root: str, collection: str = "rtest", n_videos: int = 2990,
                caps_per_video: int = 20, n_vocab: int = 11286, seed: int = 0,
                frame_feat: bool = False, false_captions: bool = False,
                negations: bool = False, objects: bool = False,
                concept_pkl: bool = False) -> dict:
    """Build the collection and its w2v table, and the auxiliary tasks'
    files that the flags ask for; returns a summary dict."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:05d}" for i in range(n_vocab)]
    word_codes = np.random.default_rng(99).standard_normal((n_vocab, LATENT)).astype(np.float32)
    vids = [f"{collection}_v{i}" for i in range(n_videos)]
    words = _video_words(rng, n_videos, n_vocab)
    latent = word_codes[words].sum(axis=1)
    cdir = os.path.join(root, collection)
    for feat, dim in FEATS.items():
        mat = latent @ _projection(feat, dim) + 0.1 * rng.standard_normal(
            (n_videos, dim)).astype(np.float32)
        write_bigfile(os.path.join(cdir, "FeatureData", feat), vids, mat)

    sel = np.argsort(rng.random((n_videos, caps_per_video, 8)), axis=2)[:, :, :6]
    cap_words = np.take_along_axis(
        np.broadcast_to(words[:, None, :], (n_videos, caps_per_video, 8)), sel, axis=2)
    cap_ids, lines = [], []
    for i, vid in enumerate(vids):
        for c in range(caps_per_video):
            cap_ids.append(f"{vid}#{c}")
            lines.append(f"{vid}#{c} the " + " ".join(vocab[w] for w in cap_words[i, c]))
    os.makedirs(os.path.join(cdir, "TextData"), exist_ok=True)
    with open(os.path.join(cdir, "TextData", f"{collection}.caption.txt"), "w") as fh:
        fh.write("\n".join(lines))
    os.makedirs(os.path.join(cdir, "VideoSets"), exist_ok=True)
    with open(os.path.join(cdir, "VideoSets", f"{collection}.txt"), "w") as fh:
        fh.write("\n".join(vids))

    # per-caption CLIP rows from the caption's own 6-word latent
    proj = np.random.default_rng(zlib.crc32(b"clip_text") % 1000).standard_normal(
        (LATENT, CLIP_DIM)).astype(np.float32) * 0.3
    cap_latent = word_codes[cap_words.reshape(-1, 6)].sum(axis=1)
    rows = cap_latent @ proj + 0.1 * rng.standard_normal(
        (len(cap_ids), CLIP_DIM)).astype(np.float32)
    write_bigfile(os.path.join(cdir, "TextData", "clip_synth"), cap_ids, rows)

    w2v = np.random.default_rng(5).standard_normal((n_vocab + 2, W2V_DIM)).astype(np.float32)
    write_bigfile(os.path.join(root, "word2vec", "synth500"), vocab + ["the", "a"], w2v)
    summary = {"collection": collection, "videos": n_videos, "captions": len(cap_ids),
               "vocab": n_vocab}
    if frame_feat:
        for feat, dim in FRAME_FEATS.items():
            mat = latent @ _projection(feat, dim) + 0.1 * rng.standard_normal(
                (n_videos, dim)).astype(np.float32)
            write_bigfile(os.path.join(cdir, "FeatureData", feat), vids, mat)
        counts = rng.integers(FRAMES_PER_VIDEO[0], FRAMES_PER_VIDEO[1] + 1, n_videos)
        frame_ids = [f"{vid}_{k}" for vid, n in zip(vids, counts) for k in range(n)]
        rows = np.repeat(latent @ _projection(FRAME_NAME, FRAME_DIM), counts, axis=0)
        rows += 0.1 * rng.standard_normal(rows.shape).astype(np.float32)
        # both layouts: FeatureData/frame/<name>, which prepare reads, and
        # the flat one, for reading a frame file as a plain BigFile
        for where in (("frame", FRAME_NAME), (FRAME_NAME,)):
            write_bigfile(os.path.join(cdir, "FeatureData", *where), frame_ids, rows)
        summary["frames"] = len(frame_ids)
    summary.update(_task_files(cdir, collection, vocab, words, cap_words, lines, seed,
                               false_captions, negations, objects, concept_pkl))
    return summary
