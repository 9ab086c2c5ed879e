"""The benchmark's world generator: a copy of the port's ``data/synth.py``
``build_world`` and the helpers it uses, kept here so that a later change
to the program cannot change the traffic it is measured on, with caption
lengths drawn from the mix's distribution where the original writes
captions of one length.

One call writes one collection in the reference layout, at the widths of
the LAFF-ml headline:

  <root>/<collection>/FeatureData/{clip_ft 512, timesformer 768,
                                   x3d 2048, ircsn 2048}
  <root>/<collection>/TextData/<collection>.caption.txt   ("vid#k the w ...")
  <root>/<collection>/TextData/clip_synth                 (512-d CLIP rows)
  <root>/<collection>/VideoSets/<collection>.txt
  <root>/word2vec/synth500                                (500-d w2v)

With ``frame_feat`` (FrameLAFF) also ``FeatureData/c3d`` (2048-d) and
``FeatureData/frame/clip_frames``: 512-d frame rows, ids ``<vid>_<k>``,
8 to 60 a video. The original also writes the frame rows a second time in
a flat layout that no reader of this benchmark opens; this copy leaves it
out, which halves the bytes a FrameLAFF run writes.

Each video draws 8 distinct words of an 11,286-word vocabulary; its
features are a fixed projection of the summed word codes plus noise. A
caption of n words (``caption_lengths``) is "the", then up to 6 of its
video's 8 words and, past 7 words, English function words (``FILLERS``,
stop words that the bow and w2v encodings drop and the GRU reads), the
two kinds in a shuffled order; its CLIP row projects the codes of the
video words it names. Every number comes from ``seed``.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

FEATS = {"clip_ft": 512, "timesformer": 768, "x3d": 2048, "ircsn": 2048}
FRAME_FEATS = {"c3d": 2048}
FRAME_NAME, FRAME_DIM = "clip_frames", 512
FRAMES_PER_VIDEO = (8, 60)
LATENT = 24
CLIP_DIM = 512
W2V_DIM = 500
VIDEO_WORDS, CAPTION_VIDEO_WORDS = 8, 6
FILLERS = ("a", "is", "in", "on", "and", "of", "with", "to", "are", "his", "her", "at")


def write_bigfile(resultdir: str, names, matrix: np.ndarray) -> None:
    """A (N, D) float32 matrix in the BigFile layout (feature.bin, id.txt,
    shape.txt)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    if matrix.ndim != 2 or len(names) != matrix.shape[0]:
        raise ValueError(f"names ({len(names)}) / matrix {matrix.shape} mismatch")
    os.makedirs(resultdir, exist_ok=True)
    matrix.tofile(os.path.join(resultdir, "feature.bin"))
    with open(os.path.join(resultdir, "id.txt"), "w") as fh:
        fh.write("\n".join(names))
    with open(os.path.join(resultdir, "shape.txt"), "w") as fh:
        fh.write("%d %d" % matrix.shape)


def read_bigfile(datadir: str):
    """(names, (N, D) float32 memmap) of a BigFile directory."""
    with open(os.path.join(datadir, "shape.txt")) as fh:
        n, d = (int(x) for x in fh.read().split())
    with open(os.path.join(datadir, "id.txt")) as fh:
        names = fh.read().split("\n")
    mat = np.memmap(os.path.join(datadir, "feature.bin"), dtype=np.float32, mode="r",
                    shape=(n, d))
    return names, mat


def _video_words(rng: np.random.Generator, n_videos: int, n_vocab: int) -> np.ndarray:
    flat = rng.integers(0, n_vocab, n_videos * VIDEO_WORDS)
    cover = min(n_vocab, flat.size)
    flat[:cover] = rng.permutation(n_vocab)[:cover]
    words = flat.reshape(n_videos, VIDEO_WORDS)
    for row in words:
        while len(set(row.tolist())) < VIDEO_WORDS:
            _, first = np.unique(row, return_index=True)
            dup = np.setdiff1d(np.arange(VIDEO_WORDS), first)
            row[dup] = rng.integers(0, n_vocab, dup.size)
    return words


def _word_codes(n_vocab: int) -> np.ndarray:
    return np.random.default_rng(99).standard_normal((n_vocab, LATENT)).astype(np.float32)


def _clip_projection() -> np.ndarray:
    return np.random.default_rng(zlib.crc32(b"clip_text") % 1000).standard_normal(
        (LATENT, CLIP_DIM)).astype(np.float32) * 0.3


def _projection(name: str, dim: int) -> np.ndarray:
    return np.random.default_rng(zlib.crc32(name.encode()) % 1000).standard_normal(
        (LATENT, dim)).astype(np.float32) * 0.3


def caption_lengths(n: int, spec: dict, rng: np.random.Generator) -> np.ndarray:
    """Words in each of ``n`` captions, "the" included: ``spec['min']`` plus a
    negative binomial of mean ``spec['mean'] - spec['min']`` and standard
    deviation ``spec['sd']``, cut at ``spec['max']``. The multiset comes from
    a fixed seed, so every world of ``n`` captions has the same lengths;
    ``rng`` gives their order."""
    lo, hi = int(spec["min"]), int(spec["max"])
    m, var = spec["mean"] - lo, spec["sd"] ** 2
    p = m / var
    draws = np.random.default_rng(0).negative_binomial(m * p / (1.0 - p), p, n)
    return rng.permutation(np.minimum(lo + draws, hi))


def _captions_of(rng: np.random.Generator, vocab, word_codes: np.ndarray, vids, words,
                 caps_per_video: int, caption_words: dict):
    n_caps = len(vids) * caps_per_video
    sel = np.argsort(rng.random((len(vids), caps_per_video, VIDEO_WORDS)),
                     axis=2)[:, :, :CAPTION_VIDEO_WORDS]
    cap_words = np.take_along_axis(
        np.broadcast_to(words[:, None, :], (len(vids), caps_per_video, VIDEO_WORDS)), sel,
        axis=2).reshape(n_caps, CAPTION_VIDEO_WORDS)
    lengths = caption_lengths(n_caps, caption_words, rng)
    named = np.minimum(lengths - 1, CAPTION_VIDEO_WORDS)  # video words in each caption
    fill = lengths - 1 - named
    cols = CAPTION_VIDEO_WORDS + int(fill.max())
    tokens = np.full((n_caps, cols), -1, np.int64)
    pos = np.arange(CAPTION_VIDEO_WORDS)
    tokens[:, :CAPTION_VIDEO_WORDS] = np.where(pos < named[:, None], cap_words, -1)
    fillers = len(vocab) + rng.integers(0, len(FILLERS), (n_caps, cols - CAPTION_VIDEO_WORDS))
    extra = np.arange(cols - CAPTION_VIDEO_WORDS)
    tokens[:, CAPTION_VIDEO_WORDS:] = np.where(extra < fill[:, None], fillers, -1)
    keys = rng.random(tokens.shape)
    keys[tokens < 0] = 2.0  # the empty places sort last
    tokens = np.take_along_axis(tokens, np.argsort(keys, axis=1), axis=1)
    names = list(vocab) + list(FILLERS)
    cap_ids = [f"{vid}#{c}" for vid in vids for c in range(caps_per_video)]
    lines = [f"{cid} the " + " ".join([names[t] for t in row[: n - 1]])
             for cid, row, n in zip(cap_ids, tokens.tolist(), lengths.tolist())]
    named_codes = word_codes[cap_words] * (pos < named[:, None])[:, :, None]
    rows = named_codes.sum(axis=1) @ _clip_projection()
    rows += 0.1 * rng.standard_normal(rows.shape).astype(np.float32)
    return cap_ids, lines, rows, cap_words


def build_world(root: str, collection: str, n_videos: int, caps_per_video: int,
                caption_words: dict, n_vocab: int = 11286, seed: int = 0,
                frame_feat: bool = False) -> dict:
    """Write the collection and its w2v table; returns a summary dict.
    ``caption_words`` is the mix's caption length distribution
    (``caption_lengths``)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:05d}" for i in range(n_vocab)]
    word_codes = _word_codes(n_vocab)
    vids = [f"{collection}_v{i}" for i in range(n_videos)]
    words = _video_words(rng, n_videos, n_vocab)
    latent = word_codes[words].sum(axis=1)
    cdir = os.path.join(root, collection)
    for feat, dim in FEATS.items():
        mat = latent @ _projection(feat, dim) + 0.1 * rng.standard_normal(
            (n_videos, dim)).astype(np.float32)
        write_bigfile(os.path.join(cdir, "FeatureData", feat), vids, mat)

    cap_ids, lines, rows, _ = _captions_of(rng, vocab, word_codes, vids, words,
                                           caps_per_video, caption_words)
    os.makedirs(os.path.join(cdir, "TextData"), exist_ok=True)
    with open(os.path.join(cdir, "TextData", f"{collection}.caption.txt"), "w") as fh:
        fh.write("\n".join(lines))
    os.makedirs(os.path.join(cdir, "VideoSets"), exist_ok=True)
    with open(os.path.join(cdir, "VideoSets", f"{collection}.txt"), "w") as fh:
        fh.write("\n".join(vids))
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
        frows = np.repeat(latent @ _projection(FRAME_NAME, FRAME_DIM), counts, axis=0)
        frows += 0.1 * rng.standard_normal(frows.shape).astype(np.float32)
        write_bigfile(os.path.join(cdir, "FeatureData", "frame", FRAME_NAME), frame_ids, frows)
        summary["frames"] = len(frame_ids)
    return summary
