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

``build_collection`` and ``build_w2v`` write ``laff_tpu.data.synth``'s toy
worlds (a few dozen videos of 4 words each over 18 stock words, 16- and
12-d features, an 8-d ``word2vec/toy``), the same files from the same
seeds, for the 'tiny' config: the reproduction's dry run and the
multi-process smoke use them.

``build_avs_world`` writes an AVS collection (iacc.3 by default, at its
335,944 shots) in the reference's TRECVID layout, over the same word codes
and feature projections, so a model trained on a ``build_world``
collection of the same vocabulary answers its topics:

  <root>/<collection>/FeatureData/{the four FEATS}     (written in chunks)
  <root>/<collection>/VideoSets/<collection>.txt
  <root>/<collection>/TextData/<edition>.avs.txt       ("<topic> the w w w")
  <root>/<collection>/TextData/clip_synth              (CLIP rows of the topics)
  <root>/<collection>/TextData/avs.qrels.<edition>     ("1<topic> 0 <shot> <stratum> <rel>")

With ``benchmark=(name, shots, captions)`` it also writes a benchmark
collection over that gallery: ``<root>/<name>/FeatureData`` links to the
AVS collection's, its video set is the whole gallery, and ``shots`` shots
spread evenly over it get ``captions`` captions each, made as
``build_world`` makes them (6 of the shot's 8 words, CLIP rows from their
codes); the other shots are distractors. These are drawn from a generator
of their own after everything else, so the AVS collection is the one
``benchmark=None`` builds.

Each topic names ``AVS_TOPIC_WORDS`` words no other topic names; a shot is
relevant to it when the shot's 8 words contain all of them. Random words
almost never meet in one shot, so each topic gets a number of planted
relevant shots drawn log-uniformly from ``relevant`` (disjoint across
topics), whose first word slots become the topic's words. The judged pool of
a topic is its relevant shots and as many others (shots sharing some of its
words first, then random ones); a third of the pool, drawn at random, is
stratum 1 and fully judged, the rest stratum 2, of which half is judged and
half left unjudged (rel -1), the sampled layout ``sample_eval.pl`` scores.
"""

from __future__ import annotations

import os
import pickle
import zlib
from concurrent.futures import ThreadPoolExecutor

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
AVS_TOPIC_WORDS = 3  # words a topic names; a relevant shot has all of them
AVS_FIRST_TOPIC = 501  # TRECVID numbers the AVS topics of 2016-2018 501-590
AVS_CHUNK = 32_768  # rows of features made and written at once


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


def _word_codes(n_vocab: int) -> np.ndarray:
    return np.random.default_rng(99).standard_normal((n_vocab, LATENT)).astype(np.float32)


def _clip_projection() -> np.ndarray:
    return np.random.default_rng(zlib.crc32(b"clip_text") % 1000).standard_normal(
        (LATENT, CLIP_DIM)).astype(np.float32) * 0.3


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
    word_codes = _word_codes(n_vocab)
    vids = [f"{collection}_v{i}" for i in range(n_videos)]
    words = _video_words(rng, n_videos, n_vocab)
    latent = word_codes[words].sum(axis=1)
    cdir = os.path.join(root, collection)
    for feat, dim in FEATS.items():
        mat = latent @ _projection(feat, dim) + 0.1 * rng.standard_normal(
            (n_videos, dim)).astype(np.float32)
        write_bigfile(os.path.join(cdir, "FeatureData", feat), vids, mat)

    cap_ids, lines, rows, cap_words = _captions_of(rng, vocab, word_codes, vids, words,
                                                   caps_per_video)
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


def _shots_with(words: np.ndarray):
    """word id -> the shots whose words hold it (an inverted index)."""
    flat = words.ravel()
    order = np.argsort(flat, kind="stable")
    ordered = flat[order]

    def shots(w: int) -> np.ndarray:
        lo, hi = np.searchsorted(ordered, [w, w + 1])
        return order[lo:hi] // words.shape[1]
    return shots


def _plant(rng: np.random.Generator, words: np.ndarray, shots: np.ndarray,
           topic: np.ndarray, n_vocab: int) -> None:
    """Give ``shots`` the topic's words in their first slots, keeping each
    shot's 8 words distinct."""
    k = len(topic)
    for s in shots:
        row = words[s]
        row[:k] = topic
        for j in range(k, row.size):
            while row[j] in row[:j]:
                row[j] = rng.integers(0, n_vocab)


def _captions_of(rng: np.random.Generator, vocab, word_codes: np.ndarray, vids, words,
                 caps_per_video: int):
    """Captions of the videos ``vids`` with word rows ``words``, each naming
    6 of its video's 8 words, and their CLIP rows from those words' codes:
    (caption ids, 'id the w ...' lines, CLIP rows, (videos, captions, 6)
    word ids)."""
    sel = np.argsort(rng.random((len(vids), caps_per_video, 8)), axis=2)[:, :, :6]
    cap_words = np.take_along_axis(
        np.broadcast_to(words[:, None, :], (len(vids), caps_per_video, 8)), sel, axis=2)
    cap_ids, lines = [], []
    for i, vid in enumerate(vids):
        for c in range(caps_per_video):
            cap_ids.append(f"{vid}#{c}")
            lines.append(f"{vid}#{c} the " + " ".join(vocab[w] for w in cap_words[i, c]))
    rows = word_codes[cap_words.reshape(-1, 6)].sum(axis=1) @ _clip_projection()
    rows += 0.1 * rng.standard_normal(rows.shape).astype(np.float32)
    return cap_ids, lines, rows, cap_words


def _benchmark_over(root: str, collection: str, name: str, n_shots: int, caps_per_video: int,
                    vocab, word_codes: np.ndarray, vids, words: np.ndarray, seed: int) -> dict:
    """The benchmark collection over an AVS gallery (module docstring)."""
    rng = np.random.default_rng(seed + 104729)
    bdir = os.path.join(root, name)
    os.makedirs(os.path.join(bdir, "VideoSets"), exist_ok=True)
    os.makedirs(os.path.join(bdir, "TextData"), exist_ok=True)
    link = os.path.join(bdir, "FeatureData")
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(os.path.join(os.path.abspath(root), collection, "FeatureData"), link)
    _write_lines(os.path.join(bdir, "VideoSets", f"{name}.txt"), vids)
    shots = np.linspace(0, len(vids) - 1, n_shots).round().astype(int)
    cap_ids, lines, rows, _ = _captions_of(rng, vocab, word_codes, [vids[s] for s in shots],
                                           words[shots], caps_per_video)
    _write_lines(os.path.join(bdir, "TextData", f"{name}.caption.txt"), lines)
    write_bigfile(os.path.join(bdir, "TextData", "clip_synth"), cap_ids, rows)
    return {"collection": name, "captioned_videos": n_shots, "captions": len(cap_ids)}


def build_avs_world(root: str, collection: str = "iacc.3", n_videos: int = 335_944,
                    editions=("tv16", "tv17", "tv18"), topics_per_edition: int = 30,
                    n_vocab: int = 11286, seed: int = 0, relevant=(50, 2000),
                    benchmark=None) -> dict:
    """Build the AVS collection of the module docstring, and with
    ``benchmark=(name, shots, captions)`` a benchmark collection over its
    gallery; returns a summary dict (the bytes of features written among
    it, and the benchmark's under 'benchmark'). Each feature is made and
    written ``AVS_CHUNK`` rows at a time, the four side by side."""
    rng = np.random.default_rng(seed)
    word_codes = _word_codes(n_vocab)
    vocab = [f"w{i:05d}" for i in range(n_vocab)]
    vids = [f"{collection}_v{i}" for i in range(n_videos)]
    words = _video_words(rng, n_videos, n_vocab)
    n_topics = len(editions) * topics_per_edition
    topic_words = rng.choice(n_vocab, n_topics * AVS_TOPIC_WORDS, replace=False).reshape(
        n_topics, AVS_TOPIC_WORDS)
    lo, hi = np.log(relevant[0]), np.log(relevant[1])
    planted = np.exp(rng.uniform(lo, hi, n_topics)).round().astype(int)
    if planted.sum() > n_videos:
        raise ValueError(f"{planted.sum()} planted relevant shots do not fit {n_videos} shots")
    starts = np.concatenate([[0], np.cumsum(planted)])
    chosen = rng.permutation(n_videos)
    for t in range(n_topics):
        _plant(rng, words, chosen[starts[t]:starts[t + 1]], topic_words[t], n_vocab)

    cdir = os.path.join(root, collection)

    def write_feature(feat: str, dim: int, stream: np.random.Generator) -> int:
        fdir = os.path.join(cdir, "FeatureData", feat)
        os.makedirs(fdir, exist_ok=True)
        proj = _projection(feat, dim)
        with open(os.path.join(fdir, "feature.bin"), "wb") as fh:
            for start in range(0, n_videos, AVS_CHUNK):
                mat = word_codes[words[start:start + AVS_CHUNK]].sum(axis=1) @ proj
                mat += 0.1 * stream.standard_normal(mat.shape, dtype=np.float32)
                mat.tofile(fh)
        _write_lines(os.path.join(fdir, "id.txt"), vids)
        _write_lines(os.path.join(fdir, "shape.txt"), [f"{n_videos} {dim}"])
        return n_videos * dim * 4

    # one noise stream and one thread per feature: numpy draws and multiplies
    # outside the interpreter lock, so the features are made side by side
    streams = [np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(len(FEATS))]
    with ThreadPoolExecutor(len(FEATS)) as pool:
        done = [pool.submit(write_feature, feat, dim, stream)
                for (feat, dim), stream in zip(FEATS.items(), streams)]
        n_bytes = sum(d.result() for d in done)
    os.makedirs(os.path.join(cdir, "VideoSets"), exist_ok=True)
    _write_lines(os.path.join(cdir, "VideoSets", f"{collection}.txt"), vids)

    tdir = os.path.join(cdir, "TextData")
    os.makedirs(tdir, exist_ok=True)
    tnums = [str(AVS_FIRST_TOPIC + t) for t in range(n_topics)]
    rows = word_codes[topic_words].sum(axis=1) @ _clip_projection()
    rows += 0.1 * rng.standard_normal(rows.shape, dtype=np.float32)
    write_bigfile(os.path.join(tdir, "clip_synth"), tnums, rows)
    shots_with = _shots_with(words)
    n_relevant = []
    for e, edition in enumerate(editions):
        topics = range(e * topics_per_edition, (e + 1) * topics_per_edition)
        _write_lines(os.path.join(tdir, f"{edition}.avs.txt"),
                     [f"{tnums[t]} the " + " ".join(vocab[w] for w in topic_words[t])
                      for t in topics])
        qrels = []
        for t in topics:
            sharing = [shots_with(w) for w in topic_words[t]]
            rel = sharing[0]
            for s in sharing[1:]:
                rel = np.intersect1d(rel, s)
            n_relevant.append(len(rel))
            others = np.setdiff1d(np.unique(np.concatenate(sharing)), rel)
            extra = np.setdiff1d(rng.choice(n_videos, min(n_videos, 2 * len(rel)), replace=False),
                                 np.concatenate([rel, others]))
            others = np.concatenate([rng.permutation(others), rng.permutation(extra)])[:len(rel)]
            pool = np.concatenate([rel, others])
            is_rel = np.arange(len(pool)) < len(rel)
            order = rng.permutation(len(pool))
            stratum1 = np.zeros(len(pool), bool)
            stratum1[order[:len(pool) // 3]] = True
            judged = stratum1 | (rng.random(len(pool)) < 0.5)
            qrels += [f"1{tnums[t]} 0 {vids[s]} {1 if s1 else 2} "
                      f"{int(r) if j else -1}"
                      for s, r, s1, j in zip(pool, is_rel, stratum1, judged)]
        _write_lines(os.path.join(tdir, f"avs.qrels.{edition}"), qrels)
    summary = {"collection": collection, "videos": n_videos, "editions": list(editions),
               "topics": n_topics, "relevant_min": int(min(n_relevant)),
               "relevant_max": int(max(n_relevant)), "relevant_total": int(sum(n_relevant)),
               "feature_bytes": n_bytes}
    if benchmark is not None:
        summary["benchmark"] = _benchmark_over(root, collection, *benchmark, vocab, word_codes,
                                               vids, words, seed)
    return summary


# ---------------------------------------------------------------------------
# laff_tpu.data.synth's toy worlds
# ---------------------------------------------------------------------------

WORDS = [
    "dog", "cat", "man", "woman", "car", "ball", "runs", "jumps", "sits",
    "eats", "red", "blue", "big", "small", "park", "road", "water", "table",
]


def build_collection(root: str, collection: str, n_videos: int = 24, caps_per_video: int = 2,
                     feat_dims=(("clip_ft", 16), ("x3d", 12)), latent_dim: int = 5,
                     seed: int = 0, noise: float = 0.05):
    """A toy collection: each video draws 4 of ``WORDS``, its features a
    fixed projection of the words' summed codes plus noise, and each caption
    is "the" and its video's words shuffled. Returns (collection dir, video
    ids, caption lines)."""
    rng = np.random.default_rng(seed)
    cdir = os.path.join(root, collection)
    vids = [f"video{i}" for i in range(n_videos)]
    word_codes = np.random.default_rng(99).standard_normal(
        (len(WORDS), latent_dim)).astype(np.float32)
    video_words = [sorted(rng.choice(len(WORDS), size=4, replace=False)) for _ in vids]
    latent = np.stack([word_codes[w].sum(0) for w in video_words])
    for feat, dim in feat_dims:
        proj = np.random.default_rng(zlib.crc32(feat.encode()) % 2**31).standard_normal(
            (latent_dim, dim)).astype(np.float32)
        mat = latent @ proj + noise * rng.standard_normal((n_videos, dim)).astype(np.float32)
        write_bigfile(os.path.join(cdir, "FeatureData", feat), vids, mat)
    cap_lines = []
    for i, vid in enumerate(vids):
        base_words = [WORDS[j] for j in video_words[i]]
        for c in range(caps_per_video):
            order = rng.permutation(len(base_words))
            cap_lines.append(f"{vid}#{c} the {' '.join(base_words[j] for j in order)}")
    for sub in ("TextData", "VideoSets"):
        os.makedirs(os.path.join(cdir, sub), exist_ok=True)
    _write_lines(os.path.join(cdir, "TextData", f"{collection}.caption.txt"), cap_lines)
    _write_lines(os.path.join(cdir, "VideoSets", f"{collection}.txt"), vids)
    return cdir, vids, cap_lines


def build_w2v(root: str, dim: int = 8, seed: int = 3) -> str:
    """The toy 8-d ``word2vec/toy`` over ``WORDS``, "the" and "a"."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "word2vec", "toy")
    vocab = WORDS + ["the", "a"]
    write_bigfile(d, vocab, rng.standard_normal((len(vocab), dim)).astype(np.float32))
    return d
