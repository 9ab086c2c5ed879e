"""The port's host data CLIs against laff_tpu's on the same files:
``cli/build_vocab`` (the vocabulary pickle and its count file),
``cli/txt2bin`` (BigFile bytes, NaN rows dropped, a wrong width raising)
and ``cli/check_data`` with ``data/check`` (the report and the exit code).
"""

import pickle

import numpy as np
import pytest

from laff_tpu.cli import build_vocab as jax_build_vocab
from laff_tpu.cli import check_data as jax_check_data
from laff_tpu.cli import txt2bin as jax_txt2bin
from laff_tpu.data import check as jax_check
from laff_tpu_torch.cli import build_vocab, check_data, txt2bin
from laff_tpu_torch.data import check
from laff_tpu_torch.store import write_bigfile

CAPTIONS = ["c0#0 A man is playing the guitar on a stage.",
            "c0#1 a man plays guitar#0.95 loudly",
            "c1#0 Two dogs run in the park, and the dogs bark!",
            "c1#1 the dogs are not running",
            "c2#0 a woman is cooking pasta in the kitchen",
            "c2#1 the woman cooks and the man plays"]


@pytest.mark.parametrize("encoding,threshold", [("bow", 1), ("bow_nsw", 2), ("gru", 1)])
def test_build_vocab_equals_laff_tpu(tmp_path, encoding, threshold):
    tdir = tmp_path / "coll" / "TextData"
    tdir.mkdir(parents=True)
    (tdir / "coll.caption.txt").write_text("\n".join(CAPTIONS) + "\n")
    outputs = {}
    for who, cli in (("jax", jax_build_vocab), ("port", build_vocab)):
        argv = ["coll", "--rootpath", str(tmp_path), "--caption_name", "coll.caption.txt",
                "--encoding", encoding, "--threshold", str(threshold), "--folder_name", who]
        assert cli.main(argv) == 0
        stem = tdir / who / f"{encoding}_{threshold}"
        with open(f"{stem}.pkl", "rb") as fh:
            vocab = pickle.load(fh)
        outputs[who] = (vars(vocab), open(f"{stem}.txt").read())
        assert cli.main(argv) == 0  # an existing vocabulary is kept
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"][0]["word2idx"]) > 4


def test_txt2bin_equals_laff_tpu(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    rows = rng.normal(size=(7, 5)).astype(np.float32)
    lines = [f"v{i} " + " ".join(repr(float(x)) for x in r) for i, r in enumerate(rows)]
    lines[3] = "v3 " + " ".join(["nan"] * 5)  # dropped
    (src / "a.txt").write_text("\n".join(lines[:4]) + "\n\n")
    (src / "b.txt").write_text("\n".join(lines[4:]) + "\n")
    single = tmp_path / "c.txt"
    single.write_text("w0 " + " ".join(["0.5"] * 5) + "\n")
    for who, cli in (("jax", jax_txt2bin), ("port", txt2bin)):
        assert cli.main(["5", str(src), str(single), str(tmp_path / who)]) == 0
    for name in ("feature.bin", "id.txt", "shape.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert (tmp_path / "port" / "shape.txt").read_text() == "7 5"
    got = np.fromfile(tmp_path / "port" / "feature.bin", np.float32).reshape(7, 5)
    np.testing.assert_array_equal(got[:3], rows[:3])
    np.testing.assert_array_equal(got[3:6], rows[4:])
    (src / "b.txt").write_text("x 1 2\n")
    for who, cli in (("jax", jax_txt2bin), ("port", txt2bin)):
        with pytest.raises(ValueError, match="has 2 dims, expected 5"):
            cli.main(["5", str(src), str(tmp_path / f"{who}_bad"), "--overwrite", "1"])


def test_check_data_equals_laff_tpu(tmp_path):
    """A collection with a good, a missing and a broken feature and no video
    set: the same report, and exit code 1 from both CLIs; 0 once the
    layout is complete."""
    root = tmp_path
    cdir = root / "coll"
    write_bigfile(str(cdir / "FeatureData" / "good"), ["a", "b"], np.ones((2, 3), np.float32))
    (cdir / "FeatureData" / "broken").mkdir()
    (cdir / "FeatureData" / "broken" / "shape.txt").write_text("2\n")
    write_bigfile(str(cdir / "FeatureData" / "frame" / "fr"), ["a_0"], np.ones((1, 2), np.float32))
    (cdir / "TextData").mkdir()
    (cdir / "TextData" / "coll.caption.txt").write_text("a#0 x\n")
    args = (str(root), "coll", ["good", "missing", "broken"], ["fr", "nofr"])
    report = check.check_collection(*args)
    assert report == jax_check.check_collection(*args)
    assert [len(report[k]) for k in ("ok", "missing", "broken")] == [3, 3, 1]
    argv = ["coll", "--rootpath", str(root), "--features", "good,missing"]
    assert check_data.main(argv) == jax_check_data.main(argv) == 1
    (root / "word2vec" / "flickr" / "vec500flickr30m").mkdir(parents=True)
    (cdir / "VideoSets").mkdir()
    (cdir / "VideoSets" / "coll.txt").write_text("a\nb\n")
    argv = ["coll", "--rootpath", str(root), "--features", "good"]
    assert check_data.main(argv) == jax_check_data.main(argv) == 0
