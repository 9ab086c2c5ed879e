"""The main path's host remainder in the port, on the CPU.

* ``laff_tpu_torch.native`` (fastfeat): the bow and index arrays equal the
  port's Python path and laff_tpu's, bit for bit, on captions with stop
  words, out-of-vocabulary words, non-ASCII bytes and more than
  ``max_len`` tokens; the extension is built under ``build/`` (never
  beside its source); without a compiler the featurizers keep the Python
  path.
* ``trainer.AsyncSaver``: the files it writes equal synchronous saves, bit
  for bit, and a payload snapshot taken the trainer's way keeps the values
  of before an in-place update that follows the submit.
"""

import os

import numpy as np
import pytest
import torch

from laff_tpu.text import textlib as jax_textlib
from laff_tpu.text import txt2vec as jax_txt2vec
from laff_tpu_torch import native
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import save_checkpoint, save_checkpoint_dance
from laff_tpu_torch.ops.kernels import BUILD_DIR
from laff_tpu_torch.text import textlib, txt2vec

CAPTIONS = [
    "A man is riding a horse on the beach",
    "the THE a an of -- dog!!! runs,quickly; to the park",
    "café naïve über straße dog 東京 cat\r\nruns\tjumps",
    "",
    "zebra quokka xylophone",  # out of vocabulary only
    " ".join(["dog cat man runs jumps park"] * 20),  # 120 tokens: cut at max_len
    "dog\x00cat \U0001F600 man",
]
WORDS = ["<pad>", "<start>", "<end>", "<unk>", "man", "riding", "horse", "beach", "dog",
         "runs", "quickly", "park", "caf", "na", "ve", "ber", "stra", "e", "cat", "jumps",
         "the", "a", "is", "on"]
MAX_LEN = 32


def _vocabs(module, encoding):
    vocab = module.Vocabulary(encoding)
    for w in WORDS:
        vocab.add(w)
    return vocab


def _featurizers(txt, lib, kind):
    if kind == "idx":
        return txt.IndexVec(_vocabs(lib, "gru"))
    cls = txt.BowVecNSW if kind == "bow_nsw" else txt.BowVec
    return cls(_vocabs(lib, kind))


def _encode(featurizer, kind):
    if kind == "idx":
        return featurizer.encode_batch_padded(CAPTIONS, MAX_LEN)
    return (featurizer.encode_batch(CAPTIONS),)


@pytest.mark.parametrize("kind", ["bow", "bow_nsw", "idx"])
def test_fastfeat_arrays_equal_python_path_and_laff_tpu(kind, monkeypatch):
    assert native.get_fastfeat() is not None  # g++ is on the test host
    port = _featurizers(txt2vec, textlib, kind)
    native.reset_calls()
    fast = _encode(port, kind)
    assert native.CALLS["encode_idx" if kind == "idx" else "encode_bow"] == 1
    monkeypatch.setattr(native, "get_fastfeat", lambda: None)
    slow = _encode(port, kind)
    ref = _encode(_featurizers(jax_txt2vec, jax_textlib, kind), kind)
    for f, s, r in zip(fast, slow, ref):
        assert f.dtype == s.dtype == r.dtype and f.shape == s.shape == r.shape
        np.testing.assert_array_equal(f, s)
        np.testing.assert_array_equal(f, r)
    if kind == "idx":
        assert fast[1][5] == MAX_LEN and fast[0][4, 1:4].tolist() == [3, 3, 3]
    else:
        assert fast[0].sum() > 0 and not fast[0][4].any()


def test_fastfeat_builds_under_build_not_beside_its_source():
    so = native.library_path()
    assert native.get_fastfeat() is not None and so.exists()
    assert so.parent == BUILD_DIR
    assert so.name.startswith("fastfeat-")  # named by the source's digest
    src_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_python_path_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_state", {"module": None, "failed": False})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.get_fastfeat() is None
    bow = _featurizers(txt2vec, textlib, "bow")
    native.reset_calls()
    out = bow.encode_batch(CAPTIONS)
    assert native.CALLS["encode_bow"] == 0
    np.testing.assert_array_equal(out, np.stack([bow.encoding(q) for q in CAPTIONS]))


def _payload(model):
    """A checkpoint of ``model`` with host copies, as the trainer takes it."""
    return {"state_dict": port_trainer.host_copy(model.state_dict().items()), "epoch": 3}


class _Synchronous:
    def submit(self, fn, *args, **kwargs):
        fn(*args, **kwargs)

    def join(self):
        pass


def test_async_saver_files_equal_synchronous_saves(tmp_path):
    model = torch.nn.Linear(64, 32)
    files = {}
    for name, saver in (("sync", _Synchronous()), ("async", port_trainer.AsyncSaver())):
        logdir = tmp_path / name
        saver.submit(save_checkpoint_dance, _payload(model), True, logdir=str(logdir),
                     filename="checkpoint_epoch_0.pth.tar")
        saver.submit(save_checkpoint, _payload(model), str(logdir / "model_resume.pth.tar"))
        saver.join()
        save_checkpoint_dance(_payload(model), False, logdir=str(logdir), only_best=True)
        files[name] = {f: (logdir / f).read_bytes() for f in sorted(os.listdir(logdir))}
    assert sorted(files["async"]) == ["model_best.pth.tar", "model_resume.pth.tar"]
    assert files["async"] == files["sync"]


def test_async_saver_writes_the_values_from_before_an_in_place_update(tmp_path):
    model = torch.nn.Linear(256, 256)
    saver = port_trainer.AsyncSaver()
    path = str(tmp_path / "ck.pt")
    for _ in range(3):  # writes in order, one in flight
        before = {k: v.clone() for k, v in model.state_dict().items()}
        saver.submit(save_checkpoint, _payload(model), path)
        with torch.no_grad():  # the next step's in-place update
            for p in model.parameters():
                p.add_(1.0)
    saver.join()
    saved = torch.load(path, weights_only=True)["state_dict"]
    for k, v in before.items():
        assert torch.equal(saved[k], v), k
        assert not torch.equal(saved[k], model.state_dict()[k])


def test_async_saver_raises_a_failed_write():
    saver = port_trainer.AsyncSaver()

    def fail():
        raise OSError("disk full")

    saver.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        saver.join()
    saver.join()  # raised once
    saver.submit(fail)  # while the epoch loop unwinds from its own error
    with pytest.raises(ValueError, match="the loop's"):
        try:
            raise ValueError("the loop's")
        except ValueError:
            saver.join_quietly()
            raise
    saver.join()
