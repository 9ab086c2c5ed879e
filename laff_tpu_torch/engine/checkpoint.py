"""The port's checkpoint format.

One ``torch.save`` file holding only tensors and plain data, so it loads
with ``weights_only=True`` and references no class of either package:

  format       "laff_tpu_torch_ckpt_v1"
  state_dict   the LAFFModel state dict (CPU tensors)
  spec         the LAFFSpec as nested dicts/tuples (``spec_to_dict``)
  config       the config's plain attributes (name -> str/number/list/dict)
  vocab        featurizer vocabularies: {'bow': {...}, 'rnn': {...}}, each
               {'encoding', 'words' (index order), 'class', 'norm'}
  opt          how the checkpoint was made (config name, sweep string, ...)

The trainer adds ``epoch`` and ``best_perf``, and its resume file
(``model_resume.pth.tar``) the optimizer state, the LR controller, the step
and early-stop counters and the mean-last window, all tensors or plain
data. ``save_checkpoint_dance`` keeps the reference's best-model file
names, so the predictor loads the trainer's ``model_best.pth.tar`` as it is.

``load_checkpoint`` tells the formats apart by the payload, not by the
file (both are ``torch.save`` zips): ``format`` equal to FORMAT is the
port's own, loaded with ``weights_only=True``; ``model`` and ``config``
keys mark a reference checkpoint (``laff_tpu``'s exported ones too), read
by ``engine.torch_import`` into the same payload; anything else raises.
"""

from __future__ import annotations

import os
import pickle
import shutil
import types
from typing import Dict, List

import torch

from ..models.spec import LAFFSpec, spec_from_dict, spec_to_dict
from ..text.textlib import Vocabulary

FORMAT = "laff_tpu_torch_ckpt_v1"
_PLAIN = (str, int, float, bool, type(None), list, tuple, dict)


def _plain(value) -> bool:
    if isinstance(value, (list, tuple)):
        return all(_plain(v) for v in value)
    if isinstance(value, dict):
        return all(isinstance(k, str) and _plain(v) for k, v in value.items())
    return isinstance(value, _PLAIN)


def _builtin(value):
    """Plain data with numpy's str and number subclasses (an ``adjust_parm``
    picks names out of numpy arrays) as the builtin types, which a
    ``weights_only`` load accepts."""
    if isinstance(value, dict):
        return {k: _builtin(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_builtin(v) for v in value)
    for kind in (bool, int, float, str):
        if isinstance(value, kind):
            return kind(value)
    return value


def config_to_dict(config) -> Dict:
    """Every public, non-callable attribute whose value is plain data."""
    out = {}
    for name in dir(config):
        if name.startswith("_"):
            continue
        value = getattr(config, name)
        if not callable(value) and _plain(value):
            out[name] = _builtin(value)
    return out


def vocab_to_dict(featurizer) -> Dict:
    vocab = featurizer.vocab
    return {
        "encoding": vocab.encoding,
        "words": [vocab[i] for i in range(len(vocab))],
        "class": type(featurizer).__name__,
        "norm": int(getattr(featurizer, "norm", 0)),
    }


def vocab_from_dict(d: Dict) -> Vocabulary:
    vocab = Vocabulary(d["encoding"])
    for word in d["words"]:
        vocab.add(word)
    return vocab


def checkpoint_payload(state_dict, spec: LAFFSpec, config, featurizers, opt) -> Dict:
    return {
        "format": FORMAT,
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "spec": spec_to_dict(spec),
        "config": config if isinstance(config, dict) else config_to_dict(config),
        "vocab": {name: vocab_to_dict(f) for name, f in featurizers.items()
                  if name in ("bow", "rnn") and f is not None},
        "opt": dict(opt),
    }


def save_checkpoint(payload: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint_dance(payload: Dict, is_best: bool, logdir: str,
                          filename: str = "checkpoint.pth.tar", only_best: bool = False) -> None:
    """The reference's best-model protocol (``trainer.py:626-645``): a best
    epoch is staged as model_temp_best; at the end of training the staged
    file becomes model_best. A resumed run that never beat the best before
    the interruption has no staged file, and writes the current weights if
    model_best does not exist yet."""
    staged = os.path.join(logdir, "model_temp_best.pth.tar")
    if is_best:
        resfile = os.path.join(logdir, filename)
        save_checkpoint(payload, resfile)
        shutil.copyfile(resfile, staged)
        os.remove(resfile)
    if only_best:
        best = os.path.join(logdir, "model_best.pth.tar")
        if os.path.exists(staged):
            shutil.copyfile(staged, best)
            os.remove(staged)
        elif not os.path.exists(best):
            save_checkpoint(payload, best)


def average_states(states: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Uniform average of parameter dicts (mean_last10, reference
    ``trainer.py:410-424``)."""
    out = {k: v.clone() for k, v in states[0].items()}
    for other in states[1:]:
        for k, v in other.items():
            out[k] += v
    return {k: v / len(states) for k, v in out.items()}


def load_checkpoint(path: str) -> Dict:
    """Load a port checkpoint, or import a reference one; ``spec`` comes
    back as a LAFFSpec and ``config`` as an attribute namespace (a
    reference file's own config object)."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # classes a weights-only load refuses: a reference pickle
        payload = None
    if isinstance(payload, dict) and payload.get("format") == FORMAT:
        payload = dict(payload)
        payload["spec"] = spec_from_dict(payload["spec"])
        payload["config"] = types.SimpleNamespace(**payload["config"])
        return payload
    from . import torch_import

    if payload is None:
        payload = torch_import.read_reference(path)
    if isinstance(payload, dict) and "model" in payload and "config" in payload:
        return torch_import.load_torch_checkpoint(path, payload)
    raise ValueError(f"{path}: neither a laff_tpu_torch checkpoint nor a reference one (no "
                     f"'format' {FORMAT!r}, no 'model' and 'config')")
