"""CLIP weight acquisition: a model name or a file -> the towers
(``laff_tpu.models.clip.load``).

The reference loader's surface (``model/clip/clip.py``): the ``_MODELS``
name -> URL table (clip.py:18-23), ``_download`` with sha256 verification
(clip.py:26-53), ``available_models`` (clip.py:68-70), and ``load``'s
handling of TorchScript archives and plain state dicts (clip.py:102-121).
A TorchScript archive is only a weight container here: its
``state_dict()`` is read and loaded into the port's towers, and its graph
never runs.

Offline: place the released ``.pt`` at ``<root>/<basename of its URL>``;
when its sha256 matches the table it is used without any network access.
"""

import hashlib
import os
import pickle
import urllib.request
import warnings
from typing import Dict, List, NamedTuple

import torch

# reference model/clip/clip.py:18-23 (the URL path carries the sha256)
_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
}

# TorchScript archives register these as buffers; the reference deletes them
# before building the model (model/clip/model.py:430-432)
_NON_WEIGHT_KEYS = ("input_resolution", "context_length", "vocab_size")


def available_models() -> List[str]:
    """Reference ``clip.available_models`` (clip.py:68-70)."""
    return list(_MODELS.keys())


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _download(url: str, root: str) -> str:
    """Fetch ``url`` into ``root`` with sha256 verification (reference
    clip.py:26-53). A file already at the target whose digest matches is
    used as it is. A download lands in a per-process temporary file, renamed
    into place only once its digest checks out."""
    os.makedirs(root, exist_ok=True)
    expected = url.split("/")[-2]
    target = os.path.join(root, os.path.basename(url))
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if _sha256_file(target) == expected:
            return target
        warnings.warn(f"{target} exists, but the SHA256 checksum does not match; "
                      "re-downloading the file")
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        with urllib.request.urlopen(url) as src, open(tmp, "wb") as dst:
            while True:
                buf = src.read(8192)
                if not buf:
                    break
                dst.write(buf)
    except OSError as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"could not download {url} ({e}); in an offline environment, "
                           f"place the released checkpoint at {target} (sha256 {expected})"
                           ) from e
    if _sha256_file(tmp) != expected:
        os.unlink(tmp)
        raise RuntimeError("Model has been downloaded but the SHA256 checksum does not match")
    os.replace(tmp, target)
    return target


def load_state_dict(path: str) -> Dict:
    """A flat CLIP state dict from ``path``: a TorchScript archive (the
    format OpenAI released), a ``torch.save``d state dict, or a dict
    wrapping one under 'state_dict' (reference clip.py:102-112 and the
    buffer stripping of model.py:430-432). A pickle that holds more than
    tensors and containers (a whole module) is read as ``laff_tpu`` reads
    it, with ``weights_only=False``."""
    try:
        sd = dict(torch.jit.load(path, map_location="cpu").state_dict())
    except RuntimeError:
        try:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if "state_dict" in sd and not any(k.startswith(("visual.", "transformer."))
                                          for k in sd):
            sd = sd["state_dict"]
        sd = dict(sd)
    for key in _NON_WEIGHT_KEYS:
        sd.pop(key, None)
    return sd


class LoadedClip(NamedTuple):
    text_tower: object
    vision_tower: object
    arch: object
    input_resolution: int


def load(name_or_path: str, download_root: str = None) -> LoadedClip:
    """Reference ``clip.load`` (clip.py:73-123): a released model's name
    (downloaded with sha256 verification, or a file already in place) or a
    file path; the architecture from the weight shapes, both towers built
    and loaded (on the CPU, in eval mode). Returns the towers, the
    architecture and the vision input resolution (0 for a text-only file)."""
    from .towers import build_towers, infer_clip_config

    if name_or_path in _MODELS:
        root = download_root or os.environ.get(
            "LAFF_TPU_CLIP_DIR", os.path.join(os.path.expanduser("~"), ".cache", "clip"))
        path = _download(_MODELS[name_or_path], root)
    elif os.path.isfile(name_or_path):
        path = name_or_path
    else:
        raise RuntimeError(f"Model {name_or_path} not found; available models = "
                           f"{available_models()}")
    sd = load_state_dict(path)
    text_tower, vision_tower = build_towers(sd)
    arch = infer_clip_config(sd)
    res = 0 if arch.vision is None else arch.vision.image_size
    return LoadedClip(text_tower, vision_tower, arch, res)
