"""Reference PyTorch checkpoints (``.pth.tar``) into the port.

A torch-to-torch port of ``laff_tpu.engine.torch_import``: the reference
state dict (``model/model.py``'s module tree) is renamed onto the port's
``LAFFModel`` state dict, and the pickled reference config rebuilds the
spec:

  txt side (MultiScaleTxtEncoderAttention):
    txt_net.encoder.rnn_encoder.we.weight          -> txt_net.gru.we.weight
    txt_net.encoder.rnn_encoder.rnn.<w>_l<k>       -> txt_net.gru.rnn.<w>_l<k>
    txt_net.transform_layer.<enc>_transform.fc1/bn1.*
                                                   -> txt_net.transform_<feat>.fc1/bn1.*
    txt_net.attention_layer.attention_layer.<h>.embedding_common.0.{weight,bias}
                                                   -> txt_net.attention.gate_{kernel,bias}[h]
    ...attention_layer.<h>.global_emb_weight_net.weight
                                                   -> txt_net.attention.global_emb_weight
    txt_net.expert_embedding.weight                -> txt_net.expert_embedding
  vis side, LAFF (VisMutiTransformNetAddAttnetion):
    vis_net.VisMutiTransformNet.<feat>.fc1/bn1.*   -> vis_net.transform_<feat>.*
    vis_net.attention_layer...                     -> vis_net.attention
  vis side, FrameLAFF (VisMutiTransformNetPlusFrameFeat):
    vis_net.<feat>.fc1/bn1.*                       -> vis_net.transform_<feat>.*
    vis_net.vis_attention_layer...                 -> vis_net.attention
    vis_net.frame_attention.<feat>.<i>...          -> vis_net.frame_attn_<feat>
                                                      (+ frame_fc_<feat> when addFC)

Linear weights keep torch's (out, in) layout, so a transform is a rename;
the per-head gate rows stack into the (H, dh) kernel. ``convert_state_dict``
returns exactly the state dict of ``LAFFModel(spec)``: a reference key it
does not consume, or a model key it cannot fill, raises (an unknown layout
never loads half). Only two model entries may be absent from the file and
take their init: BatchNorm's ``num_batches_tracked`` and a gate's
``global_emb_weight`` (1).

Reference pickles name the reference's own modules (``configs.<name>``,
``textlib``, ``txt2vec``, ``bigfile``; ``laff_tpu``'s files name
``laff_tpu.configs.<name>`` and so on). ``ReferenceUnpickler`` resolves
those names to the port's copies for the one ``torch.load`` it is passed
to, and admits besides only torch's tensor rebuilds, numpy arrays and
scalars, ``argparse.Namespace``, ``collections.OrderedDict`` and a few
builtins (``_ALLOWED``); anything else raises. It writes nothing to
``sys.modules`` and imports nothing of ``laff_tpu``: those module paths
are keys of its map.
"""

from __future__ import annotations

import argparse
import codecs
import collections
import copyreg
import dataclasses
import importlib
import pickle
import types
from typing import Dict, Optional

import torch

from ..models.laff import LAFFModel, safe_name
from ..models.spec import GruSpec, LAFFSpec
from ..utils import get_logger
from .checkpoint import vocab_to_dict

logger = get_logger(__name__)

_TXT_ENCODER_NAMES = {
    "rnn": "rnn_encoder",
    "bert": "bert_encoder",
    "bow": "bow_encoder",
    "w2v": "w2v_encoder",
    "clip": "CLIP_encoder",
    "netvlad": "NetVLAD_encoder",
}

# reference (and laff_tpu) module -> the port's copy
_MODULE_MAP = {
    "textlib": "laff_tpu_torch.text.textlib",
    "txt2vec": "laff_tpu_torch.text.txt2vec",
    "bigfile": "laff_tpu_torch.store.bigfile",
    "laff_tpu.text.textlib": "laff_tpu_torch.text.textlib",
    "laff_tpu.text.txt2vec": "laff_tpu_torch.text.txt2vec",
    "laff_tpu.store.bigfile": "laff_tpu_torch.store.bigfile",
}
_CONFIG_PACKAGES = ("configs.", "laff_tpu.configs.")

_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("argparse", "Namespace"): argparse.Namespace,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "complex"): complex,
    ("builtins", "object"): object,
    ("copyreg", "_reconstructor"): copyreg._reconstructor,
    ("_codecs", "encode"): codecs.encode,  # the bytes of a protocol-2 numpy scalar
    ("torch", "Size"): torch.Size,
    ("torch", "device"): torch.device,
}
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray", "numpy.dtypes")
_NUMPY_NAMES = ("ndarray", "dtype", "_reconstruct", "scalar")


class ReferenceUnpickler(pickle.Unpickler):
    """Unpickler for reference checkpoints: reference module names go to
    the port's copies, and only the classes and functions listed in the
    module docstring load."""

    def find_class(self, module: str, name: str):
        target = _MODULE_MAP.get(module)
        if target is None and module.startswith(_CONFIG_PACKAGES):
            config_name = module.rpartition("configs.")[2]
            target = f"laff_tpu_torch.configs.{config_name}"
            try:
                mod = importlib.import_module(target)
            except ModuleNotFoundError as e:
                raise ModuleNotFoundError(
                    f"No module named {module!r}: the port has no copy of the reference "
                    f"config {config_name!r} (laff_tpu_torch/configs/)", name=module) from e
            return _class_of(mod, module, name)
        if target is not None:
            return _class_of(importlib.import_module(target), module, name)
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if module == "torch._utils" and name.startswith("_rebuild_"):
            return getattr(importlib.import_module(module), name)
        if module == "torch._tensor" and name == "_rebuild_from_type_v2":
            return getattr(importlib.import_module(module), name)
        if module == "torch" and isinstance(getattr(torch, name, None), torch.dtype):
            return getattr(torch, name)
        if module in _NUMPY_MODULES and (name in _NUMPY_NAMES or name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"reference checkpoint: {module}.{name} is not a type "
                                     f"a checkpoint may hold; refusing to load it")


def _class_of(mod: types.ModuleType, module: str, name: str) -> type:
    obj = getattr(mod, name, None)
    if not isinstance(obj, type):
        raise pickle.UnpicklingError(f"reference checkpoint: {module}.{name} is not a class of "
                                     f"{mod.__name__}")
    return obj


def _unpickler_module() -> types.SimpleNamespace:
    """The ``pickle_module`` torch.load takes: its ``Unpickler`` is ours."""

    def load(fh, **kwargs):
        return ReferenceUnpickler(fh, **kwargs).load()

    return types.SimpleNamespace(Unpickler=ReferenceUnpickler, load=load,
                                 __name__="laff_tpu_torch.engine.torch_import")


def read_reference(path: str) -> Dict:
    """The raw payload of a reference ``.pth.tar`` ({'epoch', 'model',
    'best_perf', 'config', 'opt', ...}), tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_unpickler_module())


# ---------------------------------------------------------------------------
# state dict
# ---------------------------------------------------------------------------

class _Renamer:
    """Reference tensors -> port names, with the reference keys consumed."""

    def __init__(self, sd: Dict) -> None:
        self.sd = {k: torch.as_tensor(v) for k, v in sd.items()}
        self.out: Dict[str, torch.Tensor] = {}
        self.used = set()

    def take(self, ref: str, ours: str) -> bool:
        if ref not in self.sd:
            return False
        self.out[ours] = self.sd[ref]
        self.used.add(ref)
        return True

    def transform(self, prefix: str, ours: str) -> None:
        """fc1 + bn1 of one TransformNet."""
        for leaf in ("fc1.weight", "fc1.bias", "bn1.weight", "bn1.bias", "bn1.running_mean",
                     "bn1.running_var", "bn1.num_batches_tracked"):
            self.take(prefix + leaf, f"{ours}.{leaf}")

    def global_weight(self, key: str, ours: str) -> None:
        if key in self.sd:
            self.out[f"{ours}.global_emb_weight"] = self.sd[key].reshape(()).float()
            self.used.add(key)

    def multihead_gate(self, prefix: str, heads: int, ours: str) -> None:
        """attention_layer.<h>.embedding_common.0.{weight (1, dh), bias (1,)}
        -> gate_kernel (H, dh), gate_bias (H,); every head's residual weight
        is the same annealed scalar, head 0's is kept."""
        rows, biases = [], []
        for h in range(heads):
            base = f"{prefix}attention_layer.{h}."
            rows.append(self.sd[base + "embedding_common.0.weight"][0])
            biases.append(self.sd[base + "embedding_common.0.bias"][0])
            self.used.update((base + "embedding_common.0.weight",
                              base + "embedding_common.0.bias"))
            if h:
                self.used.add(base + "global_emb_weight_net.weight")
        self.out[f"{ours}.gate_kernel"] = torch.stack(rows)
        self.out[f"{ours}.gate_bias"] = torch.stack(biases)
        self.global_weight(f"{prefix}attention_layer.0.global_emb_weight_net.weight", ours)

    def single_gate(self, prefix: str, ours: str) -> None:
        """One Attention_1: embedding_common.0.{weight (1, D), bias (1,)}."""
        self.take(prefix + "embedding_common.0.weight", f"{ours}.gate.weight")
        self.take(prefix + "embedding_common.0.bias", f"{ours}.gate.bias")
        self.global_weight(prefix + "global_emb_weight_net.weight", ours)


def _is_frame_laff(sd: Dict) -> bool:
    return any(k.startswith("vis_net.vis_attention_layer.") for k in sd)


def convert_state_dict(sd: Dict, spec: LAFFSpec) -> Dict[str, torch.Tensor]:
    """Reference state dict -> the state dict of ``LAFFModel(spec)``
    (``laff_tpu``'s ``convert_state_dict``, LAFF and FrameLAFF layouts).
    Raises on a reference key it does not consume and on a model entry it
    cannot fill."""
    r = _Renamer(sd)
    heads = spec.txt.attention.heads

    for name, _ in spec.txt.features:
        enc = _TXT_ENCODER_NAMES.get(name, name)
        r.transform(f"txt_net.transform_layer.{enc}_transform.", f"txt_net.transform_{safe_name(name)}")
    rnn = "txt_net.encoder.rnn_encoder."
    if spec.txt.gru is not None and r.take(rnn + "we.weight", "txt_net.gru.we.weight"):
        for key in list(r.sd):
            if key.startswith(rnn + "rnn."):
                r.take(key, "txt_net.gru.rnn." + key[len(rnn + "rnn."):])
    r.take("txt_net.expert_embedding.weight", "txt_net.expert_embedding")
    if "txt_net.attention_layer.attention_layer.0.embedding_common.0.weight" in r.sd:
        r.multihead_gate("txt_net.attention_layer.", heads, "txt_net.attention")

    if _is_frame_laff(r.sd):
        vis_transform, vis_attn = "vis_net.", "vis_net.vis_attention_layer."
    else:
        vis_transform, vis_attn = "vis_net.VisMutiTransformNet.", "vis_net.attention_layer."
    for name, _ in list(spec.vis.features) + list(spec.vis.frame_features):
        r.transform(f"{vis_transform}{name}.", f"vis_net.transform_{safe_name(name)}")
    r.take("vis_net.expert_embedding.weight", "vis_net.expert_embedding")
    if f"{vis_attn}attention_layer.0.embedding_common.0.weight" in r.sd:
        r.multihead_gate(vis_attn, heads, "vis_net.attention")

    # frame attention (FrameLAFF): Sequential index 0 (no FC), or the FC at
    # 0 and the attention at 1 (vis_frame_addFC)
    for fname, _ in spec.vis.frame_features:
        base = f"vis_net.frame_attention.{fname}."
        idx = "0."
        if spec.vis.frame_add_fc and base + "0.weight" in r.sd:
            r.take(base + "0.weight", f"vis_net.frame_fc_{safe_name(fname)}.weight")
            r.take(base + "0.bias", f"vis_net.frame_fc_{safe_name(fname)}.bias")
            idx = "1."
        ours = f"vis_net.frame_attn_{safe_name(fname)}"
        fa = spec.vis.frame_attention
        if fa.kind.startswith("Multi_head"):
            if base + idx + "attention_layer.0.embedding_common.0.weight" in r.sd:
                r.multihead_gate(base + idx, fa.heads, ours)
        else:
            r.single_gate(base + idx, ours)
    return _fit(r, spec)


def _fit(r: _Renamer, spec: LAFFSpec) -> Dict[str, torch.Tensor]:
    """The renamed tensors as ``LAFFModel(spec)``'s state dict, or raise."""
    unused = sorted(set(r.sd) - r.used)
    if unused:
        raise ValueError(f"reference checkpoint: {len(unused)} keys of an unknown layout for "
                         f"this spec, e.g. {unused[:6]}")
    # the model's entries and shapes, from a CPU build (on the meta device
    # the init's reference ops would first import torch's compiler stack:
    # seconds, against well under one for the build)
    expected = LAFFModel(spec).state_dict()
    out = {}
    missing = []
    for key, like in expected.items():
        if key in r.out:
            value = r.out[key]
            if tuple(value.shape) != tuple(like.shape):
                raise ValueError(f"reference checkpoint: {key} has shape {tuple(value.shape)}, "
                                 f"the model's is {tuple(like.shape)}")
            out[key] = value.to(like.dtype).contiguous()
        elif key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=like.dtype)
        elif key.endswith("global_emb_weight"):
            out[key] = torch.ones((), dtype=like.dtype)
        else:
            missing.append(key)
    if missing:
        raise ValueError(f"reference checkpoint: no entry for {len(missing)} model keys, e.g. "
                         f"{missing[:6]}")
    # a gate without the mean residual has no weight for the file's scalar
    extra = sorted(k for k in set(r.out) - set(expected) if not k.endswith("global_emb_weight"))
    if extra:
        raise ValueError(f"reference checkpoint: entries the model does not have: {extra[:6]}")
    return out


# ---------------------------------------------------------------------------
# config -> spec
# ---------------------------------------------------------------------------

def _vis_dims_from_state_dict(sd: Dict, config) -> Dict[str, int]:
    """Per-feature visual dims read off the weights, for the reference's
    own checkpoints, whose pickled config keeps the ``['0', N]``
    placeholder (its trainer writes the dims into the shared class list,
    never the instance): a transformed feature's ``fc1.weight`` is
    (common, raw); a no_transform one's ``bn1.running_mean`` has width raw
    times the heads (the input is tiled)."""
    heads = 1
    mha = getattr(config, "multi_head_attention", None)
    if isinstance(mha, dict):
        heads = int(mha.get("heads", 1))
    no_transform = set(getattr(config, "vis_no_transform", ()) or ())
    prefix = "vis_net." if _is_frame_laff(sd) else "vis_net.VisMutiTransformNet."
    dims: Dict[str, int] = {}
    for key, w in sd.items():
        if not key.startswith(prefix):
            continue
        name, _, rest = key[len(prefix):].partition(".")
        if rest == "fc1.weight":
            dims[name] = int(w.shape[1])
        elif rest == "bn1.running_mean" and name not in dims:
            dims[name] = int(w.shape[0]) // max(heads if name in no_transform else 1, 1)
    return dims


def spec_from_reference_config(config, state_dict: Optional[Dict] = None) -> LAFFSpec:
    """A LAFFSpec from a reference config object (dims written into it by
    the trainer, or, for the placeholder, read off ``state_dict``)."""
    from .prepare import build_spec

    raw = config.vis_fc_layers[0]
    if isinstance(raw, dict):
        vis_all = dict(raw)
    elif state_dict is not None:
        vis_all = _vis_dims_from_state_dict(state_dict, config)
    else:
        raise ValueError(f"config.vis_fc_layers[0] is the un-mutated placeholder ({raw!r}) and "
                         f"no state_dict was given to recover dims from")
    frame_dims = {}
    if getattr(config, "frame_feat_input", False):
        for n in config.vid_frame_feats:
            if n in vis_all:
                frame_dims[n] = vis_all.pop(n)
    vis_all.pop("vis_feat_add_concat", None)

    sd = state_dict or {}
    txt_dims: Dict[str, int] = {}
    gru_spec = None
    te = config.text_encoding
    rnn_encoding, pooling = te["rnn_encoding"]["name"].split("_", 1)
    if rnn_encoding in ("gru", "bigru"):
        we_key = "txt_net.encoder.rnn_encoder.we.weight"
        if getattr(config, "t2v_idx", None):
            vocab_size = len(config.t2v_idx.vocab)
        elif we_key in sd:
            vocab_size = int(sd[we_key].shape[0])
        else:
            vocab_size = 0
        txt_dims["rnn"] = config.rnn_size * (2 if rnn_encoding == "bigru" else 1)
        gru_spec = GruSpec(vocab_size=vocab_size, we_dim=config.we_dim, rnn_size=config.rnn_size,
                           rnn_layer=config.rnn_layer, pooling=pooling,
                           bidirectional=(rnn_encoding == "bigru"))
    if "no" not in te["bert_encoding"]["name"]:
        txt_dims["bert"] = config.bert_size
    if "no" not in te["bow_encoding"]["name"]:
        bow_key = "txt_net.transform_layer.bow_encoder_transform.fc1.weight"
        if getattr(config, "t2v_bow", None) is not None:
            txt_dims["bow"] = config.t2v_bow.ndims
        elif bow_key in sd:
            txt_dims["bow"] = int(sd[bow_key].shape[1])
        else:
            raise ValueError("cannot determine the bow dim: no t2v_bow in the config and no bow "
                             "fc1 weight in the state dict")
    clip = "no" not in te["CLIP_encoding"]["name"]
    if clip:
        txt_dims["clip"] = config.clip_opt["size"]
    if "no" not in te["w2v_encoding"]["name"]:
        # t2v_w2v is None'd before checkpointing: the width comes off the
        # transform weight, else from the concat dim written into the config
        w2v_key = "txt_net.transform_layer.w2v_encoder_transform.fc1.weight"
        total = config.txt_fc_layers[0] if isinstance(config.txt_fc_layers, (list, tuple)) else 0
        known = sum(txt_dims.values())
        if w2v_key in sd:
            txt_dims["w2v"] = int(sd[w2v_key].shape[1])
        elif total > known:
            txt_dims["w2v"] = total - known
        else:
            txt_dims["w2v"] = 500
    if clip:  # the encoders' order, as the trainer builds them: w2v before clip
        txt_dims["clip"] = txt_dims.pop("clip")
    return build_spec(config, vis_all, txt_dims, gru_spec, frame_dims)


def _vocab_of(ckpt: Dict, config) -> Optional[Dict]:
    """The featurizer vocabularies: the file's own ('vocab', written by the
    port's exporter), else the pickled ``t2v_bow`` / ``t2v_idx`` objects of
    the config; None when neither is there (the predictor then rebuilds
    them from the train collection)."""
    if isinstance(ckpt.get("vocab"), dict):
        return ckpt["vocab"]
    vocab = {}
    if getattr(config, "t2v_bow", None) is not None:
        vocab["bow"] = vocab_to_dict(config.t2v_bow)
    if getattr(config, "t2v_idx", None) is not None:
        vocab["rnn"] = vocab_to_dict(config.t2v_idx)
    return vocab or None


def load_torch_checkpoint(path: str, ckpt: Optional[Dict] = None) -> Dict:
    """A reference ``.pth.tar`` as a port checkpoint payload: state_dict,
    spec, config (the unpickled object), vocab, opt, epoch, best_perf.
    ``ckpt`` is the file's payload when the caller has read it already."""
    if ckpt is None:
        ckpt = read_reference(path)
    config = ckpt["config"]
    spec = spec_from_reference_config(config, state_dict=ckpt["model"])
    if spec.tied_transforms:
        logger.warning(
            "checkpoint config sets txt_fc_same_with_vis_fc=True: the reference's multi-head "
            "tie is a silent no-op (a throwaway dict(named_modules()) assignment), so this "
            "checkpoint was trained with UNTIED towers and imports as such. The port ties "
            "the towers for its own training, so a model it trained tied is NOT "
            "bit-compatible with this import (see MIGRATING.md).")
        spec = dataclasses.replace(spec, tied_transforms=())
    state_dict = convert_state_dict(ckpt["model"], spec)
    opt = ckpt.get("opt")
    opt_dict = vars(opt) if opt is not None and not isinstance(opt, dict) else dict(opt or {})
    logger.info("imported reference checkpoint %s (epoch %s, best %s)", path, ckpt.get("epoch"),
                ckpt.get("best_perf"))
    return {"state_dict": state_dict, "spec": spec, "config": config,
            "vocab": _vocab_of(ckpt, config), "opt": opt_dict, "epoch": ckpt.get("epoch"),
            "best_perf": ckpt.get("best_perf"), "imported_from": "reference"}
