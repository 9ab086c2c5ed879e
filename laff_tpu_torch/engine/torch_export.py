"""The port's checkpoints in the reference PyTorch layout.

The inverse of ``engine.torch_import`` (``laff_tpu.engine.torch_export``):
a port payload's ``LAFFModel`` state dict goes back to the reference
module names, so the reference (and ``laff_tpu``) load the result. The
per-head gate kernels unstack into ``attention_layer.<h>.embedding_common.0.*``
rows, each head gets the annealed residual weight (1 for a gate without
the mean residual), and a cross-tower tied linear is written into both
towers' ``fc1``: the reference's multi-head tie is a no-op, so its loader
expects a copy per tower. Covers the LAFF and FrameLAFF layouts (the gate
kinds); a tower of another fusion kind raises, as its reference layout is
not mapped. task2's concept heads have no reference counterpart: they are
left out with a warning, and the retrieval towers are exported in full.

``save_torch_checkpoint`` writes {'epoch', 'model', 'best_perf', 'config',
'opt', 'vocab'}: the config as an ``argparse.Namespace`` of its plain
attributes (which the reference and both packages unpickle without a
module of either), and the featurizer vocabularies as plain data, which
the reference ignores and the port's predictor reads.
"""

from __future__ import annotations

import argparse
import types
from typing import Dict

import torch

from ..models.laff import safe_name
from ..utils import get_logger
from .checkpoint import config_to_dict
from .torch_import import _TXT_ENCODER_NAMES

logger = get_logger(__name__)

_GATE_KINDS = ("Multi_head_MyApply_Attention", "Multi_head_MyApply_FusionAttention",
               "Multi_head_Attention_layer_norm", "Multi_head_Attention_distinct_fc")


class _Writer:
    def __init__(self, state: Dict[str, torch.Tensor]) -> None:
        self.state = {k: v.detach().cpu() for k, v in state.items()}
        self.sd: Dict[str, torch.Tensor] = {}

    def transform(self, ours: str, prefix: str, shared: str = "") -> None:
        """One TransformNet (``shared``: the tied linear standing in for fc1)."""
        fc = ours + ".fc1" if ours + ".fc1.weight" in self.state else shared
        if fc:
            self.sd[prefix + "fc1.weight"] = self.state[fc + ".weight"]
            self.sd[prefix + "fc1.bias"] = self.state[fc + ".bias"]
        if ours + ".bn1.weight" in self.state:
            for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
                self.sd[f"{prefix}bn1.{leaf}"] = self.state[f"{ours}.bn1.{leaf}"]

    def _g(self, ours: str) -> torch.Tensor:
        g = self.state.get(ours + ".global_emb_weight")
        return torch.ones((1, 1)) if g is None else g.reshape(1, 1).float()

    def multihead_gate(self, ours: str, prefix: str) -> None:
        kernel, bias = self.state[ours + ".gate_kernel"], self.state[ours + ".gate_bias"]
        for h in range(kernel.shape[0]):
            base = f"{prefix}attention_layer.{h}."
            self.sd[base + "embedding_common.0.weight"] = kernel[h][None, :]
            self.sd[base + "embedding_common.0.bias"] = bias[h][None]
            self.sd[base + "global_emb_weight_net.weight"] = self._g(ours)

    def single_gate(self, ours: str, prefix: str) -> None:
        self.sd[prefix + "embedding_common.0.weight"] = self.state[ours + ".gate.weight"]
        self.sd[prefix + "embedding_common.0.bias"] = self.state[ours + ".gate.bias"]
        self.sd[prefix + "global_emb_weight_net.weight"] = self._g(ours)


def export_state_dict(payload: Dict) -> Dict[str, torch.Tensor]:
    """A port payload ({'state_dict', 'spec'}) -> the reference-named state
    dict (CPU tensors)."""
    spec = payload["spec"]
    for side, tower in (("txt", spec.txt), ("vis", spec.vis)):
        if tower.attention.kind not in _GATE_KINDS:
            raise ValueError(f"the {side} tower fuses with {tower.attention.kind!r}: the "
                             f"reference layout of that kind is not mapped; the exporter "
                             f"writes LAFF gate towers")
    w = _Writer(payload["state_dict"])
    txt_tied, vis_tied = {}, {}
    for txt_name, vis_name in spec.tied_transforms:
        shared = f"tied_fc_{safe_name(txt_name)}_{safe_name(vis_name)}"
        txt_tied[txt_name], vis_tied[vis_name] = shared, shared

    for name, _ in spec.txt.features:
        enc = _TXT_ENCODER_NAMES.get(name, name)
        w.transform(f"txt_net.transform_{safe_name(name)}",
                    f"txt_net.transform_layer.{enc}_transform.", txt_tied.get(name, ""))
    if spec.txt.gru is not None:
        w.sd["txt_net.encoder.rnn_encoder.we.weight"] = w.state["txt_net.gru.we.weight"]
        for key, value in w.state.items():
            if key.startswith("txt_net.gru.rnn."):
                w.sd["txt_net.encoder.rnn_encoder.rnn." + key[len("txt_net.gru.rnn."):]] = value
    if "txt_net.expert_embedding" in w.state:
        w.sd["txt_net.expert_embedding.weight"] = w.state["txt_net.expert_embedding"]
    w.multihead_gate("txt_net.attention", "txt_net.attention_layer.")

    frame_laff = bool(spec.vis.frame_features)
    t_prefix = "vis_net." if frame_laff else "vis_net.VisMutiTransformNet."
    a_prefix = "vis_net.vis_attention_layer." if frame_laff else "vis_net.attention_layer."
    for name, _ in list(spec.vis.features) + list(spec.vis.frame_features):
        w.transform(f"vis_net.transform_{safe_name(name)}", f"{t_prefix}{name}.",
                    vis_tied.get(name, ""))
    if "vis_net.expert_embedding" in w.state:
        w.sd["vis_net.expert_embedding.weight"] = w.state["vis_net.expert_embedding"]
    w.multihead_gate("vis_net.attention", a_prefix)

    for fname, _ in spec.vis.frame_features:
        base = f"vis_net.frame_attention.{fname}."
        idx = "0."
        fc = f"vis_net.frame_fc_{safe_name(fname)}"
        if fc + ".weight" in w.state:
            w.sd[base + "0.weight"] = w.state[fc + ".weight"]
            w.sd[base + "0.bias"] = w.state[fc + ".bias"]
            idx = "1."
        ours = f"vis_net.frame_attn_{safe_name(fname)}"
        if ours + ".gate_kernel" in w.state:
            w.multihead_gate(ours, base + idx)
        else:
            w.single_gate(ours, base + idx)
    if any(k.startswith(("task2_vis_head.", "task2_txt_head.")) for k in w.state):
        # the reference builds no task2 module (its task2 loss is dead code)
        logger.warning("task2 concept heads present but NOT exported (the reference has no "
                       "task2 modules); retrieval towers exported in full")
    return w.sd


def save_torch_checkpoint(payload: Dict, path: str) -> None:
    """Write a reference-loadable ``.pth.tar`` of a port payload."""
    config = payload.get("config")
    if isinstance(config, (argparse.Namespace, types.SimpleNamespace)):
        config = vars(config)
    elif config is not None and not isinstance(config, dict):
        config = config_to_dict(config)
    torch.save({
        "epoch": payload.get("epoch", 0),
        "model": export_state_dict(payload),
        "best_perf": payload.get("best_perf", 0.0),
        "config": None if config is None else argparse.Namespace(**config),
        "opt": dict(payload.get("opt") or {}),
        "vocab": payload.get("vocab"),
    }, path)
    logger.info("exported a reference-format checkpoint to %s", path)
