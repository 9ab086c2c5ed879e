"""Carry ``laff_tpu`` variables over to a ``LAFFModel`` state dict.

The port names its modules after the flax tree, so the bridge is a rename
plus these layout changes:

  <...>.<dense>.kernel (in, out)   -> <...>.<dense>.weight (out, in), transposed,
                                      for every flax Dense: fc1, the gates'
                                      'gate', frame_fc_<f>, tied_fc_<t>_<v>
                                      (the cross-tower linear, once), the zoo's
                                      q_<i> / k_<i> / v_<i> / out / concat_fc
  <...>.bn1.scale / bias           -> <...>.bn1.weight / bias
  <...>.ln.scale                   -> <...>.ln.weight (the zoo's LayerNorms)
  <...>.mha.out_proj_{weight,bias} -> <...>.mha.out_proj.{weight,bias}
                                      (torch layout in both)
  batch_stats <...>.bn1.mean / var -> <...>.bn1.running_mean / running_var
  <...>.gru.we                     -> <...>.gru.we.weight
  <...>.gru.{w,b}_{ih,hh}_l<k>     -> <...>.gru.rnn.{weight,bias}_{ih,hh}_l<k>
                                      (packed r, z, n in both; '_rev' ->
                                      '_reverse')
  schedule <...>.global_emb_weight -> the attention's buffer of that name
  txt_net.bert.<...>               -> txt_net.bert.<...> (the in-graph BERT:
                                      transformers' flax names are its
                                      PyTorch names) with <dense>.kernel ->
                                      .weight transposed, <embed>.embedding
                                      -> .weight, LayerNorm.scale -> .weight

``gate_kernel`` (H, dh), ``gate_bias`` (H,), the pre-LN parameters, the
expert embedding, LinearCombine's ``kernel`` (L, 1) and ``bias``, the MHA's
packed ``in_proj_weight`` / ``in_proj_bias``, ``cls_embedding`` and the
NetVLAD ``assign`` / ``centroids`` keep their names and shapes. task2's
``task2_vis_head`` / ``task2_txt_head`` are TransformNets (fc1, bn1) and
carry over by the same rules, BatchNorm statistics included. Inputs are
nested dicts of numpy arrays (flax variable collections after
``np.asarray``).

The CLIP towers (``models.clip``) take the OpenAI state-dict names, which
``laff_tpu``'s flax towers flatten; ``clip_*_from_jax`` map them back:

  block_<i>.ln_{1,2}.scale / bias  -> transformer.resblocks.<i>.ln_{1,2}.weight / bias
  block_<i>.attn_in_proj_{weight,bias}, attn_out_proj_{weight,bias}, mlp_c_{fc,proj}_{weight,bias}
                                   -> ...attn.in_proj_*, attn.out_proj.*, mlp.c_{fc,proj}.*
                                      (torch layout in both)
  ln_{final,pre,post}.scale        -> ln_{final,pre,post}.weight
  token_embedding (V, W)           -> token_embedding.weight
  conv1.kernel (p, p, 3, W) HWIO   -> conv1.weight (W, 3, p, p)
  ResNet conv kernels HWIO         -> OIHW; <bn>.scale -> <bn>.weight, batch_stats
                                      <bn>.mean / var -> <bn>.running_mean / running_var;
                                      layer<s>_<b> -> layer<s>.<b>, downsample_conv /
                                      downsample_bn -> downsample.0 / downsample.1;
                                      attnpool.<q>_proj_{weight,bias} -> attnpool.<q>_proj.*

``end2end_from_jax`` prefixes the text tower's entries with ``clip_text.``
and the vision tower's with ``clip_vision.``, as ``End2EndClip`` names them.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_GRU_PARAM = re.compile(r"^(w|b)_(ih|hh)_l(\d+)(_rev)?$")
_DENSE = re.compile(r"^(fc1|gate|out|concat_fc|[qkv]_\d+|frame_fc_.+|tied_fc_.+)$")


def _flatten(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def bert_param_name(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """A flax BERT parameter path (``FlaxBertModule``'s tree) -> the
    ``models.bert.BertModel`` state-dict key and value."""
    head, _, leaf = path.rpartition(".")
    if leaf == "kernel":
        return f"{head}.weight", value.T
    if leaf in ("embedding", "scale"):
        return f"{head}.weight", value
    return path, value


def _param_name(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if path.startswith("txt_net.bert."):
        return bert_param_name(path, value)
    head, _, leaf = path.rpartition(".")
    owner = head.rpartition(".")[2]
    if leaf == "kernel" and _DENSE.match(owner):
        return f"{head}.weight", value.T
    if owner in ("bn1", "ln") and leaf == "scale":
        return f"{head}.weight", value
    if owner == "mha" and leaf.startswith("out_proj_"):
        return f"{head}.out_proj.{leaf[len('out_proj_'):]}", value
    if owner == "gru" and leaf == "we":
        return f"{head}.we.weight", value
    m = _GRU_PARAM.match(leaf)
    if owner == "gru" and m:
        kind = "weight" if m.group(1) == "w" else "bias"
        suffix = "_reverse" if m.group(4) else ""
        return f"{head}.rnn.{kind}_{m.group(2)}_l{m.group(3)}{suffix}", value
    return path, value


def from_jax_variables(params: Dict, batch_stats: Optional[Dict] = None,
                       schedule: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """laff_tpu ``params`` / ``batch_stats`` / ``schedule`` collections ->
    a state dict that ``LAFFModel.load_state_dict`` takes strictly."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name: str, value: np.ndarray) -> None:
        sd[name] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))

    for path, value in _flatten(params):
        put(*_param_name(path, value))
        if path.endswith(".bn1.scale"):
            sd[path[: -len("scale")] + "num_batches_tracked"] = torch.tensor(0)
    for path, value in _flatten(batch_stats or {}):
        head, _, leaf = path.rpartition(".")
        put(f"{head}.running_{leaf}", value)
    for path, value in _flatten(schedule or {}):
        put(path, value)
    return sd


# ---------------------------------------------------------------------------
# CLIP towers
# ---------------------------------------------------------------------------

_BLOCK_LEAF = {"attn_in_proj_weight": "attn.in_proj_weight",
               "attn_in_proj_bias": "attn.in_proj_bias",
               "attn_out_proj_weight": "attn.out_proj.weight",
               "attn_out_proj_bias": "attn.out_proj.bias",
               "mlp_c_fc_weight": "mlp.c_fc.weight", "mlp_c_fc_bias": "mlp.c_fc.bias",
               "mlp_c_proj_weight": "mlp.c_proj.weight", "mlp_c_proj_bias": "mlp.c_proj.bias"}


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))  # a writable copy


def _clip_transformer_name(path: str) -> str:
    """A flax CLIP tower path -> its OpenAI state-dict key."""
    head, _, leaf = path.partition(".")
    if head.startswith("block_"):
        block = f"transformer.resblocks.{head[len('block_'):]}."
        if leaf in _BLOCK_LEAF:
            return block + _BLOCK_LEAF[leaf]
        return block + leaf.replace(".scale", ".weight")
    if head == "token_embedding":
        return "token_embedding.weight"
    if head == "conv1":
        return "conv1.weight"
    return path.replace(".scale", ".weight")


def clip_text_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``laff_tpu`` ClipTextTower params -> ``ClipTextTower`` state dict."""
    return {_clip_transformer_name(p): _tensor(v) for p, v in _flatten(params)}


def clip_vision_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``laff_tpu`` ClipVisionTower params -> ``ClipVisionTower`` state dict
    (the patch kernel HWIO -> OIHW)."""
    sd = {}
    for path, value in _flatten(params):
        if path == "conv1.kernel":
            value = value.transpose(3, 2, 0, 1)
        sd[_clip_transformer_name(path)] = _tensor(value)
    return sd


def _resnet_module(path: str) -> str:
    m = re.match(r"^layer(\d)_(\d+)\.(.*)$", path)
    if m:
        rest = m.group(3).replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1")
        return f"layer{m.group(1)}.{m.group(2)}.{rest}"
    return path


def clip_resnet_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``laff_tpu`` ModifiedResNetTower variables ({'params',
    'batch_stats'}) -> ``ModifiedResNetTower`` state dict."""
    sd = {}
    for path, value in _flatten(variables["params"]):
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            sd[_resnet_module(head) + ".weight"] = _tensor(value.transpose(3, 2, 0, 1))
        elif head == "attnpool" and leaf != "positional_embedding":
            name, _, kind = leaf.rpartition("_")
            sd[f"attnpool.{name}.{kind}"] = _tensor(value)
        else:
            sd[_resnet_module(head) + "." + ("weight" if leaf == "scale" else leaf)] = \
                _tensor(value)
    for path, value in _flatten(variables.get("batch_stats", {})):
        head, _, leaf = path.rpartition(".")
        sd[f"{_resnet_module(head)}.running_{leaf}"] = _tensor(value)
    return sd


def end2end_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``laff_tpu`` End2EndClip params -> ``End2EndClip`` state dict."""
    sd = {f"clip_text.{k}": v for k, v in clip_text_from_jax(params["clip_text"]).items()}
    sd.update({f"clip_vision.{k}": v
               for k, v in clip_vision_from_jax(params["clip_vision"]).items()})
    return sd
