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

``gate_kernel`` (H, dh), ``gate_bias`` (H,), the pre-LN parameters, the
expert embedding, LinearCombine's ``kernel`` (L, 1) and ``bias``, the MHA's
packed ``in_proj_weight`` / ``in_proj_bias``, ``cls_embedding`` and the
NetVLAD ``assign`` / ``centroids`` keep their names and shapes. task2's
``task2_vis_head`` / ``task2_txt_head`` are TransformNets (fc1, bn1) and
carry over by the same rules, BatchNorm statistics included. Inputs are
nested dicts of numpy arrays (flax variable collections after
``np.asarray``).
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


def _param_name(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
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
