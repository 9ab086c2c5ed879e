"""Carry ``laff_tpu`` variables over to a ``LAFFModel`` state dict.

The port names its modules after the flax tree, so the bridge is a rename
plus these layout changes:

  <...>.fc1.kernel (in, out)       -> <...>.fc1.weight (out, in), transposed
  <...>.frame_fc_<f>.kernel        -> <...>.frame_fc_<f>.weight, transposed
  <...>.frame_attn_<f>.gate.kernel (D, 1)
                                   -> <...>.frame_attn_<f>.gate.weight (1, D)
  <...>.bn1.scale / bias           -> <...>.bn1.weight / bias
  batch_stats <...>.bn1.mean / var -> <...>.bn1.running_mean / running_var
  <...>.gru.we                     -> <...>.gru.we.weight
  <...>.gru.{w,b}_{ih,hh}_l<k>     -> <...>.gru.rnn.{weight,bias}_{ih,hh}_l<k>
                                      (packed r, z, n in both; '_rev' ->
                                      '_reverse')
  schedule <...>.global_emb_weight -> the attention's buffer of that name

``gate_kernel`` (H, dh), ``gate_bias`` (H,), the pre-LN parameters and the
expert embedding keep their names and shapes. Inputs are nested dicts of
numpy arrays (flax variable collections after ``np.asarray``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_GRU_PARAM = re.compile(r"^(w|b)_(ih|hh)_l(\d+)(_rev)?$")


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
    if leaf == "kernel" and (owner in ("fc1", "gate") or owner.startswith("frame_fc_")):
        return f"{head}.weight", value.T
    if owner == "bn1" and leaf == "scale":
        return f"{head}.weight", value
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
