"""Initial weights from the seed, made on the card in a few large draws of
one ``torch.Generator``, keyed and shaped as the model's state dict.

Distributions follow the LAFF initialisation: a transform's Linear weight
U(+-sqrt(6 / (in + out))) (xavier); gate kernels, gate biases and the
GRU's tensors U(+-1 / sqrt(fan in)); the GRU's word embedding N(0, 1).
Biases of the Linears draw U(+-0.01) and BatchNorm holds the state a
trained model has rather than its identity at start: scale U(0.5, 1.5),
shift U(-0.1, 0.1), running mean U(-0.1, 0.1), running variance
U(0.5, 1.5), so every term of the eval forward carries weight."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Shape = Tuple[int, ...]


def _uniform_bounds(name: str, shape: Shape, fan_hidden: int) -> Tuple[float, float]:
    if name.endswith(".fc1.weight"):
        b = math.sqrt(6.0 / (shape[0] + shape[1]))
        return -b, b
    if name.endswith(".fc1.bias"):
        return -0.01, 0.01
    if name.endswith((".bn1.weight", ".bn1.running_var")):
        return 0.5, 1.5
    if name.endswith((".bn1.bias", ".bn1.running_mean")):
        return -0.1, 0.1
    if ".gru.rnn." in name:
        b = 1.0 / math.sqrt(fan_hidden)
        return -b, b
    if name.endswith(("gate_kernel", "gate_bias")):
        b = 1.0 / math.sqrt(shape[-1] if name.endswith("gate_kernel") else fan_hidden)
        return -b, b
    if name.endswith((".gate.weight", ".gate.bias")):
        b = 1.0 / math.sqrt(fan_hidden)
        return -b, b
    raise KeyError(f"no initialisation for {name} {shape}")


def make_weights(shapes: Dict[str, Shape], seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """Every entry of ``shapes`` (a state dict's, in its order) from
    ``seed``: one uniform and one normal draw, split and scaled."""
    gen = torch.Generator(device=device).manual_seed(seed)
    names = [k for k in shapes if not k.endswith("num_batches_tracked")]
    normal = [k for k in names if k.endswith("gru.we.weight")]
    uniform = [k for k in names if k not in normal]
    sizes = [math.prod(shapes[k]) for k in uniform]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    n = torch.randn(sum(math.prod(shapes[k]) for k in normal), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    for k, part in zip(uniform, u.split(sizes)):
        if ".gru.rnn." in k:  # fan in: the hidden width the GRU's tensors act on
            fan = shapes[k.split(".gru.rnn.")[0] + ".gru.rnn.weight_hh_l0"][1]
        elif k.endswith("gate_bias"):
            fan = shapes[k[: -len("gate_bias")] + "gate_kernel"][-1]
        elif k.endswith((".gate.weight", ".gate.bias")):
            fan = shapes[k.rsplit(".", 1)[0] + ".weight"][-1]
        else:
            fan = 0
        lo, hi = _uniform_bounds(k, shapes[k], fan)
        out[k] = (part * (hi - lo) + lo).view(shapes[k])
    offset = 0
    for k in normal:
        size = math.prod(shapes[k])
        out[k] = n[offset: offset + size].view(shapes[k])
        offset += size
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
    return {k: out[k] for k in shapes}
