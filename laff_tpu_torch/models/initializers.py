"""Seeded initializers with the JAX package's distributions.

TransformNet linears are xavier-uniform with zero bias; attention gates and
the GRU keep the torch defaults, every tensor ~ U(-1/sqrt(fan_in),
1/sqrt(fan_in)) with an explicit fan_in (several gate tensors are
(heads, d)-shaped, where shape-derived fans guess wrong); the GRU word
embedding is N(0, 1). Every draw takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_linear_init_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(max(int(fan_in), 1))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """For a Linear weight (out, in): U(+-sqrt(6 / (in + out)))."""
    fan_out, fan_in = t.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, generator: torch.Generator, std: float = 1.0) -> torch.Tensor:
    return t.normal_(0.0, std, generator=generator)
