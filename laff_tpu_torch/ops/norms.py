"""Vector norms with reference-exact epsilon placement.

The epsilons are added to the *norm* (denominator), not under the sqrt:
``X / (sqrt(sum(X^2)) + eps + 1e-14)``. Matching this exactly matters for
checkpoint-parity evaluation, where tiny normalization drift shifts ranks
on near-tied scores.
"""

from __future__ import annotations

import torch


def l2norm(x: torch.Tensor, eps: float = 1e-13, dim: int = -1) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps + 1e-14
    return x / norm


def l1norm(x: torch.Tensor, eps: float = 1e-13, dim: int = -1) -> torch.Tensor:
    norm = torch.sum(torch.abs(x), dim=dim, keepdim=True) + eps + 1e-14
    return x / norm
