"""Projection heads: the TransformNet family.

Linear (xavier-uniform, zero bias) -> activation (tanh default) -> dropout
-> BatchNorm1d. ``fc=False`` / ``activation=None`` give the BN-only
passthrough used for pre-aligned CLIP features. BatchNorm has eps 1e-5 and
torch momentum 0.1 (flax momentum 0.9); in eval it uses the running stats.

In training (``module.training``) BatchNorm normalizes with the batch
statistics and updates its running statistics as flax does: with the
*biased* batch variance (``nn.BatchNorm1d`` would blend in the unbiased
one), reduced in f32. Dropout draws its mask from the ``generator`` the
caller passes (the trainer's, one per epoch), so a run repeats exactly.

With a ``compute_dtype`` (bf16 for the headline) the input, the linear map
and the activation run in that type, BatchNorm normalizes in f32 and rounds
back, and the output is cast to f32, as ``laff_tpu.models.layers`` does.

``shared_fc`` replaces ``fc1`` by a linear owned elsewhere (cross-tower
weight tying, ``txt_fc_same_with_vis_fc``): the map is shared, dropout and
BatchNorm stay per tower. The module only refers to it; its owner
(``LAFFModel``) registers, initializes and moves it, so it is one set of
parameters in the state dict and the optimizer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import xavier_uniform_

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}


class TransformNet(nn.Module):
    def __init__(
        self,
        dim_in: int,
        dim_out: int,
        fc: bool = True,
        activation: Optional[str] = "tanh",
        dropout: float = 0.2,
        batch_norm: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        shared_fc: Optional[nn.Linear] = None,
    ) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim_in, dim_out) if fc and shared_fc is None else None
        # a plain attribute, not a submodule: the owner holds the parameters
        object.__setattr__(self, "shared_fc", shared_fc if fc else None)
        self.activation = activation if activation in _ACTIVATIONS else None
        self.dropout = dropout if dropout and dropout > 1e-3 else 0.0
        self.bn1 = (nn.BatchNorm1d(dim_out, eps=1e-5, momentum=0.1)
                    if batch_norm else None)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.fc1 is not None:
            xavier_uniform_(self.fc1.weight, generator)
            nn.init.zeros_(self.fc1.bias)
        if self.bn1 is not None:
            self.bn1.reset_parameters()

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn1
        if not self.training:
            return bn(x)
        out = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=0, correction=0)
            keep = 1.0 - bn.momentum
            bn.running_mean.mul_(keep).add_(mean * bn.momentum)
            bn.running_var.mul_(keep).add_(var * bn.momentum)
        return out

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype is not None:
            x = x.to(dtype)
        fc = self.fc1 if self.fc1 is not None else self.shared_fc
        if fc is not None:
            x = F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))
        if self.activation is not None:
            x = _ACTIVATIONS[self.activation](x)
        if self.dropout and self.training:
            keep = 1.0 - self.dropout
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, x.new_zeros(()))
        if self.bn1 is not None:
            x = self._batch_norm(x.float()).to(x.dtype)
        return x.float() if dtype is not None else x
