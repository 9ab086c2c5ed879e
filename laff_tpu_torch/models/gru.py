"""GRU text encoder: learned word embedding, a (bi)GRU, then mean / last /
mean_last pooling over the valid timesteps.

``torch.nn.GRU`` packs its gates in (r, z, n) order, the layout
``laff_tpu.models.gru`` keeps, so its weights carry over by a rename. A
unidirectional GRU runs over the right-padded batch as it is: outputs at
valid steps never see the padding after them. A bidirectional one runs each
layer's two directions apart: the forward one over the batch as it is, the
reverse one over each caption's valid prefix reversed by a per-row gather
(padding stays behind it), its outputs gathered back. All of it stays on
the card: no host sync and no data-dependent shape, so a CUDA graph can
hold it. Outputs at padding steps differ from ``laff_tpu``'s (which holds
the state there) and are masked out of every pooling.
"""

from __future__ import annotations

import torch
from torch import nn

from .initializers import normal_, torch_linear_init_
from .spec import GruSpec


class GruEncoder(nn.Module):
    def __init__(self, spec: GruSpec) -> None:
        super().__init__()
        self.spec = spec
        self.we = nn.Embedding(spec.vocab_size, spec.we_dim)
        self.rnn = nn.GRU(spec.we_dim, spec.rnn_size, num_layers=spec.rnn_layer,
                          batch_first=True, bidirectional=spec.bidirectional)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.we.weight, generator)
        for p in self.rnn.parameters():
            torch_linear_init_(p, self.spec.rnn_size, generator)

    def forward(self, token_ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """token_ids (B, T) right-padded, lengths (B,) -> (B, rnn_size) for
        mean/last (x2 if bidirectional), (B, 2 * rnn_size) for mean_last."""
        x = self.we(token_ids.long())
        t = x.shape[1]
        lengths = lengths.to(x.device).long()
        outs = self._bidirectional(x, lengths) if self.spec.bidirectional else self.rnn(x)[0]
        mask = (torch.arange(t, device=outs.device)[None, :] < lengths[:, None]).to(outs.dtype)

        def mean_pool():
            total = torch.sum(outs * mask[:, :, None], dim=1)
            return total / torch.clamp(lengths[:, None].to(outs.dtype), min=1.0)

        def last_pool():
            idx = torch.clamp(lengths - 1, min=0)
            return outs[torch.arange(outs.shape[0], device=outs.device), idx]

        pooling = self.spec.pooling
        if pooling == "mean":
            return mean_pool()
        if pooling == "last":
            return last_pool()
        if pooling == "mean_last":
            return torch.cat([mean_pool(), last_pool()], dim=-1)
        raise ValueError(f"pooling {pooling}")

    def _direction(self, x: torch.Tensor, layer: int, suffix: str) -> torch.Tensor:
        """One direction of one layer over x (B, T, D), left to right, with
        that direction's weights of ``self.rnn``."""
        weights = [getattr(self.rnn, f"{kind}_l{layer}{suffix}")
                   for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h0 = x.new_zeros((1, x.shape[0], self.spec.rnn_size))
        return torch._VF.gru(x, h0, weights, True, 1, 0.0, self.training, False, True)[0]

    def _bidirectional(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        steps = torch.arange(t, device=x.device)[None, :]
        n = lengths.clamp(min=1)[:, None]
        # position s of the reversed row reads step n-1-s; padding stays put
        # (the map is its own inverse, so the same gather brings outputs back)
        rev = torch.where(steps < n, n - 1 - steps, steps)
        outs = x
        for layer in range(self.spec.rnn_layer):
            fwd = self._direction(outs, layer, "")
            idx = rev[:, :, None].expand(-1, -1, outs.shape[-1])
            bwd = self._direction(torch.gather(outs, 1, idx), layer, "_reverse")
            bwd = torch.gather(bwd, 1, rev[:, :, None].expand(-1, -1, bwd.shape[-1]))
            outs = torch.cat([fwd, bwd], dim=-1)
        return outs
