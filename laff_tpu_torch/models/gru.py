"""GRU text encoder: learned word embedding, a (bi)GRU, then mean / last /
mean_last pooling over the valid timesteps.

``torch.nn.GRU`` packs its gates in (r, z, n) order, the layout
``laff_tpu.models.gru`` keeps, so its weights carry over by a rename. A
unidirectional GRU runs over the right-padded batch as it is: outputs at
valid steps never see the padding after them. A bidirectional one packs the
batch, so the reverse direction starts at each caption's last token.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

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
        if self.spec.bidirectional:
            packed = pack_padded_sequence(
                x, lengths.detach().cpu().clamp(min=1).long(), batch_first=True,
                enforce_sorted=False)
            outs, _ = pad_packed_sequence(self.rnn(packed)[0], batch_first=True,
                                          total_length=t)
        else:
            outs = self.rnn(x)[0]
        lengths = lengths.to(outs.device).long()
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
