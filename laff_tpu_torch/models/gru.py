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
the state there) and are masked out of every pooling. On the card each
direction's four weight tensors share one cuDNN weight buffer of their own
(``_PerDirectionGRU``), so the one-direction cuDNN calls read them in
place; with ``nn.GRU``'s one buffer for the whole module cuDNN copies the
reverse direction's weights into a new buffer at every call.
"""

from __future__ import annotations

import torch
from torch import nn

from .initializers import normal_, torch_linear_init_
from .spec import GruSpec

_GATE_TENSORS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


class _PerDirectionGRU(nn.GRU):
    """``nn.GRU`` whose bidirectional weights are laid out, whenever the
    module moves to the card (``flatten_parameters``), as one cuDNN buffer
    per layer and direction: the buffer a one-layer, one-direction cuDNN
    call takes in place. Parameter names and values are ``nn.GRU``'s."""

    def flatten_parameters(self) -> None:
        if not self.bidirectional:
            return super().flatten_parameters()
        weights = self._flat_weights
        if (len(weights) != len(self._flat_weights_names)
                or not torch._use_cudnn_rnn_flatten_weight()
                or not all(isinstance(w, torch.Tensor) and w.is_cuda
                           and torch.backends.cudnn.is_acceptable(w) for w in weights)):
            return
        from torch.backends.cudnn import rnn

        with torch.cuda.device_of(weights[0]), torch.no_grad():
            for layer in range(self.num_layers):
                for suffix in ("", "_reverse"):
                    group = [getattr(self, f"{k}_l{layer}{suffix}") for k in _GATE_TENSORS]
                    torch._cudnn_rnn_flatten_weight(
                        group, len(group), group[0].shape[1], rnn.get_cudnn_mode(self.mode),
                        self.hidden_size, 0, 1, self.batch_first, False)


class GruEncoder(nn.Module):
    def __init__(self, spec: GruSpec) -> None:
        super().__init__()
        self.spec = spec
        self.we = nn.Embedding(spec.vocab_size, spec.we_dim)
        self.rnn = _PerDirectionGRU(spec.we_dim, spec.rnn_size, num_layers=spec.rnn_layer,
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
        weights = [getattr(self.rnn, f"{kind}_l{layer}{suffix}") for kind in _GATE_TENSORS]
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
