"""The fusion-attention zoo of ``laff_tpu.models.attention`` and the
registry keys that build it (reference ``model/model.py:70-208``).

The LAFF gates: ``MultiHeadGateAttention`` (kinds 12-15) and the
single-head ``GateAttention`` (kinds 0, 1, 7, 9), which FrameLAFF pools
frames with.

(B, L, D) -> (B, H, d): split D into H heads (or repeat when
``split_head=False``), gate each head independently over L, weighted-sum,
optional mean residual, per-head l2norm. ``with_ave``/``mul`` may differ
per head (fusion mix); ``ave_style`` 'one' adds g * L * mean to the gated
sum, 'one_minus_g' blends (1 - g) * attn + g * L * mean; ``distinct_fc``
gives each L position its own gate; ``pre_layer_norm`` normalizes each head
first. The residual weight g is the ``global_emb_weight`` buffer (set per
epoch by the trainer, 1 at init).

The eval forward runs the fused CUDA kernel
(``laff_tpu_torch.ops.fused_gate_attention``) when the input is on the
card, grad is off and the options lie in the kernel's subset (split heads,
no mask, no pre-LN, no per-head l2norm, no distinct fc, no fusion mix,
ave_style 'one'), whatever the input's float type: the kernel computes and
returns f32. Every other case runs the plain tensor code below.

``GateAttention`` (B, L, D) -> (B, D) has no kernel in either package: a
softmax gate over L with an optional (B, L) validity mask, optional gating
on ``local * mean`` (mul) and mean residual (with_ave). Like flax's Dense,
whose parameters promote bf16 inputs, it takes the mean (and the mul) in
the input's type and the gate, the weighted sum and the residual in f32.

The rest of the zoo has no kernel in either package and runs as plain
tensor code: ``LinearCombine`` (kinds 2, 3), ``JustAverage`` (4),
``QKVAttention`` (5), ``SimpleSelfAttention`` (6), ``OfficialMHA`` (10),
``MultiHeadSelfAttention`` (11) and ``MMTAttention`` (16), and
``NetVLAD``, the pooling of the 'netvlad' text feature. Parameters carry
the flax tree's names, with torch's layouts where torch has one: a Dense
is an ``nn.Linear`` (weight (out, in)), a LayerNorm an ``nn.LayerNorm``
(eps 1e-6, flax's), and the packed projections of the self-attention
kinds are ``nn.MultiheadAttention``'s ``in_proj_weight`` / ``in_proj_bias``
/ ``out_proj``. Every module takes the ``generator`` its dropout draws
from (the trainer's, so a CUDA graph of the step replays the draws).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import fused_gate_attention
from ..ops.norms import l2norm
from .initializers import normal_, torch_linear_init_, xavier_uniform_
from .spec import AttentionSpec

_NEG_INF = -1e30


class MultiHeadGateAttention(nn.Module):
    # set by ``models.laff.get_attention_weights``: the forward takes the
    # plain path and keeps its (B, L, H) softmax weights in ``weights``
    record_weights = False

    def __init__(
        self,
        dim: int,
        heads: int,
        with_ave: bool = True,
        mul: bool = False,
        split_head: bool = True,
        l2norm_each_head: bool = False,
        pre_layer_norm: bool = False,
        ave_style: str = "one",
        distinct_fc: bool = False,
        max_positions: int = 40,
        fusion_mix: bool = False,
    ) -> None:
        super().__init__()
        if split_head and dim % heads:
            raise ValueError(f"common_dim {dim} not divisible by heads {heads} (split_head)")
        self.heads = heads
        self.dh = dim // heads if split_head else dim
        self.with_ave = with_ave
        self.mul = mul
        self.split_head = split_head
        self.l2norm_each_head = l2norm_each_head
        self.pre_layer_norm = pre_layer_norm
        self.ave_style = ave_style
        self.distinct_fc = distinct_fc
        self.fusion_mix = fusion_mix
        h, dh = heads, self.dh
        if pre_layer_norm:
            self.pre_ln_scale = nn.Parameter(torch.ones(h, dh))
            self.pre_ln_bias = nn.Parameter(torch.zeros(h, dh))
        if distinct_fc:
            self.gate_kernel = nn.Parameter(torch.empty(h, max_positions, dh))
            self.gate_bias = nn.Parameter(torch.empty(h, max_positions))
        else:
            self.gate_kernel = nn.Parameter(torch.empty(h, dh))
            self.gate_bias = nn.Parameter(torch.empty(h))
        if with_ave or fusion_mix:
            self.register_buffer("global_emb_weight", torch.ones(()))
        else:
            self.global_emb_weight = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_linear_init_(self.gate_kernel, self.dh, generator)
        torch_linear_init_(self.gate_bias, self.dh, generator)
        if self.pre_layer_norm:
            nn.init.ones_(self.pre_ln_scale)
            nn.init.zeros_(self.pre_ln_bias)
        if self.global_emb_weight is not None:
            self.global_emb_weight.fill_(1.0)

    def _kernel_applies(self, x, raw_global_emb, mask) -> bool:
        return (x.is_cuda and not torch.is_grad_enabled() and not self.record_weights
                and self.split_head and raw_global_emb is None and mask is None
                and not (self.l2norm_each_head or self.pre_layer_norm
                         or self.distinct_fc or self.fusion_mix)
                and self.ave_style == "one")

    def forward(
        self,
        local_embs: torch.Tensor,  # (B, L, D)
        raw_global_emb: Optional[torch.Tensor] = None,  # (B, H, dh)
        mask: Optional[torch.Tensor] = None,  # (B, L) 1 = valid
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        b, length, dim = local_embs.shape
        h, dh = self.heads, self.dh
        if self.split_head:
            x = local_embs.reshape(b, length, h, dh)
        else:
            x = local_embs[:, :, None, :].expand(b, length, h, dh)

        if self._kernel_applies(x, raw_global_emb, mask):
            # the kernel computes in f32 whatever the input type, as the TPU
            # kernel did (it cast its tile to f32)
            g = self.global_emb_weight if self.with_ave else 1.0
            return fused_gate_attention(
                x.float().contiguous(), self.gate_kernel.detach().float().contiguous(),
                self.gate_bias.detach().float().contiguous(),
                g, with_ave=self.with_ave, mul=self.mul)

        if self.l2norm_each_head:
            x = l2norm(x, dim=-1)
        if self.pre_layer_norm:
            mean = x.mean(dim=-1, keepdim=True)
            var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-5)
            x = x * self.pre_ln_scale[None, None] + self.pre_ln_bias[None, None]

        if self.fusion_mix:
            cyc = torch.arange(h, device=x.device) % 4
            with_ave_vec = (cyc < 2).to(x.dtype)  # heads 0,1: with_ave
            mul_vec = (cyc % 2 == 0).to(x.dtype)  # heads 0,2: mul
        else:
            with_ave_vec = torch.full((h,), float(self.with_ave), dtype=x.dtype, device=x.device)
            mul_vec = torch.full((h,), float(self.mul), dtype=x.dtype, device=x.device)

        if mask is None:
            raw_global = x.mean(dim=1)  # (B, H, dh)
        else:
            m = mask.to(x.dtype)[:, :, None, None]
            raw_global = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
        if raw_global_emb is not None:
            raw_global = raw_global_emb

        # gate input: per-head blend of x and x * mean (mul as a constant mask)
        common = (x * (1.0 - mul_vec)[None, None, :, None]
                  + (x * raw_global[:, None]) * mul_vec[None, None, :, None])
        if self.distinct_fc:
            logits = (torch.einsum("blhd,hld->blh", common, self.gate_kernel[:, :length])
                      + self.gate_bias[:, :length].T[None])
        else:
            logits = torch.einsum("blhd,hd->blh", common, self.gate_kernel) + self.gate_bias
        if mask is not None:
            logits = torch.where(mask[:, :, None] > 0, logits,
                                 torch.full_like(logits, _NEG_INF))
        weights = torch.softmax(logits, dim=1)  # (B, L, H)
        if self.record_weights:
            self.weights = weights.detach()
        out = torch.einsum("blh,blhd->bhd", weights, x)

        if self.with_ave or self.fusion_mix:
            g = self.global_emb_weight
            attn_w = 1.0 - g if self.ave_style == "one_minus_g" else 1.0
            # the reference adds g * mean per position before summing over L:
            # residual = g * L * mean
            if mask is None:
                count = float(length)
            else:
                count = torch.clamp(torch.sum(mask.to(out.dtype), dim=1), min=1.0)[:, None, None]
            residual = with_ave_vec[None, :, None] * g * raw_global * count
            out = torch.where(with_ave_vec[None, :, None] > 0, attn_w * out + residual, out)
        return l2norm(out, dim=-1, eps=0.0)


class GateAttention(nn.Module):
    """Attention_1 (reference ``Attention.py:40-105``): one gate ``Linear(D,
    1)`` over the L axis. Masked positions get logit -1e30; the mean and
    the residual count only valid positions, the count clamped at 1."""

    record_weights = False  # as MultiHeadGateAttention's: (B, L) weights

    def __init__(self, dim: int, with_ave: bool = True, mul: bool = False) -> None:
        super().__init__()
        self.dim = dim
        self.with_ave = with_ave
        self.mul = mul
        self.gate = nn.Linear(dim, 1)
        if with_ave:
            self.register_buffer("global_emb_weight", torch.ones(()))
        else:
            self.global_emb_weight = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_linear_init_(self.gate.weight, self.dim, generator)
        torch_linear_init_(self.gate.bias, self.dim, generator)
        if self.global_emb_weight is not None:
            self.global_emb_weight.fill_(1.0)

    def forward(
        self,
        local_embs: torch.Tensor,  # (B, L, D)
        raw_global_emb: Optional[torch.Tensor] = None,  # (B, D)
        mask: Optional[torch.Tensor] = None,  # (B, L) 1 = valid
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = local_embs
        if raw_global_emb is None:
            if mask is None:
                raw_global_emb = x.mean(dim=1)
            else:
                m = mask.to(x.dtype)
                raw_global_emb = (torch.sum(x * m[:, :, None], dim=1)
                                  / torch.clamp(torch.sum(m, dim=1), min=1.0)[:, None])
        common = x * raw_global_emb[:, None, :] if self.mul else x
        logits = F.linear(common.float(), self.gate.weight, self.gate.bias)[..., 0]  # (B, L)
        if mask is not None:
            logits = torch.where(mask > 0, logits, torch.full_like(logits, _NEG_INF))
        weights = torch.softmax(logits, dim=1)
        if self.record_weights:
            self.weights = weights.detach()
        out = torch.sum(weights[..., None] * x.float(), dim=1)
        if self.with_ave:
            # the reference adds g * mean at every position before the sum
            # over L (Attention.py:99-101): residual = g * count * mean
            if mask is None:
                count = float(x.shape[1])
            else:
                count = torch.clamp(torch.sum(mask.float(), dim=1), min=1.0)[:, None]
            out = out + self.global_emb_weight * raw_global_emb.float() * count
        return l2norm(out, dim=-1, eps=0.0)


def _dropout(x: torch.Tensor, rate: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator``."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


def _reset_dense(linear: nn.Linear, generator: torch.Generator) -> None:
    """flax Dense's init: xavier-uniform kernel, zero bias."""
    xavier_uniform_(linear.weight, generator)
    nn.init.zeros_(linear.bias)


def _max_token(x: torch.Tensor) -> torch.Tensor:
    """(B, L, D) -> (B, 1, D): the max over L with the gradient sent to the
    first maximum (``laff_tpu``'s gather-by-argmax)."""
    return torch.gather(x, 1, x.argmax(dim=1, keepdim=True))


class LinearCombine(nn.Module):
    """fc_attention / con_attention (kinds 3 / 2): a learned combination
    over L, out[b, d] = sum_l w_l x[b, l, d] + bias. ``kernel`` (L, 1) is
    sized by the number of locals, which flax reads at its first call."""

    def __init__(self, length: Optional[int]) -> None:
        super().__init__()
        if not length:
            raise ValueError("LinearCombine needs the number of locals it combines")
        self.kernel = nn.Parameter(torch.empty(length, 1))
        self.bias = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = math.sqrt(6.0 / (self.kernel.shape[0] + 1))
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, local_embs, raw_global_emb=None, mask=None, generator=None):
        return torch.einsum("bld,l->bd", local_embs, self.kernel[:, 0]) + self.bias


class JustAverage(nn.Module):
    """just_average (kind 4): the mean over L, over the valid positions
    under a mask (the count clamped at 1)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def forward(self, local_embs, raw_global_emb=None, mask=None, generator=None):
        if mask is None:
            return local_embs.mean(dim=1)
        m = mask.to(local_embs.dtype)
        total = torch.sum(local_embs * m[:, :, None], dim=1)
        return total / torch.clamp(torch.sum(m, dim=1), min=1.0)[:, None]


class QKVAttention(nn.Module):
    """Attention_2 (kind 5): per head tanh Q, K, V projections (each with
    its own dropout mask), the scaled dot product softmaxed over the query
    axis (the reference's quirk, kept), heads concatenated, ``out`` back to
    D, the sum over L plus the mean, l2norm (eps 1e-15)."""

    def __init__(self, dim: int, heads: int = 1, embed_dim_qkv: int = 512,
                 dropout: float = 0.1) -> None:
        super().__init__()
        self.heads, self.embed_dim_qkv, self.dropout = heads, embed_dim_qkv, dropout
        for i in range(heads):
            for name in ("q", "k", "v"):
                self.add_module(f"{name}_{i}", nn.Linear(dim, embed_dim_qkv))
        self.out = nn.Linear(heads * embed_dim_qkv, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.heads):
            for name in ("q", "k", "v"):
                _reset_dense(getattr(self, f"{name}_{i}"), generator)
        _reset_dense(self.out, generator)

    def forward(self, local_embs, raw_global_emb=None, mask=None, generator=None):
        if raw_global_emb is None:
            raw_global_emb = local_embs.mean(dim=1)
        outs = []
        for i in range(self.heads):
            q, k, v = (_dropout(torch.tanh(getattr(self, f"{n}_{i}")(local_embs)),
                                self.dropout, self.training, generator) for n in ("q", "k", "v"))
            w = torch.einsum("bld,bmd->blm", q, k) / (self.embed_dim_qkv ** 0.5)
            w = torch.softmax(w, dim=1)
            outs.append(torch.einsum("blm,bmd->bld", w, v))
        out = self.out(torch.cat(outs, dim=-1))
        return l2norm(out.sum(dim=1) + raw_global_emb, eps=1e-15)


class SimpleSelfAttention(nn.Module):
    """Attention_3 (kind 6): projection-free one-head self-attention
    (softmax over the query axis), ``out`` (D -> D), the sum over L plus
    the mean, l2norm (eps 1e-15)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.out = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_dense(self.out, generator)

    def forward(self, local_embs, raw_global_emb=None, mask=None, generator=None):
        if raw_global_emb is None:
            raw_global_emb = local_embs.mean(dim=1)
        d = local_embs.shape[-1]
        w = torch.softmax(torch.einsum("bld,bmd->blm", local_embs, local_embs) / (d ** 0.5),
                          dim=1)
        ctx = torch.einsum("blm,bmd->bld", w, local_embs)
        return l2norm(self.out(ctx).sum(dim=1) + raw_global_emb, eps=1e-15)


class TorchStyleMHA(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s parameters
    (packed ``in_proj_weight`` (3D, D) and ``in_proj_bias``, ``out_proj``),
    so reference weights carry over by name; no dropout."""

    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by {heads} heads")
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.in_proj_weight, generator)
        nn.init.zeros_(self.in_proj_bias)
        _reset_dense(self.out_proj, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, d = x.shape
        h, dh = self.heads, d // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(d, dim=-1)

        def heads(t):
            return t.reshape(b, length, h, dh).transpose(1, 2)

        w = torch.softmax(torch.einsum("bhld,bhmd->bhlm", heads(q) * dh ** -0.5, heads(k)),
                          dim=-1)
        ctx = torch.einsum("bhlm,bhmd->bhld", w, heads(v)).transpose(1, 2).reshape(b, length, d)
        return self.out_proj(ctx)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)  # flax's epsilon


class OfficialMHA(nn.Module):
    """muti_head_attention_official (kind 10): self-attention, residual,
    LayerNorm, then the mean (or max) over L."""

    def __init__(self, dim: int, heads: int = 8, agg: str = "mean") -> None:
        super().__init__()
        self.agg = agg
        self.mha = TorchStyleMHA(dim, heads)
        self.ln = _layer_norm(dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mha.reset_parameters(generator)
        self.ln.reset_parameters()

    def forward(self, local_embs, raw_global_emb=None, mask=None, generator=None):
        out = self.ln(local_embs + self.mha(local_embs))
        return out.amax(dim=1) if self.agg == "max" else out.mean(dim=1)


class MMTAttention(nn.Module):
    """Attention_MMT (kind 16): the max-pooled token prepended, self-attention,
    residual and LayerNorm; the aggregate token out."""

    def __init__(self, dim: int, heads: int = 8) -> None:
        super().__init__()
        self.mha = TorchStyleMHA(dim, heads)
        self.ln = _layer_norm(dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mha.reset_parameters(generator)
        self.ln.reset_parameters()

    def forward(self, local_embs, raw_global_emb=None, mask=None, generator=None):
        x = torch.cat([_max_token(local_embs), local_embs], dim=1)
        return self.ln(x + self.mha(x))[:, 0, :]


_FIRST_TOKEN = ("first", "cls_embedding", "concat", "max_embedding", "mean_embedding")


class MultiHeadSelfAttention(nn.Module):
    """my_self_attention (kind 11): projection-free per-head scaled
    dot-product self-attention (the reference's scale (dh // H) ** -0.5),
    dropout on the weights, a per-head LayerNorm over the residual, then
    ``output_type``'s aggregation over the tokens -> (B, H, dh). 'random'
    picks one token from ``generator`` in training and takes the mean in
    eval; 'Attention_1' fuses the tokens with the LAFF gate (``head_attn``)."""

    def __init__(self, dim: int, heads: int, n_locals: int, dropout: float = 0.0,
                 output_type: str = "mean", l2norm_each_head: bool = False,
                 head_with_ave: bool = True, head_mul: bool = False) -> None:
        super().__init__()
        if dim % heads:
            raise ValueError(f"common_dim {dim} not divisible by heads {heads}")
        self.heads, self.dropout, self.output_type = heads, dropout, output_type
        self.l2norm_each_head = l2norm_each_head
        self.dh = dim // heads
        if output_type == "cls_embedding":
            self.cls_embedding = nn.Parameter(torch.empty(1, dim))
        elif output_type == "concat":
            if not n_locals:
                raise ValueError("output_type 'concat' needs the number of locals")
            self.concat_fc = nn.Linear(n_locals * dim, dim)
        elif output_type == "Attention_1":
            self.head_attn = MultiHeadGateAttention(dim, heads, with_ave=head_with_ave,
                                                    mul=head_mul, split_head=True)
        elif output_type not in ("mean", "max", "last", "second", "third", "random",
                                 "max_embedding", "mean_embedding", "first"):
            raise ValueError(f"output_type {output_type}")
        self.ln = _layer_norm(self.dh)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.output_type == "cls_embedding":
            normal_(self.cls_embedding, generator)
        elif self.output_type == "concat":
            _reset_dense(self.concat_fc, generator)
        elif self.output_type == "Attention_1":
            self.head_attn.reset_parameters(generator)
        self.ln.reset_parameters()

    def forward(self, local_embs, raw_global_emb=None, mask=None, generator=None):
        b, length, d = local_embs.shape
        h, dh, ot = self.heads, self.dh, self.output_type
        x = local_embs
        if ot == "cls_embedding":
            cls = l2norm(self.cls_embedding, dim=-1)
            x = torch.cat([cls[None].expand(b, 1, d), x], dim=1)
        elif ot == "concat":
            x = torch.cat([self.concat_fc(x.reshape(b, -1))[:, None, :], x], dim=1)
        elif ot == "max_embedding":
            x = torch.cat([_max_token(x), x], dim=1)
        elif ot == "mean_embedding":
            x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)

        length2 = x.shape[1]
        xh = x.reshape(b, length2, h, dh).transpose(1, 2)  # (B, H, L', dh)
        if self.l2norm_each_head:
            xh = l2norm(xh, dim=-1)
        scale = (dh // h) ** -0.5 if dh >= h else 1.0
        w = torch.softmax(torch.einsum("bhld,bhmd->bhlm", xh, xh) * scale, dim=-1)
        w = _dropout(w, self.dropout, self.training, generator)
        out = self.ln(torch.einsum("bhlm,bhmd->bhld", w, xh) + xh)  # (B, H, L', dh)

        if ot == "mean" or (ot == "random" and not self.training):
            return out.mean(dim=2)
        if ot in _FIRST_TOKEN:
            return out[:, :, 0, :]
        if ot == "max":
            return out.amax(dim=2)
        if ot == "last":
            return out[:, :, -1, :]
        if ot == "second":
            return out[:, :, min(1, length2 - 1), :]
        if ot == "third":
            return out[:, :, min(2, length2 - 1), :]
        if ot == "random":  # drawn on the device: no host sync
            idx = torch.randint(0, length, (1,), generator=generator, device=out.device)
            return out.index_select(2, idx)[:, :, 0, :]
        flat = out.transpose(1, 2).reshape(b, length2, h * dh)
        return self.head_attn(flat)


class NetVLAD(nn.Module):
    """NetVLAD pooling of per-token vectors (reference ``Attention.py:862-913``),
    batched under a token mask: (B, M, D), (B, M) -> (B, K * D). Tokens are
    l2-normalized (norm clamped at 1e-12), softly assigned to K clusters,
    their residuals to the centroids summed per cluster (as
    sum_m a_mk x_m - (sum_m a_mk) c_k), each cluster's sum normalized, then
    the whole vector."""

    def __init__(self, dim: int, num_clusters: int = 32) -> None:
        super().__init__()
        self.dim, self.num_clusters = dim, num_clusters
        self.assign = nn.Parameter(torch.empty(num_clusters, dim))
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.assign, generator, std=1.0 / math.sqrt(self.dim))
        normal_(self.centroids, generator, std=1.0 / math.sqrt(self.dim))

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = tokens.shape[0]
        x = tokens.float()
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        soft = torch.softmax(x @ self.assign.T, dim=-1)  # (B, M, K)
        if mask is not None:
            soft = soft * mask.to(soft.dtype)[:, :, None]
        vlad = torch.einsum("bmk,bmd->bkd", soft, x) - soft.sum(dim=1)[:, :, None] * self.centroids
        vlad = vlad / torch.clamp(torch.linalg.vector_norm(vlad, dim=-1, keepdim=True), min=1e-12)
        vlad = vlad.reshape(b, -1)
        return vlad / torch.clamp(torch.linalg.vector_norm(vlad, dim=-1, keepdim=True), min=1e-12)


# ---------------------------------------------------------------------------
# registry (keys of ``laff_tpu.models.attention.ATTENTION_TYPES``)
# ---------------------------------------------------------------------------

# registry key -> (with_ave, mul) of the single-head gate
_SINGLE_HEAD_KINDS = {
    "attention_noAverageMul_Ave": (True, False),  # 0
    "average_AverageMul_noAve": (False, True),  # 1
    "attention_noAveNoAverageMul": (False, False),  # 7
    "attention_averageMul": (True, True),  # 9
}

_MULTI_HEAD_KINDS = {
    "Multi_head_MyApply_Attention": {},  # 12
    "Multi_head_MyApply_FusionAttention": {"fusion_mix": True},  # 13
    "Multi_head_Attention_layer_norm": {"pre_layer_norm": True, "ave_style": "one_minus_g"},
    "Multi_head_Attention_distinct_fc": {"distinct_fc": True},  # 15
}


def get_attention_layer(kind: str, dim: int, spec: AttentionSpec,
                        n_locals: Optional[int] = None) -> nn.Module:
    """Build a fusion-attention module by registry key (``laff_tpu``'s
    ``get_attention_layer``). ``n_locals`` is the number of locals fused
    (L), which sizes LinearCombine's kernel and my_self_attention's
    'concat' fc. 'concat' (kind 8) is a tower of its own
    (``FusionTower``), not an attention."""
    if kind in _SINGLE_HEAD_KINDS:
        with_ave, mul = _SINGLE_HEAD_KINDS[kind]
        return GateAttention(dim, with_ave=with_ave, mul=mul)
    if kind in _MULTI_HEAD_KINDS:
        extra = _MULTI_HEAD_KINDS[kind]
        if extra.get("fusion_mix"):
            return MultiHeadGateAttention(dim, spec.heads, split_head=spec.split_head,
                                          fusion_mix=True)
        return MultiHeadGateAttention(
            dim, spec.heads, with_ave=spec.with_ave, mul=spec.mul,
            split_head=spec.split_head,
            l2norm_each_head=spec.l2norm_each_head and not extra, **extra)
    if kind in ("con_attention", "fc_attention"):
        return LinearCombine(n_locals)
    if kind == "just_average":
        return JustAverage()
    if kind == "muti_head_attention":
        return QKVAttention(dim, heads=spec.heads, embed_dim_qkv=spec.embed_dim_qkv,
                            dropout=spec.dropout)
    if kind == "attention3":
        return SimpleSelfAttention(dim)
    if kind == "muti_head_attention_official":
        return OfficialMHA(dim, heads=8, agg=spec.agg)
    if kind == "Attention_MMT":
        return MMTAttention(dim, heads=8)
    if kind == "my_self_attention":
        return MultiHeadSelfAttention(
            dim, spec.heads, n_locals or 0, dropout=spec.dropout,
            output_type=spec.output_type, l2norm_each_head=spec.l2norm_each_head,
            head_with_ave=spec.with_ave, head_mul=spec.mul)
    raise KeyError(f"unknown attention type: {kind}")
