"""The LAFF gates of ``laff_tpu.models.attention`` and the registry keys
that build them: ``MultiHeadGateAttention`` (kinds 12-15) and the
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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import fused_gate_attention
from ..ops.norms import l2norm
from .initializers import torch_linear_init_
from .spec import AttentionSpec

_NEG_INF = -1e30


class MultiHeadGateAttention(nn.Module):
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
        return (x.is_cuda and not torch.is_grad_enabled()
                and self.split_head and raw_global_emb is None and mask is None
                and not (self.l2norm_each_head or self.pre_layer_norm
                         or self.distinct_fc or self.fusion_mix)
                and self.ave_style == "one")

    def forward(
        self,
        local_embs: torch.Tensor,  # (B, L, D)
        raw_global_emb: Optional[torch.Tensor] = None,  # (B, H, dh)
        mask: Optional[torch.Tensor] = None,  # (B, L) 1 = valid
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


# registry key -> (with_ave, mul) of the single-head gate
_SINGLE_HEAD_KINDS = {
    "attention_noAverageMul_Ave": (True, False),  # 0
    "average_AverageMul_noAve": (False, True),  # 1
    "attention_noAveNoAverageMul": (False, False),  # 7
    "attention_averageMul": (True, True),  # 9
}

_MULTI_HEAD_KINDS = {
    "Multi_head_MyApply_Attention": {},
    "Multi_head_MyApply_FusionAttention": {"fusion_mix": True},
    "Multi_head_Attention_layer_norm": {"pre_layer_norm": True, "ave_style": "one_minus_g"},
    "Multi_head_Attention_distinct_fc": {"distinct_fc": True},
}


def get_attention_layer(kind: str, dim: int, spec: AttentionSpec) -> nn.Module:
    """Build a fusion-attention module by registry key: the single-head
    gate and the LAFF multi-head gate family. The other kinds of
    ``laff_tpu.models.attention`` raise until ROADMAP Queue 1 item 2."""
    if kind in _SINGLE_HEAD_KINDS:
        with_ave, mul = _SINGLE_HEAD_KINDS[kind]
        return GateAttention(dim, with_ave=with_ave, mul=mul)
    if kind not in _MULTI_HEAD_KINDS:
        raise NotImplementedError(f"attention kind {kind!r} is not ported yet: "
                                  f"ROADMAP Queue 1 item 2")
    extra = _MULTI_HEAD_KINDS[kind]
    if extra.get("fusion_mix"):
        return MultiHeadGateAttention(dim, spec.heads, split_head=spec.split_head,
                                      fusion_mix=True)
    return MultiHeadGateAttention(
        dim, spec.heads, with_ave=spec.with_ave, mul=spec.mul,
        split_head=spec.split_head,
        l2norm_each_head=spec.l2norm_each_head and not extra, **extra)
