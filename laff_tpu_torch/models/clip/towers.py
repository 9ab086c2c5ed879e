"""CLIP text and vision towers (``laff_tpu.models.clip.towers``).

The architecture of the reference's vendored OpenAI CLIP
(``model/clip/model.py:10-375``): pre-LN transformer blocks with
QuickGELU, causal masking and EOT pooling for text, a ViT patch embedding
and class token for vision. The modules carry the OpenAI state-dict names
(``token_embedding.weight``, ``transformer.resblocks.<i>.attn.in_proj_weight``,
``visual.conv1.weight``, ...), so a released or fine-tuned checkpoint loads
with no renames: the text tower takes the top-level keys, the vision tower
the keys under ``visual.``.

The towers are plain PyTorch: ``torch.matmul``, ``softmax`` and
``layer_norm`` in the order of ``laff_tpu``'s flax modules, in float32.
Attention is not ``scaled_dot_product_attention`` (its fused kernels sum in
another order), and ViT's ``conv1`` is a patch reshape and a matmul, not a
cuDNN convolution, which would run in TF32 under torch's default
``cudnn.allow_tf32``; nothing here sets a process-wide flag.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

_LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    heads: int = 12
    layers: int = 12
    embed_dim: int = 512


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _normal(shape, std: float) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape) * std)


def _layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=_LN_EPS)


class _Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameter names (packed in-projection,
    ``out_proj``) with the computation written out."""

    def __init__(self, width: int) -> None:
        super().__init__()
        self.in_proj_weight = _normal((3 * width, width), 0.02)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.normal_(self.out_proj.weight, std=0.02)
        nn.init.zeros_(self.out_proj.bias)


class _MLP(nn.Module):
    def __init__(self, width: int) -> None:
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)
        for lin in (self.c_fc, self.c_proj):
            nn.init.normal_(lin.weight, std=0.02)
            nn.init.zeros_(lin.bias)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False) -> None:
        super().__init__()
        self.width, self.heads, self.causal = width, heads, causal
        self.ln_1 = _layer_norm(width)
        self.attn = _Attention(width)
        self.ln_2 = _layer_norm(width)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, W)
        d, h = self.width, self.heads
        dh = d // h
        b, n, _ = x.shape
        y = self.ln_1(x)
        qkv = torch.matmul(y, self.attn.in_proj_weight.T) + self.attn.in_proj_bias
        q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
        attn = torch.matmul(q * (dh ** -0.5), k.transpose(-1, -2))
        if self.causal:
            attn = attn + torch.full((n, n), float("-inf"), device=x.device,
                                     dtype=attn.dtype).triu(1)
        ctx = torch.matmul(torch.softmax(attn, dim=-1), v)
        ctx = ctx.transpose(1, 2).reshape(b, n, d)
        x = x + torch.matmul(ctx, self.attn.out_proj.weight.T) + self.attn.out_proj.bias
        y = self.ln_2(x)
        hidden = quick_gelu(torch.matmul(y, self.mlp.c_fc.weight.T) + self.mlp.c_fc.bias)
        return x + torch.matmul(hidden, self.mlp.c_proj.weight.T) + self.mlp.c_proj.bias


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, causal: bool) -> None:
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class ClipTextTower(nn.Module):
    def __init__(self, config: ClipTextConfig = ClipTextConfig()) -> None:
        super().__init__()
        self.config = config
        self.token_embedding = nn.Embedding(config.vocab_size, config.width)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        self.positional_embedding = _normal((config.context_length, config.width), 0.01)
        self.transformer = _Transformer(config.width, config.heads, config.layers, causal=True)
        self.ln_final = _layer_norm(config.width)
        self.text_projection = _normal((config.width, config.embed_dim), 0.02)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) integer ids -> (B, embed_dim) features, pooled at the EOT
        token: the first position of each row's largest id (reference
        model.py:354)."""
        ids = token_ids.long()
        x = self.token_embedding(ids) + self.positional_embedding[: ids.shape[1]]
        x = self.ln_final(self.transformer(x))
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return torch.matmul(pooled, self.text_projection)


class ClipVisionTower(nn.Module):
    def __init__(self, config: ClipVisionConfig = ClipVisionConfig()) -> None:
        super().__init__()
        self.config = config
        p, w = config.patch_size, config.width
        # OpenAI's Conv2d(3, width, p, stride=p, bias=False) weight, (width, 3, p, p)
        self.conv1 = nn.Module()
        fan_in = 3 * p * p
        self.conv1.weight = nn.Parameter(torch.randn(w, 3, p, p) * fan_in ** -0.5)
        self.class_embedding = _normal((w,), 0.02)
        n_pos = (config.image_size // p) ** 2 + 1
        self.positional_embedding = _normal((n_pos, w), 0.01)
        self.ln_pre = _layer_norm(w)
        self.transformer = _Transformer(w, config.heads, config.layers, causal=False)
        self.ln_post = _layer_norm(w)
        self.proj = _normal((w, config.embed_dim), 0.02)

    def patches(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, grid^2, width): the stride-p convolution as
        one matmul over (channel, row, column)-ordered patches, tokens in
        row-major grid order."""
        b, hh, ww, c = images.shape
        p = self.config.patch_size
        x = images.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, (hh // p) * (ww // p), c * p * p)
        return torch.matmul(x, self.conv1.weight.reshape(self.config.width, -1).T)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float32 (normalized) -> (B, embed_dim)."""
        x = self.patches(images)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return torch.matmul(self.ln_post(x[:, 0]), self.proj)


# ---------------------------------------------------------------------------
# OpenAI state dicts: the keys each tower takes
# ---------------------------------------------------------------------------

def _block_keys(prefix: str):
    return [prefix + k for k in (
        "ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias", "attn.in_proj_weight",
        "attn.in_proj_bias", "attn.out_proj.weight", "attn.out_proj.bias",
        "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")]


def _take(sd: Dict, prefix: str, keys) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(sd[prefix + k]).float() for k in keys}


def text_state_dict(sd: Dict, layers: int = 12, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The text tower's entries of an OpenAI CLIP state dict (``laff_tpu``'s
    ``import_text_tower``); ``prefix`` for wrapped files (e.g. 'ClipModel.')."""
    keys = ["token_embedding.weight", "positional_embedding", "ln_final.weight",
            "ln_final.bias", "text_projection"]
    for i in range(layers):
        keys += _block_keys(f"transformer.resblocks.{i}.")
    return _take(sd, prefix, keys)


def vision_state_dict(sd: Dict, layers: int = 12,
                      prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """The ViT tower's entries (``laff_tpu``'s ``import_vision_tower``)."""
    keys = ["conv1.weight", "class_embedding", "positional_embedding", "ln_pre.weight",
            "ln_pre.bias", "ln_post.weight", "ln_post.bias", "proj"]
    for i in range(layers):
        keys += _block_keys(f"transformer.resblocks.{i}.")
    return _take(sd, prefix, keys)


# ---------------------------------------------------------------------------
# architecture from state-dict shapes (reference build_model,
# model/clip/model.py:401-438)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClipArch:
    """What a CLIP checkpoint's weight shapes say it is. ``vision`` is None
    for text-only dumps (e.g. StrongCLIP text-tower fine-tunes)."""
    text: ClipTextConfig
    vision: object  # ClipVisionConfig (ViT), ClipResNetConfig, or None
    vit: bool


def infer_clip_config(sd: Dict, prefix: str = "") -> ClipArch:
    """The CLIP architecture from weight shapes alone, as the reference's
    ``build_model`` infers it, so ViT-B/32, ViT-B/16, ViT-L/14, RN50,
    RN50x4, RN101, ... load without a hand-written config. A missing key
    raises ``KeyError``."""
    from .resnet import ClipResNetConfig

    p = prefix
    keys = [k[len(p):] for k in sd if k.startswith(p)]

    def shape(k):
        return tuple(sd[p + k].shape)

    embed_dim = shape("text_projection")[1]
    width = shape("ln_final.weight")[0]
    text = ClipTextConfig(
        vocab_size=shape("token_embedding.weight")[0],
        context_length=shape("positional_embedding")[0],
        width=width,
        heads=width // 64,
        layers=len({k.split(".")[2] for k in keys if k.startswith("transformer.resblocks")}),
        embed_dim=embed_dim,
    )
    vit = "visual.proj" in keys
    if not any(k.startswith("visual.") for k in keys):
        return ClipArch(text=text, vision=None, vit=False)
    if vit:
        vision_width = shape("visual.conv1.weight")[0]
        vision_layers = len([k for k in keys if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        patch = shape("visual.conv1.weight")[-1]
        grid = round((shape("visual.positional_embedding")[0] - 1) ** 0.5)
        vision = ClipVisionConfig(image_size=patch * grid, patch_size=patch, width=vision_width,
                                  heads=vision_width // 64, layers=vision_layers,
                                  embed_dim=embed_dim)
    else:
        counts = tuple(len({k.split(".")[2] for k in keys if k.startswith(f"visual.layer{b}")})
                       for b in (1, 2, 3, 4))
        vision_width = shape("visual.layer1.0.conv1.weight")[0]
        n_pos = shape("visual.attnpool.positional_embedding")[0]
        out_width = round((n_pos - 1) ** 0.5)
        if out_width ** 2 + 1 != n_pos:
            raise ValueError(f"attnpool positional embedding of {n_pos} rows is not a square "
                             f"grid plus one")
        vision = ClipResNetConfig(layers=counts, width=vision_width,
                                  heads=vision_width * 32 // 64, image_size=out_width * 32,
                                  embed_dim=embed_dim)
    return ClipArch(text=text, vision=vision, vit=vit)


def build_towers(sd: Dict, prefix: str = ""):
    """The reference ``build_model``: infer the architecture from the state
    dict, build both towers and load their weights (strictly). Returns
    ``(text_tower, vision_tower)``, the vision tower None for a text-only
    dump; a ResNet tower's BatchNorm runs on its stored statistics."""
    from .resnet import ModifiedResNetTower, resnet_state_dict

    arch = infer_clip_config(sd, prefix=prefix)
    text = ClipTextTower(arch.text)
    text.load_state_dict(text_state_dict(sd, arch.text.layers, prefix))
    if arch.vision is None:
        return text.eval(), None
    if arch.vit:
        vision = ClipVisionTower(arch.vision)
        vision.load_state_dict(vision_state_dict(sd, arch.vision.layers, prefix + "visual."))
    else:
        vision = ModifiedResNetTower(arch.vision)
        vision.load_state_dict(resnet_state_dict(sd, arch.vision, prefix + "visual."))
    return text.eval(), vision.eval()

