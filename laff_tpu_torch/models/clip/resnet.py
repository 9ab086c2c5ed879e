"""CLIP ModifiedResNet visual tower (``laff_tpu.models.clip.resnet``).

The reference's vendored OpenAI CLIP ResNet (``model/clip/model.py:10-150``):
a 3-conv stem with an average pool (no max pool), anti-aliased strided
convolutions (an average pool before every stride-2 step), Bottleneck
stages, and a QKV attention pool instead of global average pooling. The
modules carry the OpenAI names under ``visual.`` (``layer1.0.conv1.weight``,
``layer1.0.downsample.0.weight``, ``attnpool.q_proj.weight``, ...).

BatchNorm is frozen (running statistics, the reference's
``build_model(...).eval()``), and the attention pool computes only the
mean-token query, as ``laff_tpu`` does: the reference evaluates full
self-attention and keeps ``x[0]``, so the other queries change nothing.
Inputs are (B, H, W, 3) like the ViT tower's; the convolutions run in NCHW
under a scoped ``torch.backends.cudnn.flags(allow_tf32=False)``, so a cuDNN
convolution keeps float32 without a process-wide setting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ClipResNetConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)  # RN50
    width: int = 64
    heads: int = 32          # reference: vision_width * 32 // 64
    image_size: int = 224
    embed_dim: int = 1024


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on stored statistics (eps 1e-5); no ``num_batches_tracked``."""

    def __init__(self, n: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-5)


def _conv(cin: int, cout: int, size: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, size, stride=stride, padding=size // 2, bias=False)


class Bottleneck(nn.Module):
    """Reference Bottleneck (model/clip/model.py:10-53): stride-1
    convolutions, an average pool after conv2 (and before the downsample
    conv) for the stride."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.bn3 = FrozenBatchNorm2d(planes * self.expansion)
        self.downsample = None
        if stride > 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential()
            self.downsample.add_module("0", _conv(inplanes, planes * self.expansion, 1))
            self.downsample.add_module("1", FrozenBatchNorm2d(planes * self.expansion))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling (model/clip/model.py:56-93), mean-token query
    only."""

    def __init__(self, grid: int, width: int, heads: int, output_dim: int) -> None:
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.randn(grid * grid + 1, width)
                                                 * width ** -0.5)
        self.q_proj, self.k_proj = nn.Linear(width, width), nn.Linear(width, width)
        self.v_proj, self.c_proj = nn.Linear(width, width), nn.Linear(width, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W) -> (B, output_dim)
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C), row-major as NHWC
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding
        n, dh = tokens.shape[1], c // self.heads

        def lin(m: nn.Linear, t: torch.Tensor) -> torch.Tensor:
            return torch.matmul(t, m.weight.T) + m.bias

        q = lin(self.q_proj, tokens[:, 0]).reshape(b, self.heads, dh) * dh ** -0.5
        k = lin(self.k_proj, tokens).reshape(b, n, self.heads, dh)
        v = lin(self.v_proj, tokens).reshape(b, n, self.heads, dh)
        attn = torch.softmax(torch.einsum("bhd,blhd->bhl", q, k), dim=-1)
        ctx = torch.einsum("bhl,blhd->bhd", attn, v).reshape(b, c)
        return lin(self.c_proj, ctx)


class ModifiedResNetTower(nn.Module):
    def __init__(self, config: ClipResNetConfig = ClipResNetConfig()) -> None:
        super().__init__()
        self.config = config
        w = config.width
        self.conv1, self.bn1 = _conv(3, w // 2, 3, stride=2), FrozenBatchNorm2d(w // 2)
        self.conv2, self.bn2 = _conv(w // 2, w // 2, 3), FrozenBatchNorm2d(w // 2)
        self.conv3, self.bn3 = _conv(w // 2, w, 3), FrozenBatchNorm2d(w)
        inplanes = w
        for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), config.layers), start=1):
            layer = nn.Sequential()
            for blk in range(blocks):
                stride = 2 if (stage > 1 and blk == 0) else 1
                layer.add_module(str(blk), Bottleneck(inplanes, w * mult, stride))
                inplanes = w * mult * Bottleneck.expansion
            self.add_module(f"layer{stage}", layer)
        self.attnpool = AttentionPool2d(config.image_size // 32, inplanes, config.heads,
                                        config.embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float32 (normalized) -> (B, embed_dim)."""
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            x = images.permute(0, 3, 1, 2)
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.relu(self.bn2(self.conv2(x)))
            x = F.relu(self.bn3(self.conv3(x)))
            x = F.avg_pool2d(x, 2)
            for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
                x = stage(x)
            return self.attnpool(x)


def resnet_state_dict(sd: Dict, config: ClipResNetConfig,
                      prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """The ResNet tower's entries of an OpenAI CLIP state dict (``laff_tpu``'s
    ``import_resnet_tower``): convolutions, BatchNorm parameters and
    statistics (``num_batches_tracked`` dropped), the attention pool."""
    def bn(name):
        return [f"{name}.{k}" for k in ("weight", "bias", "running_mean", "running_var")]

    keys = ["conv1.weight", "conv2.weight", "conv3.weight", *bn("bn1"), *bn("bn2"), *bn("bn3")]
    for stage, blocks in enumerate(config.layers, start=1):
        for blk in range(blocks):
            p = f"layer{stage}.{blk}."
            keys += [p + "conv1.weight", p + "conv2.weight", p + "conv3.weight",
                     *bn(p + "bn1"), *bn(p + "bn2"), *bn(p + "bn3")]
            if f"{prefix}{p}downsample.0.weight" in sd:
                keys += [p + "downsample.0.weight", *bn(p + "downsample.1")]
    keys.append("attnpool.positional_embedding")
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        keys += [f"attnpool.{name}.weight", f"attnpool.{name}.bias"]
    return {k: torch.as_tensor(sd[prefix + k]).float() for k in keys}
