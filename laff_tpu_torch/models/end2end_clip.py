"""End2EndClip: raw video frames and raw text through live CLIP towers
(``laff_tpu.models.end2end_clip``; reference ``model/model.py:2261-2498``).

S sampled frames a video go through the ViT tower and are mean-pooled (over
the frames that ``frames_mask`` keeps, the count clipped at 1; the
reference's only frame_agg_method), the caption through the text tower.
``frozen`` detaches both towers' outputs, as the reference's
``torch.no_grad()`` blocks and ``laff_tpu``'s ``stop_gradient`` do: every
gradient is then zero. Every parameter sits under ``clip_text`` or
``clip_vision``, so ``clip_param_labels`` marks them all 'clip' (the
reference's lr/20 rule, model/model.py:2013-2019).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .clip.towers import ClipTextConfig, ClipTextTower, ClipVisionConfig, ClipVisionTower


class End2EndClip(nn.Module):
    def __init__(self, text_config: ClipTextConfig = ClipTextConfig(),
                 vision_config: ClipVisionConfig = ClipVisionConfig(),
                 frozen: bool = True) -> None:
        super().__init__()
        self.frozen = frozen
        self.clip_text = ClipTextTower(text_config)
        self.clip_vision = ClipVisionTower(vision_config)

    def encode_txt(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = self.clip_text(inputs["clip_ids"])
        return feats.detach() if self.frozen else feats

    def encode_vis(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        frames = inputs["frames"]  # (B, S, H, W, 3)
        b, s = frames.shape[:2]
        feats = self.clip_vision(frames.reshape(b * s, *frames.shape[2:])).reshape(b, s, -1)
        if self.frozen:
            feats = feats.detach()
        mask = inputs.get("frames_mask")  # (B, S) optional
        if mask is None:
            return feats.mean(dim=1)
        m = mask.to(feats.dtype)
        return (feats * m[:, :, None]).sum(dim=1) / m.sum(dim=1, keepdim=True).clamp(min=1.0)

    def forward(self, txt_inputs: Dict[str, torch.Tensor], vis_inputs: Dict[str, torch.Tensor]):
        return self.encode_txt(txt_inputs), self.encode_vis(vis_inputs)


def clip_param_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> 'clip' for tower parameters (lr/20 in the
    reference), 'usual' otherwise."""
    def label(name: str) -> str:
        parts = name.split(".")
        if any(p in ("clip_text", "clip_vision") or "ClipModel" in p for p in parts):
            return "clip"
        return "usual"

    return {name: label(name) for name, _ in model.named_parameters()}
