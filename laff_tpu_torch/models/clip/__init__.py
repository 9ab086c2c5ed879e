"""Live CLIP towers (``laff_tpu.models.clip``): the BPE tokenizer, the
text, ViT and ResNet towers in the OpenAI state-dict layout, and the
weight loader."""

from .load import LoadedClip, available_models, load, load_state_dict
from .resnet import ClipResNetConfig, ModifiedResNetTower, resnet_state_dict
from .tokenizer import CONTEXT_LENGTH, ClipTokenizer, get_tokenizer, tokenize
from .towers import (
    ClipArch,
    ClipTextConfig,
    ClipTextTower,
    ClipVisionConfig,
    ClipVisionTower,
    build_towers,
    infer_clip_config,
    text_state_dict,
    vision_state_dict,
)

__all__ = [
    "CONTEXT_LENGTH",
    "ClipTokenizer",
    "get_tokenizer",
    "tokenize",
    "ClipTextConfig",
    "ClipTextTower",
    "ClipVisionConfig",
    "ClipVisionTower",
    "text_state_dict",
    "vision_state_dict",
    "ClipArch",
    "ClipResNetConfig",
    "ModifiedResNetTower",
    "resnet_state_dict",
    "build_towers",
    "infer_clip_config",
    "LoadedClip",
    "available_models",
    "load",
    "load_state_dict",
]
