from .attention import MultiHeadGateAttention, get_attention_layer
from .gru import GruEncoder
from .laff import FusionTower, LAFFModel
from .layers import TransformNet
from .spec import (AttentionSpec, GruSpec, LAFFSpec, TowerSpec, TransformSpec,
                   spec_from_dict, spec_to_dict)

__all__ = [
    "MultiHeadGateAttention",
    "get_attention_layer",
    "GruEncoder",
    "FusionTower",
    "LAFFModel",
    "TransformNet",
    "AttentionSpec",
    "GruSpec",
    "LAFFSpec",
    "TowerSpec",
    "TransformSpec",
    "spec_from_dict",
    "spec_to_dict",
]
