"""Model registry: reference model names -> builders (``laff_tpu.models.
registry``, reference ``get_model``, ``model/model.py:2501-2519``).

Every W2VVPP-family name builds a ``LAFFModel`` whose behavior the spec
drives (the reference classes differ only in tower wiring, which the spec
encodes). 'End2EndClip', the raw-frame CLIP model, raises until its
ROADMAP item lands.
"""

from __future__ import annotations

from typing import Optional

from .laff import LAFFModel
from .spec import LAFFSpec

MODEL_NAMES = (
    "W2VVPP",                   # concat fusion both sides
    "w2vpp_mutivis_attention",  # multi-feature visual attention
    "LAFF",                     # multi-head gate fusion (LAFF / LAFF-ml)
    "FrameLAFF",                # + frame-level fusion
    "End2EndClip",              # raw frames + raw text through CLIP
)

END2END_NOT_PORTED = ("End2EndClip (raw frames through live CLIP towers) is not ported yet: "
                      "ROADMAP Queue 1 item 4")


def validate_spec_for(model_name: str, spec: LAFFSpec) -> None:
    if model_name == "End2EndClip":
        raise NotImplementedError(END2END_NOT_PORTED)
    if model_name == "FrameLAFF" and not spec.vis.frame_features:
        raise ValueError("FrameLAFF requires frame features (config.frame_feat_input "
                         "with vid_frame_feats)")
    if model_name == "W2VVPP":
        if spec.txt.attention.kind != "concat" or spec.vis.attention.kind != "concat":
            raise ValueError("W2VVPP uses concat fusion on both towers")


def get_model(model_name: str, spec: Optional[LAFFSpec] = None) -> LAFFModel:
    if model_name == "End2EndClip":
        raise NotImplementedError(END2END_NOT_PORTED)
    if model_name not in MODEL_NAMES:
        raise KeyError(f"unknown model '{model_name}'; known: {MODEL_NAMES}")
    if spec is None:
        raise ValueError(f"{model_name} requires a LAFFSpec")
    validate_spec_for(model_name, spec)
    return LAFFModel(spec)
