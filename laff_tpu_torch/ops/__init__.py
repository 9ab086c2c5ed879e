from .kernels import (
    LAUNCHES,
    build_kernels,
    fused_gate_attention,
    fused_gate_attention_plain,
    fused_sim_rank,
    fused_sim_rank_plain,
    reset_launches,
)
from .norms import l1norm, l2norm
from .quantized import int8_scores, int8_topk, quantize_rows
from .similarity import cosine_sim, flatten_heads, hist_scores, hist_sim, multi_head_cosine_sim

__all__ = [
    "LAUNCHES",
    "build_kernels",
    "fused_gate_attention",
    "fused_gate_attention_plain",
    "fused_sim_rank",
    "fused_sim_rank_plain",
    "reset_launches",
    "l1norm",
    "l2norm",
    "cosine_sim",
    "flatten_heads",
    "hist_scores",
    "hist_sim",
    "int8_scores",
    "int8_topk",
    "quantize_rows",
    "multi_head_cosine_sim",
]
