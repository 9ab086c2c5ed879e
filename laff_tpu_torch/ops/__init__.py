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
from .similarity import cosine_sim, flatten_heads, multi_head_cosine_sim

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
    "multi_head_cosine_sim",
]
