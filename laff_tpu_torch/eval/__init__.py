from .metrics import (
    eval_label_matrix,
    eval_qry2retro,
    eval_t2v,
    eval_v2t,
    label_matrix_from_scores,
    metrics_from_ranks,
    ranks_from_scores,
)

__all__ = [
    "eval_label_matrix",
    "eval_qry2retro",
    "eval_t2v",
    "eval_v2t",
    "label_matrix_from_scores",
    "metrics_from_ranks",
    "ranks_from_scores",
]
