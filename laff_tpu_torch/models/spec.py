"""ModelSpec: the architecture description consumed by the model builders.

This is the boundary between the user-facing config system (string-keyed,
mutated by ``adjust_parm`` sweeps) and the model code: everything the
towers need, as frozen dataclasses. ``spec_to_dict`` / ``spec_from_dict``
turn a spec into plain data for checkpoints and back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Which fusion attention to build and its knobs (reference
    ``model/model.py:70-208`` registry arguments)."""

    kind: str = "Multi_head_MyApply_Attention"
    heads: int = 8
    with_ave: bool = True
    mul: bool = False
    split_head: bool = True
    l2norm_each_head: bool = False
    dropout: float = 0.0
    output_type: str = "mean"  # my_self_attention only
    agg: str = "mean"  # muti_head_attention_official only
    embed_dim_qkv: int = 512  # Attention_2 only


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """One projection head: Linear -> activation -> dropout -> BatchNorm
    (reference TransformNet, ``model/model.py:211-277``)."""

    dim_in: int
    dim_out: int
    fc: bool = True
    activation: Optional[str] = "tanh"
    dropout: float = 0.2
    batch_norm: bool = False


@dataclasses.dataclass(frozen=True)
class BertSpec:
    """Live in-graph BERT text tower (reference BertTxtEncoder with
    ``bert_frozen=False``, model/model.py:437-466): the transformer runs
    inside the model graph and fine-tunes with the rest of the model
    (backbone updates scaled 1/20, reference model.py:2010-2024).

    ``config_kwargs`` override transformers' BertConfig; empty means the
    bert-base defaults. ``name_or_path`` is used to import pretrained
    params when it points at a local checkout."""

    name_or_path: str = "bert-base-uncased"
    hidden_size: int = 768
    max_length: int = 64
    do_lower_case: bool = True
    config_kwargs: Tuple[Tuple[str, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class GruSpec:
    vocab_size: int = 0
    we_dim: int = 500
    rnn_size: int = 1024
    rnn_layer: int = 1
    pooling: str = "mean"  # mean | last | mean_last
    bidirectional: bool = False


@dataclasses.dataclass(frozen=True)
class TowerSpec:
    """One side (text or visual) of the dual-encoder.

    features: ordered mapping feature-name -> input dim. Encoder order is
    significant (expert embeddings, checkpoint import) and follows the
    reference insertion order.
    no_transform: features passed through BN-only (no fc / activation),
    tiled ``heads`` times to reach common_dim (reference
    ``vis_no_transform`` / ``txt_no_transform`` handling).
    """

    features: Tuple[Tuple[str, int], ...]
    common_dim: int = 4096
    attention: AttentionSpec = dataclasses.field(default_factory=AttentionSpec)
    no_transform: Tuple[str, ...] = ()
    transform_overrides: Tuple[Tuple[str, TransformSpec], ...] = ()
    expert_embedding: bool = False
    expert_l2norm: bool = False
    dropout: float = 0.2
    batch_norm: bool = False
    activation: str = "tanh"
    gru: Optional[GruSpec] = None  # text tower only, when 'rnn' in features
    bert: Optional[BertSpec] = None  # live in-graph BERT ('bert' feature)
    # FrameLAFF (visual tower only): frame-feature name -> dim, pooled by a
    # masked frame-axis attention before feature-level fusion
    frame_features: Tuple[Tuple[str, int], ...] = ()
    frame_attention: Optional[AttentionSpec] = None
    frame_add_fc: bool = False
    frame_feat_with_video_feat: bool = True
    feat_add_concat: bool = False
    netvlad_clusters: int = 32
    compute_dtype: str = "float32"  # 'bfloat16' = reference float16/AMP flag

    def feature_dims(self) -> Dict[str, int]:
        return dict(self.features)


@dataclasses.dataclass(frozen=True)
class Task3Spec:
    """Negation-aware ('task3') auxiliary loss knobs (reference
    ``configs/base_config.py:251-257`` + Margin2Loss wiring)."""

    neg_weight: float = 1.0
    bottom_margin: Optional[float] = 0.1
    upper_margin: Optional[float] = 0.6
    bottom_margin_t2t: Optional[float] = 0.1
    upper_margin_t2t: Optional[float] = 0.3
    retrieval_weight: float = 0.001
    end_epoch: int = 100


@dataclasses.dataclass(frozen=True)
class Task2Spec:
    """Concept-space ('task2') auxiliary objective — the reference's
    documented INTENT, which its shipped code never executes: every
    ``compute_loss`` call passes literal zeros for the task2 embeddings
    (reference ``model/model.py:884``; full evidence in COMPONENTS.md).
    The reference trainer still builds the plumbing — a bow vocabulary
    over the per-video object-caption file and projection dims
    ``vis_fc_layers_task2`` (input = concatenated raw video features) /
    ``txt_fc_layers_task2`` (input = the MAIN task's text feature,
    output = the concept vocab; ``trainer.py:218-263``) — from which the
    intent is unambiguous: project both towers into the concept space and
    supervise with the video's concept labels. OPT-IN via
    ``--task2_intended 1``; the default keeps effective parity with the
    reference (config accepted, loss inert).

    Loss = alpha * (BCE(vis concepts, labels) + BCE(txt concepts, labels)
    + triplet over measure-``task2`` (hist/Jaccard) concept similarities)
    added to the retrieval loss (``alpha`` "balance[s] latent space and
    task2 space", reference ``base_config.py:242``)."""

    n_concepts: int
    vis_dim_in: int
    txt_feature: str = "bow"  # bow | w2v | no (reference txt_feature_task2)
    txt_dim_in: int = 0
    activation: str = "sigmoid"
    batch_norm: bool = True
    dropout: float = 0.1
    measure: str = "hist"
    alpha: float = 0.2


@dataclasses.dataclass(frozen=True)
class LAFFSpec:
    """Full dual-encoder spec."""

    txt: TowerSpec
    vis: TowerSpec
    # cross-tower weight tying (reference txt_fc_same_with_vis_fc,
    # model/model.py:764-768 and 1954-1966): (txt feature, vis feature)
    # pairs whose TransformNets share one parameter set. The special pair
    # ("__concat__", "__concat__") ties the whole concat-path transform.
    tied_transforms: Tuple[Tuple[str, str], ...] = ()
    multi_space: bool = True
    measure: str = "cosine"
    margin: float = 0.2
    direction: str = "t2i"
    max_violation: bool = True
    cost_style: str = "sum"
    loss: str = "mrl"  # mrl | dsl | CELoss
    task3: Optional[Task3Spec] = None
    task2: Optional[Task2Spec] = None


def spec_to_dict(spec: LAFFSpec) -> Dict:
    """Plain nested dicts/lists/scalars (no classes) for a checkpoint."""
    return dataclasses.asdict(spec)


def _tuples(x):
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    return x


def _transform_overrides(items):
    return tuple((name, TransformSpec(**ts)) for name, ts in items)


def _tower_from_dict(d: Dict) -> TowerSpec:
    d = dict(d)
    d["features"] = tuple((n, int(v)) for n, v in d["features"])
    d["attention"] = AttentionSpec(**d["attention"])
    d["no_transform"] = tuple(d["no_transform"])
    d["transform_overrides"] = _transform_overrides(d["transform_overrides"])
    d["gru"] = GruSpec(**d["gru"]) if d.get("gru") else None
    if d.get("bert"):
        bert = dict(d["bert"])
        bert["config_kwargs"] = _tuples(bert["config_kwargs"])
        d["bert"] = BertSpec(**bert)
    d["frame_features"] = tuple((n, int(v)) for n, v in d["frame_features"])
    if d.get("frame_attention"):
        d["frame_attention"] = AttentionSpec(**d["frame_attention"])
    return TowerSpec(**d)


def spec_from_dict(d: Dict) -> LAFFSpec:
    """Inverse of :func:`spec_to_dict`."""
    d = dict(d)
    d["txt"] = _tower_from_dict(d["txt"])
    d["vis"] = _tower_from_dict(d["vis"])
    d["tied_transforms"] = _tuples(d["tied_transforms"])
    d["task3"] = Task3Spec(**d["task3"]) if d.get("task3") else None
    d["task2"] = Task2Spec(**d["task2"]) if d.get("task2") else None
    return LAFFSpec(**d)
