"""The LAFF dual encoder: two symmetric fusion towers.

``FusionTower`` takes a feature dict to a (B, H, d) multi-space embedding:
each feature is projected into the common space by a ``TransformNet``
(BN-only and tiled for no-transform features such as precomputed CLIP
rows), the L projections are stacked and fused by the multi-head gate.
The GRU feature ('rnn') is encoded from token ids inside the tower; a bow
feature shipped as sparse (ids, counts) pairs is densified on the device.

Module and parameter names follow the ``laff_tpu`` flax tree
(``txt_net.transform_bow.fc1``, ``txt_net.gru``, ``vis_net.attention``),
so ``laff_tpu_torch.engine.weights.from_jax_variables`` is a rename.

The eval forward and the training forward (``module.training``) of the
video-level LAFF towers. In training, a visual feature batch that is zero
everywhere is replaced by standard normal noise (reference
``model/model.py:1819-1821``), drawn, like the dropout masks, from the
``generator`` the trainer passes.

FrameLAFF (``laff_tpu.models.laff`` ``VisMutiTransformNetPlusFrameFeat``):
each frame feature arrives padded as '<name>@frames' (B, T, D) with its
'<name>@mask' (B, T), goes through the optional xavier ``frame_fc_<name>``
and is pooled over T by the frame attention ``frame_attn_<name>`` (a
multi-head one is flattened) under each sample's own mask (the
reference's loop reads sample 0's mask for every sample; neither package
copies that). The pooled vector then enters the feature list like a
video-level feature, after the video features or, without
``frame_feat_with_video_feat``, in their place. The frame gate runs the
plain tensor code: it has a mask, and no package has a kernel for it.

'concat' fusion (W2VVPP, the single-space models): the raw features,
concatenated, go through one ``transform`` into the common space (B, D),
with no attention and no zero-feature noise. Cross-tower tying
(``spec.tied_transforms``, ``txt_fc_same_with_vis_fc``): ``LAFFModel``
owns one ``tied_fc_<txt>_<vis>`` linear per pair, and both towers'
TransformNets use it as their fc, each with its own dropout and
BatchNorm; the pair ('__concat__', '__concat__') ties the concat
transform. The 'netvlad' text feature pools the caption's per-token w2v
vectors ('netvlad_tokens' (B, T, D) under 'netvlad_mask' (B, T)) with
``NetVLAD`` inside the tower.

The 'bert' text feature: with an in-graph tower (``spec.bert``, the
config's ``bert_frozen=False``) the tower's ``bert`` (``models.bert.BertModel``
over ``BertConfig(spec.bert.config_kwargs)``) runs on the batch's
'bert_ids' and 'bert_mask' ('bert_type' when given) in f32 and its pooler
output is the raw feature, its dropout drawn from the step's generator;
otherwise, or when the batch carries no token ids, the batch's
precomputed 'bert' row is the feature, as in ``laff_tpu``.

task2 (``spec.task2``, ``laff_tpu``'s concept-space intent): two heads
``task2_vis_head`` and ``task2_txt_head``, TransformNets in f32 from the
raw features to concept logits (fc -> dropout -> BatchNorm; the sigmoid is
the loss's). ``encode_concepts`` feeds the vis head the concatenated raw
video-level features and the txt head the main tower's
``txt_feature`` ('bow' or 'w2v'); ``forward_with_concepts`` is the
training forward with both, densifying a sparse bow row once for the text
tower and the bow head.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.norms import l2norm
from .attention import GateAttention, NetVLAD, get_attention_layer
from .bert import BertConfig, BertModel
from .gru import GruEncoder
from .initializers import normal_, xavier_uniform_
from .layers import TransformNet
from .spec import LAFFSpec, TowerSpec, TransformSpec


def _dtype_of(spec: TowerSpec):
    return torch.bfloat16 if spec.compute_dtype == "bfloat16" else None


def safe_name(name: str) -> str:
    return name.replace(".", "_").replace(",", "_").replace("/", "_").replace("+", "_")


def densify_bow(inputs: Dict[str, torch.Tensor], dim: int) -> Dict[str, torch.Tensor]:
    """Scatter sparse (ids, counts) bow pairs back to the dense (B, vocab)
    row; padding ids hit the sink column ``dim``, which is dropped. The row
    is made contiguous, so the transform's product runs as on a fed dense
    batch."""
    inputs = dict(inputs)
    ids = inputs.pop("bow_ids").long()
    cnt = inputs.pop("bow_cnt")
    dense = torch.zeros((ids.shape[0], dim + 1), dtype=cnt.dtype, device=cnt.device)
    dense.scatter_add_(1, ids, cnt)
    inputs["bow"] = dense[:, :dim].contiguous()
    return inputs


def transform_spec_for(spec: TowerSpec, name: str, dim_in: int) -> TransformSpec:
    overrides = dict(spec.transform_overrides)
    if name in overrides:
        return overrides[name]
    if name in spec.no_transform:
        # BN-only passthrough (reference fc=False, activation=False path)
        return TransformSpec(dim_in=dim_in, dim_out=spec.common_dim, fc=False,
                             activation=None, dropout=0.0, batch_norm=True)
    return TransformSpec(dim_in=dim_in, dim_out=spec.common_dim, fc=True,
                         activation=spec.activation, dropout=spec.dropout,
                         batch_norm=spec.batch_norm)


def _pooled_frame_dim(spec: TowerSpec, fdim: int) -> int:
    """The width of a frame feature after its frame attention: a multi-head
    gate over repeated (not split) heads flattens H copies."""
    fa = spec.frame_attention
    if fa.kind.startswith("Multi_head") and not fa.split_head:
        return fa.heads * fdim
    return fdim


def _tower_features(spec: TowerSpec):
    """(name, input width) of every local the tower fuses, frame features
    at their pooled width."""
    frames = [(n, _pooled_frame_dim(spec, d)) for n, d in spec.frame_features]
    if not spec.frame_features:
        return list(spec.features)
    return (list(spec.features) if spec.frame_feat_with_video_feat else []) + frames


class FusionTower(nn.Module):
    """feature dict -> (B, H, d) multi-space embedding, or (B, D) for the
    single-space attention kinds and 'concat'. ``tied`` maps a feature name
    (or '__concat__') to a linear owned by the parent LAFFModel."""

    def __init__(self, spec: TowerSpec, is_visual: bool = False,
                 tied: Optional[Dict[str, nn.Linear]] = None) -> None:
        super().__init__()
        tied = tied or {}
        self.spec = spec
        self.is_visual = is_visual
        self.concat = spec.attention.kind == "concat"
        for fname, fdim in spec.frame_features:
            if spec.frame_add_fc:
                self.add_module(f"frame_fc_{safe_name(fname)}", nn.Linear(fdim, fdim))
            self.add_module(f"frame_attn_{safe_name(fname)}", get_attention_layer(
                spec.frame_attention.kind, fdim, spec.frame_attention))
        self.features = _tower_features(spec)
        dims = dict(self.features)
        self.expert_embedding = None
        if self.concat:
            self._raw_encoders(dims)
            self.transform = TransformNet(
                sum(dims.values()), spec.common_dim, activation=spec.activation,
                dropout=spec.dropout, batch_norm=spec.batch_norm,
                compute_dtype=_dtype_of(spec), shared_fc=tied.get("__concat__"))
            return
        for name, dim in self.features:
            tspec = transform_spec_for(spec, name, dim)
            self.add_module(f"transform_{safe_name(name)}", TransformNet(
                dim if tspec.fc else spec.common_dim, tspec.dim_out, fc=tspec.fc,
                activation=tspec.activation, dropout=tspec.dropout,
                batch_norm=tspec.batch_norm, compute_dtype=_dtype_of(spec),
                shared_fc=tied.get(name)))
        if spec.feat_add_concat:
            self.transform_feat_add_concat = TransformNet(
                sum(dims.values()), spec.common_dim,
                activation=spec.activation, dropout=spec.dropout,
                batch_norm=spec.batch_norm, compute_dtype=_dtype_of(spec))
        self._raw_encoders(dims)
        n_locals = len(self.features) + int(spec.feat_add_concat)
        if spec.expert_embedding:
            self.expert_embedding = nn.Parameter(torch.empty(n_locals, spec.common_dim))
        self.attention = get_attention_layer(spec.attention.kind, spec.common_dim,
                                             spec.attention, n_locals)

    def _raw_encoders(self, dims: Dict[str, int]) -> None:
        spec = self.spec
        self.gru = GruEncoder(spec.gru) if "rnn" in dims else None
        self.netvlad = (NetVLAD(dims["netvlad"] // spec.netvlad_clusters,
                                spec.netvlad_clusters) if "netvlad" in dims else None)
        self.bert = (BertModel(BertConfig.from_kwargs(spec.bert.config_kwargs))
                     if "bert" in dims and spec.bert is not None else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, module in self.named_children():
            if name.startswith("frame_fc_"):  # flax Dense, xavier kernel, zero bias
                xavier_uniform_(module.weight, generator)
                nn.init.zeros_(module.bias)
            else:
                module.reset_parameters(generator)
        if self.expert_embedding is not None:
            normal_(self.expert_embedding, generator)

    def _pool_frames(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """'<name>@frames' (B, T, D) under '<name>@mask' -> pooled (B, D). The
        fc and a multi-head frame gate take the frames in f32, as flax's
        Dense and einsum promote bf16 frames against f32 parameters."""
        pooled = {}
        for fname, _ in self.spec.frame_features:
            frames = inputs[f"{fname}@frames"]
            mask = inputs.get(f"{fname}@mask")
            attention = getattr(self, f"frame_attn_{safe_name(fname)}")
            if self.spec.frame_add_fc:
                frames = getattr(self, f"frame_fc_{safe_name(fname)}")(frames.float())
            elif not isinstance(attention, GateAttention):
                frames = frames.float()
            out = attention(frames, mask=mask)
            pooled[fname] = out.reshape(out.shape[0], -1)  # multi-head: flattened
        return pooled

    def _raw_feature(self, name: str, inputs: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if name == "rnn":
            return self.gru(inputs["rnn_ids"], inputs["rnn_len"])
        if name == "netvlad":
            return self.netvlad(inputs["netvlad_tokens"], inputs.get("netvlad_mask"))
        if name == "bert" and self.bert is not None and "bert_ids" in inputs:
            return self.bert(inputs["bert_ids"], inputs["bert_mask"], inputs.get("bert_type"),
                             generator=generator)[1]
        return inputs[name]

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        spec = self.spec
        if "bow_ids" in inputs:
            inputs = densify_bow(inputs, dict(self.features)["bow"])
        if spec.frame_features:
            inputs = {**inputs, **self._pool_frames(inputs)}
        if self.concat:
            cat = torch.cat([self._raw_feature(n, inputs, generator) for n, _ in self.features],
                            dim=1)
            return self.transform(cat, generator)
        locals_ = []
        for name, dim in self.features:
            feat = self._raw_feature(name, inputs, generator)
            if self.is_visual and self.training:
                # decided on the card: no host sync; drawn in f32 whatever
                # the feature's type, so a host bf16 cast draws the same
                noise = torch.randn(feat.shape, generator=generator, device=feat.device)
                feat = torch.where(feat.abs().sum() == 0, noise, feat.float())
            transform = getattr(self, f"transform_{safe_name(name)}")
            if name in spec.no_transform and transform.fc1 is None \
                    and transform.shared_fc is None:
                feat = feat.repeat(1, spec.common_dim // feat.shape[-1])
            locals_.append(transform(feat, generator))
        if spec.feat_add_concat:
            cat = torch.cat([self._raw_feature(n, inputs) for n, _ in self.features], dim=1)
            locals_.append(self.transform_feat_add_concat(cat, generator))
        local_embs = torch.stack(locals_, dim=1)  # (B, L, common)
        if self.expert_embedding is not None:
            local_embs = local_embs + self.expert_embedding[None]
        if spec.expert_l2norm:
            local_embs = l2norm(local_embs, dim=2)
        return self.attention(local_embs, generator=generator)


class LAFFModel(nn.Module):
    """Dual encoder: ``encode_txt`` / ``encode_vis`` give common-space
    embeddings; similarity and ranking live in ``laff_tpu_torch.ops``."""

    def __init__(self, spec: LAFFSpec) -> None:
        super().__init__()
        self.spec = spec
        txt_tied, vis_tied = self._build_tied_transforms()
        self.txt_net = FusionTower(spec.txt, tied=txt_tied)
        self.vis_net = FusionTower(spec.vis, is_visual=True, tied=vis_tied)
        t2 = spec.task2
        self.task2_vis_head = self.task2_txt_head = None
        if t2 is not None:
            act = None if t2.activation == "sigmoid" else t2.activation
            self.task2_vis_head = TransformNet(t2.vis_dim_in, t2.n_concepts, activation=act,
                                               dropout=t2.dropout, batch_norm=t2.batch_norm)
            if t2.txt_feature != "no":
                self.task2_txt_head = TransformNet(t2.txt_dim_in, t2.n_concepts,
                                                   activation=act, dropout=t2.dropout,
                                                   batch_norm=t2.batch_norm)

    def _build_tied_transforms(self):
        """One ``tied_fc_<txt>_<vis>`` linear per tied pair, owned here
        (``laff_tpu``'s ``_build_tied_transforms``, with its checks)."""
        spec = self.spec
        txt_tied: Dict[str, nn.Linear] = {}
        vis_tied: Dict[str, nn.Linear] = {}
        for txt_name, vis_name in spec.tied_transforms:
            if txt_name == "__concat__":
                if spec.txt.attention.kind != "concat" or spec.vis.attention.kind != "concat":
                    raise ValueError("__concat__ tying needs 'concat' fusion on both towers")
                dim_in = sum(d for _, d in spec.txt.features)
                vis_in = sum(d for _, d in spec.vis.features)
            else:
                dim_in = dict(spec.txt.features)[txt_name]
                vis_in = dict(spec.vis.features)[vis_name]
                if not transform_spec_for(spec.vis, vis_name, vis_in).fc:
                    raise ValueError(f"txt_fc_same_with_vis_fc: vis feature {vis_name!r} has "
                                     f"no fc to tie (no_transform)")
            if dim_in != vis_in or spec.txt.common_dim != spec.vis.common_dim:
                raise ValueError(
                    f"txt_fc_same_with_vis_fc: tied pair ({txt_name}, {vis_name}) dims do not "
                    f"match ({dim_in}/{spec.txt.common_dim} vs {vis_in}/{spec.vis.common_dim})")
            fc = nn.Linear(dim_in, spec.vis.common_dim)
            self.add_module(f"tied_fc_{safe_name(txt_name)}_{safe_name(vis_name)}", fc)
            txt_tied[txt_name] = vis_tied[vis_name] = fc
        return txt_tied, vis_tied

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions."""
        for name, module in self.named_children():
            if name.startswith("tied_fc_"):  # flax Dense: xavier kernel, zero bias
                xavier_uniform_(module.weight, generator)
                nn.init.zeros_(module.bias)
        self.txt_net.reset_parameters(generator)
        self.vis_net.reset_parameters(generator)
        for head in (self.task2_vis_head, self.task2_txt_head):
            if head is not None:
                head.reset_parameters(generator)

    def encode_txt(self, inputs: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.txt_net(inputs, generator)

    def encode_vis(self, inputs: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.vis_net(inputs, generator)

    def forward(self, txt_inputs, vis_inputs, generator: Optional[torch.Generator] = None):
        return self.encode_txt(txt_inputs, generator), self.encode_vis(vis_inputs, generator)

    def encode_concepts(self, txt_inputs: Optional[Dict[str, torch.Tensor]],
                        vis_inputs: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None):
        """task2 concept logits (txt (B, C) or None, vis (B, C)). The heads
        run in f32 on f32 copies of their inputs, as flax promotes bf16
        features against f32 parameters."""
        t2 = self.spec.task2
        raw = torch.cat([vis_inputs[name].float() for name, _ in self.spec.vis.features],
                        dim=1)
        vis_logits = self.task2_vis_head(raw, generator)
        txt_logits = None
        if self.task2_txt_head is not None and txt_inputs is not None:
            if t2.txt_feature == "bow" and "bow_ids" in txt_inputs:
                txt_inputs = densify_bow(txt_inputs, dict(self.spec.txt.features)["bow"])
            txt_logits = self.task2_txt_head(txt_inputs[t2.txt_feature].float(), generator)
        return txt_logits, vis_logits

    def forward_with_concepts(self, txt_inputs: Dict[str, torch.Tensor],
                              vis_inputs: Dict[str, torch.Tensor],
                              generator: Optional[torch.Generator] = None):
        """The task2 training forward: (txt_embs, vis_embs, txt_logits,
        vis_logits). A sparse bow row is densified once, for the text tower
        and the bow concept head."""
        if "bow_ids" in txt_inputs:
            txt_inputs = densify_bow(txt_inputs, dict(self.spec.txt.features)["bow"])
        txt_embs, vis_embs = self(txt_inputs, vis_inputs, generator)
        return (txt_embs, vis_embs, *self.encode_concepts(txt_inputs, vis_inputs, generator))


@torch.no_grad()
def get_attention_weights(model: LAFFModel, inputs: Dict[str, torch.Tensor],
                          side: str = "txt") -> Optional[np.ndarray]:
    """A batch's fusion-gate weights in eval mode (``laff_tpu``'s
    ``get_attention_weights``; reference ``get_attention_weight``,
    ``Attention.py:75-76`` / ``model.py:1707-1709``): (B, L) for the
    single-head gate, (B, L, H) for the multi-head LAFF gate, None for a
    fusion without gate weights. The forward takes the plain gate path (the
    gate kernel returns no weights); the model's mode is put back."""
    tower = model.txt_net if side == "txt" else model.vis_net
    attn = tower.attention
    if not hasattr(attn, "record_weights"):
        return None
    was_training = model.training
    model.eval()
    attn.record_weights, attn.weights = True, None
    try:
        tower(inputs)
        return attn.weights.cpu().numpy()
    finally:
        attn.record_weights, attn.weights = False, None
        model.train(was_training)
