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
'concat' fusion, cross-tower tied transforms, live BERT/NetVLAD features
and the task2 concept heads come with later slices and raise here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.norms import l2norm
from .attention import MultiHeadGateAttention, get_attention_layer
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


class FusionTower(nn.Module):
    """feature dict -> (B, H, d) multi-space embedding."""

    def __init__(self, spec: TowerSpec, is_visual: bool = False) -> None:
        super().__init__()
        if spec.attention.kind == "concat":
            raise NotImplementedError("'concat' fusion is not ported yet: ROADMAP Queue 1 item 2")
        self.spec = spec
        self.is_visual = is_visual
        self.features = list(spec.features)
        for fname, fdim in spec.frame_features:
            if spec.frame_add_fc:
                self.add_module(f"frame_fc_{safe_name(fname)}", nn.Linear(fdim, fdim))
            self.add_module(f"frame_attn_{safe_name(fname)}", get_attention_layer(
                spec.frame_attention.kind, fdim, spec.frame_attention))
        if spec.frame_features:
            video = self.features if spec.frame_feat_with_video_feat else []
            self.features = video + list(spec.frame_features)
        for name, dim in self.features:
            if name in ("bert", "netvlad"):
                raise NotImplementedError(f"text feature {name!r} is not ported yet: "
                                          f"ROADMAP Queue 1 item {6 if name == 'bert' else 2}")
            tspec = transform_spec_for(spec, name, dim)
            self.add_module(f"transform_{safe_name(name)}", TransformNet(
                dim if tspec.fc else spec.common_dim, tspec.dim_out, fc=tspec.fc,
                activation=tspec.activation, dropout=tspec.dropout,
                batch_norm=tspec.batch_norm, compute_dtype=_dtype_of(spec)))
        if spec.feat_add_concat:
            self.transform_feat_add_concat = TransformNet(
                sum(d for _, d in self.features), spec.common_dim,
                activation=spec.activation, dropout=spec.dropout,
                batch_norm=spec.batch_norm, compute_dtype=_dtype_of(spec))
        self.gru = GruEncoder(spec.gru) if "rnn" in dict(self.features) else None
        n_locals = len(self.features) + int(spec.feat_add_concat)
        self.expert_embedding = (
            nn.Parameter(torch.empty(n_locals, spec.common_dim))
            if spec.expert_embedding else None)
        self.attention = get_attention_layer(spec.attention.kind, spec.common_dim,
                                             spec.attention)

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
            elif isinstance(attention, MultiHeadGateAttention):
                frames = frames.float()
            out = attention(frames, mask=mask)
            pooled[fname] = out.reshape(out.shape[0], -1)  # multi-head: flattened
        return pooled

    def _raw_feature(self, name: str, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        if name == "rnn":
            return self.gru(inputs["rnn_ids"], inputs["rnn_len"])
        return inputs[name]

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        spec = self.spec
        if "bow_ids" in inputs:
            inputs = densify_bow(inputs, dict(self.features)["bow"])
        if spec.frame_features:
            inputs = {**inputs, **self._pool_frames(inputs)}
        locals_ = []
        for name, dim in self.features:
            feat = self._raw_feature(name, inputs)
            if self.is_visual and self.training:
                # decided on the card: no host sync; drawn in f32 whatever
                # the feature's type, so a host bf16 cast draws the same
                noise = torch.randn(feat.shape, generator=generator, device=feat.device)
                feat = torch.where(feat.abs().sum() == 0, noise, feat.float())
            transform = getattr(self, f"transform_{safe_name(name)}")
            if name in spec.no_transform and transform.fc1 is None:
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
        return self.attention(local_embs)


class LAFFModel(nn.Module):
    """Dual encoder: ``encode_txt`` / ``encode_vis`` give common-space
    embeddings; similarity and ranking live in ``laff_tpu_torch.ops``."""

    def __init__(self, spec: LAFFSpec) -> None:
        super().__init__()
        if spec.tied_transforms:
            raise NotImplementedError("tied cross-tower transforms are not ported yet: "
                                      "ROADMAP Queue 1 item 2")
        if spec.task2 is not None:
            raise NotImplementedError("task2 concept heads are not ported yet: "
                                      "ROADMAP Queue 1 item 3")
        self.spec = spec
        self.txt_net = FusionTower(spec.txt)
        self.vis_net = FusionTower(spec.vis, is_visual=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions."""
        self.txt_net.reset_parameters(generator)
        self.vis_net.reset_parameters(generator)

    def encode_txt(self, inputs: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.txt_net(inputs, generator)

    def encode_vis(self, inputs: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.vis_net(inputs, generator)

    def forward(self, txt_inputs, vis_inputs, generator: Optional[torch.Generator] = None):
        return self.encode_txt(txt_inputs, generator), self.encode_vis(vis_inputs, generator)
