"""The plain reference of the LAFF-ml towers (Hu et al., "Lightweight
Attentional Feature Fusion", arXiv:2112.01832), read from a configuration
file of ``portbench/configs`` and a weight dict keyed as the port's state
dict. Plain ``torch`` operations in float32 (TF32 off), no kernel.

A tower projects each of its L features into the common space (D) with a
TransformNet, Linear -> tanh -> dropout -> BatchNorm1d (a feature marked
without transform: BatchNorm alone, on the feature tiled to D), stacks
the L projections and fuses them with the multi-head gate: D splits into
H heads of d = D / H; per head, a logit w_h . x_{l,h} + b_h for each of the
L locals, a softmax over L, the weighted sum, then the head's l2 norm.
The text tower's 'rnn' feature is a one-way GRU (PyTorch's gate order r,
z, n) over the caption's word embeddings, mean-pooled over its valid
steps. FrameLAFF pools a video's frame rows with a single-head gate under
the frame mask and l2-normalizes the pooled row before it joins the video
features.

Training mode: BatchNorm normalizes with the batch's (biased) statistics
(kept in ``batch_stats``: the running statistics move by 0.1 of the way to
them);
each transform with dropout draws its keep mask as ``torch.rand((B, D),
generator) < 1 - p`` and scales kept values by 1 / (1 - p); before each
video feature's transform a ``torch.randn`` of the feature's shape is
drawn, which replaces the feature where the whole batch of it is zero
(``model/model.py:1819-1821`` of the reference). The draws come from the
generator the caller passes, in this order: the text features in the
configuration's order, then the video features, then the frame feature.

``precision`` 'f32' is the reference. 'control' is the same computation
one precision step below what the configuration states: what the
configuration computes in bfloat16 (a transform's input, its Linear's
operands, the activation and the BatchNorm's output) rounded to fp8 (e4m3,
one scale per tensor), and what it computes in float32 (the GRU's state,
the gates' outputs) rounded to bfloat16, in the forward and the backward.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Tensor = torch.Tensor


def safe_name(name: str) -> str:
    return name.replace(".", "_").replace(",", "_").replace("/", "_").replace("+", "_")


def _fp8(x: Tensor) -> Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def _bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Round(torch.autograd.Function):
    """Rounds the forward value and the gradient with ``q``."""

    @staticmethod
    def forward(ctx, x: Tensor, q: Callable) -> Tensor:
        ctx.q = q
        return q(x)

    @staticmethod
    def backward(ctx, grad: Tensor):
        return ctx.q(grad), None


def _identity(x: Tensor) -> Tensor:
    return x


def rounding(precision: str):
    """(round for Linear operands, round for module outputs)."""
    if precision == "f32":
        return _identity, _identity
    if precision == "control":
        return (lambda x: _Round.apply(x, _fp8)), (lambda x: _Round.apply(x, _bf16))
    raise ValueError(f"precision {precision!r}")


def l2norm(x: Tensor, dim: int = -1, eps: float = 1e-13) -> Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps + 1e-14)


class ReferenceModel:
    def __init__(self, cfg: Dict, weights: Dict[str, Tensor], precision: str = "f32") -> None:
        gate = cfg["gate"]
        if gate["with_ave"] or gate["mul"] or not gate["split_head"]:
            raise ValueError("the reference covers the gate without residual and mul, "
                             "on split heads")
        self.cfg, self.w = cfg, weights
        self.q_lin, self.q_out = rounding(precision)
        self.batch_stats: Dict[str, tuple] = {}  # BatchNorm prefix -> (mean, var) in training

    def _transform(self, prefix: str, x: Tensor, has_fc: bool, training: bool,
                   gen: Optional[torch.Generator]) -> Tensor:
        w, cfg = self.w, self.cfg
        if has_fc:
            x = self.q_lin(x) @ self.q_lin(w[prefix + ".fc1.weight"]).T + w[prefix + ".fc1.bias"]
            x = self.q_lin(torch.tanh(x))
            p = cfg["dropout"]
            if training and p > 1e-3:
                keep = 1.0 - p
                mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros((), device=x.device))
        eps, scale, shift = cfg["bn_eps"], w[prefix + ".bn1.weight"], w[prefix + ".bn1.bias"]
        x = self.q_lin(x)
        if training:
            var, mean = torch.var_mean(x, dim=0, correction=0)
            self.batch_stats[prefix + ".bn1"] = (mean.detach(), var.detach())
        else:
            mean, var = w[prefix + ".bn1.running_mean"], w[prefix + ".bn1.running_var"]
        return self.q_lin((x - mean) / torch.sqrt(var + eps) * scale + shift)

    def _gru(self, ids: Tensor, lens: Tensor) -> Tensor:
        w = self.w
        x = w["txt_net.gru.we.weight"][ids]  # (B, T, E)
        w_ih, w_hh = w["txt_net.gru.rnn.weight_ih_l0"], w["txt_net.gru.rnn.weight_hh_l0"]
        b_ih, b_hh = w["txt_net.gru.rnn.bias_ih_l0"], w["txt_net.gru.rnn.bias_hh_l0"]
        hid = w_hh.shape[1]
        steps = int(lens.max())
        gi = (self.q_out(x[:, :steps]) @ w_ih.T + b_ih)  # input products for every step
        h = x.new_zeros((x.shape[0], hid))
        total = x.new_zeros((x.shape[0], hid))
        for t in range(steps):
            gh = h @ w_hh.T + b_hh
            i_r, i_z, i_n = gi[:, t].split(hid, dim=1)
            h_r, h_z, h_n = gh.split(hid, dim=1)
            r, z = torch.sigmoid(i_r + h_r), torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = self.q_out((1.0 - z) * n + z * h)
            total = total + h * (t < lens).to(h.dtype)[:, None]
        return total / lens.clamp(min=1).to(h.dtype)[:, None]

    def _gate(self, prefix: str, locals_: Tensor) -> Tensor:
        b, length, dim = locals_.shape
        kernel, bias = self.w[prefix + ".gate_kernel"], self.w[prefix + ".gate_bias"]
        heads = kernel.shape[0]
        x = locals_.reshape(b, length, heads, dim // heads)
        logits = torch.einsum("blhd,hd->blh", x, kernel) + bias
        weights = torch.softmax(logits, dim=1)
        out = torch.einsum("blh,blhd->bhd", weights, x)
        return self.q_out(l2norm(out, eps=0.0))

    def _frame_pool(self, prefix: str, frames: Tensor, mask: Tensor) -> Tensor:
        logits = (frames @ self.w[prefix + ".gate.weight"].T)[..., 0] + self.w[prefix + ".gate.bias"]
        logits = torch.where(mask > 0, logits, torch.full_like(logits, -1e30))
        weights = torch.softmax(logits, dim=1)
        return self.q_out(l2norm(torch.sum(weights[..., None] * frames, dim=1), eps=0.0))

    def _tower(self, tower: str, side: Dict, inputs: Dict[str, Tensor], training: bool,
               gen: Optional[torch.Generator]) -> Tensor:
        cfg = self.cfg
        feats = list(side["features"])
        if side.get("frames"):
            fr = side["frames"]
            pooled = self._frame_pool(f"{tower}.frame_attn_{safe_name(fr['name'])}",
                                      inputs[fr["name"] + "@frames"], inputs[fr["name"] + "@mask"])
            inputs = {**inputs, fr["name"]: pooled}
            feats.append({"name": fr["name"], "dim": fr["dim"], "transform": False})
        locals_ = []
        for f in feats:
            name = f["name"]
            x = self._gru(inputs["rnn_ids"], inputs["rnn_len"]) if name == "rnn" else inputs[name]
            if tower == "vis_net" and training:
                noise = torch.randn(x.shape, generator=gen, device=x.device)
                x = torch.where(x.abs().sum() == 0, noise, x)
            if not f["transform"]:
                x = x.repeat(1, cfg["common_dim"] // x.shape[1])
            locals_.append(self._transform(f"{tower}.transform_{safe_name(name)}", x,
                                           f["transform"], training, gen))
        return self._gate(f"{tower}.attention", torch.stack(locals_, dim=1))

    def encode_txt(self, inputs, training=False, gen=None) -> Tensor:
        return self._tower("txt_net", self.cfg["text"], inputs, training, gen)

    def encode_vis(self, inputs, training=False, gen=None) -> Tensor:
        return self._tower("vis_net", self.cfg["video"], inputs, training, gen)


def triplet_multi_space(txt: Tensor, vis: Tensor, loss_cfg: Dict) -> Tensor:
    """The improved triplet loss per head of (B, H, d) embeddings, summed
    over heads: scores s[v, c] of video v against caption c; direction
    't2i' compares each positive s[i, i] with the other videos of its
    caption, keeps the hardest (max_violation) and sums over captions."""
    if (loss_cfg["direction"], loss_cfg["max_violation"], loss_cfg["cost_style"]) != (
            "t2i", True, "sum"):
        raise ValueError("the reference covers t2i, max_violation, sum")
    scores = torch.einsum("bhd,chd->hbc", l2norm(vis), l2norm(txt))
    n = scores.shape[-1]
    diag = torch.diagonal(scores, dim1=-2, dim2=-1)
    eye = torch.eye(n, dtype=torch.bool, device=scores.device)
    cost = torch.clamp(loss_cfg["margin"] + scores - diag[:, None, :], min=0.0)
    cost = torch.where(eye, torch.zeros((), device=scores.device), cost)
    return cost.amax(dim=-2).sum()


def flat_embeddings(embs: Tensor) -> Tensor:
    """(N, H, d) -> per-head normalized (N, H * d): the H-head mean of
    cosines is one dot product of these, divided by H."""
    n, h, d = embs.shape
    return l2norm(embs).reshape(n, h * d)


def parameter_count(cfg: Dict, bow_words: int, gru_words: int) -> int:
    """The parameters of the configuration's model with vocabularies of
    ``bow_words`` (bow) and ``gru_words`` (the GRU's embedding)."""
    common, heads = cfg["common_dim"], cfg["heads"]
    total = 0
    for side in (cfg["text"], cfg["video"]):
        for f in side["features"]:
            dim = bow_words if f["name"] == "bow" else f["dim"]
            total += (dim * common + common if f["transform"] else 0) + 2 * common
        total += heads * (common // heads) + heads  # the fusion gate
    gru = cfg["text"]["gru"]
    h, e = gru["hidden"], gru["we_dim"]
    total += gru_words * e + 3 * h * (e + h) + 6 * h
    frames = cfg["video"].get("frames")
    if frames:  # its gate's Linear(D, 1) and the pooled row's BatchNorm
        total += frames["dim"] + 1 + 2 * common
    return total
