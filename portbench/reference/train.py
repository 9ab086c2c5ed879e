"""The reference's training steps: the towers in training mode, the
improved triplet loss per head, the gradient by autograd, then optax's
chain as the LAFF trainer configures it: the gradient clipped to a global
norm (g / norm * max when the norm reaches max), then Adam (b1, b2, eps
added to the root of the corrected second moment, bias correction by a
step count), a step with a gradient that is not finite skipped whole.

``fault`` plants one of the faults the benchmark's check must catch in
the reference put in the program's place: 'half_batch' takes the loss of
the first half of each batch only, times two (the mean over the rest)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .model import ReferenceModel, triplet_multi_space

Tensor = torch.Tensor
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_param(name: str) -> bool:
    return not name.endswith(BUFFERS)


def running_stats(buffers: Dict[str, Tensor], batch: Dict[str, tuple],
                  momentum: float) -> Dict[str, Tensor]:
    """The running mean and variance after one training forward: each moves
    ``momentum`` of the way to the batch's statistics."""
    out = {}
    for prefix, (mean, var) in batch.items():
        rm, rv = buffers[prefix + ".running_mean"], buffers[prefix + ".running_var"]
        out[prefix + ".running_mean"] = (1.0 - momentum) * rm + momentum * mean
        out[prefix + ".running_var"] = (1.0 - momentum) * rv + momentum * var
    return out


def train_steps(cfg: Dict, weights: Dict[str, Tensor], batches: List[Tuple[Dict, Dict]],
                gen_seed: int, precision: str = "f32", fault: Optional[str] = None) -> Dict:
    """Steps over ``batches`` ((text inputs, video inputs) on the device)
    from ``weights``, dropout and noise drawn from a generator on the
    weights' device seeded with ``gen_seed``. Returns {'losses': [float],
    'grad1': {name: the first step's gradient as the optimizer takes it,
    clipped}, 'stats': {name: the BatchNorm running statistics after the
    last step}, 'params': {name: the parameters after the last step}}."""
    oc = cfg["optimizer"]
    device = next(iter(weights.values())).device
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if is_param(k)}
    buffers = {k: v for k, v in weights.items() if not is_param(k)}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count = 0
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    out = {"losses": [], "grad1": None}
    for txt_in, vis_in in batches:
        model = ReferenceModel(cfg, {**buffers, **params}, precision)
        txt = model.encode_txt(txt_in, training=True, gen=gen)
        vis = model.encode_vis(vis_in, training=True, gen=gen)
        if fault == "half_batch":
            half = txt.shape[0] // 2
            loss = 2.0 * triplet_multi_space(txt[:half], vis[:half], cfg["loss"])
        else:
            loss = triplet_multi_space(txt, vis, cfg["loss"])
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p))
                 for (k, p), g in zip(params.items(), grads)}
        out["losses"].append(float(loss.detach()))
        buffers = {**buffers, **running_stats(buffers, model.batch_stats, cfg["bn_momentum"])}
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            finite = bool(torch.isfinite(norm)) or not oc["skip_nonfinite"]
            if oc["grad_clip"] > 0 and float(norm) >= oc["grad_clip"]:
                grads = {k: g / norm * oc["grad_clip"] for k, g in grads.items()}
            if out["grad1"] is None:
                out["grad1"] = {k: g.clone() for k, g in grads.items()}
            if not finite:
                continue
            count += 1
            b1, b2, eps, lr = oc["b1"], oc["b2"], oc["eps"], oc["lr"]
            for k, p in params.items():
                g = grads[k]
                mu[k] = b1 * mu[k] + (1.0 - b1) * g
                nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
                m_hat = mu[k] / (1.0 - b1 ** count)
                v_hat = nu[k] / (1.0 - b2 ** count)
                p -= lr * m_hat / (torch.sqrt(v_hat) + eps)
    out["params"] = {k: p.detach() for k, p in params.items()}
    out["stats"] = {k: v for k, v in buffers.items() if k.endswith(("running_mean", "running_var"))}
    return out
