"""The trainer's optimizer and LR control, as ``laff_tpu.engine.trainer``
has them (``make_optimizer``, ``LRController``).

``OptaxChain`` is the optax chain ``clip_by_global_norm(grad_clip)`` then
``adam(lr, eps=1e-4)`` or ``rmsprop(lr)``, with optax's formulas where they
differ from ``torch.optim``:

* clip: updates are ``g / norm * max_norm`` only when ``norm >= max_norm``
  (``clip_grad_norm_`` divides by ``norm + 1e-6`` whatever the norm);
* adam: ``m_hat / (sqrt(v_hat) + eps)`` with eps 1e-4, bias correction by
  a step count that a skipped step does not advance;
* rmsprop: decay 0.9 and ``g * rsqrt(nu + 1e-8)``, eps *inside* the root,
  ``nu`` from 0, no bias correction (``torch.optim.RMSprop`` has alpha
  0.99 and eps outside the root).

``scaled`` parameters (an in-graph BERT tower, ``laff_tpu``'s
``optax.masked(optax.scale(1 / 20))`` after the optimizer, the reference's
backbone learning rate of lr/20) have their updates multiplied by
``scale``: the clip still takes the global norm of every gradient. The
scaled parameters are contiguous runs of the flat buffers (a submodule's
parameters are), so the scale is an in-place multiply of those slices: no
host sync and no extra buffer, and a CUDA graph of the step keeps it.

With ``skip_nonfinite`` (the bf16 towers) a step whose gradients are not
all finite leaves the parameters, the moments and the count as they were.
Every gradient lives in one flat f32 buffer (``p.grad`` is a view of it),
so the finite check, the clip and the update are a few whole-buffer ops on
the card, and the step never waits for the host. The state tensors (count,
moments, learning rate) are updated in place, never rebound, so a CUDA
graph captured over a step keeps reading and writing the live state.

Under data parallelism (``mesh``) each rank's gradients are its rows'
share; one all-reduce of the flat buffer sums them before the finite check
and the clip, so every rank takes the same step.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-4
_RMS_DECAY, _RMS_EPS = 0.9, 1e-8
OPTIMIZERS = ("adam", "rmsprop")
BACKBONE_SCALE = 1.0 / 20.0  # the reference's backbone lr/20 (model/model.py:2013-2020)
BACKBONE_PREFIX = "txt_net.bert."  # the in-graph BERT tower's parameters


class OptaxChain:
    def __init__(self, params: Iterable[torch.nn.Parameter], kind: str, lr: float,
                 grad_clip: float = 0.0, skip_nonfinite: bool = False,
                 scaled: Iterable[torch.nn.Parameter] = (), scale: float = 1.0,
                 mesh=None) -> None:
        if kind not in OPTIMIZERS:
            raise ValueError(f"optimizer {kind!r} is not one of {OPTIMIZERS}")
        self.kind = kind
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip = float(grad_clip or 0.0)
        self.skip_nonfinite = skip_nonfinite
        device = self.params[0].device
        sizes = [p.numel() for p in self.params]
        self.grad = torch.zeros(sum(sizes), device=device)
        self._update = torch.empty_like(self.grad)
        self._update_views = []
        for p, g, u in zip(self.params, self.grad.split(sizes), self._update.split(sizes)):
            p.grad = g.view_as(p)
            self._update_views.append(u.view_as(p))
        self.lr = torch.zeros((), device=device)
        self.lr.fill_(lr)
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = torch.zeros_like(self.grad) if kind == "adam" else None
        self.nu = torch.zeros_like(self.grad)
        self.scale = float(scale)
        self.scaled_segments = _segments(self.params, sizes, {id(p) for p in scaled})
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None

    def set_learning_rate(self, lr: float) -> None:
        self.lr.fill_(lr)

    def zero_grad(self) -> None:
        self.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        g = self.grad
        if self.mesh is not None:
            self.mesh.all_reduce(g)
        finite = torch.isfinite(g).all() if self.skip_nonfinite else None
        if self.grad_clip > 0:
            norm = torch.linalg.vector_norm(g)
            trigger = norm < self.grad_clip
            one = torch.ones((), device=g.device)
            # g / 1 * 1 below the limit, g / norm * max_norm at or above it
            g = g / torch.where(trigger, one, norm) * torch.where(trigger, one,
                                                                 one * self.grad_clip)
        count = self.count + 1
        if self.kind == "adam":
            mu = torch.add(g * (1.0 - _B1), self.mu, alpha=_B1)
            nu = torch.add(g * g * (1.0 - _B2), self.nu, alpha=_B2)
            mu_hat = mu / (1.0 - torch.pow(_B1, count))
            nu_hat = nu / (1.0 - torch.pow(_B2, count))
            update = mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)
        else:
            mu = None
            nu = torch.add(g * g * (1.0 - _RMS_DECAY), self.nu, alpha=_RMS_DECAY)
            update = torch.rsqrt(nu + _RMS_EPS) * g
        torch.mul(update, -self.lr, out=self._update)
        for start, stop in self.scaled_segments:
            self._update[start:stop].mul_(self.scale)
        if finite is not None:
            torch.where(finite, self._update, torch.zeros((), device=g.device),
                        out=self._update)
            count = torch.where(finite, count, self.count)
            nu = torch.where(finite, nu, self.nu)
            if mu is not None:
                mu = torch.where(finite, mu, self.mu)
        torch._foreach_add_(self.params, self._update_views)
        # in place: a captured CUDA graph writes the tensors it saw
        self.count.copy_(count)
        self.nu.copy_(nu)
        if mu is not None:
            self.mu.copy_(mu)

    def state_dict(self) -> Dict:
        # copies: the live tensors change in place with every step
        out = {"kind": self.kind, "lr": self.lr.to("cpu", copy=True),
               "count": self.count.to("cpu", copy=True), "nu": self.nu.to("cpu", copy=True)}
        if self.mu is not None:
            out["mu"] = self.mu.to("cpu", copy=True)
        return out

    def load_state_dict(self, state: Dict) -> None:
        if state["kind"] != self.kind:
            raise ValueError(f"optimizer state of {state['kind']!r}, not {self.kind!r}")
        self.lr.copy_(state["lr"])
        self.count.copy_(state["count"])
        self.nu.copy_(state["nu"])
        if self.mu is not None:
            self.mu.copy_(state["mu"])


def _segments(params: List[torch.nn.Parameter], sizes: List[int],
              scaled: set) -> List[Tuple[int, int]]:
    """[start, stop) runs of the flat buffers that hold the ``scaled``
    parameters, adjacent runs merged."""
    out: List[Tuple[int, int]] = []
    offset = 0
    for p, n in zip(params, sizes):
        if id(p) in scaled:
            if out and out[-1][1] == offset:
                out[-1] = (out[-1][0], offset + n)
            else:
                out.append((offset, offset + n))
        offset += n
    return out


def make_optimizer(config, model: torch.nn.Module, bf16: bool = False,
                   mesh=None) -> OptaxChain:
    """The optax chain of ``laff_tpu.engine.trainer.make_optimizer`` over the
    model's parameters: an in-graph BERT tower's updates (``BACKBONE_PREFIX``)
    scaled by 1/20; ``bf16`` turns on the finite-gradient skip; ``mesh``
    sums the gradients over a data-parallel group."""
    backbone = [p for name, p in model.named_parameters() if name.startswith(BACKBONE_PREFIX)]
    return OptaxChain(model.parameters(), config.optimizer, config.lr,
                      grad_clip=getattr(config, "grad_clip", 0) or 0, skip_nonfinite=bf16,
                      scaled=backbone, scale=BACKBONE_SCALE, mesh=mesh)


class LRController:
    """StepLR(gamma, per epoch) x ReduceLROnPlateau(max, 0.5, patience 2)
    (reference ``model/model.py:2026-2028`` + ``lr_step``)."""

    def __init__(self, base_lr: float, gamma: float, plateau_factor: float = 0.5,
                 patience: int = 2) -> None:
        self.base_lr = base_lr
        self.gamma = gamma
        self.plateau_factor = plateau_factor
        self.patience = patience
        self.plateau_scale = 1.0
        self.best = -float("inf")
        self.bad_epochs = 0
        self.epoch = 0

    def current(self) -> float:
        return self.base_lr * (self.gamma ** self.epoch) * self.plateau_scale

    def step(self, val_metric: float) -> float:
        self.epoch += 1
        if val_metric > self.best:
            self.best = val_metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.plateau_scale *= self.plateau_factor
                self.bad_epochs = 0
        return self.current()
