"""AdamW + cosine schedule + global-norm clipping (the JAX package's
``optim/adamw.py``), as functions on a model's named parameters.

The optimizer state is an `AdamWState`: ``step`` (a 0-d int32 tensor) and
``mu``, ``nu`` (float32 tensors keyed by the model's parameter names).
`apply` updates the parameters and the state in place, under
`torch.no_grad`, with float32 arithmetic in the reference's order; a bf16
parameter is updated in float32 and rounded back, with no float32 master
copy, as the reference does. Decoupled weight decay falls on the leaves the
reference decays: those of two or more dims in its stacked layout
(`models.model.reference_ndim`), so every block's RMSNorm scale (stacked
(L, d)) is decayed, and ``ln_f`` (d,) and the hybrid's unstacked shared
block's norms are not. Nothing reads a tensor back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.model import reference_ndim


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW's hyperparameters and its warmup + cosine schedule."""

    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    """Steps taken (0-d int32) and the float32 moments by parameter
    name."""

    step: torch.Tensor
    mu: dict
    nu: dict


def _named(model) -> dict:
    return dict(model.named_parameters())


def init(model) -> AdamWState:
    """Zero moments for every parameter of `model`, on its device."""
    params = _named(model)
    device = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(), nu=zeros())


def decayed(model) -> list:
    """Names of the parameters weight decay falls on, as the reference
    picks its leaves: two or more dims in its stacked layout."""
    return [n for n, p in _named(model).items() if reference_ndim(n, p) >= 2]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor): linear warmup, then cosine
    decay to ``min_lr_ratio`` of ``lr``, in float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """The float32 l2 norm of every tensor of `tree` together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled so their global norm is at most `max_norm`, the
    norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g * scale for n, g in grads.items()}, norm


@torch.no_grad()
def apply(cfg: AdamWConfig, model, grads: dict, state: AdamWState):
    """One AdamW step on `model`'s parameters from `grads` (by parameter
    name): clip by the global norm, update the moments and then every
    parameter in place. Returns (model, state, {"grad_norm", "lr"})."""
    grads = {n: g.float() for n, g in grads.items()}
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    decay = set(decayed(model))
    for name, p in _named(model).items():
        g = grads[name]
        m = state.mu[name].mul_(b1).add_((1 - b1) * g)
        v = state.nu[name].mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if name in decay:       # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return model, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
