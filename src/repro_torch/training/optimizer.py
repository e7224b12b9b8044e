"""AdamW with global-norm clipping and a warmup+cosine schedule.

Written out in tensor code (not ``torch.optim``) so that it matches the
JAX package's ``adamw_update`` term for term: f32 moments, the step
incremented before the rate is read, the update computed in f32 and cast
back to the parameter dtype.  Unlike the JAX version it updates params,
mu and nu IN PLACE: the train step owns the only reference (JAX donated
the old state to the jitted step), and a second copy of 1B parameters'
f32 moments would cost 8.6 GB.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.training import tree


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: dict
    nu: dict


def init_adamw(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree.tree_map(zeros, params), nu=tree.tree_map(zeros, params))


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(grads) -> torch.Tensor:
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: TrainConfig):
    """One AdamW step; ``params``, ``state.mu`` and ``state.nu`` are
    updated in place and returned.  Returns (params, state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, mu, nu in zip(*(tree.leaves(t) for t in
                              (params, grads, state.mu, state.nu))):
        gf = g.float()
        mu.mul_(b1).add_((1 - b1) * gf)
        nu.mul_(b2).add_((1 - b2) * gf * gf)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        upd = upd + wd * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"lr": lr, "grad_norm": gnorm}
