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
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.config import TrainConfig
from repro_torch.sharding.collectives import all_reduce
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


def global_norm(grads, groups: Optional[Sequence] = None) -> torch.Tensor:
    """The L2 norm of every leaf of ``grads``.  On a mesh each rank holds
    pieces of the sharded leaves: ``groups`` names, per leaf in tree
    order, the process group its pieces are spread over (None where the
    rank holds it whole).  Each group's squared sums are all-reduced over
    it once, so a replicated leaf counts once, not once a rank."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    if groups is None:
        return torch.sqrt(torch.sum(torch.stack(sums)))
    buckets: dict = {}                 # group -> squared sums, first seen
    for s, group in zip(sums, groups, strict=True):
        buckets.setdefault(group, []).append(s)
    total = []
    for group, part in buckets.items():
        t = torch.sum(torch.stack(part))
        if group is not None:
            all_reduce(t, group)
        total.append(t)
    return torch.sqrt(torch.sum(torch.stack(total)))


def clip_scale(grads, max_norm: float,
               groups: Optional[Sequence] = None):
    """(the factor ``clip_by_global_norm`` scales every gradient by, the
    global norm)."""
    norm = global_norm(grads, groups)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


# AdamW is elementwise: a leaf of more elements updates in pieces of this
# many, so that its float32 temporaries stay small (a 152064 x 8192
# embedding table's would take ~25 GB at once)
UPDATE_CHUNK = 1 << 26


def _pieces(*leaves) -> list:
    """Matching flat pieces of same-shaped leaves, each viewing its leaf
    (in-place writes land in it); the leaves whole where one is not
    contiguous."""
    if leaves[0].numel() <= UPDATE_CHUNK or not all(
            t.is_contiguous() for t in leaves):
        return [leaves]
    return list(zip(*(t.view(-1).split(UPDATE_CHUNK) for t in leaves)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: TrainConfig,
                 groups: Optional[Sequence] = None):
    """One AdamW step; ``params``, ``state.mu`` and ``state.nu`` are
    updated in place and returned.  Returns (params, state, metrics).
    ``groups``: the sharded leaves' groups, as ``global_norm`` takes them
    (AdamW itself is elementwise: it runs on each rank's pieces)."""
    scale, gnorm = clip_scale(grads, cfg.grad_clip, groups)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for leaf in zip(*(tree.leaves(t) for t in
                      (params, grads, state.mu, state.nu))):
        for p, g, mu, nu in _pieces(*leaf):
            # clip_by_global_norm's g * scale in g's dtype, then float32
            gf = (g * scale.to(g.dtype)).float()
            mu.mul_(b1).add_((1 - b1) * gf)
            nu.mul_(b2).add_((1 - b2) * gf * gf)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            upd = upd + wd * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"lr": lr, "grad_norm": gnorm}
