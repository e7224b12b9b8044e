"""Train step: loss -> grads (with microbatch accumulation) -> AdamW.

A copy of the JAX package's ``training/train_step.py`` for the text
decoder on one device.  ``make_train_step`` returns a function
``(state, batch) -> (state, metrics)`` like the JAX one; the state is
updated in place (see ``training/optimizer.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.config import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.training import optimizer as opt
from repro_torch.training import tree


class TrainState(NamedTuple):
    params: dict
    opt: opt.AdamWState


def init_train_state(model, gen: torch.Generator) -> TrainState:
    params = model.init(gen)
    return TrainState(params=params, opt=opt.init_adamw(params))


def make_loss_fn(model, cfg: ModelConfig) -> Callable:
    """Mean next-token cross entropy of a {"tokens", "labels"} batch (the
    text path; the model refuses encoder-decoder and vision configs)."""
    def loss_fn(params, batch):
        return model.loss(params, batch["tokens"], batch["labels"])
    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


def make_train_step(model, cfg: ModelConfig, parallel: ParallelConfig,
                    train_cfg: TrainConfig) -> Callable:
    loss_fn = make_loss_fn(model, cfg)
    n_micro = parallel.microbatches

    def train_step(state: TrainState, batch: dict):
        if n_micro <= 1:
            loss, grads = _value_and_grad(loss_fn, state.params, batch)
        else:
            # microbatch i is rows [i*mb, (i+1)*mb) of every batch array,
            # the JAX package's reshape((n_micro, B // n_micro) + ...)
            mb = next(iter(batch.values())).shape[0] // n_micro
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree.leaves(state.params)]
            for i in range(n_micro):
                micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                l, g = _value_and_grad(loss_fn, state.params, micro)
                loss = loss + l
                grads = [a + b for a, b in zip(grads, g)]
            loss = loss / n_micro
            grads = [g / n_micro for g in grads]
        grads = tree.unflatten(state.params, list(grads))
        params, opt_state, om = opt.adamw_update(
            grads, state.opt, state.params, train_cfg)
        return TrainState(params=params, opt=opt_state), {"loss": loss, **om}

    return train_step
