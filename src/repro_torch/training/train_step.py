"""Train step: loss -> grads (with microbatch accumulation) -> AdamW.

A copy of the JAX package's ``training/train_step.py`` for the text
decoder, the encoder-decoder and the vision stub.  ``make_train_step``
returns a function ``(state, batch) -> (state, metrics)`` like the JAX
one; the state is updated in place (see ``training/optimizer.py``).

On one device the step is the JAX step's arithmetic.  Under a training
mesh (``sharding.rules.axis_rules(mesh=...)`` active when the step is
made) it computes what the JAX step computes under GSPMD on that mesh,
one process a rank (``launch/mesh.py``):

* the state holds this rank's pieces of every leaf
  (``init_train_state`` draws the whole tree and keeps them);
* every rank receives the same global batch; microbatch ``i`` is global
  rows ``[i*mb, (i+1)*mb)`` (``mb = B / microbatches``), of which DP rank
  ``d`` takes ``[i*mb + d*mb/dp, i*mb + (d+1)*mb/dp)`` and model rank
  ``m`` sequence rows ``[m*S/model, (m+1)*S/model)`` -- along dims 1 and
  2 of M-RoPE's (3, B, S) positions (JAX's reshape splits their t/h/w
  axis instead: ROADMAP Queue 3), and frames ``[m*F/model,
  (m+1)*F/model)`` of an encoder-decoder's (B, F, D) ``enc_embeds``;
* each rank's loss is its share of the microbatch's global mean
  (``LM.loss``); the gathers' backward sums the model axis into each
  rank's pieces, and every gradient is then summed over the mesh axes its
  leaf is not sharded over -- the whole mesh for a replicated leaf;
* the gradient norm is the whole gradient's (``optimizer.global_norm``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.config import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (axis_rules, current_mesh, flatten,
                                        is_spec, shard_index, shard_of,
                                        spec_axes)
from repro_torch.training import optimizer as opt
from repro_torch.training import tree


class TrainState(NamedTuple):
    params: dict
    opt: opt.AdamWState


def state_specs(param_specs: dict) -> TrainState:
    """The spec tree of a ``TrainState`` whose params have
    ``param_specs``: the moments shard as the params, the step counter is
    whole."""
    return TrainState(params=param_specs,
                      opt=opt.AdamWState(step=(), mu=param_specs,
                                         nu=param_specs))


def init_train_state(model, gen: torch.Generator) -> TrainState:
    """Fresh parameters from ``gen`` and zero moments.  Under an active
    mesh every rank draws the whole tree and keeps its pieces, as JAX's
    init followed by ``device_put`` does."""
    params = model.init(gen)
    mesh = current_mesh()
    if mesh is not None and mesh.world > 1:
        specs = model.param_specs(mesh)
        leaves = tree.leaves(params)
        pieces = [shard_of(t, s, mesh)
                  for t, s in zip(leaves, flatten(specs, is_spec),
                                  strict=True)]
        del leaves
        params = tree.unflatten(params, pieces)
    return TrainState(params=params, opt=opt.init_adamw(params))


def make_loss_fn(model, cfg: ModelConfig) -> Callable:
    """Mean next-token cross entropy of a {"tokens", "labels"} batch; for
    an encoder-decoder of an {"enc_embeds", "tokens", "labels"} batch, for
    the vision stub of an {"inputs_embeds", "positions", "labels"} batch
    (positions optional: by default each row's index)."""
    def loss_fn(params, batch):
        if cfg.is_encoder_decoder:
            return model.loss(params, batch["enc_embeds"], batch["tokens"],
                              batch["labels"])
        if cfg.modality == "vision_stub":
            return model.loss(params, None, batch["labels"],
                              inputs_embeds=batch["inputs_embeds"],
                              positions=batch.get("positions"))
        return model.loss(params, batch["tokens"], batch["labels"])
    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(loss, the gradient of every leaf); a leaf the loss never reads
    (a vision batch's token table) gets zeros, as ``jax.grad`` gives
    it."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _accumulate(loss_fn, params, micro, device):
    """(mean loss, mean grads) over the microbatches ``micro``; one
    microbatch passes its grads through as they are."""
    if len(micro) == 1:
        return _value_and_grad(loss_fn, params, micro[0])
    loss = torch.zeros((), dtype=torch.float32, device=device)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree.leaves(params)]
    for mb in micro:
        l, g = _value_and_grad(loss_fn, params, mb)
        loss = loss + l
        grads = [a + b for a, b in zip(grads, g)]
    return loss / len(micro), [g / len(micro) for g in grads]


def _axes(key: str) -> tuple:
    """The (batch, sequence) dims of a batch array: M-RoPE's positions
    are (3, B, S), every other array (B, S, ...)."""
    return (1, 2) if key == "positions" else (0, 1)


def _rows(x: torch.Tensor, key: str, rows: slice,
          cols: slice = slice(None)) -> torch.Tensor:
    """``x``'s batch rows ``rows`` and sequence positions ``cols``."""
    bd, sd = _axes(key)
    return x.narrow(bd, rows.start, rows.stop - rows.start)[
        (slice(None),) * sd + (cols,)]


def microbatches(batch: dict, n_micro: int) -> list:
    """Microbatch i: rows [i*mb, (i+1)*mb) of every batch array along its
    batch dim (``_axes``), the JAX package's reshape((n_micro, B //
    n_micro) + ...) for (B, ...) arrays."""
    mb = batch["labels"].shape[0] // n_micro
    return [{k: _rows(x, k, slice(i * mb, (i + 1) * mb))
             for k, x in batch.items()} for i in range(n_micro)]


def rank_rows(batch: dict, mesh, n_micro: int) -> list:
    """This rank's pieces of every microbatch of a global batch (rows as
    the module docstring says; an encoder-decoder's ``enc_embeds`` split
    along its own frame dim over the model axis, beside the tokens).
    Raises ValueError naming the shapes when the batch, its microbatches,
    the sequence or the frames do not split evenly."""
    b, s = batch["labels"].shape[:2]
    dp_axes = tuple(a for a in mesh.axis_names if a != "model")
    d, dp = shard_index(dp_axes, mesh, mesh.coords)
    m, n_model = shard_index(("model",) if "model" in mesh.axis_names
                             else (), mesh, mesh.coords)
    if b % n_micro or (b // n_micro) % dp or s % n_model:
        raise ValueError(
            f"batch {b} x seq {s} does not split over {n_micro} "
            f"microbatches x dp={dp} rows and model={n_model} sequence "
            "pieces: the batch must be a multiple of microbatches * dp and "
            "the sequence of model")
    frames = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
    if frames % n_model:
        raise ValueError(
            f"{frames} frames of enc_embeds and {s} tokens: both must "
            f"split into model={n_model} sequence pieces")
    mb = b // n_micro
    rows = mb // dp

    def cols(key: str) -> slice:
        n = (frames if key == "enc_embeds" else s) // n_model
        return slice(m * n, (m + 1) * n)
    return [{k: _rows(x, k, slice(i * mb + d * rows, i * mb + (d + 1) * rows),
                      cols(k))
             for k, x in batch.items()} for i in range(n_micro)]


def make_train_step(model, cfg: ModelConfig, parallel: ParallelConfig,
                    train_cfg: TrainConfig) -> Callable:
    """The step on one device, or -- with a mesh of more than one rank
    active here -- this rank's step on that mesh (module docstring)."""
    loss_fn = make_loss_fn(model, cfg)
    n_micro = parallel.microbatches
    mesh = current_mesh()
    if mesh is None or mesh.world == 1:
        def train_step(state: TrainState, batch: dict):
            micro = microbatches(batch, n_micro)
            loss, grads = _accumulate(loss_fn, state.params, micro,
                                      model.device)
            grads = tree.unflatten(state.params, list(grads))
            params, opt_state, om = opt.adamw_update(
                grads, state.opt, state.params, train_cfg)
            return TrainState(params=params, opt=opt_state), \
                {"loss": loss, **om}
        return train_step

    specs = flatten(model.param_specs(mesh), is_spec)
    # per leaf: the group its pieces spread over (the norm), and the group
    # of the axes it is not sharded over (its gradient's sum)
    shard_groups = [mesh.group(spec_axes(s)) for s in specs]
    sum_groups = [mesh.group(tuple(a for a in mesh.axis_names
                                   if a not in spec_axes(s)))
                  for s in specs]
    world = mesh.group(mesh.axis_names)

    def train_step(state: TrainState, batch: dict):
        with axis_rules(mesh=mesh):
            micro = rank_rows(batch, mesh, n_micro)
            loss, grads = _accumulate(loss_fn, state.params, micro,
                                      model.device)
            grads = [C.all_reduce(g, grp)
                     for g, grp in zip(grads, sum_groups)]
            loss = C.all_reduce(loss, world)
            grads = tree.unflatten(state.params, grads)
            params, opt_state, om = opt.adamw_update(
                grads, state.opt, state.params, train_cfg, shard_groups)
        return TrainState(params=params, opt=opt_state), {"loss": loss, **om}

    return train_step
