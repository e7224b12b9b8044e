"""The dry run: how many bytes one rank holds, for every (architecture x
input shape) cell on the production meshes, and what it moves.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]

The port of the JAX package's ``launch/dryrun.py``.  JAX lowers each cell
on 512 fake devices and reads XLA's memory analysis; the port has no
compiler to ask, so it builds the rank's pieces themselves, on the meta
device (shapes and dtypes, no storage), through the code that allocates
them on a card: ``init()`` with no generator, ``shard_of`` of each leaf
under the rule table (``param_sharding_tree``),
``training/optimizer.init_adamw`` of the pieces, ``init_cache`` under
``axis_rules(mesh=...)`` (the rank's slice of every cache leaf) and the
batch's piece under ``specs.batch_logical``.  The meshes are JAX's: 16 x
16 ``("data", "model")`` and 2 x 16 x 16 ``("pod", "data", "model")``
(``launch/mesh.make_production_mesh``).  Nothing runs and no process
group is made.

A record per cell (``results/dryrun_torch/<cell>.json``) holds JAX's
keys where they mean the same: ``memory.argument_bytes`` is what JAX
counts as the step's arguments -- the rank's parameters, AdamW moments
and step and batch for ``train``; parameters and batch for ``prefill``;
parameters, token, cache and the ``pos`` scalar for ``decode`` -- beside
each part.  ``memory.activation_bytes_estimate`` is a stated formula
(``activation_estimate``), NOT held to XLA's ``temp_bytes``.
``collectives`` counts what one step of the port's own code issues on
the rank (``collective_counts``), as ``sharding/collectives.COUNTS`` and
``core/tiled_allreduce.COUNTS`` tally them.  ``roofline`` is
``analysis/roofline.roofline_terms`` of the model's FLOPs over the
devices, the argument bytes read once and the collective bytes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.analysis.flops import (attention_flops, model_flops,
                                        param_count)
from repro_torch.analysis.roofline import Cost, roofline_terms
from repro_torch.config import (SHAPES, ModelConfig, ShapeConfig,
                                get_model_config)
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.device import torch_dtype
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     parallel_for_mesh)
from repro_torch.layers import ssm
from repro_torch.models import blocks as B
from repro_torch.models import build_model
from repro_torch.sharding.rules import (axis_rules, entry_axes, flatten,
                                        is_spec, param_sharding_tree,
                                        shard_of, spec_axes)
from repro_torch.training import optimizer as opt
from repro_torch.training import tree

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
# one H100's memory, as the "80 GB" of its name
H100_BYTES = 80e9


def skip_reason(arch: str, shape_name: str) -> str:
    """The JAX package's documented cell skips."""
    cfg = get_model_config(arch)
    if shape_name == "long_500k" and not cfg.is_subquadratic():
        return ("long_500k needs sub-quadratic attention; "
                f"{arch} has full/global attention layers")
    return ""


@dataclass
class Cell:
    """One rank's pieces of a cell, on the meta device."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    model: Any
    whole: dict                 # the whole parameter tree
    params: dict                # the rank's pieces of it
    opt: Optional[opt.AdamWState]
    batch: dict                 # the rank's pieces of the batch
    token: Optional[torch.Tensor]
    cache: Any
    pos: Optional[torch.Tensor]


def _config(arch: Union[str, ModelConfig]) -> ModelConfig:
    return get_model_config(arch) if isinstance(arch, str) else arch


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch: Union[str, ModelConfig],
               shape: Union[str, ShapeConfig], mesh: Mesh,
               rank: int = 0) -> Cell:
    """Rank ``rank``'s pieces of a cell under ``mesh``'s axes: its
    parameters (``shard_of`` of the meta leaves), for ``train`` their
    AdamW state (float32 moments, as JAX's ``init_adamw``), its piece of
    the batch, and for ``decode`` its piece of the token, its slice of
    every cache leaf and the position."""
    cfg, shape = _config(arch), _shape(shape)
    if rank != mesh.rank:
        mesh = Mesh(mesh.axis_names, mesh.sizes, rank)
    model = build_model(cfg, "meta", parallel_for_mesh(mesh))
    with axis_rules(mesh=mesh):
        whole = S.abstract_params(model)
        specs = flatten(model.param_specs(mesh), is_spec)
        params = tree.unflatten(whole, [
            shard_of(t, s, mesh)
            for t, s in zip(tree.leaves(whole), specs, strict=True)])
        state = opt.init_adamw(params) if shape.kind == "train" else None
        token = cache = pos = None
        batch: dict = {}
        if shape.kind == "decode":
            token, cache, pos = S.decode_specs(cfg, shape, model)
            token = shard_of(token, param_sharding_tree(
                (("batch",), (shape.global_batch,)), mesh), mesh)
        else:
            whole_batch = S.batch_specs(cfg, shape)
            bspec = param_sharding_tree(S.batch_logical(cfg, shape), mesh)
            batch = {k: shard_of(v, bspec[k], mesh)
                     for k, v in whole_batch.items()
                     if shape.kind == "train" or k != "labels"}
    return Cell(cfg, shape, mesh, model, whole, params, state, batch, token,
                cache, pos)


def tree_bytes(*trees) -> int:
    """Bytes of every tensor of ``trees``, each storage counted once (an
    encoder-decoder's zero cross K/V is one tensor for every layer)."""
    seen, total = set(), 0
    for t in trees:
        for leaf in tree.leaves(t) if t is not None else ():
            if id(leaf) not in seen:
                seen.add(id(leaf))
                total += leaf.numel() * leaf.element_size()
    return total


def memory(cell: Cell) -> dict:
    """The rank's bytes: JAX's ``argument_bytes`` and its parts."""
    p = tree_bytes(cell.params)
    o = tree_bytes(cell.opt)
    b = tree_bytes(cell.batch, cell.token, cell.pos)
    c = tree_bytes(cell.cache)
    return {"argument_bytes": p + o + b + c, "param_bytes": p,
            "opt_bytes": o, "batch_bytes": b, "cache_bytes": c,
            "activation_bytes_estimate": activation_estimate(cell)}


# ---------------------------------------------------------------------------
# the rank's split of the step's rows, and what the port's step refuses
# ---------------------------------------------------------------------------

def _split(cell: Cell) -> dict:
    """The rank's rows and positions: ``b`` of the batch (every row where
    dp does not divide it), ``s`` of the sequence (a training or prefill
    step's S / model; a decode step's one), ``f`` of an encoder's frames,
    ``n`` the model axis, ``act`` the activations' bytes an element."""
    mesh, shape, cfg = cell.mesh, cell.shape, cell.cfg
    n = mesh.shape.get("model", 1)
    dp = mesh.world // n
    b = shape.global_batch
    b = b // dp if b % dp == 0 else b
    one = shape.kind == "decode"
    return {"n": n, "b": b, "s": 1 if one else shape.seq_len // n,
            "seq": shape.seq_len, "f": cfg.encoder_seq // n,
            "act": torch_dtype(cfg.dtype).itemsize}


def refused(cell: Cell) -> str:
    """Why the port's step would refuse the cell on this mesh ("" where it
    runs it): a training or prefill step splits the sequence, and an
    encoder-decoder's frames, over the model axis
    (``training/train_step.rank_rows``), and a training batch over dp."""
    mesh, shape, cfg = cell.mesh, cell.shape, cell.cfg
    n = mesh.shape.get("model", 1)
    if shape.kind == "decode":
        return ""
    if shape.seq_len % n:
        return f"{shape.seq_len} positions do not split over model={n}"
    if cfg.is_encoder_decoder and cfg.encoder_seq % n:
        return (f"{cfg.encoder_seq} frames of enc_embeds do not split over "
                f"model={n} (training/train_step.rank_rows)")
    dp = mesh.world // n
    if shape.kind == "train" and shape.global_batch % dp:
        return f"a batch of {shape.global_batch} does not split over dp={dp}"
    return ""


# ---------------------------------------------------------------------------
# collectives: what one step of the port's code issues on the rank
# ---------------------------------------------------------------------------

class _Events:
    """The collectives of a forward pass in order, each with the
    collective its backward issues: ("all_gather" | "reduce_scatter" |
    "all_reduce", bytes in, backward op or None, its bytes in, whether a
    block's checkpoint recomputes it).  A block's last collective whose
    output no later operation of the block saves for its backward (a
    MoE FFN's or an mLSTM / sLSTM cell's reduce-scatter, added straight
    to the residual) is not recomputed: the non-reentrant checkpoint
    stops its recompute at the last tensor the backward needs."""

    def __init__(self):
        self.items: list = []
        self.merges: list = []          # core/tiled_allreduce's

    def gather(self, nbytes: int, g: int, block: bool,
               grad: bool = True) -> None:
        """An all-gather over ``g`` ranks of ``nbytes`` (its gradient a
        reduce-scatter of the whole); nothing over one rank."""
        if g > 1:
            self.items.append(("all_gather", nbytes,
                               "reduce_scatter" if grad else None,
                               nbytes * g, block))

    def scatter(self, nbytes: int, g: int, block: bool) -> None:
        """A reduce-scatter over ``g`` ranks of ``nbytes`` (its gradient
        an all-gather of the piece); ``block`` False for a block's last
        collective (the recompute stops before it)."""
        if g > 1:
            self.items.append(("reduce_scatter", nbytes, "all_gather",
                               nbytes // g, block))

    def all_reduce(self, nbytes: int, block: bool = False) -> None:
        self.items.append(("all_reduce", nbytes, None, 0, block))

    def leaves(self, pieces, specs, mesh, block: bool,
               skip: Callable[[str], bool] = lambda path: False,
               unused: tuple = ()) -> None:
        """``collectives.gather_tree``: each sharded dim of each leaf of
        ``pieces`` (whose spec tree is ``specs``) gathered in turn, but
        the leaves at the paths ``skip`` names; those at ``unused``
        paths get no gradient (nothing reduce-scatters it)."""
        flat = flatten(specs, is_spec)
        for (path, t), spec in zip(tree.leaves_with_paths(pieces), flat,
                                   strict=True):
            if skip(path):
                continue
            shape = list(t.shape)
            for dim, entry in enumerate(spec):
                axes = entry_axes(entry)
                g = mesh.size(axes) if axes else 1
                self.gather(math.prod(shape) * t.element_size(), g, block,
                            path not in unused)
                shape[dim] *= g


def _local_skip(cfg, kind: str, spec: dict, n: int, decode: bool):
    """The paths of a block's leaves that ``models/lm._block_leaves``
    leaves ungathered (``blocks.local_leaves``)."""
    local = B.local_leaves(cfg, kind, spec, n, decode)
    return lambda path: any(path == f"/{sub}/{k}"
                            for sub, keys in local.items() for k in keys)


def _attention(ev: _Events, cfg, sp: dict, kv_rows: int) -> None:
    """Context-parallel attention (``layers/attention.apply_attention``):
    K and V of the rank's ``kv_rows`` gathered along the sequence over
    the model axis."""
    nbytes = sp["b"] * kv_rows * cfg.kv_dim * sp["act"]
    ev.gather(nbytes, sp["n"], True)
    ev.gather(nbytes, sp["n"], True)


def _moe(ev: _Events, cfg, spec: dict, sp: dict) -> None:
    """``blocks._moe_ffn`` in a training or prefill step."""
    n = sp["n"]
    if n == 1:
        return
    rows = sp["b"] * sp["s"] * cfg.d_model * sp["act"]
    ev.gather(rows, n, True)
    if spec["moe"]["w_up"][:1] == ("model",):
        # the recompute reaches it only if the post-FFN norm saves it
        ev.scatter(rows * n, n, cfg.post_norm)


def _cell(ev: _Events, cfg, cell: str, sp: dict) -> None:
    """``blocks._channel_cell`` in a training or prefill step: the rows
    gathered along the sequence, the float32 partial reduce-scattered
    where the model axis splits the cell (recomputed in hymba, whose
    fusion norms its output; an mLSTM / sLSTM block adds it to the
    residual as it is)."""
    n = sp["n"]
    if n == 1:
        return
    ev.gather(sp["b"] * sp["s"] * cfg.d_model * sp["act"], n, True)
    if ssm.channel_shards(cfg, cell, n):
        ev.scatter(sp["b"] * sp["s"] * n * cfg.d_model * 4, n,
                   cell == "mamba")


def _lm_forward(cell: Cell, sp: dict) -> _Events:
    cfg, mesh, n = cell.cfg, cell.mesh, sp["n"]
    specs = cell.model.param_specs(mesh)
    ev = _Events()
    # a vision batch reads no token: the table's gradient is the tied
    # head's, or none
    unused = ("/embed",) if cfg.modality == "vision_stub" \
        and not cfg.tie_embeddings else ()
    for key in ("embedding", "frontend"):
        if key in cell.params:
            ev.leaves(cell.params[key], specs[key], mesh, False,
                      unused=unused)
    for kind, bp, spec in zip(cfg.blocks(), cell.params["layers"],
                              specs["layers"]):
        ev.leaves(bp, spec, mesh, True, _local_skip(cfg, kind, spec, n,
                                                    False))
        if kind in ("mlstm", "slstm"):
            _cell(ev, cfg, kind, sp)
            continue
        _attention(ev, cfg, sp, sp["s"])
        if kind in B.HYMBA_KINDS:
            _cell(ev, cfg, "mamba", sp)
        elif kind == "moe":
            _moe(ev, cfg, spec, sp)
    return ev


def _encdec_forward(cell: Cell, sp: dict) -> _Events:
    cfg, mesh = cell.cfg, cell.mesh
    specs = cell.model.param_specs(mesh)
    ev = _Events()
    for key in ("enc_norm", "embedding", "final_norm", "frontend"):
        ev.leaves(cell.params[key], specs[key], mesh, False)
    for bp, spec in zip(cell.params["enc_blocks"], specs["enc_blocks"]):
        ev.leaves(bp, spec, mesh, True)
        _attention(ev, cfg, sp, sp["f"])
    for bp, spec in zip(cell.params["dec_blocks"], specs["dec_blocks"]):
        ev.leaves(bp, spec, mesh, True)
        _attention(ev, cfg, sp, sp["s"])                   # self
        _attention(ev, cfg, sp, sp["f"])                   # cross K, V
    return ev


def _decode(cell: Cell, sp: dict) -> _Events:
    """One ``decode_step``: the weights gathered (the embedding whole, a
    block's leaves but a MoE block's experts), the LSE merge of each
    attention layer over a split cache (two all-reduces), a MoE block's
    unsummed slots all-reduced, a cell on a slice of its state gathering
    what it mixes across channels (``blocks._cell_decode``)."""
    cfg, mesh, model, n = cell.cfg, cell.mesh, cell.model, sp["n"]
    specs = model.param_specs(mesh)
    ev = _Events()
    split = model._kv_split(mesh)
    b, act = sp["b"], sp["act"]
    merge = [b * cfg.num_heads * 4,
             b * cfg.num_heads * (cfg.head_dim + 1) * 4] if split else []
    if cfg.is_encoder_decoder:
        for key in ("embedding", "final_norm"):
            ev.leaves(cell.params[key], specs[key], mesh, False)
        for bp, spec in zip(cell.params["dec_blocks"], specs["dec_blocks"]):
            ev.leaves(bp, spec, mesh, True)
            ev.merges += merge
        return ev
    ev.leaves(cell.params["embedding"], specs["embedding"], mesh, False)
    cache_specs = param_sharding_tree(
        model.cache_logical(cell.shape.global_batch, cell.shape.seq_len),
        mesh)
    for kind, bp, spec, cspec in zip(cfg.blocks(), cell.params["layers"],
                                     specs["layers"], cache_specs):
        ev.leaves(bp, spec, mesh, True, _local_skip(cfg, kind, spec, n,
                                                    True))
        if kind in B.ATTN_KINDS + B.HYMBA_KINDS:
            ev.merges += merge
        if kind == "moe" and n > 1 and spec["moe"]["w_up"][:1] == ("model",):
            ev.all_reduce(b * cfg.num_experts_per_tok * cfg.d_model * 4)
        if kind in B.HYMBA_KINDS and "model" in spec_axes(
                cspec["mamba"].h):
            di = cfg.q_dim // n
            ev.gather(b * di * act, n, True, False)       # the conv output
            ev.gather(b * di * act, n, True, False)       # y
        if kind == "mlstm" and "model" in spec_axes(cspec.c):
            hd = ssm._di(cfg) // cfg.num_heads
            ev.gather(b * cfg.num_heads * (hd // n) * act, n, True, False)
        if kind == "slstm" and "model" in spec_axes(cspec.c):
            di = ssm._di(cfg) // n
            if cfg.num_heads % n == 0:
                ev.gather(b * di * act, n, True, False)
            else:
                ev.gather(4 * b * di * 4, n, True, False)
    return ev


def collective_counts(cell: Cell) -> dict:
    """The collectives one step of the port's code issues on the rank,
    from the rule table: ``sharding`` as ``sharding/collectives.COUNTS``
    tallies them (count a kind, and the bytes of every input), ``merge``
    as ``core/tiled_allreduce.COUNTS`` (the decode's LSE merges).

    ``train`` (``training/train_step.make_train_step``, one microbatch,
    remat "full" or "selective"): the top-level leaves gathered whole
    once (``MeshModel._whole``), each block's sharded leaves gathered
    before use -- but the leaves the rank runs as its own
    (``blocks.local_leaves``) -- and again when the backward recomputes
    the block; K/V gathered along the sequence for context-parallel
    attention, a MoE block's or a recurrent cell's rows gathered and its
    partial reduce-scattered, again under the recompute; each gather's
    gradient a reduce-scatter of the whole, each reduce-scatter's an
    all-gather of the piece; the masked count all-reduced (8 bytes);
    then each gradient all-reduced over the axes its leaf is not sharded
    over, the loss (4 bytes), and one float32 square sum a group the
    leaves are sharded over (``optimizer.global_norm``).  ``prefill``
    (``apply`` under no gradient): the forward once.  ``decode``:
    ``_decode``."""
    sp = _split(cell)
    kind = cell.shape.kind
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
           "ppermute": 0, "bytes": 0}

    def add(op, nbytes, times=1):
        out[op] += times
        out["bytes"] += nbytes * times

    if kind == "decode":
        ev = _decode(cell, sp)
    else:
        fwd = _encdec_forward if cell.cfg.is_encoder_decoder else \
            _lm_forward
        ev = fwd(cell, sp)
    train = kind == "train"
    remat = train and cell.model.parallel.remat != "none"
    for op, nbytes, back, back_bytes, block in ev.items:
        add(op, nbytes, 2 if remat and block else 1)
        if train and back is not None:
            add(back, back_bytes)
    merge = {"all_reduce": len(ev.merges), "bytes": sum(ev.merges)}
    if train:
        mesh = cell.mesh
        add("all_reduce", 8)                            # the masked count
        specs = flatten(cell.model.param_specs(mesh), is_spec)
        for t, s in zip(tree.leaves(cell.params), specs, strict=True):
            others = tuple(a for a in mesh.axis_names
                           if a not in spec_axes(s))
            if mesh.size(others) > 1:
                add("all_reduce", t.numel() * t.element_size())
        add("all_reduce", 4)                            # the loss
        groups = {spec_axes(s) for s in specs
                  if mesh.size(spec_axes(s)) > 1}
        add("all_reduce", 4, len(groups))
    return {"sharding": out, "merge": merge}


# ---------------------------------------------------------------------------
# activations, stated
# ---------------------------------------------------------------------------

def activation_estimate(cell: Cell) -> int:
    """Bytes a rank holds past its arguments at its peak, by formula:
    NOT XLA's ``temp_bytes`` (nor held to it).

    * every step: the top-level leaves gathered whole (the embedding and
      LM head, a frontend), held through the pass;
    * ``train`` (remat: each block's input saved): a block input
      (b x s x d) per layer, the gradient of every parameter piece, the
      gathered leaves' whole gradient, and the largest transient of one
      block's gathered weights and their whole gradient (2x) or the
      logits in the activations' dtype with their float32 copy and
      gradient (b x s x V x (act + 8));
    * ``prefill``: the largest of one block's gathered weights beside its
      K/V gathered along the sequence, or the logits (b x s x V x act);
    * ``decode``: one block's gathered weights.

    ``b`` and ``s`` are the rank's rows and positions (``_split``)."""
    cfg, mesh, sp = cell.cfg, cell.mesh, _split(cell)
    specs = cell.model.param_specs(mesh)
    b, s, act, n = sp["b"], sp["s"], sp["act"], sp["n"]
    blocks = [k for k in ("layers", "enc_blocks", "dec_blocks")
              if k in cell.whole]
    top = [k for k in cell.whole if k not in blocks]
    sharded_top = sum(
        tree_bytes(cell.whole[k]) for k in top
        if any(spec_axes(x) for x in flatten(specs[k], is_spec)))
    largest = max(tree_bytes(bp) for k in blocks for bp in cell.whole[k])
    logits = b * s * cfg.vocab_size
    kind = cell.shape.kind
    if kind == "train":
        layers = sum(len(cell.whole[k]) for k in blocks)
        saved = layers * b * max(s, sp["f"]) * cfg.d_model * act
        return int(2 * sharded_top + saved + tree_bytes(cell.params)
                   + max(2 * largest, logits * (act + 8)))
    if kind == "prefill":
        kv = 2 * b * sp["seq"] * cfg.kv_dim * act if n > 1 else 0
        return int(sharded_top + max(largest + kv, logits * act))
    return int(sharded_top + largest)


# ---------------------------------------------------------------------------
# one rank of a cell run for real
# ---------------------------------------------------------------------------

def _drawing(cfg: ModelConfig, device: torch.device, seed: int):
    """A function making a tensor of a meta tensor's shape and dtype on
    ``device``: floats drawn N(0, 0.02), integers from the vocabulary."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(t: torch.Tensor) -> torch.Tensor:
        if t.is_floating_point():
            return torch.empty(t.shape, dtype=t.dtype, device=device
                               ).normal_(0.0, 0.02, generator=gen)
        return torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                             device=device, generator=gen)
    return draw


def materialize(cell: Cell, device, seed: int = 0) -> Cell:
    """The rank's state of a cell as tensors on ``device``, each made at
    the rank's shape -- never whole (a whole qwen2.5-32b is 65.5 GB):
    the parameter pieces drawn N(0, 0.02) in their dtypes, the AdamW
    state by ``optimizer.init_adamw`` and the cache by ``init_cache`` of
    a model on ``device`` under the cell's mesh.  The step's inputs are
    drawn by ``rank_step``.  ``cell.mesh`` must carry the process groups
    the step runs over (``launch/mesh.make_mesh_for``)."""
    device = torch.device(device)
    draw = _drawing(cell.cfg, device, seed)
    model = build_model(cell.cfg, device, cell.model.parallel)
    shape = cell.shape
    with axis_rules(mesh=cell.mesh), torch.no_grad():
        params = tree.tree_map(draw, cell.params)
        state = opt.init_adamw(params) if cell.opt is not None else None
        cache = None
        if shape.kind == "decode":
            cache = model.init_cache(shape.global_batch, shape.seq_len)
    return Cell(cell.cfg, shape, cell.mesh, model, cell.whole, params, state,
                {}, None, cache, None)


def rank_step(cell: Cell, *, positions=(0,), seed: int = 1) -> Any:
    """Run the step of a materialized cell on its rank, its inputs drawn
    here: one AdamW step of ``make_train_step`` on the whole batch (the
    step takes the rank's rows), ``apply`` of the rank's rows and
    positions under no gradient, or ``decode_step`` of the whole batch
    of tokens (the step keeps the rank's rows) at each of
    ``positions``.  Returns the step's metrics, or the last logits."""
    from repro_torch.config import TrainConfig
    from repro_torch.training.train_step import TrainState, make_train_step
    cfg, shape, mesh, model = cell.cfg, cell.shape, cell.mesh, cell.model
    draw = _drawing(cfg, model.device, seed)
    whole = S.batch_specs(cfg, shape)
    with axis_rules(mesh=mesh):
        if shape.kind == "train":
            step = make_train_step(model, cfg, model.parallel, TrainConfig())
            batch = {k: draw(v) for k, v in whole.items()}
            return step(TrainState(cell.params, cell.opt), batch)[1]
        with torch.no_grad():
            if shape.kind == "decode":
                token = draw(S.meta((shape.global_batch,), torch.int32))
                logits = None
                for pos in positions:
                    logits, cell.cache = model.decode_step(
                        cell.params, token, cell.cache, pos)
                return logits
            n = mesh.shape.get("model", 1)
            rows = param_sharding_tree(S.batch_logical(cfg, shape), mesh)
            x = {}
            for k, v in whole.items():
                # the rank's rows, and its 1 / n of the sequence (frames)
                dim = 2 if k == "positions" else 1
                piece = list(shard_of(v, rows[k], mesh).shape)
                piece[dim] //= n
                x[k] = draw(S.meta(piece, v.dtype))
            if cfg.is_encoder_decoder:
                return model.apply(cell.params, x["enc_embeds"], x["tokens"])
            if cfg.modality == "vision_stub":
                return model.apply(cell.params,
                                   inputs_embeds=x["inputs_embeds"],
                                   positions=x["positions"])
            return model.apply(cell.params, x["tokens"])


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _record(cell: Cell) -> dict:
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    mem = memory(cell)
    why = refused(cell)
    coll = None if why else collective_counts(cell)
    moved = 0 if coll is None else (coll["sharding"]["bytes"]
                                    + coll["merge"]["bytes"])
    flops = (model_flops(cfg, shape) + attention_flops(cfg, shape)) \
        / mesh.world
    rec = {"n_devices": mesh.world, "memory": mem,
           "fits_h100": mem["argument_bytes"]
           + mem["activation_bytes_estimate"] <= H100_BYTES,
           "param_count_leaves": sum(t.numel()
                                     for t in tree.leaves(cell.whole)),
           "param_count_formula": param_count(cfg),
           "collectives": coll,
           "roofline": roofline_terms(
               Cost(flops, mem["argument_bytes"], moved), cfg=cfg,
               shape=shape, n_devices=mesh.world)}
    if why:
        rec["refused"] = why
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = RESULTS_DIR, tag: str = "",
             clock: Callable[[], float] = time.perf_counter) -> dict:
    """Build rank 0's pieces of a cell (and the last rank's, which must
    hold the same bytes: ``_divides`` gives every rank pieces of one
    shape), record them, write ``<out_dir>/<cell>.json``."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}{tag}"
    head = {"cell": cell_id, "arch": arch, "shape": shape_name,
            "mesh": mesh_name}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec = dict(head, status="skipped", reason=reason)
        _save(rec, out_dir, cell_id)
        return rec
    t0 = clock()
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        cell = build_cell(arch, shape_name, mesh, 0)
        rec = dict(head, status="ok", **_record(cell))
        last = memory(build_cell(arch, shape_name, mesh, mesh.world - 1))
        if last != rec["memory"]:
            raise AssertionError(f"rank {mesh.world - 1} holds {last}, "
                                 f"rank 0 {rec['memory']}")
        rec["build_s"] = round(clock() - t0, 3)
    except Exception as e:
        rec = dict(head, status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _save(rec, out_dir, cell_id)
    return rec


def _save(rec: dict, out_dir: str, cell_id: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out)
                status = rec["status"]
                extra = rec.get("reason") or rec.get("error", "")
                print(f"[{status:7s}] {rec['cell']} "
                      f"({rec.get('build_s', 0)}s) {extra}", flush=True)
                failures += status == "error"
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
