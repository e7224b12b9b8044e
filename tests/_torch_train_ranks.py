"""Rank bodies of the data- and model-parallel training tests: each runs
in a process of its own, started by
``repro_torch.launch.mesh.spawn_ranks`` on ``gloo``, and imports only
``torch``, ``numpy`` and ``repro_torch`` (never JAX).  Parameters and
batches arrive as numpy; results go back as plain Python and numpy, to be
held to the JAX package in the test process.
"""
import os

import torch

from repro_torch.config import (ParallelConfig, TrainConfig,
                                get_model_config, reduce_for_smoke)
from repro_torch.launch.mesh import make_mesh_for, spawn_ranks
from repro_torch.models import build_model
from repro_torch.sharding.rules import (axis_rules, flatten, is_spec,
                                        shard_of)
from repro_torch.training import optimizer as opt
from repro_torch.training import tree
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             state_specs)

INIT_TIMEOUT_S = 60.0      # every collective of a rank
DEADLINE_S = 240.0         # a spawned group as a whole


def spawn(fn, world: int, tmp_path, *args) -> list:
    """``fn(rank, *args)`` on ``world`` CPU ranks over gloo, rendezvous
    through a file under ``tmp_path`` (no port, so parallel test workers
    cannot collide)."""
    pg = tmp_path / f"pg-{fn.__name__}-{world}-{len(os.listdir(tmp_path))}"
    return spawn_ranks(fn, world, args=args, backend="gloo",
                       init_method=f"file://{pg}", timeout_s=DEADLINE_S,
                       init_timeout_s=INIT_TIMEOUT_S)


def _np(tree_):
    return tree.tree_map(lambda t: t.detach().numpy().copy(), tree_)


def _setup(arch: str, par_kw: dict):
    torch.set_num_threads(1)
    parallel = ParallelConfig(**par_kw)
    mesh = make_mesh_for(parallel, timeout=INIT_TIMEOUT_S)
    cfg = reduce_for_smoke(get_model_config(arch))
    return parallel, mesh, cfg, build_model(cfg, "cpu", parallel)


def train_rank(rank: int, arch: str, par_kw: dict, params: dict,
               batches: list, train_kw: dict, ckpt: dict) -> dict:
    """This rank's share of ``len(batches)`` steps of the whole
    ``params`` (numpy, the port's tree) on the mesh of ``par_kw``.
    Returns every step's metrics, the rank's initial pieces, its step
    counter and (rank 0) the final state gathered whole.  ``ckpt``:
    "dir" -- the mesh's checkpoint directory; optional "save" -- save the
    final state there, and (rank 0) "one" -- a directory where a
    one-device manager saves the same gathered state; "next" -- one more
    batch, stepped after the save."""
    parallel, mesh, cfg, model = _setup(arch, par_kw)
    whole = tree.tree_map(torch.from_numpy, params)
    tcfg = TrainConfig(**train_kw)
    with axis_rules(mesh=mesh):
        specs = model.param_specs(mesh)
        pieces = tree.unflatten(whole, [
            shard_of(t, s, mesh) for t, s in zip(
                tree.leaves(whole), flatten(specs, is_spec), strict=True)])
        state = TrainState(pieces, opt.init_adamw(pieces))
        step = make_train_step(model, cfg, parallel, tcfg)
    out = {"coords": mesh.coords, "init": _np(pieces), "metrics": []}
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                b.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
    mgr = CheckpointManager(ckpt["dir"], mesh=mesh,
                            specs=state_specs(specs))
    host = mgr.gather_host(state)
    if host is not None:
        out["final"] = [t.numpy().copy() for _, t in host]
        out["paths"] = [p for p, _ in host]
    if ckpt.get("save"):
        mgr.save(len(batches), state, extras={"data": {"step": 7}})
        if host is not None and "one" in ckpt:
            CheckpointManager(ckpt["one"]).save(
                len(batches), tree.unflatten(state, [t for _, t in host]),
                extras={"data": {"step": 7}})
    out["step"] = int(state.opt.step)
    if "next" in ckpt:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                ckpt["next"].items()})
        out["next_loss"] = float(m["loss"])
        host = mgr.gather_host(state)
        if host is not None:
            out["next_final"] = [t.numpy().copy() for _, t in host]
    return out


def resume_rank(rank: int, arch: str, par_kw: dict, params: dict,
                train_kw: dict, ckpt_dir: str, batch: dict) -> dict:
    """Restore the newest checkpoint of ``ckpt_dir`` into this rank's
    pieces on the mesh of ``par_kw`` (``params``: any whole tree of the
    model's shapes, the template) and take one step on ``batch``.
    Returns the restored pieces of every leaf (params, AdamW's moments,
    its step), the step's loss and (rank 0) the state after it, gathered
    whole."""
    parallel, mesh, cfg, model = _setup(arch, par_kw)
    whole = tree.tree_map(torch.from_numpy, params)
    with axis_rules(mesh=mesh):
        specs = model.param_specs(mesh)
        pieces = tree.unflatten(whole, [
            shard_of(t, s, mesh) for t, s in zip(
                tree.leaves(whole), flatten(specs, is_spec), strict=True)])
        template = TrainState(pieces, opt.init_adamw(pieces))
        mgr = CheckpointManager(ckpt_dir, mesh=mesh,
                                specs=state_specs(specs))
        state, manifest = mgr.restore(template)
        step = make_train_step(model, cfg, parallel, TrainConfig(**train_kw))
    restored = [t.numpy().copy() for t in tree.leaves(state)]
    state, m = step(state, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    host = mgr.gather_host(state)
    return {"loss": float(m["loss"]), "step": int(state.opt.step),
            "restored_step": manifest["step"], "restored": restored,
            "after": None if host is None else
            [t.numpy().copy() for _, t in host]}


def bf16_train(rank: int, cfg_kw: dict, data_kw: dict, train_kw: dict,
               steps: int, ckpt_dir: str, par_kw=None) -> list:
    """``steps`` AdamW steps of llama2-7b's smoke config in bf16 (widened
    by ``cfg_kw``) from the model's own seeded draw, on one device
    (``par_kw`` None) or as this rank's share of the mesh of ``par_kw``,
    each rank drawing the whole tree and keeping its pieces, as
    ``chip_smoke.py`` phase 4b does on the card.  Returns every step's
    metrics; the initial state (one device) and the final one are saved
    whole under ``ckpt_dir``."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.training.train_step import init_train_state
    torch.set_num_threads(1)
    parallel = ParallelConfig(remat="selective", **(par_kw or {}))
    mesh = (make_mesh_for(parallel, timeout=INIT_TIMEOUT_S) if par_kw
            else None)
    cfg = dataclasses.replace(reduce_for_smoke(get_model_config(
        "llama2-7b")), dtype="bfloat16", param_dtype="bfloat16", **cfg_kw)
    model = build_model(cfg, "cpu", parallel)
    tcfg = TrainConfig(**train_kw)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
    with axis_rules(mesh=mesh):
        state = init_train_state(model, model.generator(tcfg.seed))
        mgr = (CheckpointManager(ckpt_dir) if mesh is None else
               CheckpointManager(ckpt_dir, mesh=mesh, specs=state_specs(
                   model.param_specs(mesh))))
        if mesh is None:
            mgr.save(0, state)
        step = make_train_step(model, cfg, parallel, tcfg)
    out = []
    for _ in range(steps):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in data.next().items()})
        out.append({k: float(v) for k, v in m.items()})
    mgr.save(steps, state)
    return out


def collectives_rank(rank: int, world: int) -> dict:
    """``all_gather_dim`` / ``reduce_scatter_dim`` (gloo's
    ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` on CPU
    tensors) on this rank's (3, 4) block, and the gradient ``gather``
    gives it."""
    from repro_torch.sharding import collectives as C
    torch.set_num_threads(1)
    group = torch.distributed.group.WORLD
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * rank
    out = {"gather0": C.all_gather_dim(x, 0, group).numpy(),
           "gather1": C.all_gather_dim(x, 1, group).numpy(),
           "scatter1": C.reduce_scatter_dim(x.repeat(1, world), 1,
                                            group).numpy()}
    # the gradient of a gathered tensor is this rank's piece of the sum
    w = x.clone().requires_grad_(True)
    g = C.gather(w, 1, group)
    (g * (rank + 1)).sum().backward()
    out["grad"] = w.grad.numpy()
    return out


def remat_thread_rank(rank: int, arch: str, params: dict,
                      batch: dict) -> dict:
    """The gradients of this rank's loss on a (1, 2) mesh under remat,
    the backward run on this thread and on a fresh one (CUDA's autograd
    runs its backward on a device thread, where the mesh's context
    variable is unset: each recomputed block must bring its own)."""
    import threading
    parallel, mesh, cfg, model = _setup(arch, dict(model=2, remat="full"))
    whole = tree.tree_map(torch.from_numpy, params)
    with axis_rules(mesh=mesh):
        specs = flatten(model.param_specs(mesh), is_spec)
        leaves = [shard_of(t, s, mesh).requires_grad_(True)
                  for t, s in zip(tree.leaves(whole), specs, strict=True)]
        pieces = tree.unflatten(whole, leaves)
        tok, lab = (torch.from_numpy(batch[k][:, 32 * rank:32 * rank + 32])
                    for k in ("tokens", "labels"))
        grads = {}
        for where in ("here", "thread"):
            loss = model.loss(pieces, tok, lab)
            if where == "here":
                grads[where] = torch.autograd.grad(loss, leaves)
                continue
            t = threading.Thread(target=lambda: grads.__setitem__(
                where, torch.autograd.grad(loss, leaves)))
            t.start()
            t.join(timeout=60)
    return {k: [g.numpy() for g in v] for k, v in grads.items()}


def moe_routes_rank(rank: int, arch: str, par_kw: dict, params: dict,
                    batch: dict) -> dict:
    """The loss forward of this rank's share of ``batch`` on the mesh of
    ``par_kw`` (no gradient), recording for every MoE block the input its
    routing saw (whole rows under a model axis), each assignment's kept
    flag in (token, j) order and this rank's rows of the block's
    output."""
    from repro_torch.layers import moe
    from repro_torch.models import blocks
    from repro_torch.training.train_step import rank_rows
    parallel, mesh, cfg, model = _setup(arch, par_kw)
    whole = tree.tree_map(torch.from_numpy, params)
    seen = []
    apply, ffn = moe.apply_moe, blocks._moe_ffn

    def recording_apply(p, x, c, **kw):
        r = moe.routing(p, x, c)
        keep = torch.empty_like(r.plan.keep).scatter_(1, r.plan.order,
                                                      r.plan.keep)
        seen.append({"x": x.numpy().copy(), "keep": keep.numpy(),
                     "experts": kw.get("experts"),
                     "w_up": tuple(p["w_up"].shape)})
        return apply(p, x, c, **kw)

    def recording_ffn(p, h2, c):
        y = ffn(p, h2, c)
        seen[-1]["y"] = y.numpy().copy()
        return y
    moe.apply_moe, blocks._moe_ffn = recording_apply, recording_ffn
    try:
        with axis_rules(mesh=mesh), torch.no_grad():
            specs = model.param_specs(mesh)
            pieces = tree.unflatten(whole, [
                shard_of(t, s, mesh) for t, s in zip(
                    tree.leaves(whole), flatten(specs, is_spec),
                    strict=True)])
            mb = rank_rows({k: torch.from_numpy(v) for k, v in
                            batch.items()}, mesh, 1)[0]
            model.loss(pieces, mb["tokens"], mb["labels"])
    finally:
        moe.apply_moe, blocks._moe_ffn = apply, ffn
    return {"coords": mesh.coords, "blocks": seen}
