"""The JAX package's side of the dry-run tests (``test_torch_dryrun.py``),
run as a subprocess with forced host devices: it imports JAX and the
JAX package, never the port.

    python -m _jax_dryrun shards OUT.json      # 512 devices
    python -m _jax_dryrun memory OUT.json      # 8 devices

``shards``: for every assigned arch x shape x production mesh cell that
JAX's ``skip_reason`` keeps, each leaf's ``NamedSharding(mesh,
spec).shard_shape`` and dtype of JAX's own dry-run trees
(``jax.eval_shape`` of ``init``, ``init_adamw``, the batch -- a
prefill's without labels, as its ``build_cell`` drops them --, the
decode token and cache; nothing compiled).  ``memory``: the
per-device ``argument_size_in_bytes`` of XLA's memory analysis of three
reduced cells (``MEMORY_CELLS``) on a (2, 4) mesh, lowered as
``launch/dryrun.run_cell`` lowers them.
"""
import json
import sys

import jax
import numpy as np
from jax.sharding import Mesh

from repro.config import SHAPES, ShapeConfig, get_model_config
from repro.config import reduce_for_smoke
from repro.configs import ASSIGNED_ARCHS
from repro.launch import specs as S
from repro.launch.mesh import parallel_for_mesh
from repro.models import build_model
from repro.sharding.rules import param_sharding_tree
from repro.training import optimizer as opt_mod

# (arch, shape): reduced in batch and sequence; the (2, 4) mesh
MEMORY_CELLS = {
    "dense_train": ("qwen2.5-32b", ShapeConfig("train_r", 64, 8, "train")),
    "hymba_decode": ("hymba-1.5b", ShapeConfig("decode_r", 128, 8,
                                               "decode")),
    "whisper_prefill": ("whisper-small",
                        ShapeConfig("prefill_r", 64, 8, "prefill")),
}
MEMORY_MESH = (2, 4)


def _enc(tree):
    """A tree of [shard shape, dtype] leaves as JSON: dicts by key,
    lists, tuples and NamedTuples as lists."""
    if isinstance(tree, dict):
        return {k: _enc(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_enc(v) for v in tree]
    return tree


def _shards(sds, logical, mesh):
    sh = param_sharding_tree(logical, mesh)
    return jax.tree.map(lambda s, x: [list(s.shard_shape(x.shape)),
                                      str(x.dtype)], sh, sds)


def _mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def shards() -> dict:
    meshes = {"16x16": _mesh((16, 16), ("data", "model")),
              "2x16x16": _mesh((2, 16, 16), ("pod", "data", "model"))}
    # imported once the devices are up (it sets XLA_FLAGS for its own run)
    from repro.launch.dryrun import skip_reason
    out = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_model_config(arch)
        for mname, mesh in meshes.items():
            model = build_model(cfg, parallel_for_mesh(mesh))
            params = S.abstract_params(model)
            opt = jax.eval_shape(opt_mod.init_adamw, params)
            rec = {"params": _enc(_shards(params, model.logical(), mesh)),
                   "mu_dtypes": sorted({str(x.dtype) for x in
                                        jax.tree.leaves(opt.mu)}),
                   "step": [list(opt.step.shape), str(opt.step.dtype)]}
            for name, shape in SHAPES.items():
                if skip_reason(arch, name):
                    continue
                cell = {}
                if shape.kind == "decode":
                    tok, cache, _ = S.decode_specs(cfg, shape, model)
                    b = shape.global_batch
                    cell["token"] = _enc(_shards(
                        tok, (("batch",), (b,)), mesh))
                    cell["cache"] = _enc(_shards(
                        cache, model.cache_logical(b, shape.seq_len), mesh))
                else:
                    batch = S.batch_specs(cfg, shape)
                    logical = S.batch_logical(cfg, shape)
                    if shape.kind == "prefill":
                        batch.pop("labels")
                        logical.pop("labels")
                    cell["batch"] = _enc(_shards(batch, logical, mesh))
                rec[name] = cell
            out[f"{arch}|{mname}"] = rec
    return out


def memory() -> dict:
    from repro.launch import dryrun
    orig = dryrun.get_model_config
    out = {}
    mesh = _mesh(MEMORY_MESH, ("data", "model"))
    for key, (arch, shape) in MEMORY_CELLS.items():
        dryrun.get_model_config = lambda a: reduce_for_smoke(orig(a))
        dryrun.SHAPES = {shape.name: shape}
        from repro.sharding.rules import axis_rules
        with axis_rules(None, mesh=mesh):
            fn, args, shardings, out_sh, _, _ = dryrun.build_cell(
                arch, shape.name, mesh)
            donate = (2,) if shape.kind == "decode" else (
                (0,) if shape.kind == "train" else ())
            with mesh:
                compiled = jax.jit(fn, in_shardings=shardings,
                                   out_shardings=out_sh,
                                   donate_argnums=donate).lower(
                    *args).compile()
        out[key] = int(compiled.memory_analysis().argument_size_in_bytes)
    dryrun.get_model_config = orig
    return out


if __name__ == "__main__":
    what, path = sys.argv[1:3]
    with open(path, "w") as f:
        json.dump(shards() if what == "shards" else memory(), f)
