"""JAX's dense decode caches beside the port's, for the mesh decode tests
(``test_torch_mesh_decode.py``): the port keeps a list of per-layer
trees (an encoder-decoder ``{"cross": [(k, v)], "self": [KVCache]}``),
JAX stacks the layers of a repeating segment (and every decoder layer of
an encoder-decoder).  Both sides are moved as flat lists of numpy leaves
in the port's ``tree.leaves`` order.  ``jax_mesh_main`` is the body of
the subprocess that decodes on JAX's own (2, 2) mesh of forced host
devices.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import ParallelConfig, get_model_config, reduce_for_smoke
from repro.models import build_model
from repro.models.lm import periodic_segments


def layer_index(cfg) -> list:
    """(segment, rep or None, unit) of every layer of an LM, in order."""
    out = []
    for si, (unit, reps) in enumerate(periodic_segments(cfg)):
        for rep in range(reps):
            for i in range(len(unit)):
                out.append((si, rep if reps > 1 else None, i))
    return out


def _places(cfg, cache):
    """Each of JAX's leaves (a getter of the stacked ``cache``) with its
    layer (or None), in the port's leaf order."""
    if cfg.is_encoder_decoder:
        return [((lambda c, key=key, j=j: c[key][j]), layer)
                for key in ("cross", "self") for layer in range(cfg.num_layers)
                for j in range(2)]
    out = []
    for si, rep, i in layer_index(cfg):
        n = len(jax.tree.leaves(cache[f"seg{si}"][f"u{i}"]))
        out += [((lambda c, si=si, i=i, j=j:
                  jax.tree.leaves(c[f"seg{si}"][f"u{i}"])[j]), rep)
                for j in range(n)]
    return out


def port_leaves(cfg, cache) -> list:
    """JAX's cache as the port's per-layer leaves (float32 numpy)."""
    out = []
    for get, layer in _places(cfg, cache):
        a = np.asarray(get(cache), dtype=np.float32)
        out.append(a if layer is None else a[layer])
    return out


def shard_index(cfg, cache) -> list:
    """For each port leaf, {(data, model) coordinate: [[start, stop] of
    every dim]} of JAX's shard on that device (the layer dim dropped)."""
    coords = None
    out = []
    for get, layer in _places(cfg, cache):
        leaf = get(cache)
        lead = 0 if layer is None else 1
        where = {}
        for sh in leaf.addressable_shards:
            if coords is None:
                mesh = leaf.sharding.mesh
                coords = {d.id: (i, j) for i, row in enumerate(mesh.devices)
                          for j, d in enumerate(row)}
            where[coords[sh.device.id]] = [
                [sl.start or 0, n if sl.stop is None else sl.stop]
                for sl, n in zip(sh.index[lead:], leaf.shape[lead:])]
        out.append(where)
    return out


def jax_cache(model, leaves: list, batch: int, seq: int, *,
              enc_out=None, params=None):
    """JAX's stacked cache holding the port's per-layer ``leaves`` (of an
    encoder-decoder: its self caches' leaves; the cross K/V come from
    ``enc_out``)."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        cache = model.init_cache(batch, seq, enc_out=enc_out, params=params)
        k = np.stack(leaves[0::2])
        v = np.stack(leaves[1::2])
        dt = cache["self"].k.dtype
        cache["self"] = type(cache["self"])(jnp.asarray(k, dtype=dt),
                                            jnp.asarray(v, dtype=dt))
        return cache
    cache = model.init_cache(batch, seq)
    index = layer_index(cfg)
    per_layer, at = [], 0
    for si, _, i in index:
        n = len(jax.tree.leaves(cache[f"seg{si}"][f"u{i}"]))
        per_layer.append(leaves[at:at + n])
        at += n
    for si, (unit, reps) in enumerate(periodic_segments(cfg)):
        for i in range(len(unit)):
            layers = [li for li, (s_, _, u) in enumerate(index)
                      if (s_, u) == (si, i)]
            old, treedef = jax.tree.flatten(cache[f"seg{si}"][f"u{i}"])
            new = []
            for j, o in enumerate(old):
                a = np.stack([per_layer[li][j] for li in layers])
                new.append(jnp.asarray(a if reps > 1 else a[0],
                                       dtype=o.dtype))
            cache[f"seg{si}"][f"u{i}"] = jax.tree.unflatten(treedef, new)
    return cache


def config(case: dict):
    return dataclasses.replace(reduce_for_smoke(get_model_config(
        case["arch"])), **case["cfg_kw"])


def jax_mesh_main(inp: str, out_path: str) -> None:
    """Decode each case of ``inp`` on JAX's (2, 2) mesh under the dry
    run's shardings (``param_sharding_tree`` of ``logical`` and
    ``cache_logical``); save every step's logits, the final cache's
    leaves and each leaf's shard on every device."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.sharding.rules import axis_rules, param_sharding_tree
    cases = np.load(inp, allow_pickle=True).item()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    res = {}
    for name, case in cases.items():
        cfg = config(case)
        model = build_model(cfg, ParallelConfig(data=2, model=2,
                                                remat="none"))
        b, s = case["batch"], case["seq"]
        with axis_rules(mesh=mesh):
            params = model.init(jax.random.PRNGKey(0))
            kw = {}
            if cfg.is_encoder_decoder:
                kw = dict(enc_out=model.encode(
                    params, jnp.asarray(case["frames"])), params=params)
            cache = jax_cache(model, case["leaves"], b, s, **kw)
            psh = param_sharding_tree(model.logical(), mesh)
            csh = param_sharding_tree(model.cache_logical(b, s), mesh)
            tsh = param_sharding_tree((("batch",), (b,)), mesh)
            params = jax.device_put(params, psh)
            cache = jax.device_put(cache, csh)
            step = jax.jit(model.decode_step,
                           in_shardings=(psh, tsh, csh,
                                         NamedSharding(mesh, P())),
                           out_shardings=(None, csh))
            logits = []
            with mesh:
                for pos, tok in case["steps"]:
                    lg, cache = step(params, jnp.asarray(tok), cache,
                                     jnp.int32(pos))
                    logits.append(np.asarray(lg, dtype=np.float32))
        res[name] = {"logits": logits, "leaves": port_leaves(cfg, cache),
                     "shards": shard_index(cfg, cache)}
    np.save(out_path, res, allow_pickle=True)
    print("ok")


if __name__ == "__main__":
    jax_mesh_main(*sys.argv[1:])
