"""The port's logical-axis rules against the JAX package's, exactly.

``logical_to_spec`` on every logical name of both default rule tables
and on JAX's meshes; the ``*_logical`` trees of every ported config,
reduced and at full size, leaf for leaf through ``params_from_jax``'s
layer mapping (a JAX leaf of a scanned segment carries a leading
``layers`` axis, dropped here); and ``param_sharding_tree``'s spec of
every parameter and cache leaf against the specs of the JAX package's
own ``NamedSharding`` trees, computed in a subprocess with 512 forced
host devices (the multi-pod production mesh).  A (2, 3) mesh leaves axes
that do not divide.  ``shard_of`` cuts the pieces those specs name.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_model_config as j_get  # noqa: E402
from repro.config import reduce_for_smoke as j_reduce  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.sharding import rules as jr  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import periodic_segments  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import rules as tr  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama2-7b", "gemma2-2b", "qwen2.5-32b", "stablelm-3b",
         "phi3-mini-3.8b", "xlstm-125m", "qwen3-moe-30b-a3b", "grok-1-314b",
         "hymba-1.5b"]
MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (4, 2): ("data", "model"), (2, 3): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model"),
          # the recurrent cells' channels -> model at a model axis of 2
          # and of 4 (reduced xlstm: DI splits four ways, its heads do not)
          (1, 2): ("data", "model"), (1, 4): ("data", "model")}
CACHE = (4, 64)                       # batch, max_seq of the cache trees

CHILD = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.config import get_model_config, reduce_for_smoke, ParallelConfig
from repro.models import build_model
from repro.sharding.rules import param_sharding_tree
meshes, archs, cache = json.loads(sys.argv[1])
devs = jax.devices()

def enc(tree):
    if hasattr(tree, "spec"):
        return {"spec": [list(a) if isinstance(a, tuple) else a
                         for a in tree.spec]}
    if isinstance(tree, dict):
        return {k: enc(v) for k, v in tree.items()}
    return [enc(v) for v in tree]      # NamedTuple caches: field order

out = {}
for shape, axes in meshes:
    n = int(np.prod(shape))
    mesh = Mesh(np.array(devs[:n]).reshape(shape), tuple(axes))
    for arch in archs:
        for size in ("full", "reduced"):
            cfg = get_model_config(arch)
            if size == "reduced":
                cfg = reduce_for_smoke(cfg)
            model = build_model(cfg, ParallelConfig())
            key = f"{arch}|{size}|{tuple(shape)}"
            out[key] = {
                "params": enc(param_sharding_tree(model.logical(), mesh)),
                "cache": enc(param_sharding_tree(
                    model.cache_logical(*cache), mesh))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    arg = json.dumps([[[list(s), list(a)] for s, a in MESHES.items()],
                      ARCHS, list(CACHE)])
    res = subprocess.run([sys.executable, "-c", CHILD, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _spec(enc) -> tuple:
    return tuple(tuple(a) if isinstance(a, list) else a
                 for a in enc["spec"])


def _configs(arch: str, size: str):
    jc, tc = j_get(arch), t_get(arch)
    if size == "reduced":
        jc, tc = j_reduce(jc), t_reduce(tc)
    return jc, tc


def _per_layer(tree: dict, cfg, leaf_fn) -> list:
    """The port's per-layer list from a JAX tree of scanned segments,
    params_from_jax's mapping: layer rep * len(unit) + i is unit member
    u{i} at repeat rep; ``leaf_fn(leaf, stacked)`` drops the stacked
    layers axis."""
    layers = []
    for si, (unit, reps) in enumerate(periodic_segments(cfg)):
        for _ in range(reps):
            for i in range(len(unit)):
                layers.append(_map(tree[f"seg{si}"][f"u{i}"],
                                   lambda x: leaf_fn(x, reps > 1)))
    return layers


def _map(tree, fn):
    if isinstance(tree, dict) and "spec" not in tree:
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack_logical(leaf, stacked):
    axes, shape = leaf
    if stacked:
        assert axes[0] == "layers" and shape[0] is None
        return (tuple(axes[1:]), tuple(shape[1:]))
    return (tuple(axes), tuple(shape))


def _unstack_spec(enc, stacked):
    spec = _spec(enc)
    return spec[1:] if stacked else spec


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(MESHES))
def test_logical_to_spec_of_every_logical_name(shape, multi_pod):
    mesh = make_mesh(shape, MESHES[shape])
    jrules, trules = jr.default_rules(multi_pod), tr.default_rules(multi_pod)
    assert dict(trules) == dict(jrules)
    names = list(jrules) + [None, "layers", "unknown"]
    for a in names:
        for b in names:
            want = tuple(jr.logical_to_spec((a, b), jrules, mesh))
            assert tr.logical_to_spec((a, b), trules, mesh) == want, (a, b)
    # seq beats ff; the batch takes both dp axes on the pod mesh
    assert tr.logical_to_spec(("batch", "seq", "ff"), trules, mesh) == \
        tuple(jr.logical_to_spec(("batch", "seq", "ff"), jrules, mesh))
    axes = [None, "model", "data"] + (
        [("pod", "data"), "pod"] if "pod" in MESHES[shape] else [])
    for dim in (1, 2, 3, 32, 48):
        for ax in axes:
            assert tr._divides(dim, mesh, ax) == jr._divides(dim, mesh, ax)


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_trees_equal_jax(arch, size):
    jc, tc = _configs(arch, size)
    jm, tm = j_build(jc), build_model(tc, "cpu")
    jt, tt = jm.logical(), tm.logical()
    assert tt["embedding"] == jt["embedding"]
    assert tt["final_norm"] == jt["final_norm"]
    assert tt["layers"] == _per_layer(jt, jc, _unstack_logical)
    jcache = _per_layer(jm.cache_logical(*CACHE), jc, lambda nt, st: (
        type(nt).__name__, nt._fields,
        [_unstack_logical(f, st) for f in nt]))

    def node(nt):       # a NamedTuple, or hymba's {"kv", "mamba"} of them
        if isinstance(nt, dict):
            return {k: node(v) for k, v in nt.items()}
        return (type(nt).__name__, nt._fields, list(nt))
    for got, want in zip(tm.cache_logical(*CACHE), jcache, strict=True):
        assert node(got) == want


@pytest.mark.parametrize("shape", list(MESHES))
def test_param_and_cache_specs_equal_jax(jax_specs, shape):
    mesh = make_mesh(shape, MESHES[shape])
    dropped = 0
    for arch in ARCHS:
        for size in ("full", "reduced"):
            jc, tc = _configs(arch, size)
            js = jax_specs[f"{arch}|{size}|{shape}"]
            tm = build_model(tc, "cpu")
            got = tr.param_sharding_tree(tm.logical(), mesh)
            assert got["embedding"] == _map(js["params"]["embedding"],
                                            _spec)
            assert got["final_norm"] == _map(js["params"]["final_norm"],
                                             _spec)
            assert got["layers"] == _per_layer(js["params"], jc,
                                               _unstack_spec)
            assert got == tm.param_specs(mesh)
            # cache trees: NamedTuples of specs, field for field
            jcache = _per_layer(js["cache"], jc, lambda fields, st: [
                _unstack_spec(x, st) for x in fields])
            tcache = tr.param_sharding_tree(tm.cache_logical(*CACHE), mesh)
            assert [{k: list(v) for k, v in g.items()}
                    if isinstance(g, dict) else list(g)
                    for g in tcache] == jcache
            # leaves whose rule names a mesh axis that does not divide
            logical = tr.flatten(tm.logical(), tr.is_logical_leaf)
            specs = tr.flatten(got, tr.is_spec)
            for (axes, _), spec in zip(logical, specs):
                raw = tr.logical_to_spec(axes, tr.default_rules(
                    len(shape) == 3), mesh)
                dropped += sum(1 for i, a in enumerate(raw)
                               if a is not None and spec[i] is None)
    if shape == (2, 3):
        assert dropped > 0


def test_shard_of_cuts_the_named_pieces():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 6).reshape(8, 6)
    pieces = {}
    for r in range(8):
        m = make_mesh((2, 2, 2), ("pod", "data", "model"), r)
        pieces[r] = tr.shard_of(x, (("pod", "data"), "model"), m)
        c = m.coords
        i = c["pod"] * 2 + c["data"]
        assert torch.equal(pieces[r], x[2 * i:2 * i + 2,
                                        3 * c["model"]:3 * c["model"] + 3])
        assert tr.shard_of(x, (), m) is x
    # the pieces tile the whole, each once
    seen = torch.zeros_like(x)
    for r, p in pieces.items():
        for v in p.flatten().tolist():
            seen.view(-1)[v] += 1
    assert torch.equal(seen, torch.ones_like(x))
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert make_mesh((2, 2, 2), ("pod", "data", "model"), 6).coords == \
        {"pod": 1, "data": 1, "model": 0}
    assert np.prod(list(mesh.shape.values())) == mesh.world == 8


def test_constrain_is_the_identity_and_rules_scope():
    x = torch.ones(2, 3)
    assert tr.constrain(x, "batch", "seq") is x
    mesh = make_mesh((2, 2), ("data", "model"))
    assert tr.current_mesh() is None and tr.current_rules() is None
    with tr.axis_rules(mesh=mesh) as rules:
        assert tr.current_mesh() is mesh
        assert rules == tr.default_rules(False)
        assert tr.logical_to_spec(("batch", "seq")) == ("data", "model")
    assert tr.current_mesh() is None
