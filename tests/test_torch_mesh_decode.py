"""Dense decode on a (data, model) mesh for every block kind -- hymba's KV
cache and Mamba channels, the mLSTM's and sLSTM's states, a MoE block's
experts, the encoder-decoder's self cache -- against the JAX package, on
the CPU.

* (b) ``init_cache`` / ``decode_step`` of reduced hymba-1.5b (``hymba``
  and ``hymba_local``, window 32), xlstm-125m (two mLSTM blocks; and
  ``block_pattern=("slstm",)``; and d_model 48 over 3 heads, whose sLSTM
  slice cuts a head at model 2), qwen3-moe-30b-a3b (4 experts, 2 a rank
  at model 2), whisper-small (its cross K/V projected from ``encode`` on
  the mesh), qwen2-vl-72b (M-RoPE: a text token's three position
  components equal), grok-1-314b (4 GeGLU experts, 2 a rank at model 2;
  the attention and final softcaps), and hymba, xlstm, whisper and
  qwen3-moe in bf16, on (1, 2)
  and (2, 2) gloo ranks (``_torch_train_ranks.mesh_decode_rank``), and
  every float32 LM case on (1, 3) ranks, where the model axis divides no
  channel dim and no expert count (each such leaf stays whole and its
  cell runs whole), against JAX's one-device ``decode_step`` on the same
  weights (``params_from_jax``) and the same random caches, at positions
  in the first slice of the KV cache, across its end and in the last
  slice, where hymba_local's window empties the first slice; a bf16 case
  also against the port's one-device decode;
* (c) the float32 (2, 2) ranks against JAX's own (2, 2) mesh under the
  dry run's decode shardings (a subprocess on four forced host devices,
  ``_jax_decode_cache.jax_mesh_main``): the logits, and each rank's
  slice of every cache leaf against JAX's shard at its coordinate;
* (d) each rank's cache is the rule table's slice of ``cache_logical``,
  whole where the model axis does not divide a dim: a recurrent state's
  channels (Mamba's DI, the mLSTM's dv, the sLSTM's DI).

Inputs are made with numpy from a seed, float32 but for the bf16 cases
(bf16 values, exact in float32).  Tolerances: ``_torch_mesh_pair.TOL``
for the float32 models (sums in another order).  A bf16 case is held to
JAX's one-device decode within the larger of the bf16 bound ``BF16_ROW``
(2e-2 plus 1e-2 of each row's largest value) and JAX's own spread,
measured in the same run (``_limits``): how far JAX's (2, 2) mesh, JAX's
float32 decode of the same bf16 values and JAX's decode from a cache one
bf16 ulp away on 1% of its values lie from JAX's one-device bf16 decode.
On these N(0, 1) states the reduced xlstm's bf16 decode is
ill-conditioned, and JAX's own witnesses lie beyond the bound;
``test_bf16_port_is_within_jaxs_own_spread`` prints them.  A bf16 case
is also held to the port's own one-device decode (what the mesh changes)
within the bf16 bound, or OWN_AT_SPREAD's within ``_limits``.  torch
runs on one thread where it meets JAX (ROADMAP Queue 3 item 10).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.layers import ssm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding.rules import (axis_rules, flatten,  # noqa: E402
                                        is_spec, param_sharding_tree,
                                        shard_index, shard_of)
from repro_torch.training import tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _jax_decode_cache as jdc  # noqa: E402
from _torch_mesh_pair import ROOT, TOL  # noqa: E402
from _torch_train_ranks import mesh_decode_rank, spawn  # noqa: E402

BF16_ROW = (2e-2, 1e-2)       # absolute, and relative to a row's max |x|
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
# name -> (arch, the reduced config's changed fields)
CASES = {
    "hymba": ("hymba-1.5b", {}),
    "xlstm": ("xlstm-125m", {}),
    "xlstm-slstm": ("xlstm-125m", dict(block_pattern=("slstm",))),
    "xlstm-h3": ("xlstm-125m", dict(d_model=48, num_heads=3,
                                    block_pattern=("mlstm", "slstm"))),
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}),
    "whisper": ("whisper-small", {}),
    "qwen2-vl": ("qwen2-vl-72b", {}),
    "grok": ("grok-1-314b", {}),
    "hymba-bf16": ("hymba-1.5b", BF16),
    "xlstm-bf16": ("xlstm-125m", BF16),
    "whisper-bf16": ("whisper-small", BF16),
    "qwen3-moe-bf16": ("qwen3-moe-30b-a3b", BF16),
}
NAMES = list(CASES)
BF16_NAMES = [n for n in NAMES if CASES[n][1].get("dtype") == "bfloat16"]
F32 = [n for n in NAMES if n not in BF16_NAMES]
# the bf16 cases held to the port's own one-device decode within the
# model's measured spread (``_limits``) rather than the bf16 bound: the
# mesh moves the attention's output by an ulp here and there (the merge
# of the slices' float32 partials), which the reduced qwen3-moe carries
# past the bound, as it carries a one-ulp change of its cache
# (``test_bf16_port_is_within_jaxs_own_spread`` prints both)
OWN_AT_SPREAD = ("qwen3-moe-bf16",)
ULP_DRAWS = 4
B, S = 4, 96                  # KV slices of 48 positions at model 2
# the first slice; across its end (47 | 48); the last slice, where
# hymba_local's window of 32 leaves slice 0 no valid key (kv_len 81, 82)
POSITIONS = [0, 1, 2, 46, 47, 48, 49, 80, 81]
MESHES = {"1x2": dict(data=1, model=2), "2x2": dict(data=2, model=2),
          "1x3": dict(data=1, model=3)}
# (1, 3): every LM case in float32 (whisper's 16 frames do not split 3
# ways for ``encode`` on the mesh)
ON_MESH = {"1x2": NAMES, "2x2": NAMES,
           "1x3": [n for n in F32 if n != "whisper"]}


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """torch on one intra-op thread beside JAX in this process, as the
    port's tests hold it there (ROADMAP Queue 3 item 10)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact(name: str):
    """Values exact in the case's dtype."""
    if name not in BF16_NAMES:
        return lambda a: a
    return lambda a: torch.from_numpy(a).bfloat16().float().numpy()


def _jax_decode(model, params, case: dict) -> dict:
    """JAX's one-device decode of ``case``: every step's logits and the
    final cache's leaves (float32 numpy)."""
    kw = {}
    if model.cfg.is_encoder_decoder:
        kw = dict(enc_out=model.encode(params, jnp.asarray(case["frames"])),
                  params=params)
    cache = jdc.jax_cache(model, case["leaves"], B, S, **kw)
    logits = []
    for pos, tok in case["steps"]:
        lg, cache = model.decode_step(params, jnp.asarray(tok), cache,
                                      jnp.int32(pos))
        logits.append(np.asarray(lg, dtype=np.float32))
    return {"logits": logits, "leaves": jdc.port_leaves(model.cfg, cache)}


def _case(name: str) -> dict:
    """JAX's reduced config of case ``name`` at PRNGKey(0), its weights as
    the port's float32 numpy tree with each leaf's dtype, a random whole
    cache (N(0, 1) values exact in their dtype; an encoder-decoder's self
    caches, beside N(0, 1) frames), the steps' tokens, and JAX's
    one-device decode.  A bf16 case's also carries the port's one-device
    decode ("port"), JAX's float32 decode of the same bf16 values ("f32")
    and JAX's one-device decode from the cache with one bf16 ulp moved on
    1% of its values, in ULP_DRAWS draws ("ulp")."""
    arch, cfg_kw = CASES[name]
    case = {"arch": arch, "cfg_kw": cfg_kw, "batch": B, "seq": S}
    jcfg = jdc.config(case)
    tcfg = dataclasses.replace(t_reduce(t_get(arch)), **cfg_kw)
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    case["params"] = tree.tree_map(lambda t: t.float().numpy().copy(),
                                   tparams)
    case["dtypes"] = tree.tree_map(lambda t: str(t.dtype).split(".")[-1],
                                   tparams)
    rng = np.random.default_rng(7)
    exact = _exact(name)
    shapes = build_model(tcfg, "cpu").init_cache(B, S)
    if tcfg.is_encoder_decoder:
        shapes = shapes["self"]
        case["frames"] = rng.normal(size=(B, tcfg.encoder_seq,
                                          tcfg.d_model)).astype(np.float32)
    case["leaves"] = [exact(rng.normal(size=t.shape).astype(np.float32))
                      for t in tree.leaves(shapes)]
    case["steps"] = [(pos, rng.integers(0, tcfg.vocab_size,
                                        size=B).astype(np.int32))
                     for pos in POSITIONS]
    one = _jax_decode(jm, jp, case)
    if name in BF16_NAMES:
        one["port"] = _port_one_device(tcfg, tparams, case)
        f32 = dict(dtype="float32", param_dtype="float32")
        one["f32"] = _jax_decode(
            j_build(dataclasses.replace(jcfg, **f32), JParallel(remat="none")),
            jax.tree.map(lambda a: a.astype(jnp.float32), jp), case)
        one["ulp"] = [_jax_decode(jm, jp, dict(case, leaves=[
            _ulp(a, np.random.default_rng([draw, i]))
            for i, a in enumerate(case["leaves"])]))
            for draw in range(ULP_DRAWS)]
    return case, one


def _ulp(a: np.ndarray, rng) -> np.ndarray:
    """bf16 values ``a`` with one ulp added or taken on 1% of them."""
    bits = torch.from_numpy(a).bfloat16().view(torch.int16)
    step = torch.from_numpy((rng.random(a.shape) < 0.01)
                            * rng.choice([-1, 1], size=a.shape))
    return (bits + step.to(torch.int16)).view(torch.bfloat16).float().numpy()


def _port_one_device(cfg, params: dict, case: dict) -> dict:
    """The port's one-device decode of ``case``."""
    model = build_model(cfg, "cpu")
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            enc = model.encode(params, torch.from_numpy(case["frames"]))
            cache = model.init_cache(B, S, enc_out=enc, params=params)
            filled = cache["self"]
        else:
            cache = filled = model.init_cache(B, S)
        for t, w in zip(tree.leaves(filled), case["leaves"], strict=True):
            t.copy_(torch.from_numpy(w))
        logits = []
        for pos, tok in case["steps"]:
            lg, cache = model.decode_step(params, torch.from_numpy(tok),
                                          cache, pos)
            logits.append(lg.float().numpy())
    return {"logits": logits,
            "leaves": [t.float().numpy() for t in tree.leaves(cache)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's one-device decode of every case; JAX's own (2, 2) mesh in a
    subprocess started first, beside the port's ranks (one spawn a mesh,
    its cases in turn)."""
    tmp = tmp_path_factory.mktemp("mesh_decode")
    made = {name: _case(name) for name in NAMES}
    cases = {name: c for name, (c, _) in made.items()}
    one = {name: r for name, (_, r) in made.items()}
    np.save(tmp / "cases.npy", cases, allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([
        os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="cpu")
    child = subprocess.Popen(
        [sys.executable, "-m", "_jax_decode_cache", str(tmp / "cases.npy"),
         str(tmp / "jax_mesh.npy")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = {}
        for mesh_name, kw in MESHES.items():
            got = spawn(mesh_decode_rank, kw["data"] * kw["model"], tmp, kw,
                        [cases[n] for n in ON_MESH[mesh_name]])
            ranks[mesh_name] = [dict(zip(ON_MESH[mesh_name], r))
                                for r in got]
        _, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err[-3000:]
    jax_mesh = np.load(tmp / "jax_mesh.npy", allow_pickle=True).item()
    return cases, one, ranks, jax_mesh


def _spread(got, want) -> float:
    """The largest |got - want| in units of the bf16 bound of its row
    along the last axis (BF16_ROW of the row's largest |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if got.size == 0:
        return 0.0
    bound = BF16_ROW[0] + BF16_ROW[1] * np.abs(want).max(-1, keepdims=True)
    return float((np.abs(got - want) / bound).max())


def _close(name: str, got, want, err_msg: str = "",
           limit: float = 1.0) -> None:
    """``got`` against ``want``: ``TOL`` in a float32 case; in a bf16 one
    each row along the last axis within ``limit`` times the bf16 bound."""
    if name not in BF16_NAMES:
        np.testing.assert_allclose(got, want, err_msg=err_msg, **TOL)
        return
    worst = _spread(got, want)
    assert worst <= limit, \
        f"{err_msg}: {worst:.3f} of the bf16 bound (limit {limit:.3f})"


def _limits(runs, name: str) -> dict:
    """A case's limits against JAX's one-device decode, in units of the
    bf16 bound, for its "logits" and its "leaves": 1 in float32 (where
    ``_close`` uses TOL); in bf16 the larger of 1 and JAX's own spread,
    the farthest that JAX's (2, 2) mesh, JAX's float32 decode of the
    same values or JAX's decode from a cache one ulp away lies from
    JAX's one-device bf16 decode."""
    _, one, _, jax_mesh = runs
    out = {"logits": 1.0, "leaves": 1.0}
    if name in BF16_NAMES:
        for key in out:
            for witness in (jax_mesh[name], one[name]["f32"],
                            *one[name]["ulp"]):
                out[key] = max([out[key]] + [
                    _spread(a, b) for a, b in zip(
                        witness[key], one[name][key], strict=True)])
    return out


def _rows(mesh_kw: dict, coords: dict) -> slice:
    n = B // mesh_kw["data"]
    return slice(coords["data"] * n, (coords["data"] + 1) * n)


def _rank_mesh(mesh_kw: dict, rank: int):
    return make_mesh((mesh_kw["data"], mesh_kw["model"]), ("data", "model"),
                     rank)


@pytest.mark.parametrize("mesh_name,name", [
    (m, n) for m in MESHES for n in ON_MESH[m]])
def test_mesh_decode_matches_jax_one_device(runs, mesh_name, name):
    """Every rank's logits at every position are JAX's one-device logits
    of its rows (a bf16 case's: within ``_limits``, and within the bf16
    bound of the port's own one-device logits, or OWN_AT_SPREAD's within
    ``_limits`` of them); the model ranks of a row
    group agree bit for bit; each rank's cache leaves are the rule
    table's slices of the whole cache, and at the end they hold the
    slices of JAX's final cache (the new KV rows written by the rank that
    owns their position, each recurrent state's channels stepped by the
    rank that holds them), held as the logits are."""
    cases, one, ranks, _ = runs
    mesh_kw = MESHES[mesh_name]
    want = one[name]
    limits = _limits(runs, name)
    wants = [(want, limits, "JAX")]
    if name in BF16_NAMES:
        wants.append((want["port"], limits if name in OWN_AT_SPREAD else
                      {"logits": 1.0, "leaves": 1.0}, "the port"))
    n_model = mesh_kw["model"]
    for r, res in enumerate(ranks[mesh_name]):
        got = res[name]
        rank_mesh = _rank_mesh(mesh_kw, r)
        assert got["coords"] == rank_mesh.coords
        rows = _rows(mesh_kw, got["coords"])
        for ref, lim, who in wants:
            for step, (lg, w) in enumerate(zip(got["logits"], ref["logits"],
                                               strict=True)):
                _close(name, lg, w[rows], f"{who}, step {step}",
                       lim["logits"])
        m = got["coords"]["model"]
        for peer in ranks[mesh_name][r - m:r - m + n_model]:
            for a, b_ in zip(got["logits"], peer[name]["logits"]):
                np.testing.assert_array_equal(a, b_)
        for ref, lim, who in wants:
            for i, (leaf, sp, shape, w) in enumerate(zip(
                    got["leaves"], got["specs"], got["shapes"],
                    ref["leaves"], strict=True)):
                whole = shard_of(torch.from_numpy(np.array(w)), sp,
                                 rank_mesh).numpy()
                assert tuple(shape) == whole.shape, i
                _close(name, leaf, whole, f"{who}, leaf {i}", lim["leaves"])


@pytest.mark.parametrize("name", BF16_NAMES)
def test_bf16_port_is_within_jaxs_own_spread(runs, name):
    """The port's one-device bf16 decode is no farther from JAX's than
    JAX's own (2, 2) mesh, JAX's float32 decode of the same values or
    JAX's decode from a cache one ulp away is (``_limits``; each at least
    the bf16 bound).  Prints the spreads."""
    _, one, _, jax_mesh = runs
    limit = _limits(runs, name)
    for key in ("logits", "leaves"):
        spreads = {who: max(_spread(a, b) for a, b in zip(
            got[key], one[name][key], strict=True))
            for who, got in (("JAX's (2, 2) mesh", jax_mesh[name]),
                             ("JAX float32", one[name]["f32"]),
                             *((f"JAX one ulp away ({d})", u) for d, u in
                               enumerate(one[name]["ulp"])),
                             ("the port", one[name]["port"]))}
        print(f"{name} {key} against JAX's one-device bf16 decode, in "
              f"bf16 bounds: " + ", ".join(f"{who} {v:.3f}"
                                           for who, v in spreads.items()))
        assert spreads["the port"] <= limit[key], (key, spreads)


@pytest.mark.parametrize("name", F32)
def test_mesh_decode_matches_jax_mesh(runs, name):
    """The (2, 2) ranks against JAX's own (2, 2) mesh under the dry run's
    decode shardings: each rank's logits are the JAX mesh's of its rows,
    JAX's shard of every cache leaf at the rank's coordinate is the
    rule table's slice the rank holds, and the rank's final slice holds
    that shard."""
    _, one, ranks, jax_mesh = runs
    want = jax_mesh[name]
    for step, (jl, ol) in enumerate(zip(want["logits"],
                                        one[name]["logits"])):
        _close(name, jl, ol, str(step))
    mesh_kw = MESHES["2x2"]
    for r, res in enumerate(ranks["2x2"]):
        got = res[name]
        c = got["coords"]
        rank_mesh = _rank_mesh(mesh_kw, r)
        rows = _rows(mesh_kw, c)
        for lg, jl in zip(got["logits"], want["logits"], strict=True):
            _close(name, lg, jl[rows])
        for i, (leaf, sp, jleaf, where) in enumerate(zip(
                got["leaves"], got["specs"], want["leaves"],
                want["shards"], strict=True)):
            bounds = where[(c["data"], c["model"])]
            for dim, (lo, hi) in enumerate(bounds):
                idx, n = shard_index(sp[dim] if dim < len(sp) else None,
                                     rank_mesh, c)
                size = jleaf.shape[dim] // n
                assert (lo, hi) == (idx * size, (idx + 1) * size), (i, dim)
            part = jleaf[tuple(slice(lo, hi) for lo, hi in bounds)]
            _close(name, leaf, part, f"leaf {i}")


# ---------------------------------------------------------------------------
# (d) the layout
# ---------------------------------------------------------------------------

def _channels(cfg, kind: str) -> int:
    """The width of a recurrent kind's state channels: Mamba's DI, the
    mLSTM's dv within a head, the sLSTM's DI."""
    di = ssm._di(cfg)
    return {"hymba": cfg.q_dim, "hymba_local": cfg.q_dim,
            "mlstm": di // cfg.num_heads, "slstm": di}[kind]


@pytest.mark.parametrize("shape", [(2, 2), (1, 3), (1, 4)])
@pytest.mark.parametrize("name", [n for n in F32 if n != "xlstm-h3"])
def test_init_cache_is_the_rule_table_slice(name, shape):
    """Each rank's cache leaves have the shapes of their rule-table
    slices of ``cache_logical`` (``batch -> data``, ``kv_seq -> model``,
    ``channels -> model`` where the model axis divides the dim), and a
    recurrent state is split exactly where the model axis divides its
    channels."""
    arch, kw = CASES[name]
    cfg = dataclasses.replace(t_reduce(t_get(arch)), **kw)
    model = build_model(cfg, "cpu")
    whole = model.init_cache(B, S)
    for r in range(shape[0] * shape[1]):
        mesh = make_mesh(shape, ("data", "model"), r)
        with axis_rules(mesh=mesh):
            mine = model.init_cache(B, S)
        specs = param_sharding_tree(model.cache_logical(B, S), mesh)
        for t, w, sp in zip(tree.leaves(mine), tree.leaves(whole),
                            flatten(specs, is_spec), strict=True):
            assert torch.equal(t, shard_of(w, sp, mesh))
    if cfg.is_encoder_decoder:
        return
    mesh = make_mesh(shape, ("data", "model"), 0)
    specs = param_sharding_tree(model.cache_logical(B, S), mesh)
    for kind, sp in zip(cfg.blocks(), specs):
        if kind in ("hymba", "hymba_local", "mlstm", "slstm"):
            state = sp["mamba"] if kind in ("hymba", "hymba_local") else sp
            split = "model" in flatten(state, is_spec)[0]
            assert split == (_channels(cfg, kind) % shape[1] == 0)
