"""Context-parallel dense decode -- the cache's ``kv_seq -> model`` --
against the JAX package, on the CPU.

* (a) the plain version of ``flash_decode`` at a slice offset with its
  log-sum-exp (``decode_reference(kv_start=, return_lse=True)`` and the
  port's ``_local_decode_with_lse``) against JAX's
  ``_local_decode_with_lse``: a slice with no valid key, a window that
  cuts or empties the slice, softcap, GQA;
  and in bf16, where each slice's output stays float32 for the merge as
  JAX's does;
* (b) ``LM.init_cache`` / ``LM.decode_step`` of reduced llama2-7b,
  gemma2-2b (window, softcaps) and qwen2.5-32b (qkv bias), and of
  llama2-7b in bf16, on (1, 2) and (2, 2) gloo ranks
  (``_torch_train_ranks.mesh_decode_rank``) against JAX's one-device
  ``decode_step`` on the same weights (``params_from_jax``) and the
  same random caches, at positions in the first slice, across the slice
  boundary and in the last slice, where gemma2-2b's window empties the
  first slice;
* (c) the float32 (2, 2) ranks against JAX's own (2, 2) mesh running
  the dry run's decode shardings (``cache_logical`` and ``param_sharding_tree``,
  a subprocess on four forced host devices): the logits, and each rank's
  cache slice against JAX's shard at its coordinate;
* (d) a cache width or a batch that the mesh does not split stays whole
  on the ranks (as the rule table keeps such a dim) and decodes as JAX's
  one device does, and a mesh whose model axis is 1 decodes each rank's
  rows as one device does (the other block kinds on a model axis:
  ``test_torch_mesh_decode.py``).

Inputs are made with numpy from a seed, float32 but for the bf16 cases
(bf16 values, exact in float32).  Tolerances: 1e-5 for the attention
functions (the order of float32 sums), the mesh tests'
``_torch_mesh_pair.TOL`` for the float32 models, and the bf16 bound
``BF16_ROW`` (2e-2 plus 1e-2 of each row's largest value: a few bf16
roundings that land differently) for the bf16 model.  One deliberate difference: a
slice with no valid key gives 0 here, where JAX averages the masked
values; its log-sum-exp is NEG_INF in both, so the merge weighs it at
zero and the difference never reaches a result.
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
from repro.core.distributed_decode import \
    _local_decode_with_lse as j_local  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.distributed_decode import \
    _local_decode_with_lse  # noqa: E402
from repro_torch.kernels.flash_decode.ref import (NEG_INF,  # noqa: E402
                                                  decode_reference)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding.rules import (axis_rules,  # noqa: E402
                                        param_sharding_tree, shard_of)
from repro_torch.training import tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_pair import ROOT, TOL  # noqa: E402
import _jax_decode_cache as jdc  # noqa: E402
from _torch_train_ranks import mesh_decode_rank, spawn  # noqa: E402

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ROW = (2e-2, 1e-2)       # absolute, and relative to a row's max |x|


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """torch on one intra-op thread beside JAX in this process, as the
    port's tests hold it there (ROADMAP Queue 3 item 10)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) one slice: the plain kernel against JAX's _local_decode_with_lse
# ---------------------------------------------------------------------------

# (b, hq, hkv, s_local, d, start, lens, window, softcap): rows ending
# before the slice (no valid key), inside it and past it; a window that
# cuts the slice from below, one inside it and one that starts past it
# (no valid key); softcap; GQA 4 and 1
SLICE_CASES = [
    (3, 4, 4, 64, 32, 64, [30, 64, 100], None, None),
    (3, 8, 2, 64, 32, 64, [100, 130, 200], 20, None),
    (2, 8, 2, 48, 16, 0, [60, 40], 16, 30.0),
    (3, 4, 1, 40, 64, 80, [81, 120, 500], 100, 50.0),
    (2, 2, 2, 32, 16, 32, [1, 64], None, 20.0),
]


@pytest.mark.parametrize("case", SLICE_CASES)
def test_slice_decode_with_lse_matches_jax(case):
    b, hq, hkv, s, d, start, lens, window, softcap = case
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    kw = dict(window=window, softcap=softcap, scale=None)
    jout, jlse = (np.asarray(a) for a in j_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), start, start + s,
        global_len=jnp.asarray(kv_len), **kw))
    qt, lt = torch.from_numpy(q), torch.from_numpy(kv_len)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    out, lse = _local_decode_with_lse(qt, kt.transpose(1, 2),
                                      vt.transpose(1, 2), start, start + s,
                                      global_len=lt, **kw)
    ref, ref_lse = decode_reference(
        qt[:, :, None], kt.transpose(1, 2), vt.transpose(1, 2), lt,
        layout="bshd", kv_start=start, return_lse=True, **kw)
    assert out.shape == (b, hq, d) and lse.dtype == torch.float32
    empty = jlse <= NEG_INF / 2
    assert empty.any() or start == 0
    for got, got_lse in ((out, lse), (ref[:, :, 0], ref_lse[:, :, 0])):
        np.testing.assert_allclose(got_lse.numpy(), jlse, **ATTN_TOL)
        np.testing.assert_allclose(got.numpy()[~empty], jout[~empty],
                                   **ATTN_TOL)
        assert not got.numpy()[empty].any()


@pytest.mark.parametrize("case", SLICE_CASES)
def test_bf16_slice_partial_is_jaxs_float32_partial(case):
    """On bf16 inputs the slice's output and log-sum-exp are float32, as
    JAX's ``_local_decode_with_lse`` gives them, so the ranks' merge
    weighs unrounded partials: held to JAX's within the float32
    tolerance, far inside one bf16 rounding (2^-9 of a value)."""
    b, hq, hkv, s, d, start, lens, window, softcap = case
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).bfloat16() for shape in ((b, hq, d), (b, hkv, s, d),
                                              (b, hkv, s, d)))
    kv_len = np.asarray(lens, np.int32)
    kw = dict(window=window, softcap=softcap, scale=None)
    jout, jlse = (np.asarray(a) for a in j_local(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), start, start + s,
        global_len=jnp.asarray(kv_len), **kw))
    assert jout.dtype == np.float32
    out, lse = _local_decode_with_lse(
        q, k.transpose(1, 2), v.transpose(1, 2), start, start + s,
        global_len=torch.from_numpy(kv_len), **kw)
    assert out.dtype == lse.dtype == torch.float32
    empty = jlse <= NEG_INF / 2
    np.testing.assert_allclose(lse.numpy(), jlse, **ATTN_TOL)
    np.testing.assert_allclose(out.numpy()[~empty], jout[~empty],
                               **ATTN_TOL)
    assert not out.numpy()[empty].any()


def test_slice_offset_zero_without_lse_is_the_whole_cache():
    """kv_start 0 and no lse: decode_reference's old function."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 4, 1, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(
        np.float32)) for _ in range(2))
    lens = torch.tensor([40, 9], dtype=torch.int32)
    out, lse = decode_reference(q, k, v, lens, layout="bshd", window=8,
                                return_lse=True)
    torch.testing.assert_close(
        decode_reference(q, k, v, lens, layout="bshd", window=8), out,
        rtol=0, atol=0)
    assert lse.shape == (2, 4, 1) and bool((lse > NEG_INF / 2).all())


# ---------------------------------------------------------------------------
# (b), (c) the model on gloo ranks against JAX
# ---------------------------------------------------------------------------

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
# name -> (arch, the reduced config's changed fields)
CASES = {"llama2-7b": ("llama2-7b", {}), "gemma2-2b": ("gemma2-2b", {}),
         "qwen2.5-32b": ("qwen2.5-32b", {}),
         "llama2-7b-bf16": ("llama2-7b", BF16)}
ARCHS = list(CASES)
# (c) compares the float32 cases: in bf16, JAX's own (2, 2) mesh is 1.105
# of the bf16 bound from its one-device logits (the ranks: 0.845), so it
# is no tighter reference than the one device (b) holds them to
MESH_ARCHS = [name for name in ARCHS if not CASES[name][1]]
B, S = 4, 96                  # two slices of 48 positions at model = 2
# the first slice; across its end (47 | 48); the last slice, where
# gemma2-2b's window of 32 leaves slice 0 no valid key (kv_len 81, 82)
POSITIONS = [0, 1, 2, 46, 47, 48, 49, 80, 81]
MESHES = {"1x2": dict(data=1, model=2), "2x2": dict(data=2, model=2)}


def _case(name: str) -> dict:
    """JAX's reduced ``arch`` of case ``name`` (with its changed fields)
    at PRNGKey(0), its weights as the port's float32 numpy tree with each
    leaf's dtype, random per-layer caches (values exact in the model's
    dtype) as the cache's leaves (k, v of each layer), the steps' tokens,
    and JAX's one-device decode: every step's logits and the final
    cache's leaves (``_jax_decode_cache``)."""
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
    shape = (B, S, jcfg.num_kv_heads, jcfg.head_dim)
    exact = (lambda a: a) if not cfg_kw else (
        lambda a: torch.from_numpy(a).bfloat16().float().numpy())
    case["leaves"] = [exact(rng.normal(size=shape).astype(np.float32))
                      for _ in range(2 * jcfg.num_layers)]
    case["steps"] = [(pos, rng.integers(0, jcfg.vocab_size,
                                        size=B).astype(np.int32))
                     for pos in POSITIONS]
    jcache = jdc.jax_cache(jm, case["leaves"], B, S)
    logits = []
    for pos, tok in case["steps"]:
        lg, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache,
                                    jnp.int32(pos))
        logits.append(np.asarray(lg, dtype=np.float32))
    return dict(case, logits=logits, final=jdc.port_leaves(jcfg, jcache))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's one-device decode of every arch; JAX's own (2, 2) mesh in a
    subprocess started first (``_jax_decode_cache.jax_mesh_main``),
    beside the port's (1, 2) and (2, 2) ranks (one spawn a mesh, every
    arch in turn)."""
    tmp = tmp_path_factory.mktemp("cp_decode")
    cases = {name: _case(name) for name in ARCHS}
    keys = ("arch", "cfg_kw", "batch", "seq", "leaves", "steps")
    np.save(tmp / "cases.npy", {name: {k: cases[name][k] for k in keys}
                                for name in MESH_ARCHS}, allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([
        os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="cpu")
    child = subprocess.Popen(
        [sys.executable, "-m", "_jax_decode_cache", str(tmp / "cases.npy"),
         str(tmp / "jax_mesh.npy")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        work = [{k: c[k] for k in keys + ("params", "dtypes")}
                for c in cases.values()]
        ranks = {name: spawn(mesh_decode_rank, kw["data"] * kw["model"],
                             tmp, kw, work)
                 for name, kw in MESHES.items()}
        _, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err[-3000:]
    jax_mesh = np.load(tmp / "jax_mesh.npy", allow_pickle=True).item()
    return cases, ranks, jax_mesh


def _close(name: str, got, want, err_msg: str = "") -> None:
    """``got`` against ``want``: ``TOL`` in a float32 case; in a bf16 one
    each row along the last axis within BF16_ROW of the row's largest
    |want|."""
    if not CASES[name][1]:
        np.testing.assert_allclose(got, want, err_msg=err_msg, **TOL)
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), err_msg
    bound = BF16_ROW[0] + BF16_ROW[1] * np.abs(want).max(-1, keepdims=True)
    worst = (np.abs(got - want) / bound).max()
    assert worst <= 1.0, f"{err_msg}: {worst:.3f} of the bf16 bound"


def _rows(mesh_kw: dict, coords: dict) -> slice:
    n = B // mesh_kw["data"]
    return slice(coords["data"] * n, (coords["data"] + 1) * n)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_decode_matches_jax_one_device(runs, mesh_name, arch):
    """Every rank's logits at every position are JAX's one-device logits
    of its rows; the two model ranks of a row group agree bit for bit;
    each rank's cache is the rule table's slice of (B, S, Hkv, D), and at
    the end it holds the slice of JAX's final cache (the new rows written
    by the rank that owns their position, the rest untouched)."""
    cases, ranks, _ = runs
    case = cases[arch]
    mesh_kw = MESHES[mesh_name]
    ai = ARCHS.index(arch)
    mesh = make_mesh((mesh_kw["data"], mesh_kw["model"]), ("data", "model"))
    for r, res in enumerate(ranks[mesh_name]):
        got = res[ai]
        assert got["coords"] == make_mesh(mesh.sizes, mesh.axis_names,
                                          r).coords
        rows = _rows(mesh_kw, got["coords"])
        hkv, d = case["leaves"][0].shape[2:]
        assert got["shapes"] == [(B // mesh_kw["data"],
                                  S // mesh_kw["model"], hkv, d)] * len(
            case["leaves"])
        for step, (lg, want) in enumerate(zip(got["logits"],
                                              case["logits"], strict=True)):
            _close(arch, lg, want[rows], str(step))
        pair = ranks[mesh_name][r ^ 1][ai]
        for a, b_ in zip(got["logits"], pair["logits"]):
            np.testing.assert_array_equal(a, b_)
        rank_mesh = make_mesh(mesh.sizes, mesh.axis_names, r)
        for i, (part, sp, whole) in enumerate(zip(
                got["leaves"], got["specs"], case["final"], strict=True)):
            _close(arch, part, shard_of(torch.from_numpy(whole), sp,
                                        rank_mesh).numpy(),
                   f"layer {i // 2} {'kv'[i % 2]}")


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_decode_matches_jax_mesh(runs, arch):
    """The (2, 2) ranks against JAX's own (2, 2) mesh under the dry run's
    decode shardings: each rank's logits are the JAX mesh's of its rows,
    JAX's cache shard at the rank's coordinate covers the rule table's
    rows and positions, and the rank's final slice holds that shard."""
    cases, ranks, jax_mesh = runs
    want = jax_mesh[arch]
    ai = ARCHS.index(arch)
    for step, (jl, ol) in enumerate(zip(want["logits"],
                                        cases[arch]["logits"])):
        _close(arch, jl, ol, str(step))
    for res in ranks["2x2"]:
        got = res[ai]
        c = got["coords"]
        rows = _rows(MESHES["2x2"], c)
        for lg, jl in zip(got["logits"], want["logits"], strict=True):
            _close(arch, lg, jl[rows])
        s_l = S // 2
        for i, (part, whole, where) in enumerate(zip(
                got["leaves"], want["leaves"], want["shards"], strict=True)):
            (b0, b1), (s0, s1) = where[(c["data"], c["model"])][:2]
            assert (b0, b1) == (rows.start, rows.stop), i
            assert (s0, s1) == (c["model"] * s_l, (c["model"] + 1) * s_l)
            _close(arch, part, whole[b0:b1, s0:s1], f"layer {i // 2}")


# ---------------------------------------------------------------------------
# (d) what is left out, and the layout without a collective
# ---------------------------------------------------------------------------

# (batch, positions) the (2, 2) mesh does not split: a cache width the
# model axis does not divide, a batch the data axis does not
UNSPLIT = {"97-positions": (B, 97), "3-rows": (3, S)}


@pytest.fixture(scope="module")
def unsplit_runs(tmp_path_factory):
    """JAX's one-device decode of reduced llama2-7b on each UNSPLIT
    cache, beside the port's (2, 2) gloo ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp("cp_unsplit")
    case0 = {"arch": "llama2-7b", "cfg_kw": {}}
    jcfg = jdc.config(dict(case0, batch=B, seq=S))
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jp),
                              t_reduce(t_get("llama2-7b")), "cpu")
    cases, want = [], []
    for b, s in UNSPLIT.values():
        rng = np.random.default_rng(11)
        case = dict(case0, batch=b, seq=s,
                    params=tree.tree_map(lambda t: t.numpy().copy(),
                                         tparams),
                    dtypes=tree.tree_map(lambda t: "float32", tparams))
        shape = (b, s, jcfg.num_kv_heads, jcfg.head_dim)
        case["leaves"] = [rng.normal(size=shape).astype(np.float32)
                          for _ in range(2 * jcfg.num_layers)]
        case["steps"] = [(pos, rng.integers(0, jcfg.vocab_size,
                                            size=b).astype(np.int32))
                         for pos in (0, 47, 48, s - 1)]
        cache = jdc.jax_cache(jm, case["leaves"], b, s)
        logits = []
        for pos, tok in case["steps"]:
            lg, cache = jm.decode_step(jp, jnp.asarray(tok), cache,
                                       jnp.int32(pos))
            logits.append(np.asarray(lg, dtype=np.float32))
        cases.append(case)
        want.append(logits)
    ranks = spawn(mesh_decode_rank, 4, tmp, MESHES["2x2"], cases)
    return want, ranks


@pytest.mark.parametrize("name", list(UNSPLIT))
def test_cache_width_or_batch_that_does_not_split_raises(unsplit_runs,
                                                        name):
    """What raised ValueError before the rule table's layout was followed
    now decodes: a dim the mesh does not divide stays whole, as
    ``param_sharding_tree`` keeps it -- 97 positions on every model rank
    (decoded as one device does, no merge), 3 rows on every data rank --
    and every rank's logits of its rows are JAX's one-device logits
    within TOL."""
    want, ranks = unsplit_runs
    i = list(UNSPLIT).index(name)
    b, s = UNSPLIT[name]
    mesh = make_mesh((2, 2), ("data", "model"))
    for r, res in enumerate(ranks):
        got = res[i]
        coords = make_mesh(mesh.sizes, mesh.axis_names, r).coords
        rows = slice(0, b) if b % 2 else _rows(MESHES["2x2"], coords)
        s_l = s if s % 2 else s // 2
        assert set(got["shapes"]) == {(rows.stop - rows.start, s_l, 2, 16)}
        for step, (lg, w) in enumerate(zip(got["logits"], want[i],
                                           strict=True)):
            np.testing.assert_allclose(lg, w[rows], err_msg=str(step), **TOL)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_init_cache_is_the_rule_table_slice(shape):
    """Each rank's cache has the shape of its rule-table slice of
    ``cache_logical`` (``kv_seq -> model``, ``batch -> data``)."""
    cfg = t_reduce(t_get("gemma2-2b"))
    model = build_model(cfg, "cpu")
    whole = model.init_cache(B, S)
    for r in range(shape[0] * shape[1]):
        mesh = make_mesh(shape, ("data", "model"), r)
        with axis_rules(mesh=mesh):
            mine = model.init_cache(B, S)
        specs = param_sharding_tree(model.cache_logical(B, S), mesh)
        for kv, w, sp in zip(mine, whole, specs, strict=True):
            assert sp.k[:2] == ("data", "model")
            assert kv.k.shape == kv.v.shape == shard_of(w.k, sp.k,
                                                        mesh).shape
            assert kv.k.shape == (B // shape[0], S // shape[1],
                                  cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("arch", ["llama2-7b", "xlstm-125m"])
def test_data_only_mesh_decodes_each_ranks_rows(arch):
    """Under a (2, 1) mesh (no model axis to split: no collective) each
    rank decodes its rows of the batch from its rows of the cache, as the
    one-device step does those rows; recurrent kinds included."""
    cfg = t_reduce(t_get(arch))
    model = build_model(cfg, "cpu")
    params = model.init(model.generator(0))
    rng = np.random.default_rng(5)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, size=B).astype(
        np.int64)) for _ in range(4)]
    one = model.init_cache(B, 16)
    want = []
    for pos, tok in enumerate(toks):
        lg, one = model.decode_step(params, tok, one, pos)
        want.append(lg)
    for r in range(2):
        with axis_rules(mesh=make_mesh((2, 1), ("data", "model"), r)):
            cache = model.init_cache(B, 16)
            for pos, tok in enumerate(toks):
                lg, cache = model.decode_step(params, tok, cache, pos)
                torch.testing.assert_close(lg, want[pos][2 * r:2 * r + 2],
                                           **TOL)

