"""The dry run (``repro_torch.launch.dryrun``) against the JAX package's,
on the CPU.

* (1) every assigned arch x shape x production mesh (16 x 16, 2 x 16 x
  16) cell: each leaf of the rank's pieces -- parameters, AdamW state,
  batch, decode token and cache -- has the shape and dtype of JAX's
  ``NamedSharding(mesh, spec).shard_shape`` of its own dry-run trees
  (``jax.eval_shape``, nothing compiled; ``_jax_dryrun.py shards`` in a
  subprocess with 512 forced host devices), a stacked JAX leaf's layer
  dim dropped;
* (2) three reduced cells (a dense ``train``, hymba ``decode``, whisper
  ``prefill``, cut in batch and sequence) on a (2, 4) mesh: the record's
  ``argument_bytes`` equal, byte for byte, XLA's per-device
  ``argument_size_in_bytes`` of the cell JAX's dry run lowers
  (``_jax_dryrun.py memory``, 8 forced host devices);
* (3) the skipped cells are JAX's ``skip_reason``'s; ``main --all``
  writes one record per cell and exits 0, and the roofline's command
  line renders two of them;
* (4) the record's ``collectives`` equal ``sharding/collectives.COUNTS``
  and ``core/tiled_allreduce.COUNTS`` of one rank's step (train, prefill,
  decode at B = 8, 1 and 3 on 63 positions) of every assigned arch,
  reduced, in a fake world of four ranks (a subprocess; the fake
  backend's collectives move no data), on (2, 2) and (2, 1, 2);
* (5) long_500k's B = 1 on (2, 2) gloo ranks: reduced hymba-1.5b and
  xlstm-125m decode their one row, whole on every data rank, within
  ``_torch_mesh_pair.TOL`` of JAX's one-device ``decode_step``.
"""
import dataclasses
import json
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
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 periodic_segments)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _jax_decode_cache as jdc  # noqa: E402
from _jax_dryrun import MEMORY_CELLS, MEMORY_MESH  # noqa: E402
from _torch_mesh_pair import ROOT, TOL  # noqa: E402
from _torch_train_ranks import mesh_decode_rank, spawn  # noqa: E402

MESHES = {"16x16": False, "2x16x16": True}
FAKE_MESHES = {"2x2": dict(data=2, model=2),
               "2x1x2": dict(pods=2, data=1, model=2)}
# (4)'s reduced shapes: one of each kind, and decode batches that the
# data axis splits, leaves whole (1 row), and a cache width the model
# axis leaves whole (63 positions)
FAKE_SHAPES = [ShapeConfig("train_r", 32, 8, "train"),
               ShapeConfig("prefill_r", 32, 8, "prefill"),
               ShapeConfig("decode_r", 64, 8, "decode"),
               ShapeConfig("decode_b1", 64, 1, "decode"),
               ShapeConfig("decode_odd", 63, 3, "decode")]
LONG_ARCHS = ["hymba-1.5b", "xlstm-125m"]
LONG_B, LONG_S = 1, 96          # two KV slices of 48 positions at model 2
LONG_POSITIONS = [0, 1, 46, 47, 48, 81]

FAKE_CHILD = r"""
import json, sys
import torch
from repro_torch.config import ParallelConfig, ShapeConfig
from repro_torch.config import get_model_config, reduce_for_smoke
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.core import tiled_allreduce as T
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_mesh_for
from repro_torch.sharding import collectives as C
torch.set_num_threads(1)
mesh_kw, shapes, out = json.loads(sys.argv[1])
par = ParallelConfig(**mesh_kw)
res = {}
world = 1
for n in par.mesh_shape():
    world *= n
with fake_world(world):
    mesh = make_mesh_for(par)
    for arch in ASSIGNED_ARCHS:
        cfg = reduce_for_smoke(get_model_config(arch))
        for sh in shapes:
            shape = ShapeConfig(*sh)
            cell = D.build_cell(cfg, shape, mesh)
            want = D.collective_counts(cell)
            C.COUNTS.update({k: 0 for k in C.COUNTS})
            T.COUNTS.update({k: 0 for k in T.COUNTS})
            D.rank_step(D.materialize(cell, "cpu"), positions=(5,))
            res[f"{arch}|{shape.name}"] = {
                "want": want, "refused": D.refused(cell),
                "got": {"sharding": dict(C.COUNTS), "merge": dict(T.COUNTS)}}
with open(out, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every subprocess of the file, started together: JAX's shard
    shapes (512 forced host devices), XLA's memory analysis (8), and a
    fake world of four ranks a (4) mesh.  Returns name -> its result."""
    tmp = tmp_path_factory.mktemp("dryrun")
    src = os.path.join(ROOT, "src")
    tests = os.path.join(ROOT, "tests")
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([src, tests]))
    started = {}
    for what, n in (("shards", 512), ("memory", 8)):
        env = dict(jax_env, XLA_FLAGS="--xla_force_host_platform_device_"
                   f"count={n}")
        started[what] = subprocess.Popen(
            [sys.executable, "-m", "_jax_dryrun", what,
             str(tmp / f"{what}.json")], env=env, cwd=tests,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, kw in FAKE_MESHES.items():
        arg = json.dumps([kw, [dataclasses.astuple(s) for s in FAKE_SHAPES],
                          str(tmp / f"{name}.json")])
        started[name] = subprocess.Popen(
            [sys.executable, "-c", FAKE_CHILD, arg],
            env=dict(os.environ, PYTHONPATH=src), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, proc in started.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{name}: {err[-3000:]}"
            with open(tmp / f"{name}.json") as f:
                out[name] = json.load(f)
    finally:
        for proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``main --all``'s records (its exit code and its directory)."""
    out = tmp_path_factory.mktemp("dryrun_records")
    with pytest.raises(SystemExit) as stop:
        D.main(["--all", "--out", str(out)])
    return stop.value.code, str(out), roofline.load_records(str(out))


# ---------------------------------------------------------------------------
# the meta device: the allocating code, drawing nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_meta_init_is_the_real_inits_tree(arch):
    """``init()`` with no generator on the meta device makes every leaf
    of the real init's tree with its shape and dtype (and stores
    nothing); off the meta device a call with no generator raises."""
    cfg = t_reduce(t_get(arch))
    real = build_model(cfg, "cpu")
    meta = build_model(cfg, "meta").init()
    assert all(t.is_meta for t in tree.leaves(meta))
    assert _enc(meta) == _enc(real.init(real.generator(0)))
    with pytest.raises(ValueError, match="needs a generator"):
        real.init()


# ---------------------------------------------------------------------------
# (1) every leaf's piece against JAX's shard shape
# ---------------------------------------------------------------------------

def _enc(t):
    """The port's tree as ``_jax_dryrun``'s JSON: [shape, dtype] leaves."""
    if isinstance(t, torch.Tensor):
        return [list(t.shape), str(t.dtype).split(".")[-1]]
    if isinstance(t, dict):
        return {k: _enc(v) for k, v in t.items()}
    return [_enc(v) for v in t]


def _unstack(t, stacked: bool):
    """A JAX tree of [shape, dtype] leaves with its stacked layer dim
    dropped."""
    if isinstance(t, dict):
        return {k: _unstack(v, stacked) for k, v in t.items()}
    if len(t) == 2 and isinstance(t[1], str):
        return [t[0][1:], t[1]] if stacked else t
    return [_unstack(v, stacked) for v in t]


def _per_layer(jtree: dict, cfg) -> list:
    """The port's per-layer list of JAX's segment tree (layer ``rep *
    len(unit) + i`` is unit member ``u{i}``: ``params_from_jax``'s
    mapping)."""
    out = []
    for si, (unit, reps) in enumerate(periodic_segments(cfg)):
        for _ in range(reps):
            for i in range(len(unit)):
                out.append(_unstack(jtree[f"seg{si}"][f"u{i}"], reps > 1))
    return out


def _jax_params(jtree: dict, cfg) -> dict:
    if cfg.is_encoder_decoder:
        out = {k: v for k, v in jtree.items()
               if k not in ("enc_blocks", "dec_blocks")}
        out["enc_blocks"] = [_unstack(jtree["enc_blocks"], True)] \
            * cfg.encoder_layers
        out["dec_blocks"] = [_unstack(jtree["dec_blocks"], True)] \
            * cfg.num_layers
        return out
    out = {k: v for k, v in jtree.items() if not k.startswith("seg")}
    out["layers"] = _per_layer(jtree, cfg)
    return out


def _jax_cache(jtree, cfg):
    if cfg.is_encoder_decoder:
        return {"self": [_unstack(jtree["self"], True)] * cfg.num_layers,
                "cross": [_unstack(jtree["cross"], True)] * cfg.num_layers}
    return _per_layer(jtree, cfg)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_leaf_piece_is_jaxs_shard_shape(children, arch):
    cfg = t_get(arch)
    checked = 0
    for mname, multi_pod in MESHES.items():
        want = children["shards"][f"{arch}|{mname}"]
        mesh = make_production_mesh(multi_pod=multi_pod)
        params = _jax_params(want["params"], cfg)
        assert want["mu_dtypes"] == ["float32"]
        for shape in SHAPES:
            if shape not in want:
                continue
            cell = D.build_cell(arch, shape, mesh)
            assert _enc(cell.params) == params, (mname, shape)
            if cell.opt is not None:
                assert _enc(cell.opt.step) == want["step"]
                for part in (cell.opt.mu, cell.opt.nu):
                    assert _enc(part) == tree.tree_map(
                        lambda t: [list(t.shape), "float32"], cell.params)
            got = want[shape]
            if "batch" in got:
                assert _enc(cell.batch) == got["batch"], (mname, shape)
            else:
                assert _enc(cell.token) == got["token"]
                assert _enc(cell.cache) == _jax_cache(got["cache"], cfg)
            checked += 1
    assert checked == 2 * (len(SHAPES) - (not cfg.is_subquadratic()))


# ---------------------------------------------------------------------------
# (2) the argument bytes against XLA's memory analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(MEMORY_CELLS))
def test_argument_bytes_equal_xla_memory_analysis(children, key):
    arch, shape = MEMORY_CELLS[key]
    mesh = make_mesh(MEMORY_MESH, ("data", "model"))
    cfg = t_reduce(t_get(arch))
    for rank in (0, mesh.world - 1):
        mem = D.memory(D.build_cell(cfg, shape, mesh, rank))
        assert mem["argument_bytes"] == children["memory"][key], rank


# ---------------------------------------------------------------------------
# (3) the cells, the skips and the command line
# ---------------------------------------------------------------------------

def test_skipped_cells_are_jaxs(children):
    from repro.config import get_model_config as j_get
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            jax_runs = shape in children["shards"][f"{arch}|16x16"]
            assert (D.skip_reason(arch, shape) == "") == jax_runs
            assert j_get(arch).is_subquadratic() == \
                t_get(arch).is_subquadratic()


def test_main_writes_every_cell_and_exits_zero(records):
    code, _, recs = records
    assert code == 0
    assert len(recs) == 2 * len(ASSIGNED_ARCHS) * len(SHAPES) == 80
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    assert skipped == {(a, "long_500k") for a in ASSIGNED_ARCHS
                       if a not in ("xlstm-125m", "hymba-1.5b")}
    by = {r["cell"]: r for r in recs}
    # the numbers the port's records stand on
    qd = by["qwen2.5-32b__decode_32k__16x16"]["memory"]
    assert qd["cache_bytes"] == 64 * 2 * 8 * 2048 * 8 * 128 * 2
    # grok-1's 8 experts do not divide a model axis of 16, so every rank
    # holds them whole: 98% of its bf16 weights on each
    grok = by["grok-1-314b__decode_32k__16x16"]
    assert grok["memory"]["param_bytes"] > 0.98 * 2 * grok[
        "param_count_leaves"] and not grok["fits_h100"]
    long = by["hymba-1.5b__long_500k__16x16"]["memory"]
    assert long["batch_bytes"] == 4 + 4          # the whole token, pos
    whisper = by["whisper-small__train_4k__16x16"]
    assert whisper["collectives"] is None and "1500 frames" in \
        whisper["refused"]


def test_roofline_main_renders_two_records(records, tmp_path, capsys):
    _, out, _ = records
    for name in ("qwen2.5-32b__train_4k__16x16",
                 "hymba-1.5b__long_500k__2x16x16"):
        with open(os.path.join(out, name + ".json")) as f:
            (tmp_path / (name + ".json")).write_text(f.read())
    roofline.main(["--dir", str(tmp_path)])
    text = capsys.readouterr().out.splitlines()
    assert text[0].split()[:2] == ["cell", "status"]
    rows = [line for line in text if line.startswith(("qwen", "hymba"))]
    assert len(rows) == 4 and all(" ok " in r or ": " in r for r in rows)
    rec = json.load(open(os.path.join(
        out, "qwen2.5-32b__train_4k__16x16.json")))
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    roofline.main(["--dir", str(tmp_path), "--mesh", "16x16"])
    assert "hymba" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (4) the record's collectives against a fake world's counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(FAKE_MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_collectives_equal_one_ranks_counts(children, mesh_name, arch):
    for shape in FAKE_SHAPES:
        res = children[mesh_name][f"{arch}|{shape.name}"]
        assert res["refused"] == ""
        assert res["got"] == res["want"], shape.name


# ---------------------------------------------------------------------------
# (5) long_500k's one row on a (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def long_runs(tmp_path_factory):
    """JAX's one-device decode of a B = 1 cache of each LONG_ARCHS arch,
    beside the port's (2, 2) gloo ranks (one spawn, the archs in
    turn)."""
    tmp = tmp_path_factory.mktemp("dryrun_long")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases, want = [], []
        for arch in LONG_ARCHS:
            case = {"arch": arch, "cfg_kw": {}, "batch": LONG_B,
                    "seq": LONG_S}
            jm = j_build(jdc.config(case), JParallel(remat="none"))
            jp = jm.init(jax.random.PRNGKey(0))
            tcfg = t_reduce(t_get(arch))
            params = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     "cpu")
            case["params"] = tree.tree_map(lambda t: t.numpy().copy(),
                                           params)
            case["dtypes"] = tree.tree_map(lambda t: "float32", params)
            rng = np.random.default_rng(3)
            shapes = build_model(tcfg, "cpu").init_cache(LONG_B, LONG_S)
            case["leaves"] = [rng.normal(size=t.shape).astype(np.float32)
                              for t in tree.leaves(shapes)]
            case["steps"] = [(p, rng.integers(0, tcfg.vocab_size,
                                               size=LONG_B).astype(np.int32))
                             for p in LONG_POSITIONS]
            cache = jdc.jax_cache(jm, case["leaves"], LONG_B, LONG_S)
            logits = []
            for pos, tok in case["steps"]:
                lg, cache = jm.decode_step(jp, jnp.asarray(tok), cache,
                                           jnp.int32(pos))
                logits.append(np.asarray(lg, dtype=np.float32))
            cases.append(case)
            want.append(logits)
    finally:
        torch.set_num_threads(n)
    ranks = spawn(mesh_decode_rank, 4, tmp, dict(data=2, model=2), cases)
    return want, ranks


@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_one_row_decodes_whole_on_every_data_rank(long_runs, arch):
    """long_500k's B = 1 does not split over data = 2: every rank holds
    the row (its cache leaves B = 1, the KV cache's positions still
    split over the model axis) and returns its logits, JAX's one-device
    logits within TOL."""
    want, ranks = long_runs
    i = LONG_ARCHS.index(arch)
    for res in ranks:
        got = res[i]
        # (an mLSTM state's empty conv placeholder aside)
        assert all(s[0] == LONG_B for s in got["shapes"] if np.prod(s)), \
            got["shapes"]
        for step, (lg, w) in enumerate(zip(got["logits"], want[i],
                                           strict=True)):
            np.testing.assert_allclose(lg, w, err_msg=str(step), **TOL)
