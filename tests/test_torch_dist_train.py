"""Data- and model-parallel training of the port against the JAX package,
on CPU gloo ranks (one spawned process a rank; bodies in
``tests/_torch_train_ranks.py``, which imports no JAX).

Each case carries the JAX ``LM.init`` weights across
(``params_from_jax``), gives every rank the same global batches, takes 3
AdamW steps on the mesh and holds the loss, grad norm and lr of every
step, every parameter (gathered whole) and the step counter to the JAX
step on one device -- what GSPMD computes on any mesh -- within phase
4's CPU tolerance, 1e-4 (float32 smoke configs; sums in another order).
Each rank's initial pieces are the rule table's slices for its
coordinate.  One case runs JAX's own (2, 2) mesh in a subprocess.  The
checkpoint of a (2, 2) run equals, file for file, the one-device save of
the same gathered state, and resumes at other meshes; the launcher runs
at --data 2 --model-axis 2; gloo runs the collectives the trainer
issues.
"""
import functools
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
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding.rules import (flatten, is_spec,  # noqa: E402
                                        shard_of)
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.train_step import state_specs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_pair import JaxMesh, check_ranks  # noqa: E402
from _torch_train_ranks import (collectives_rank,  # noqa: E402
                                remat_thread_rank, resume_rank, spawn,
                                train_rank)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
B, S, STEPS = 4, 64, 3


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _batches(vocab: int, n: int, uneven: bool = False) -> list:
    """``n`` global batches of B x S from the data pipeline.  ``uneven``
    masks 0, 5, 17 and 40 labels of the four rows, so that the DP ranks'
    and microbatches' masked counts differ."""
    pipe = TokenPipeline(DataConfig(vocab_size=vocab, seq_len=S,
                                    global_batch=B))
    out = []
    for _ in range(n):
        b = pipe.next()
        if uneven:
            for row, k in enumerate((0, 5, 17, 40)):
                b["labels"][row, :k] = -1
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, micro: int, uneven: bool, steps: int = STEPS):
    """JAX's init and ``steps`` steps on one device (shared by the cases
    of one arch): (batches, init params as the port's numpy tree,
    per-step metrics, final params, step counter)."""
    batches = _batches(t_reduce(t_get(arch)).vocab_size, steps, uneven)
    jcfg = reduce_for_smoke(get_model_config(arch))
    tcfg = t_reduce(t_get(arch))
    jpar = JParallel(remat="none", microbatches=micro)
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    init = tree.tree_map(lambda t: t.numpy().copy(), params_from_jax(
        _np_tree(jstate.params), tcfg, "cpu"))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**TRAIN)))
    metrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    final = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    return batches, init, metrics, final, int(jstate.opt.step)


def _check_ranks(ranks, arch, par_kw, init, metrics, final, jstep_n):
    """``_torch_mesh_pair.check_ranks`` on the reduced ``arch`` as it is."""
    check_ranks(ranks, arch, {}, par_kw, init, metrics, final, jstep_n)


CASES = {
    "llama-2x2": ("llama2-7b", dict(data=2, model=2), False),
    # window 32, softcap, post-norms, a tied embed
    "gemma-1x2": ("gemma2-2b", dict(model=2), False),
    # replicated qkv biases; every block recomputed under remat
    "qwen-1x2-remat": ("qwen2.5-32b", dict(model=2, remat="full"), False),
    "llama-2x1-micro": ("llama2-7b", dict(data=2, microbatches=2), True),
    "xlstm-2x1": ("xlstm-125m", dict(data=2), False),
    "llama-pods2": ("llama2-7b", dict(pods=2, data=1, model=2), False),
}


_PORT_RUNS: dict = {}


def _port_run(case: str, tmp_path):
    """The case's ranks on its mesh (shared by the tests that read
    them)."""
    if case not in _PORT_RUNS:
        arch, par_kw, uneven = CASES[case]
        batches, init, *_ = _jax_run(arch, par_kw.get("microbatches", 1),
                                     uneven)
        par = ParallelConfig(**par_kw)
        _PORT_RUNS[case] = spawn(train_rank, par.dp * par.model, tmp_path,
                                 arch, par_kw, init, batches, TRAIN,
                                 {"dir": str(tmp_path / "ck")})
    return _PORT_RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_training_matches_jax(case, tmp_path):
    arch, par_kw, uneven = CASES[case]
    _, init, metrics, final, n = _jax_run(
        arch, par_kw.get("microbatches", 1), uneven)
    _check_ranks(_port_run(case, tmp_path), arch, par_kw, init, metrics,
                 final, n)


def test_mesh_training_matches_jax_own_2x2_mesh(tmp_path):
    """The port's (2, 2) ranks against JAX's own (2, 2) mesh (GSPMD over
    four forced host devices, in a subprocess): the same steps."""
    batches, init, *_ = _jax_run("llama2-7b", 1, False)
    metrics, final, step = JaxMesh("llama2-7b", {}, batches,
                                   tmp_path).result()
    _check_ranks(_port_run("llama-2x2", tmp_path), "llama2-7b",
                 CASES["llama-2x2"][1], init, metrics, final, step)


def _same_files(a, b, step) -> None:
    da, db = (os.path.join(d, f"step_{step:08d}") for d in (a, b))
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db)) and "arr_0.npy" in names
    for n in names:
        with open(os.path.join(da, n), "rb") as fa, \
                open(os.path.join(db, n), "rb") as fb:
            ba, bb = fa.read(), fb.read()
        if n == "manifest.json":
            ma, mb = json.loads(ba), json.loads(bb)
            ma.pop("time"), mb.pop("time")
            assert ma == mb
        else:
            assert ba == bb, n


def test_checkpoint_is_the_one_device_file_and_resumes_at_other_meshes(
        tmp_path):
    """A (2, 2) save gathers every leaf whole and rank 0 writes what a
    one-device manager writes for the same state, bit for bit; (1, 2),
    (2, 1) and one device restore their pieces of it -- every leaf,
    AdamW's moments and step too, exactly the rule table's slice of the
    saved whole -- and take the next step to the (2, 2) run's own next
    loss and state."""
    arch = "llama2-7b"
    cfg = t_reduce(t_get(arch))
    batches = _batches(cfg.vocab_size, STEPS + 1)
    _, init, *_ = _jax_run(arch, 1, False)
    ck, one = tmp_path / "ck", tmp_path / "one"
    ranks = spawn(train_rank, 4, tmp_path, arch, dict(data=2, model=2),
                  init, batches[:STEPS], TRAIN,
                  {"dir": str(ck), "save": True, "one": str(one),
                   "next": batches[STEPS]})
    _same_files(ck, one, STEPS)
    nxt = ranks[0]["next_loss"]
    assert all(r["next_loss"] == nxt for r in ranks)
    saved, after = ranks[0]["final"], ranks[0]["next_final"]
    for par_kw in (dict(data=1, model=2), dict(data=2, model=1)):
        res = spawn(resume_rank, 2, tmp_path, arch, par_kw, init, TRAIN,
                    str(ck), batches[STEPS])
        par = ParallelConfig(**par_kw)
        for rank, r in enumerate(res):
            assert r["restored_step"] == STEPS and r["step"] == STEPS + 1
            np.testing.assert_allclose(r["loss"], nxt, **TOL)
            mesh = make_mesh(par.mesh_shape(), par.mesh_axes(), rank)
            specs = flatten(state_specs(build_model(
                cfg, "cpu", par).param_specs(mesh)), is_spec)
            assert len(r["restored"]) == len(saved) == len(specs)
            for got, whole, spec in zip(r["restored"], saved, specs):
                np.testing.assert_array_equal(
                    got, shard_of(torch.from_numpy(whole), spec,
                                  mesh).numpy())
        # the step from the restored moments is the (2, 2) run's step
        assert len(res[0]["after"]) == len(after)
        for a, b in zip(res[0]["after"], after):
            np.testing.assert_allclose(a, b, **TOL)
    # one device: the plain manager reads the same files
    from repro_torch.training.train_step import (TrainState,
                                                 make_train_step)
    from repro_torch.training import optimizer as opt
    from repro_torch.config import TrainConfig
    params = tree.tree_map(torch.from_numpy, init)
    model = build_model(cfg, "cpu", ParallelConfig())
    state, manifest = CheckpointManager(str(ck)).restore(
        TrainState(params, opt.init_adamw(params)))
    for a, b in zip(tree.leaves(state), saved, strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    step = make_train_step(model, cfg, ParallelConfig(), TrainConfig(**TRAIN))
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batches[STEPS].items()})
    assert manifest["extras"]["data"] == {"step": 7}
    np.testing.assert_allclose(float(m["loss"]), nxt, **TOL)
    for a, b in zip(tree.leaves(state), after, strict=True):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_train_cli_on_a_2x2_mesh(tmp_path):
    """The launcher spawns data x model ranks over gloo and writes one
    checkpoint the one-device restore reads."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama2-7b", "--smoke", "--device", "cpu", "--steps", "3",
           "--batch", "4", "--seq", "32", "--data", "2", "--model-axis",
           "2", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "4 ranks (data=2, model=2) over gloo" in out.stdout
    assert "step     2 loss" in out.stdout and "done" in out.stdout
    for r in range(4):
        assert f"rank {r} " in out.stdout
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path))[:2] == ["LATEST", "step_00000002"]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_runs_the_trainers_collectives(world, tmp_path):
    """gloo runs all_gather_into_tensor and reduce_scatter_tensor on CPU
    tensors (phase 4b of chip_smoke.py runs them on CUDA tensors): along
    either dimension, in group-rank order; the gather's gradient is the
    rank's piece of the ranks' summed gradients."""
    ranks = spawn(collectives_rank, world, tmp_path, world)
    blocks = [np.arange(12, dtype=np.float32).reshape(3, 4) + 100 * r
              for r in range(world)]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["gather0"], np.concatenate(blocks))
        np.testing.assert_array_equal(res["gather1"],
                                      np.concatenate(blocks, axis=1))
        np.testing.assert_array_equal(res["scatter1"], sum(blocks))
        # d/dw of sum_r (r + 1) * gather(w): every rank's piece gets the
        # sum of the weights
        np.testing.assert_array_equal(
            res["grad"], np.full((3, 4), world * (world + 1) / 2))


def test_remat_recompute_on_another_thread_finds_the_mesh(tmp_path):
    """The backward's recompute of a block under remat gathers K/V and
    the weights as the forward did when autograd runs it on another
    thread (as CUDA's device thread does): the same gradients."""
    batches, init, *_ = _jax_run("llama2-7b", 1, False)
    for res in spawn(remat_thread_rank, 2, tmp_path, "llama2-7b", init,
                     batches[0]):
        assert len(res["thread"]) == len(res["here"])
        for a, b in zip(res["here"], res["thread"]):
            np.testing.assert_array_equal(a, b)
