"""Shared set-up of the tests that train the recurrent cells and the
encoder-decoder on a (data, model) mesh (``test_torch_mesh_ssm.py``,
``test_torch_mesh_encdec.py``): the JAX package's one-device run and its
own (2, 2) mesh as references, the port's gloo ranks
(``_torch_train_ranks.train_rank``) and the checks that hold them to
each other.

Every case carries JAX's ``init`` weights across (``params_from_jax``),
gives every rank the same global batches, takes STEPS AdamW steps and
holds the loss, grad norm and lr of every step, every parameter
(gathered whole) and the step counter to the reference within TOL
(float32 reduced configs; sums in another order).  Each rank's initial
pieces are the rule table's slices for its coordinate.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import ParallelConfig as JParallel
from repro.config import TrainConfig as JTrain
from repro.config import get_model_config, reduce_for_smoke
from repro.models import build_model as j_build
from repro.training import train_step as jts
from repro_torch.config import ParallelConfig
from repro_torch.config import get_model_config as t_get
from repro_torch.config import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.sharding.rules import flatten, is_spec, shard_of
from repro_torch.training import tree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import spawn, train_rank  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
B, STEPS = 4, 3


def configs(arch: str, cfg_kw: dict):
    """(JAX's, the port's) reduced config of ``arch`` with ``cfg_kw``."""
    return (dataclasses.replace(reduce_for_smoke(get_model_config(arch)),
                                **cfg_kw),
            dataclasses.replace(t_reduce(t_get(arch)), **cfg_kw))


def batches(cfg, seq: int, n: int = STEPS) -> list:
    """``n`` global batches of B x ``seq`` from the data pipeline, 0, 5,
    9 and 13 labels of the four rows masked (the ranks' masked counts
    differ); an encoder-decoder's also carry N(0, 1) ``enc_embeds`` of
    ``encoder_seq`` frames from a seeded generator."""
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=B))
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        b = pipe.next()
        for row, k in enumerate((0, 5, 9, 13)):
            b["labels"][row, :k] = -1
        if cfg.is_encoder_decoder:
            b["enc_embeds"] = rng.normal(size=(
                B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


_JAX_RUNS: dict = {}


def jax_run(arch: str, cfg_kw: dict, seq: int):
    """JAX's init and STEPS steps on one device (shared by the cases of
    one arch): (batches, init params as the port's numpy tree, per-step
    metrics, final params, step counter)."""
    key = (arch, tuple(sorted(cfg_kw.items())), seq)
    if key not in _JAX_RUNS:
        jcfg, tcfg = configs(arch, cfg_kw)
        bs = batches(tcfg, seq)
        jpar = JParallel(remat="none")
        jm = j_build(jcfg, jpar)
        jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
        init = tree.tree_map(lambda t: t.numpy().copy(), params_from_jax(
            _np_tree(jstate.params), tcfg, "cpu"))
        jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**TRAIN)))
        metrics = []
        for b in bs:
            jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            metrics.append({k: float(m[k])
                            for k in ("loss", "grad_norm", "lr")})
        final = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
        _JAX_RUNS[key] = (bs, init, metrics, final, int(jstate.opt.step))
    return _JAX_RUNS[key]


_PORT_RUNS: dict = {}


def port_run(name: str, arch: str, cfg_kw: dict, par_kw: dict, seq: int,
             tmp_path) -> list:
    """The ranks of ``par_kw``'s mesh on JAX's init and batches (shared
    by the tests that read them)."""
    if name not in _PORT_RUNS:
        bs, init, *_ = jax_run(arch, cfg_kw, seq)
        par = ParallelConfig(**par_kw)
        _PORT_RUNS[name] = spawn(train_rank, par.dp * par.model, tmp_path,
                                 arch, par_kw, init, bs, TRAIN,
                                 {"dir": str(tmp_path / "ck")}, cfg_kw)
    return _PORT_RUNS[name]


_ONE_RUNS: dict = {}


def port_one_device(arch: str, cfg_kw: dict, seq: int) -> dict:
    """The port's own one-device run of JAX's init and batches: its final
    params (the port's tree)."""
    from repro_torch.config import TrainConfig
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import TrainState, make_train_step
    key = (arch, tuple(sorted(cfg_kw.items())), seq)
    if key not in _ONE_RUNS:
        bs, init, *_ = jax_run(arch, cfg_kw, seq)
        cfg = configs(arch, cfg_kw)[1]
        model = build_model(cfg, "cpu", ParallelConfig())
        params = tree.tree_map(lambda a: torch.from_numpy(a.copy()), init)
        state = TrainState(params, opt.init_adamw(params))
        step = make_train_step(model, cfg, ParallelConfig(),
                               TrainConfig(**TRAIN))
        for b in bs:
            state, _ = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        _ONE_RUNS[key] = state.params
    return _ONE_RUNS[key]


def check_ranks(ranks, arch, cfg_kw, par_kw, init, metrics, final, jstep_n,
                one_device=None):
    """Every rank's metrics equal rank 0's and the reference's; the
    gathered final params the reference's; the step counter; each rank's
    initial pieces the rule table's slices of the whole for its
    coordinate.  With ``one_device`` (the port's own one-device final
    params) the gathered params are held elementwise to it instead, and
    each leaf's update to the reference's within 1e-3 of its norm: where
    a gradient near 0 flips sign between two float32 summation orders,
    Adam moves the weight by about the learning rate either way, and the
    port's one-device run itself ends an element past TOL from JAX's
    (ROADMAP Queue 3 item 13)."""
    parallel = ParallelConfig(**par_kw)
    model = build_model(configs(arch, cfg_kw)[1], "cpu", parallel)
    specs = flatten(model.param_specs(make_mesh(parallel.mesh_shape(),
                                                parallel.mesh_axes())),
                    is_spec)
    whole = tree.leaves(tree.tree_map(torch.from_numpy, init))
    for r, res in enumerate(ranks):
        assert res["metrics"] == ranks[0]["metrics"], r
        assert res["step"] == jstep_n == STEPS
        mesh = make_mesh(parallel.mesh_shape(), parallel.mesh_axes(), r)
        assert res["coords"] == mesh.coords
        for t, s, got in zip(whole, specs, tree.leaves(res["init"]),
                             strict=True):
            np.testing.assert_array_equal(got, shard_of(t, s, mesh).numpy())
    for got, want in zip(ranks[0]["metrics"], metrics, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    paths = [p for p in ranks[0]["paths"] if p.startswith("/params/")]
    want = tree.leaves_with_paths(final)
    assert paths == [f"/params{p}" for p, _ in want]
    if one_device is None:
        for got, (path, w) in zip(ranks[0]["final"], want):
            np.testing.assert_allclose(got, w.numpy(), err_msg=path, **TOL)
        return
    gathered = [t for p, t in zip(ranks[0]["paths"], ranks[0]["final"])
                if p.startswith("/params/")]
    for got, (path, w), one, p0 in zip(gathered, want,
                                       tree.leaves(one_device),
                                       tree.leaves(init), strict=True):
        np.testing.assert_allclose(got, one.numpy(), err_msg=path, **TOL)
        du = got.astype(np.float64) - p0
        dw = w.numpy().astype(np.float64) - p0
        assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw), path


JAX_MESH_CHILD = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.config import (get_model_config, reduce_for_smoke,
                          ParallelConfig, TrainConfig)
from repro.models import build_model
from repro.sharding.rules import axis_rules, param_sharding_tree
from repro.training import optimizer as opt
from repro.training.train_step import (TrainState, init_train_state,
                                       make_train_step)
arch, cfg_kw, batches_path, train, out_path = sys.argv[1:]
batches = list(np.load(batches_path, allow_pickle=True))
cfg = dataclasses.replace(reduce_for_smoke(get_model_config(arch)),
                          **json.loads(cfg_kw))
par = ParallelConfig(data=2, model=2, remat="none")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
model = build_model(cfg, par)
with axis_rules(mesh=mesh):
    state = init_train_state(model, jax.random.PRNGKey(0))
    sh = param_sharding_tree(model.logical(), mesh)
    state = TrainState(params=jax.device_put(state.params, sh),
                       opt=opt.AdamWState(step=state.opt.step,
                                          mu=jax.device_put(state.opt.mu, sh),
                                          nu=jax.device_put(state.opt.nu, sh)))
    step = jax.jit(make_train_step(model, cfg, par,
                                   TrainConfig(**json.loads(train))))
    metrics = []
    with mesh:
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                     "lr")})
leaves = jax.tree_util.tree_flatten_with_path(state.params)[0]
np.savez(out_path, **{jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in leaves})
print(json.dumps({"metrics": metrics, "step": int(state.opt.step)}))
"""


class JaxMesh:
    """JAX's own (2, 2) mesh on ``arch`` (GSPMD over four forced host
    devices) stepping through ``batches`` in a subprocess, started at
    once so that it runs beside the port's ranks; ``result()`` waits for
    it (once; later calls return the same): (metrics, final params as
    the port's tree, step counter)."""

    def __init__(self, arch: str, cfg_kw: dict, batches: list, tmp):
        self.arch, self.cfg_kw, self.tmp = arch, cfg_kw, tmp
        np.save(tmp / "batches.npy", np.array(batches, dtype=object),
                allow_pickle=True)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_MESH_CHILD, arch, json.dumps(cfg_kw),
             str(tmp / "batches.npy"), json.dumps(TRAIN),
             str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self):
        if not hasattr(self, "_result"):
            self._result = self._read()
        return self._result

    def _read(self):
        out, err = self.proc.communicate(timeout=300)
        assert self.proc.returncode == 0, err[-3000:]
        child = json.loads(out.strip().splitlines()[-1])
        with np.load(self.tmp / "jax.npz") as z:
            jparams = {}
            for key in z.files:        # "['seg0']['u0']['attn']['wq']"
                node = jparams
                parts = [p.strip("'") for p in key.strip("[]").split("][")]
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = z[key]
        final = params_from_jax(jparams, configs(self.arch, self.cfg_kw)[1],
                                "cpu")
        return child["metrics"], final, child["step"]
