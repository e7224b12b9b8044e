"""Expert parallelism in the port's trainer against the JAX package, on
CPU gloo ranks (bodies in ``tests/_torch_train_ranks.py``, JAX-free):
reduced qwen3-moe-30b-a3b and reduced grok-1-314b (4 experts top-2) at
(data, model) = (1, 2) and (2, 2), where the rule table puts the expert
dim on the model axis (``expert -> model``: 4 experts over 2 ranks).

Under a model axis a rank holds S / model rows of each batch row; the
MoE block gathers the normed hidden state along the sequence so that
every model rank routes and dispatches whole rows (JAX's capacity counts
the whole row), runs its own experts' slots and reduce-scatters the
partial combine back to its rows.  The router is replicated: its
gradient, from each rank's own experts' slots, is summed over the mesh.

Each case carries JAX's init across (``params_from_jax``), gives every
rank the same global batches (capacity factor 1.25: assignments drop),
takes 3 AdamW steps and holds the loss, grad norm and lr of every step,
every parameter (gathered whole) and the step counter to JAX's step on
one device within 1e-4 (``test_torch_dist_train._check_ranks``); each
rank's initial pieces -- its experts among them -- are the rule table's
slices.  One case runs JAX's own (2, 2) mesh in a subprocess.
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
from repro_torch.training import tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import spawn, train_rank  # noqa: E402
from test_torch_dist_train import (B, STEPS, TRAIN,  # noqa: E402
                                   _check_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
S = 64


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """torch on one intra-op thread while this module runs: it meets JAX
    in this process, and other test workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _jax_steps(arch: str, seq: int = S, masked: bool = True):
    """JAX's init and STEPS steps on one device on B x ``seq`` batches of
    the data pipeline, row 0's first 5 labels masked (as
    ``test_torch_moe_train``'s) unless not ``masked``: (batches, init as
    the port's numpy tree, per-step metrics, final params, step
    counter)."""
    tcfg = t_reduce(t_get(arch))
    pipe = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size,
                                    seq_len=seq, global_batch=B))
    batches = [pipe.next() for _ in range(STEPS)]
    for b in batches if masked else ():   # the DP ranks' counts differ
        b["labels"][0, :5] = -1
    jcfg = reduce_for_smoke(get_model_config(arch))
    jpar = JParallel(remat="none")
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


def _experts(res: dict) -> list:
    """The first dim of every expert leaf of a rank's initial pieces."""
    return [v.shape[0] for bp in res["init"]["layers"]
            for k, v in bp["moe"].items() if k != "router"]


_PORT_RUNS: dict = {}


def _port_run(arch: str, par_kw: dict, tmp_path, seq: int = S,
              masked: bool = True) -> list:
    key = (arch, tuple(sorted(par_kw.items())), seq, masked)
    if key not in _PORT_RUNS:
        batches, init, *_ = _jax_steps(arch, seq, masked)
        par = ParallelConfig(**par_kw)
        _PORT_RUNS[key] = spawn(train_rank, par.dp * par.model, tmp_path,
                                arch, par_kw, init, batches, TRAIN,
                                {"dir": str(tmp_path / "ck")})
    return _PORT_RUNS[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_expert_parallel_training_matches_jax(arch, mesh, tmp_path):
    """3 AdamW steps at (data, model) = ``mesh`` against JAX's step on
    one device; each rank holds 2 of the 4 experts of every expert leaf,
    the rule table's slice for its model coordinate."""
    par_kw = dict(data=mesh[0], model=mesh[1])
    _, init, metrics, final, n = _jax_steps(arch)
    ranks = _port_run(arch, par_kw, tmp_path)
    for res in ranks:
        assert set(_experts(res)) == {2}
    _check_ranks(ranks, arch, par_kw, init, metrics, final, n)


JAX_MESH_CHILD = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.config import (get_model_config, reduce_for_smoke,
                          ParallelConfig, TrainConfig)
from repro.models import build_model
from repro.sharding.rules import axis_rules, param_sharding_tree
from repro.training import optimizer as opt
from repro.training.train_step import (TrainState, init_train_state,
                                       make_train_step)
arch, batches_path, train, out_path = sys.argv[1:]
batches = list(np.load(batches_path, allow_pickle=True))
cfg = reduce_for_smoke(get_model_config(arch))
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
w_up = state.params["seg0"]["u0"]["moe"]["w_up"]
leaves = jax.tree_util.tree_flatten_with_path(state.params)[0]
np.savez(out_path, **{jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in leaves})
print(json.dumps({"metrics": metrics, "step": int(state.opt.step),
                  "w_up_spec": str(w_up.sharding.spec)}))
"""


def test_expert_parallel_training_matches_jax_own_2x2_mesh(tmp_path):
    """The port's (2, 2) ranks on reduced qwen3-moe against JAX's own
    (2, 2) mesh (GSPMD over four forced host devices, in a subprocess),
    whose expert leaves are sharded over ``model`` on the expert dim:
    the same steps."""
    arch = "qwen3-moe-30b-a3b"
    cfg = t_reduce(t_get(arch))
    batches, init, *_ = _jax_steps(arch)
    np.save(tmp_path / "batches.npy", np.array(batches, dtype=object),
            allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", JAX_MESH_CHILD, arch,
         str(tmp_path / "batches.npy"), json.dumps(TRAIN),
         str(tmp_path / "jax.npz")], env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    child = json.loads(res.stdout.strip().splitlines()[-1])
    # stacked layers first: the expert dim on the model axis
    assert child["w_up_spec"] == "PartitionSpec(None, 'model')"
    with np.load(tmp_path / "jax.npz") as z:
        jparams = {}
        for key in z.files:            # "['seg0']['u0']['moe']['w_up']"
            node = jparams
            parts = [p.strip("'") for p in key.strip("[]").split("][")]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    final = params_from_jax(jparams, cfg, "cpu")
    _check_ranks(_port_run(arch, dict(data=2, model=2), tmp_path), arch,
                 dict(data=2, model=2), init, child["metrics"], final,
                 child["step"])
