"""GPipe (``training/pipeline.py``) on four gloo ranks against the JAX
package's ``make_pipeline`` on a 4-device CPU mesh and against the stages
applied in sequence, on the CPU.

The case of ``tests/test_pipeline.py`` (4 stages, 8 microbatches, one
tanh linear layer a stage) is held to JAX's pipeline and to the
sequential oracle within 1e-5; a second case runs the smoke llama2-7b's
four blocks as the stages (``apply_block``), against JAX's
``apply_block`` applied in sequence, within 1e-5 of its scale.  Every
rank returns the same output; each ran every one of the
n_micro + n - 1 ticks and sent its carry on each (``COUNTS``); the
bubble is 3/11.
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
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.training.pipeline import bubble_fraction  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import pipeline_rank, spawn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STAGES, N_MICRO = 4, 8

JAX_CHILD = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.training.pipeline import make_pipeline
a = np.load(sys.argv[1])
mesh = make_mesh((4,), ('stage',))

def stage_fn(w, x):
    return jnp.tanh(x @ w)

pipe = jax.jit(make_pipeline(mesh, stage_fn, params_spec=P('stage'),
                             x_spec=P()))
np.save(sys.argv[2], np.asarray(pipe(jnp.asarray(a['ws']),
                                     jnp.asarray(a['x']))))
print('ok')
"""


def _check_ranks(ranks, d_bytes: int) -> np.ndarray:
    out = ranks[0]["out"]
    for r in ranks:
        np.testing.assert_array_equal(r["out"], out)
        ticks = N_MICRO + N_STAGES - 1
        assert r["counts"]["ppermute"] == ticks
        assert r["counts"]["all_reduce"] == 1
        assert r["counts"]["bytes"] == ticks * d_bytes + out.nbytes
    return out


def test_gpipe_tanh_stages_match_jax_and_sequential(tmp_path):
    rng = np.random.default_rng(0)
    d, mb = 16, 2
    ws = (rng.normal(size=(N_STAGES, d, d)) * 0.5).astype(np.float32)
    x = rng.normal(size=(N_MICRO, mb, d)).astype(np.float32)
    np.savez(tmp_path / "in.npz", ws=ws, x=x)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", JAX_CHILD,
                          str(tmp_path / "in.npz"), str(tmp_path / "j.npy")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "j.npy")
    ranks = spawn(pipeline_rank, N_STAGES, tmp_path, "tanh", list(ws), x)
    out = _check_ranks(ranks, mb * d * 4)
    ref = x
    for s in range(N_STAGES):
        ref = np.tanh(ref @ ws[s])
    assert np.abs(out - want).max() < 1e-5
    assert np.abs(out - ref).max() < 1e-5
    assert abs(bubble_fraction(N_STAGES, N_MICRO) - 3 / 11) < 1e-12


def test_gpipe_llama_blocks_match_jax_blocks_in_sequence(tmp_path):
    kw = dict(num_layers=N_STAGES)
    jcfg = dataclasses.replace(reduce_for_smoke(
        get_model_config("llama2-7b")), **kw)
    tcfg = dataclasses.replace(t_reduce(t_get("llama2-7b")), **kw)
    jm = j_build(jcfg, JParallel(remat="none", scan_layers=False))
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    layers = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                             "cpu", scan_layers=False)["layers"]
    mb, s = 2, 12
    x = np.random.default_rng(1).normal(
        size=(N_MICRO, mb, s, tcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s), (mb, s))
    jblocks = [jparams[f"seg{i}"]["u0"] for i in range(N_STAGES)]

    @jax.jit
    def sequential(h):
        for bp in jblocks:
            h = JB.apply_block(bp, h, jcfg, "attn", positions=pos)
        return h
    want = np.stack([np.asarray(sequential(jnp.asarray(m))) for m in x])
    stages = [jax.tree.map(lambda t: t.numpy(), layer) for layer in layers]
    ranks = spawn(pipeline_rank, N_STAGES, tmp_path, "llama", stages, x)
    out = _check_ranks(ranks, mb * s * tcfg.d_model * 4)
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()
