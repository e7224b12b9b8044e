"""Expert parallelism in the port's trainer at its edges, on CPU gloo
ranks, against the JAX package:

* the capacity point: under a model axis each rank holds S / model rows
  of a batch row, but JAX's capacity counts the whole row.  The port's
  MoE block routes the gathered whole rows, so its kept assignments are
  exactly JAX's dispatch of the same block inputs -- where a dispatch of
  each rank's S / model tokens alone would keep others -- and each
  rank's rows of the block's output are JAX's ``apply_moe``'s;
* the fallback: at model = 3 the 4 experts do not divide, the rule table
  keeps them whole, and every rank runs every expert on the gathered
  whole rows and keeps its own: 3 AdamW steps held to JAX's one-device
  step as in ``tests/test_torch_moe_ep.py``;
* ``launch.train --data 2 --model-axis 2`` on a moe arch.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import moe_routes_rank, spawn  # noqa: E402
from test_torch_dist_train import B, _check_ranks  # noqa: E402
from test_torch_moe_ep import S, _experts, _jax_steps, _port_run  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """torch on one intra-op thread while this module runs: it meets JAX
    in this process, and other test workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_keep(moe_params: dict, x, jcfg) -> np.ndarray:
    """Each assignment's kept flag, (B, S * k) in (token, j) order, of
    JAX's dispatch (``repro/layers/moe.py``'s routing and capacity, term
    for term) of ``x`` (B, S, D), capacity counted over its S tokens."""
    b, s, _ = x.shape
    e, k = jcfg.num_experts, jcfg.num_experts_per_tok
    cap = max(1, int(s * k / e * jcfg.moe_capacity_factor))
    logits = jcommon.dense(x, moe_params["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = idx.reshape(b, s * k)
    order = jnp.argsort(flat, axis=-1)
    sorted_e = jnp.take_along_axis(flat, order, axis=-1)
    same = sorted_e[:, :, None] == jnp.arange(e)[None, None, :]
    pos = jnp.cumsum(same, axis=1) - 1
    slot = jnp.take_along_axis(pos, sorted_e[..., None], axis=-1)[..., 0]
    keep = np.zeros((b, s * k), bool)
    np.put_along_axis(keep, np.asarray(order), np.asarray(slot < cap),
                      axis=1)
    return keep


def test_capacity_counts_whole_rows_as_jax(tmp_path):
    """(1, 2) on reduced qwen3-moe, the first batch at the initial
    weights: every rank routes the same whole rows, keeps exactly JAX's
    assignments (some dropped), runs its 2 experts, and its rows of each
    block's output are JAX's apply_moe's; a dispatch of each rank's 32
    tokens alone would have kept other assignments."""
    arch = "qwen3-moe-30b-a3b"
    jcfg = reduce_for_smoke(get_model_config(arch))
    batches, init, *_ = _jax_steps(arch)
    ranks = spawn(moe_routes_rank, 2, tmp_path, arch, dict(model=2), init,
                  batches[0])
    s = S // 2
    other = 0
    for i in range(jcfg.num_layers):
        x = ranks[0]["blocks"][i]["x"]
        assert x.shape == (B, S, jcfg.d_model)
        params = {k: jnp.asarray(v)
                  for k, v in init["layers"][i]["moe"].items()}
        keep = _jax_keep(params, jnp.asarray(x), jcfg)
        assert (~keep).any()
        y = np.asarray(jmoe.apply_moe(params, jnp.asarray(x), jcfg))
        for m, res in enumerate(ranks):
            blk = res["blocks"][i]
            assert res["coords"]["model"] == m
            assert blk["experts"] == (2 * m, 2 * m + 2)
            assert blk["w_up"][0] == 2
            np.testing.assert_array_equal(blk["x"], x)
            np.testing.assert_array_equal(blk["keep"], keep)
            np.testing.assert_allclose(blk["y"], y[:, m * s:(m + 1) * s],
                                       **TOL)
        per_rank = np.concatenate([
            _jax_keep(params, jnp.asarray(x[:, m * s:(m + 1) * s]), jcfg)
            for m in range(2)], axis=1)
        other += int((per_rank != keep).sum())
    assert other > 0


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_experts_that_do_not_divide_stay_whole(arch, tmp_path):
    """model = 3 over 4 experts (B x 48 batches): every rank holds all 4
    experts of every expert leaf and 3 AdamW steps match JAX's one-device
    step."""
    par_kw = dict(model=3)
    _, init, metrics, final, n = _jax_steps(arch, 48)
    ranks = _port_run(arch, par_kw, tmp_path, 48)
    for res in ranks:
        assert set(_experts(res)) == {4}
    _check_ranks(ranks, arch, par_kw, init, metrics, final, n)


def test_train_cli_on_a_2x2_mesh_with_moe(tmp_path):
    """The launcher trains reduced qwen3-moe on data x model = 2 x 2
    gloo ranks and writes the checkpoint."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--steps",
           "2", "--batch", "4", "--seq", "32", "--data", "2",
           "--model-axis", "2", "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "4 ranks (data=2, model=2) over gloo" in out.stdout
    assert "step     1 loss" in out.stdout and "done" in out.stdout
    for r in range(4):
        assert f"rank {r} " in out.stdout
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
