"""Expert parallelism on the data pipeline's batches as they come (no
label masked), reduced qwen3-moe-30b-a3b and grok-1-314b at (data,
model) = (2, 2) on CPU gloo ranks: held to JAX's one-device step (loss,
grad norm, lr; each leaf's update by its norm) and elementwise to the
port's own one-device run.  ``tests/test_torch_moe_ep.py`` holds the
masked batches' cases, whose helpers this file shares; a file of its
own so that no test worker runs both.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             make_train_step)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dist_train import STEPS, TRAIN  # noqa: E402
from test_torch_moe_ep import ARCHS, S, _jax_steps, _port_run  # noqa: E402
# torch on one thread while this module runs (an autouse fixture)
from test_torch_moe_ep import _torch_on_one_thread  # noqa: E402,F401


def _port_one_device(arch: str, masked: bool = True):
    """The port's STEPS steps on one device, in this process, from JAX's
    init on ``_jax_steps``' batches: the final state (params, AdamW's
    moments, its step), in ``train_rank``'s gathered order."""
    batches, init, *_ = _jax_steps(arch, S, masked)
    cfg = t_reduce(t_get(arch))
    par = ParallelConfig(remat="none")
    model = t_build(cfg, "cpu", par)
    params = tree.tree_map(lambda a: torch.from_numpy(a.copy()), init)
    state = TrainState(params, opt.init_adamw(params))
    step = make_train_step(model, cfg, par, TrainConfig(**TRAIN))
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
    return state


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_training_on_unmasked_batches(arch, tmp_path):
    """The pipeline's batches as they come (no label masked) at (2, 2):
    every step's loss, grad norm and lr within 1e-4 of JAX's one-device
    step, and the gathered final params within 1e-4 of the port's own
    one-device run (``model=1``) elementwise -- expert parallelism
    changes nothing there.  Against JAX, each leaf's update (final -
    init) within 1e-3 of its norm: on these batches one lm_head element
    ends 1.3e-4 from JAX's after 3 steps, on one device as on the mesh
    (Adam's first steps take a near-zero gradient's rounding to a whole
    step; ``test_torch_hymba``'s train-step rule)."""
    _, init, metrics, final, n = _jax_steps(arch, masked=False)
    mesh = _port_run(arch, dict(data=2, model=2), tmp_path, masked=False)
    one = _port_one_device(arch, masked=False)
    for res in mesh:
        assert res["metrics"] == mesh[0]["metrics"]
        assert res["step"] == n == STEPS
    for got, want in zip(mesh[0]["metrics"], metrics, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=1e-4,
                                       atol=1e-4)
    for path, got, ref in zip(mesh[0]["paths"], mesh[0]["final"],
                              tree.leaves(one), strict=True):
        np.testing.assert_allclose(got, ref.numpy(), err_msg=path,
                                   rtol=1e-4, atol=1e-4)
    start = tree.leaves_with_paths(tree.tree_map(torch.from_numpy, init))
    want = tree.leaves(final)
    paths = [p for p in mesh[0]["paths"] if p.startswith("/params/")]
    assert paths == [f"/params{p}" for p, _ in start]
    worst = 0.0
    for (path, a), got, w in zip(start, mesh[0]["final"][:len(paths)],
                                 want, strict=True):
        du, dw = torch.from_numpy(got) - a, w - a
        assert (du - dw).norm() <= 1e-3 * dw.norm(), path
        worst = max(worst, float((du - dw).abs().max()))
    print(f"{arch}: largest elementwise gap to JAX {worst:.3e}")
