"""The port's mLSTM kernel module against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both sides.  The plain
recurrent, parallel and chunkwise forms are held to the JAX oracles, the
port's ``mlstm_chunkwise_fwd`` (its plain version on CPU tensors) to the
JAX Pallas kernel in interpret mode, and the gradients of the port's
autograd op to ``jax.vjp`` of the JAX custom_vjp op.  Everything is
float32 and the algorithms are the same, only the order of sums differs:
the tolerance is 1e-4 (absolute and relative; gradients relative to each
gradient's scale).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm import kernel as jkernel  # noqa: E402
from repro.kernels.mlstm import ops as jops  # noqa: E402
from repro.kernels.mlstm import ref as jref  # noqa: E402
from repro_torch.kernels._launch import resolve_impl  # noqa: E402
from repro_torch.kernels.mlstm import ref  # noqa: E402
from repro_torch.kernels.mlstm.ops import (mlstm_chunkwise,  # noqa: E402
                                           mlstm_chunkwise_fwd)

TOL = dict(rtol=1e-4, atol=1e-4)
# the shapes of tests/test_kernels_mlstm.py: (b, h, s, dk, dv, chunk)
SHAPES = [(2, 2, 384, 32, 48, 128), (1, 4, 256, 64, 64, 128),
          (1, 1, 300, 16, 16, 128), (2, 2, 128, 32, 32, 128)]


def _inputs(b, h, s, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, dk)).astype(np.float32),
            rng.normal(size=(b, h, s, dk)).astype(np.float32),
            rng.normal(size=(b, h, s, dv)).astype(np.float32),
            rng.normal(size=(b, h, s)).astype(np.float32),
            (rng.normal(size=(b, h, s)) + 2.0).astype(np.float32))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_recurrent_matches_jax_with_state():
    j, t = _both(_inputs(2, 3, 96, 32, 48, seed=1))
    jh, jst = jref.mlstm_recurrent(*j)
    th, tst = ref.mlstm_recurrent(*t)
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)
    # a second segment from the carried state
    j2, t2 = _both(_inputs(2, 3, 20, 32, 48, seed=2))
    jh2, _ = jref.mlstm_recurrent(*j2, initial_state=jst)
    th2, _ = ref.mlstm_recurrent(*t2, initial_state=tst)
    _close(th2, jh2)


@pytest.mark.parametrize("shape", SHAPES)
def test_parallel_matches_jax(shape):
    b, h, s, dk, dv, _ = shape
    j, t = _both(_inputs(b, h, s, dk, dv, seed=3))
    _close(ref.mlstm_parallel(*t), jref.mlstm_parallel(*j))


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("shape", SHAPES)
def test_chunkwise_matches_jax(shape, chunk):
    b, h, s, dk, dv, _ = shape
    j, t = _both(_inputs(b, h, s, dk, dv, seed=4))
    jh, jst = jref.mlstm_chunkwise(*j, chunk=chunk, return_state=True)
    th, tst = ref.mlstm_chunkwise(*t, chunk=chunk, return_state=True)
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)
    _close(ref.mlstm_chunkwise(*t, chunk=chunk), jh)


def test_chunkwise_state_handoff_matches_jax():
    """Chunkwise with carried state (tests/test_kernels_mlstm.py's
    streaming case): both halves equal JAX's, and together the port's
    one recurrent pass."""
    j, t = _both(_inputs(1, 2, 256, 16, 16, seed=9))
    cut = lambda xs, sl: [x[:, :, sl] for x in xs]  # noqa: E731
    jh1, jst = jref.mlstm_chunkwise(*cut(j, slice(0, 128)), chunk=64,
                                    return_state=True)
    th1, tst = ref.mlstm_chunkwise(*cut(t, slice(0, 128)), chunk=64,
                                   return_state=True)
    jh2 = jref.mlstm_chunkwise(*cut(j, slice(128, None)), chunk=64,
                               initial_state=jst)
    th2 = ref.mlstm_chunkwise(*cut(t, slice(128, None)), chunk=64,
                              initial_state=tst)
    _close(th1, jh1)
    _close(th2, jh2)
    hr, _ = ref.mlstm_recurrent(*t)
    _close(torch.cat([th1, th2], dim=2), hr, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_matches_jax_kernel_interpret(shape):
    """The port's kernel wrapper (plain version on CPU tensors) against
    the JAX Pallas kernel in interpret mode: h and (C, n, m)."""
    b, h, s, dk, dv, chunk = shape
    j, t = _both(_inputs(b, h, s, dk, dv, seed=4))
    jh, jst = jkernel.mlstm_chunkwise_fwd(*j, chunk=chunk, interpret=True)
    before = mlstm_chunkwise_fwd.launches
    th, tst = mlstm_chunkwise_fwd(*t, chunk=chunk)
    assert mlstm_chunkwise_fwd.launches == before     # no kernel on CPU
    assert th.shape == (b, h, s, dv) and th.dtype == torch.float32
    assert [tuple(x.shape) for x in tst] == [(b, h, dk, dv), (b, h, dk),
                                             (b, h)]
    _close(th, jh)
    for a, w in zip(tst, jst):
        _close(a, w)


def test_fwd_short_sequence_and_bshd_view():
    """S below the chunk (one chunk of S rows), and q/k/v passed as the
    model passes them: (B, S, H, D) projections transposed, not copied."""
    arrays = _inputs(2, 2, 40, 16, 24, seed=5)
    j, t = _both(arrays)
    jh, _ = jkernel.mlstm_chunkwise_fwd(*j, chunk=128, interpret=True)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                              ).transpose(1, 2) for a in arrays[:3]]
    th, _ = mlstm_chunkwise_fwd(*views, *t[3:], chunk=128)
    _close(th, jh)


def _scaled_close(got, want):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("impl", [None, "kernel", "reference"])
@pytest.mark.parametrize("shape", [(1, 2, 100, 16, 24, 64),
                                   (2, 1, 64, 32, 32, 128)])
def test_gradients_match_jax_vjp(shape, impl):
    """Gradients of h with respect to q, k, v and both gates: the port's
    autograd op (plain forward on the CPU, plain recompute backward) and
    its reference path against jax.vjp of the JAX custom_vjp op."""
    b, h, s, dk, dv, chunk = shape
    arrays = _inputs(b, h, s, dk, dv, seed=6)
    g = np.random.default_rng(7).normal(size=(b, h, s, dv)).astype(
        np.float32)
    j, t = _both(arrays)
    jh, vjp = jax.vjp(lambda *a: jops.mlstm_chunkwise(*a, chunk,
                                                      "interpret"), *j)
    want = vjp(jnp.asarray(g))
    leaves = [x.clone().requires_grad_() for x in t]
    th = mlstm_chunkwise(*leaves, chunk, impl=impl)
    got = torch.autograd.grad(th, leaves, torch.from_numpy(g))
    _close(th.detach(), jh)
    for a, w in zip(got, want):
        _scaled_close(a, w)


def test_impl_resolution_and_argument_checks():
    x = torch.zeros(1, 1, 4, 8)
    assert resolve_impl(None, x, "mlstm") == "reference"
    assert resolve_impl("auto", x, "mlstm") == "reference"
    assert resolve_impl("pallas", x, "mlstm") == "kernel"
    assert resolve_impl("kernel", x, "mlstm") == "kernel"
    gates = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="unknown mlstm impl"):
        mlstm_chunkwise(x, x, x, gates, gates, impl="interpret")
    with pytest.raises(ValueError, match="bad arguments"):
        mlstm_chunkwise_fwd(x, x[..., :4], x, gates, gates)
    with pytest.raises(ValueError, match="bad arguments"):
        mlstm_chunkwise_fwd(x, x, x, gates[..., :3], gates)
