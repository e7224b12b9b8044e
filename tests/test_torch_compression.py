"""The int8 error-feedback all-reduce (``training/compression.py``) against
the JAX package's, on the CPU.

``quantize_int8`` equals JAX's bit for bit.  ``compressed_psum`` runs on
four gloo ranks (``launch/mesh.spawn_ranks``; the rank body in
``tests/_torch_train_ranks.py``) against JAX's under ``shard_map`` on a
4-device CPU mesh in a subprocess, three rounds with the residuals
carried: the residuals are equal, and each reduced leaf within one f32
ulp of its scale of JAX's (both sum the int32 payload exactly; the f32
sum of the four scales may associate differently).  The payload is int32:
its bytes are an f32 all-reduce's (ROADMAP Queue 3).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.training.compression import quantize_int8 as j_quantize  # noqa: E402
from repro_torch.training.compression import (  # noqa: E402
    dequantize_int8, quantize_int8)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import compression_rank, spawn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, ROUNDS = 4, 3
SHAPES = {"w": (64, 32), "b": (17,)}


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), rows=st.integers(1, 48),
       cols=st.integers(1, 48), mag=st.sampled_from([1e-6, 1e-2, 1.0, 1e3]))
def test_quantize_int8_is_jaxs_bit_for_bit(seed, rows, cols, mag):
    x = (np.random.default_rng(seed).normal(size=(rows, cols)) * mag
         ).astype(np.float32)
    jq, js = j_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    # the residual identity the error feedback carries
    v = torch.from_numpy(x)
    r = v - dequantize_int8(q, s)
    assert (r.abs() <= s / 2 * (1 + 2 ** -20)).all()


def _rounds() -> list:
    """ROUNDS x N ranks' gradient trees, a leaf's scale differing by rank
    and round."""
    rng = np.random.default_rng(0)
    return [[{k: (rng.normal(size=s) * rng.uniform(0.1, 10)).astype(
        np.float32) for k, s in SHAPES.items()} for _ in range(N)]
        for _ in range(ROUNDS)]


JAX_CHILD = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.core.compat import shard_map
from repro.training.compression import compressed_psum, init_residuals
rounds = np.load(sys.argv[1])
keys, n_rounds, n = json.loads(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
mesh = make_mesh((n,), ('data',))

def body(g, r):
    g = jax.tree.map(lambda a: a[0], g)
    r = jax.tree.map(lambda a: a[0], r)
    red, res = compressed_psum(g, r, 'data')
    return (jax.tree.map(lambda a: a[None], red),
            jax.tree.map(lambda a: a[None], res))

spec = {k: P('data') for k in keys}
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec), check_vma=False))
res = None
out = {}
for i in range(n_rounds):
    g = {k: jnp.asarray(rounds[f'{i}/{k}']) for k in keys}
    res = init_residuals(g) if res is None else res
    red, res = f(g, res)
    for k in keys:
        out[f'{i}/red/{k}'] = np.asarray(red[k])
        out[f'{i}/res/{k}'] = np.asarray(res[k])
np.savez(sys.argv[5], **out)
print('ok')
"""


def _jax_run(rounds, tmp_path) -> dict:
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **{f"{i}/{k}": np.stack([g[k] for g in rnd])
                     for i, rnd in enumerate(rounds) for k in SHAPES})
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c", JAX_CHILD, str(src), json.dumps(list(SHAPES)),
         str(ROUNDS), str(N), str(dst)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(dst))


def test_compressed_psum_on_gloo_ranks_matches_jax_mesh(tmp_path):
    rounds = _rounds()
    want = _jax_run(rounds, tmp_path)
    ranks = spawn(compression_rank, N, tmp_path, rounds)
    for i in range(ROUNDS):
        for k, shape in SHAPES.items():
            jred = want[f"{i}/red/{k}"]           # (N, ...) every device's
            scale = np.abs(jred[0]).max()
            ulp = np.spacing(np.float32(scale))
            for r, out in enumerate(ranks):
                red, res = out[i]["reduced"][k], out[i]["residuals"][k]
                assert red.dtype == np.float32 and red.shape == shape
                # every rank's reduction is the same bits
                np.testing.assert_array_equal(red, ranks[0][i]["reduced"][k])
                err = np.abs(red - jred[r]).max()
                assert err <= ulp, (i, k, r, err / ulp)
                np.testing.assert_array_equal(res, want[f"{i}/res/{k}"][r])
            counts = ranks[0][i]["counts"]
            # int32 payload + one f32 scale a leaf: an f32 all-reduce's bytes
            assert counts["all_reduce"] == 2 * len(SHAPES)
            assert counts["bytes"] == sum(
                4 * int(np.prod(s)) + 4 for s in SHAPES.values())
    # the reference's arithmetic, in float64 from each rank's int8 values
    # and scale: the payloads summed and scaled by the MEAN scale -- not
    # the mean of the dequantized payloads, which it misses by far where
    # the ranks' scales differ (ROADMAP Queue 3)
    res = [{"w": np.zeros(SHAPES["w"], np.float32)} for _ in range(N)]
    worst = 0.0
    for i, rnd in enumerate(rounds):
        qs, ss = [], []
        for r in range(N):
            v = torch.from_numpy(rnd[r]["w"] + res[r]["w"])
            q, sc = quantize_int8(v)
            qs.append(q.numpy().astype(np.float64))
            ss.append(float(sc))
            res[r] = ranks[r][i]["residuals"]
        ref = sum(qs) * (sum(ss) / N) / N
        got = ranks[0][i]["reduced"]["w"].astype(np.float64)
        worst = max(worst, np.abs(got - ref).max()
                    / np.spacing(np.float32(np.abs(ref).max())))
        deq = sum(q * s for q, s in zip(qs, ss)) / N
        miss = np.abs(got - deq).max() / np.abs(deq).max()
        print(f"round {i}: scales {np.round(ss, 4)}, against the mean of "
              f"the dequantized payloads {miss:.3f} of its scale")
        assert miss > 0.15
    print(f"against the float64 arithmetic: {worst:.2f} ulp of the scale")
    assert worst <= 1.0
