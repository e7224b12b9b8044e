"""The recurrent cells on a (data, model) mesh, held to the JAX package:
the mLSTM and sLSTM heads and hymba's Mamba channels carry
``channels -> model`` (each rank runs its share of them over the whole
sequence, ``models/blocks._channel_cell``), on CPU gloo ranks (bodies in
``tests/_torch_train_ranks.py``, which imports no JAX).

Each cell on a (1, 2) mesh against the JAX function on one device,
forward and every gradient, with the shapes the scan, the mLSTM kernel
and the sLSTM loop were given: a rank's DI / 2 channels or H / 2 heads;
at (1, 4) reduced xlstm's 2 heads do not split and every rank runs them
whole.  Reduced xlstm-125m (3 layers: mlstm, mlstm, slstm) and hymba-1.5b
train 3 AdamW steps at (1, 2), (2, 2) and (xlstm) (1, 4), held to JAX's
one-device step, and at (2, 2) to JAX's own (2, 2) mesh
(``tests/_torch_mesh_pair.py``).  (The launcher's runs of both at --data
2 --model-axis 2 are in ``test_torch_mesh_encdec.py``, which has room in
the time of one test worker.)
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import ssm as jssm  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_pair import (JaxMesh, check_ranks,  # noqa: E402
                              configs, jax_run, port_one_device, port_run)
from _torch_train_ranks import cells_rank, spawn  # noqa: E402
from repro_torch.training import tree  # noqa: E402

# name -> (arch, config changes, mesh, sequence length)
XLSTM = ("xlstm-125m", {"num_layers": 3})     # mlstm, mlstm, slstm
HYMBA = ("hymba-1.5b", {})                    # hymba, hymba_local
CASES = {
    "xlstm-1x2": (*XLSTM, dict(model=2), 32),
    "xlstm-2x2": (*XLSTM, dict(data=2, model=2), 32),
    # 2 heads over a model axis of 4: every rank runs the cells whole
    "xlstm-1x4": (*XLSTM, dict(model=4), 32),
    # every block recomputed in the backward; 48 rows past the window 32
    "hymba-1x2-remat": (*HYMBA, dict(model=2, remat="full"), 48),
    "hymba-2x2": (*HYMBA, dict(data=2, model=2), 48),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_device(arch, cfg_kw, seq):
    """hymba's parameters are held elementwise to the port's own
    one-device run, and to JAX's by each leaf's update: on these batches
    one element of layer 1's MLP w_down ends past 1e-4 from JAX's in the
    port's one-device run itself, as one of JAX's own (2, 2) mesh does
    from JAX's one device (summation order alone:
    ``test_hymba_spread_is_jax_against_its_own_mesh``; ROADMAP Queue 3
    item 13)."""
    return port_one_device(arch, cfg_kw, seq) if arch == HYMBA[0] else None


OWN_MESH = ("xlstm-2x2", "hymba-2x2")


@pytest.fixture(scope="module")
def jax_meshes(tmp_path_factory):
    """JAX's own (2, 2) mesh on each case of OWN_MESH, started before the
    port's ranks so that they run beside them."""
    out = {}
    for case in OWN_MESH:
        arch, cfg_kw, _, seq = CASES[case]
        out[case] = JaxMesh(arch, cfg_kw, jax_run(arch, cfg_kw, seq)[0],
                            tmp_path_factory.mktemp(case))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_training_matches_jax(case, tmp_path, jax_meshes):
    arch, cfg_kw, par_kw, seq = CASES[case]
    _, init, metrics, final, n = jax_run(arch, cfg_kw, seq)
    ranks = port_run(case, arch, cfg_kw, par_kw, seq, tmp_path)
    check_ranks(ranks, arch, cfg_kw, par_kw, init, metrics, final, n,
                _one_device(arch, cfg_kw, seq))


@pytest.mark.parametrize("case", OWN_MESH)
def test_mesh_training_matches_jax_own_2x2_mesh(case, tmp_path, jax_meshes):
    """The port's (2, 2) ranks against JAX's own (2, 2) mesh (GSPMD
    over four forced host devices)."""
    arch, cfg_kw, par_kw, seq = CASES[case]
    _, init, *_ = jax_run(arch, cfg_kw, seq)
    ranks = port_run(case, arch, cfg_kw, par_kw, seq, tmp_path)
    metrics, final, n = jax_meshes[case].result()
    check_ranks(ranks, arch, cfg_kw, par_kw, init, metrics, final, n,
                _one_device(arch, cfg_kw, seq))


def _largest_gap(a: list, b: list, paths: list):
    """(path, index, |a - b|) of the largest elementwise gap."""
    gaps = [(p, np.unravel_index(np.abs(x - y).argmax(), x.shape),
             float(np.abs(x - y).max())) for p, x, y in zip(paths, a, b)]
    return max(gaps, key=lambda g: g[2])


def test_hymba_spread_is_jax_against_its_own_mesh(tmp_path, jax_meshes):
    """Why hymba's parameters are held to JAX by update norm (ROADMAP
    Queue 3 item 13): after the 3 steps, the largest elementwise gap
    between each pair of four runs -- JAX's one device, JAX's own (2, 2)
    mesh, the port's one device and the port's (2, 2) ranks -- printed.
    JAX's two runs differ by as much as the port's from JAX's: summation
    order alone moves single MLP w_down elements past 1e-4.  Every pair
    stays within twice 1e-4, and the port's two runs within 1e-4."""
    arch, cfg_kw, par_kw, seq = CASES["hymba-2x2"]
    _, init, _, final, _ = jax_run(arch, cfg_kw, seq)
    ranks = port_run("hymba-2x2", arch, cfg_kw, par_kw, seq, tmp_path)
    _, jax_mesh, _ = jax_meshes["hymba-2x2"].result()
    paths = [p for p, _ in tree.leaves_with_paths(final)]
    runs = {"JAX one device": final, "JAX (2, 2)": jax_mesh,
            "port one device": port_one_device(arch, cfg_kw, seq)}
    runs = {k: [t.numpy() for t in tree.leaves(v)] for k, v in runs.items()}
    runs["port (2, 2)"] = [t for p, t in zip(ranks[0]["paths"],
                                             ranks[0]["final"])
                           if p.startswith("/params/")]
    names = list(runs)
    gaps = {(a, b): _largest_gap(runs[a], runs[b], paths)
            for i, a in enumerate(names) for b in names[i + 1:]}
    for (a, b), (path, idx, gap) in gaps.items():
        print(f"{a} vs {b}: {gap:.4e} at {path}{list(map(int, idx))}")
        assert gap <= 2e-4, (a, b)
    assert gaps[("port one device", "port (2, 2)")][2] <= 1e-4


# ---------------------------------------------------------------------------
# each cell on its own
# ---------------------------------------------------------------------------

B, S = 2, 16
CELLS = {   # block kind -> (arch, config changes, the cell's keywords)
    "hymba": (*HYMBA, {"chunk": 4}),          # four chunks of the scan
    "mlstm": (*XLSTM, {"chunk": 8}),
    "slstm": (*XLSTM, {}),
}


def _cell_case(kind: str, seed: int):
    """(the JAX cell's params, its output and vjp on x, the rank case)."""
    arch, cfg_kw, kw = CELLS[kind]
    jcfg, _ = configs(arch, cfg_kw)
    name = {"hymba": "mamba"}.get(kind, kind)
    jp = getattr(jssm, f"init_{name}")(jax.random.PRNGKey(seed), jcfg,
                                      jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    fn = getattr(jssm, f"apply_{name}")

    @jax.jit
    def out_and_grads(p, x, g):
        y, vjp = jax.vjp(lambda p, x: fn(p, x, jcfg, **kw), p, x)
        return (y,) + vjp(g)
    y, jg, jdx = out_and_grads(jp, jnp.asarray(x), jnp.asarray(g))
    params = {k: np.asarray(v) for k, v in jp.items()}
    return (np.asarray(y), np.asarray(jdx), {k: np.asarray(v) for k, v in
                                             jg.items()},
            {"kind": kind, "arch": arch, "cfg_kw": cfg_kw, "params": params,
             "x": x, "g": g, "kw": kw})


_CELL_RUNS: dict = {}


def _cell_run(model: int, kinds: tuple, tmp_path):
    if model not in _CELL_RUNS:
        refs = [_cell_case(k, seed) for seed, k in enumerate(kinds)]
        ranks = spawn(cells_rank, model, tmp_path, model,
                      [r[3] for r in refs])
        _CELL_RUNS[model] = refs, ranks
    return _CELL_RUNS[model]


def _whole(pieces: list, spec: tuple) -> np.ndarray:
    """A leaf's gradient from the ranks' pieces: concatenated along the
    dim its spec shards over the model axis; summed where every rank
    holds it whole (each rank's gradient is its own rows' share)."""
    for dim, entry in enumerate(spec):
        if entry == "model":
            return np.concatenate(pieces, axis=dim)
    return sum(pieces)


def _close(got, want, err_msg=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_on_a_1x2_mesh_matches_jax(kind, tmp_path):
    """A rank's rows of the output and of x's gradient, and every leaf's
    gradient from the ranks' pieces, equal the JAX cell's on one device;
    the local leaves are the rank's pieces of the channel dim and the
    recurrence walked the rank's share only."""
    refs, ranks = _cell_run(2, tuple(CELLS), tmp_path)
    i = list(CELLS).index(kind)
    y, dx, grads, case = refs[i]
    res = [r[i] for r in ranks]
    _close(np.concatenate([r["y"] for r in res], axis=1), y, "output")
    _close(np.concatenate([r["dx"] for r in res], axis=1), dx, "dx")
    for k, want in grads.items():
        got = _whole([r["grads"][k] for r in res], res[0]["specs"][k])
        _close(got, want, k)
    _, tcfg = configs(case["arch"], case["cfg_kw"])
    di = tcfg.q_dim if kind == "hymba" else 2 * tcfg.d_model
    nh, hd = tcfg.num_heads, di // tcfg.num_heads
    want = {"hymba": [("mamba_scan_chunk", (B, 4, di // 2))] * (S // 4),
            "mlstm": [("mlstm_chunkwise", (B, nh // 2, S, hd))],
            "slstm": [("slstm_recurrence", (B, S, 4 * di // 2))]}[kind]
    local = {"hymba": ["a_log", "d_skip", "dt_bias", "w_out"],
             "mlstm": ["w_down", "w_gate", "wk", "wq", "wv"],
             "slstm": ["w_down"]}[kind]
    for r in res:
        assert r["shapes"] == want
        assert r["local"] == local
        for k in local:
            assert r["grads"][k].size * 2 == grads[k].size, k


def test_heads_that_do_not_split_run_whole_on_every_rank(tmp_path):
    """Reduced xlstm at a model axis of 4: the rule table shards DI = 64
    four ways, but its 2 heads do not split: every leaf is gathered, each
    rank runs both heads on every row and keeps its own, the same as
    JAX's cell on one device."""
    kinds = ("mlstm", "slstm")
    refs, ranks = _cell_run(4, kinds, tmp_path)
    for i, kind in enumerate(kinds):
        y, dx, grads, case = refs[i]
        res = [r[i] for r in ranks]
        _close(np.concatenate([r["y"] for r in res], axis=1), y, "output")
        _close(np.concatenate([r["dx"] for r in res], axis=1), dx, "dx")
        for k, want in grads.items():
            _close(_whole([r["grads"][k] for r in res], res[0]["specs"][k]),
                   want, k)
        _, tcfg = configs(case["arch"], case["cfg_kw"])
        di, nh = 2 * tcfg.d_model, tcfg.num_heads
        shape = {"mlstm": ("mlstm_chunkwise", (B, nh, S, di // nh)),
                 "slstm": ("slstm_recurrence", (B, S, 4 * di))}[kind]
        for r in res:
            assert r["shapes"] == [shape] and r["local"] == []
            assert r["specs"]["w_down"][0] == "model"
