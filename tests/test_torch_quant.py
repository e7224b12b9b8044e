"""Weight-only int8 (``quant/int8.py``) against the JAX package's, on the
CPU.

``quantize_tensor`` equals JAX's bit for bit (q and scale).
``quantize_tree`` on reduced llama2-7b and hymba-1.5b, through
``params_from_jax``, equals JAX's ``quantize_tree`` of JAX's own tree
leaf for leaf at ``scan_layers`` True and False: the same leaves
quantized, q and scale exact -- under True JAX stacks each periodic
segment's layers, so a leaf's scale is shared by the segment's layers
and its norm scales are quantized (ROADMAP Queue 3).  ``dequantize_tree``
and ``quantized_size_bytes`` are equal, and ``LM.apply`` on the port's
dequantized weights is within 1e-4 of its scale of JAX's ``model.apply``
on JAX's.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.quant import int8 as J  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax, periodic_segments  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.quant import int8 as T  # noqa: E402
from repro_torch.training import tree  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)      # torch beside JAX (ROADMAP Queue 3)
    yield
    torch.set_num_threads(n)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000), shape=st.sampled_from(
    [(1, 1), (7, 1), (1, 9), (33, 17), (64, 64), (3, 5, 8), (2, 4, 3, 6)]),
    mag=st.sampled_from([1e-8, 1e-2, 1.0, 100.0]),
    bf16=st.booleans())
def test_quantize_tensor_is_jaxs_bit_for_bit(seed, shape, mag, bf16):
    x = (np.random.default_rng(seed).normal(size=shape) * mag
         ).astype(np.float32)
    jw, tw = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    jq, tq = J.quantize_tensor(jw), T.quantize_tensor(tw)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert tq.scale.shape == jq.scale.shape
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert tq.scale.numpy().tobytes() == np.asarray(jq.scale).tobytes()
    np.testing.assert_array_equal(
        T.dequantize_tensor(tq, torch.float32).numpy(),
        np.asarray(J.dequantize_tensor(jq, jnp.float32)))


def _np(x):
    return np.asarray(x)


def _jax_layout(jq: dict, cfg, scan: bool) -> dict:
    """JAX's quantized tree in the port's layout: each layer its slice of
    its segment's stack (q at its repeat, the stack's one scale), each
    leaf numpy or a (q, scale) pair."""
    segs = (periodic_segments(cfg) if scan
            else [((k,), 1) for k in cfg.blocks()])

    def pick(x, rep, reps):
        if isinstance(x, J.QuantizedTensor):
            return (_np(x.q[rep] if reps > 1 else x.q),
                    _np(x.scale[0] if reps > 1 else x.scale))
        return _np(x[rep] if reps > 1 else x)

    def top(x):
        return ((_np(x.q), _np(x.scale))
                if isinstance(x, J.QuantizedTensor) else _np(x))

    layers = []
    for si, (unit, reps) in enumerate(segs):
        seg = jq[f"seg{si}"]
        for rep in range(reps):
            for i in range(len(unit)):
                layers.append(jax.tree.map(
                    lambda x: pick(x, rep, reps), seg[f"u{i}"],
                    is_leaf=lambda x: isinstance(x, J.QuantizedTensor)))
    out = {k: jax.tree.map(top, v, is_leaf=lambda x: isinstance(
        x, J.QuantizedTensor)) for k, v in jq.items()
        if not k.startswith("seg")}
    out["layers"] = layers
    return out


def _port_layout(tq):
    if isinstance(tq, T.QuantizedTensor):
        return (tq.q.numpy(), tq.scale.numpy())
    if isinstance(tq, dict):
        return {k: _port_layout(v) for k, v in tq.items()}
    if isinstance(tq, list):
        return [_port_layout(v) for v in tq]
    return tq.numpy()


def _same(a, b, path="") -> list:
    """The paths where two trees of numpy leaves and (q, scale) pairs
    differ: in kind, shape, dtype or any bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        return [p for k in a for p in _same(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list):
        assert len(a) == len(b), path
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _same(x, y, f"{path}/{i}")]
    if isinstance(a, tuple) != isinstance(b, tuple):
        return [f"{path}: quantized on one side only"]
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return [path for x, y in pairs
            if x.shape != y.shape or x.dtype != y.dtype
            or x.tobytes() != y.tobytes()]


ARCHS = ["llama2-7b", "hymba-1.5b"]


@pytest.fixture(scope="module", params=[(a, s) for a in ARCHS
                                        for s in (True, False)],
                ids=lambda p: f"{p[0]}-scan{p[1]}")
def pair(request):
    arch, scan = request.param
    jcfg = reduce_for_smoke(get_model_config(arch))
    tcfg = t_reduce(t_get(arch))
    jm = j_build(jcfg, JParallel(remat="none", scan_layers=scan))
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(_np, jparams), tcfg, "cpu",
                             scan_layers=scan)
    return dict(arch=arch, scan=scan, tcfg=tcfg, jm=jm, jparams=jparams,
                params=params, jq=J.quantize_tree(jparams),
                tq=T.quantize_tree(params, tcfg, scan_layers=scan))


def test_quantize_tree_is_jaxs_leaf_for_leaf(pair):
    want = _jax_layout(pair["jq"], pair["tcfg"], pair["scan"])
    got = _port_layout(pair["tq"])
    assert _same(got, want) == []
    norm = got["layers"][0]["ln1"]["scale"]
    if pair["arch"] == "llama2-7b" and pair["scan"]:
        # stacked: one scale a channel for the segment's layers, and the
        # norm scales quantized (the reference's layout property)
        assert isinstance(norm, tuple)
        s0 = pair["tq"]["layers"][0]["attn"]["wq"].scale
        assert pair["tq"]["layers"][1]["attn"]["wq"].scale is s0
    else:
        assert not isinstance(norm, tuple)


def test_dequantize_tree_and_size_are_jaxs(pair):
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = T.dequantize_tree(pair["tq"], dtype)
        want = params_from_jax(jax.tree.map(
            _np, J.dequantize_tree(pair["jq"], jdt)), pair["tcfg"], "cpu",
            scan_layers=pair["scan"])
        for (p, a), b in zip(tree.leaves_with_paths(got), tree.leaves(want),
                             strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), p
    assert T.quantized_size_bytes(pair["tq"]) == \
        J.quantized_size_bytes(pair["jq"])
    full = sum(t.numel() * t.element_size()
               for t in tree.leaves(pair["params"]))
    assert T.quantized_size_bytes(pair["tq"]) < 0.6 * full


def test_apply_on_dequantized_weights_matches_jax(pair):
    tcfg = pair["tcfg"]
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                             size=(2, 24)).astype(np.int32)
    jlogits = _np(jax.jit(pair["jm"].apply)(
        J.dequantize_tree(pair["jq"], jnp.float32), jnp.asarray(toks)))
    model = build_model(tcfg, "cpu", ParallelConfig(remat="none"))
    with torch.no_grad():
        logits = model.apply(T.dequantize_tree(pair["tq"], torch.float32),
                             torch.from_numpy(toks)).numpy()
    scale = np.abs(jlogits).max()
    assert np.abs(logits - jlogits).max() <= 1e-4 * scale
