"""The port's hybrid family (hymba-1.5b: parallel attention and Mamba
heads) against the JAX package's, on the CPU.

``params_from_jax`` carries the JAX weights across.  float32 outputs are
held to rtol 1e-5 with an absolute slack of 1e-5 of the output's scale
(the scan's association order differs: JAX's ``associative_scan`` against
the port's Hillis-Steele rounds); bf16 outputs to 2e-2 plus 1e-2 of each
row's largest |output| (the two round their elementwise chains at other
points).  Gradients are held leaf by leaf to 1e-4 of the leaf's norm,
greedy tokens under the top-1 margin rule, refusals exactly.

Torch runs on one intra-op thread throughout the module: with torch
2.13 on the CPU at 8 intra-op threads, the first ``torch.exp`` after a
JAX computation in the same process has returned one thread's share of
a tensor wrong by up to 1e-4, and the scan compounds the decay over
every step.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.config import ServeConfig as JServe  # noqa: E402
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import ssm as jssm  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.lm import periodic_segments  # noqa: E402
from repro.serving.core import EngineCore as JCore  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.config import (ParallelConfig, ServeConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.convert import \
    periodic_segments as t_periodic_segments  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import ssm  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.core import EngineCore  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import SamplingParams  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             make_train_step)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import apply_rank, spawn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "hymba-1.5b"
RTOL = 1e-5                     # float32, with atol RTOL x the scale
GRAD_RTOL = 1e-4                # a leaf's gradient, of the leaf's norm
MARGIN = 1e-4
B, S = 2, 48                    # S > window (32 reduced): the window bites


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _t(a) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of the same dtype (bf16
    through its bits: numpy's bfloat16 has no torch bridge)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = a.view(np.uint16).astype(np.int32) << 16
        return torch.from_numpy(bits).view(torch.float32).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, err_msg=""):
    want = _f32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_f32(got), want, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def _bf16_close(got, want, err_msg=""):
    """Every element within 2e-2 plus 1e-2 of its row's largest |want|
    (rows: the last dim)."""
    want = _f32(want)
    got = _f32(got).reshape(want.shape)
    rows = want.reshape(-1, want.shape[-1])
    scale = np.abs(rows).max(-1, keepdims=True)
    err = np.abs(got.reshape(rows.shape) - rows)
    worst = float((err - 1e-2 * scale).max())
    assert worst <= 2e-2, f"{err_msg}: {worst} above 2e-2 + 1e-2 x row scale"


def _held(got, want, dtype, err_msg=""):
    if dtype == "bfloat16":
        _bf16_close(got, want, err_msg)
    else:
        _close(got, want, err_msg=err_msg)


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(reduce_for_smoke(get_model_config(ARCH)),
                               dtype=dtype, param_dtype=dtype, **kw)
    tcfg = dataclasses.replace(t_reduce(t_get(ARCH)), dtype=dtype,
                               param_dtype=dtype, **kw)
    return jcfg, tcfg


def _pair(num_layers=2):
    jcfg, tcfg = _cfgs(num_layers=num_layers)
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(vocab, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, :5] = -1                              # masked positions
    return tokens, labels


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------

def test_config_is_a_copy_of_jax():
    """Field for field, but the impl default: "auto" in the port (the
    kernel on the card), "reference" in the JAX package."""
    got = dataclasses.asdict(t_get(ARCH))
    want = dataclasses.asdict(get_model_config(ARCH))
    assert got.pop("attention_impl") == "auto"
    want.pop("attention_impl")
    assert got == want
    kinds = t_get(ARCH).blocks()
    assert [i for i, k in enumerate(kinds) if k == "hymba"] == [0, 15, 31]


@pytest.mark.parametrize("num_layers", [2, 32])
def test_params_from_jax_on_hymba_segments(num_layers):
    """2 layers form one unit (hymba, hymba_local); the full 32-layer
    pattern has none and falls back to runs of one kind: 1, 14, 1, 15, 1."""
    jcfg, tcfg = _cfgs(num_layers=num_layers)
    segs = t_periodic_segments(tcfg)
    assert segs == periodic_segments(jcfg)
    if num_layers == 32:
        assert segs == [(("hymba",), 1), (("hymba_local",), 14),
                        (("hymba",), 1), (("hymba_local",), 15),
                        (("hymba",), 1)]
    jp = j_build(jcfg, JParallel(remat="none")).init(jax.random.PRNGKey(1))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    assert len(tp["layers"]) == num_layers
    layer = 0
    for si, (unit, reps) in enumerate(segs):
        for rep in range(reps):
            for i, kind in enumerate(unit):
                want = jp[f"seg{si}"][f"u{i}"]
                assert set(want) >= {"mamba", "norm_attn", "norm_mamba"}
                flat = jax.tree_util.tree_flatten_with_path(want)[0]
                for path, leaf in flat:
                    leaf = np.asarray(leaf)
                    leaf = leaf[rep] if reps > 1 else leaf
                    got = tp["layers"][layer]
                    for p in path:
                        got = got[p.key]
                    assert got.dtype == _t(leaf).dtype, path
                    np.testing.assert_array_equal(got.numpy(), leaf)
                assert tcfg.blocks()[layer] == kind
                layer += 1
    assert layer == num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_matches_jax(dtype):
    """Shapes and dtypes are JAX's (``a_log`` float32 in a bf16 model);
    the deterministic leaves equal JAX's -- ``a_log`` to the correctly
    rounded log(1..N), which JAX's float32 log misses by one ulp at 7 --
    and the random ones have the reference's scale."""
    jcfg, tcfg = _cfgs(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jdt)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = ssm.init_mamba(gen, tcfg, tdt)
    assert got.keys() == jp.keys()
    for k in got:
        want = _t(jp[k])
        assert got[k].shape == want.shape and got[k].dtype == want.dtype, k
    assert got["a_log"].dtype == torch.float32
    for k in ("conv_b", "dt_bias", "d_skip"):
        assert torch.equal(got[k], _t(jp[k])), k
    n = tcfg.ssm_state_size
    exact = np.log(np.arange(1, n + 1, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got["a_log"].numpy(),
                                  np.broadcast_to(exact, (tcfg.q_dim, n)))
    ulps = np.abs(np.asarray(jp["a_log"]).view(np.int32)
                  - got["a_log"].numpy().view(np.int32))
    assert ulps.max() <= 1
    di, d = tcfg.q_dim, tcfg.d_model
    for k, scale in (("w_in", d ** -0.5), ("w_bc", di ** -0.5),
                     ("w_dt", di ** -0.5), ("w_out", di ** -0.5),
                     ("conv_w", tcfg.conv_kernel ** -0.5)):
        assert abs(got[k].float().std().item() - scale) < 0.15 * scale, k


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------

def _mamba(dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(dtype)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg, getattr(jnp, dtype))
    tp = {k: _t(v) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(shape, dtype="float32", seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), _t(x).to(
        getattr(torch, dtype))


def _state(tcfg, dtype="float32", seed=5):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, tcfg.q_dim, tcfg.ssm_state_size)).astype(
        np.float32)
    conv = rng.normal(size=(B, tcfg.conv_kernel - 1, tcfg.q_dim)).astype(
        np.float32)
    jconv = jnp.asarray(conv).astype(getattr(jnp, dtype))
    return (jssm.MambaState(h=jnp.asarray(h), conv=jconv),
            ssm.MambaState(h=_t(h), conv=_t(np.asarray(jconv))))


@pytest.mark.parametrize("chunk", [4, 256])
@pytest.mark.parametrize("s", [1, 7, 48])
def test_apply_mamba_matches_jax(s, chunk):
    """One step, a length the chunk of 4 does not divide (the zero-padded
    tail) and twelve chunks of 4 (the state carried across them)."""
    jcfg, tcfg, jp, tp = _mamba(seed=s)
    jx, tx = _x((B, s, tcfg.d_model), seed=s)
    want = jssm.apply_mamba(jp, jx, jcfg, chunk=chunk)
    got = ssm.apply_mamba(tp, tx, tcfg, chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_decode_from_a_state_matches_jax(dtype):
    """decode=True from a non-zero state over 5 steps at once: output and
    the new (h, conv) equal JAX's; the chunked pass from that state (not
    decode) gives the same output."""
    jcfg, tcfg, jp, tp = _mamba(dtype, seed=2)
    jx, tx = _x((B, 5, tcfg.d_model), dtype, seed=3)
    jst, tst = _state(tcfg, dtype)
    jy, jnew = jssm.apply_mamba(jp, jx, jcfg, state=jst, decode=True)
    ty, tnew = ssm.mamba_decode(tp, tx, tcfg, tst)
    _held(ty, jy, dtype, "output")
    assert tnew.h.dtype == torch.float32 and tnew.conv.dtype == tx.dtype
    # h is float32, but in a bf16 model it integrates bf16 inputs that the
    # two packages round at other points: held as a bf16 output
    _held(tnew.h, jnew.h, dtype, "h")
    _held(tnew.conv, jnew.conv, dtype, "conv")
    chunked = ssm.apply_mamba(tp, tx, tcfg, chunk=2, state=tst)
    _held(chunked, ty, dtype, "chunked from the state")


def test_mamba_single_steps_match_jax_and_the_chunked_pass():
    """Twelve one-token decode steps threaded through the state: each
    step's output and state against JAX's decode steps, and the outputs
    together against one chunked pass over the twelve tokens."""
    jcfg, tcfg, jp, tp = _mamba(seed=4)
    jx, tx = _x((B, 12, tcfg.d_model), seed=4)
    jst = tst = None
    outs = []
    for t in range(12):
        jy, jst = jssm.apply_mamba(jp, jx[:, t:t + 1], jcfg, state=jst,
                                   decode=True)
        ty, tst = ssm.mamba_decode(tp, tx[:, t:t + 1], tcfg, tst)
        _close(ty, jy, err_msg=f"step {t}")
        _close(tst.h, jst.h, err_msg=f"h after step {t}")
        _close(tst.conv, jst.conv, err_msg=f"conv after step {t}")
        outs.append(ty)
    _close(torch.cat(outs, dim=1), ssm.apply_mamba(tp, tx, tcfg, chunk=4))


def test_mamba_scan_matches_a_sequential_loop():
    """The log-depth scan against the recurrence written out step by step
    in float64."""
    g = torch.Generator()
    g.manual_seed(0)
    b, length, di, n = 2, 37, 8, 4
    xc, dt = torch.randn((b, length, di), generator=g), torch.rand(
        (b, length, di), generator=g)
    bc, cc = (torch.randn((b, length, n), generator=g) for _ in range(2))
    a = -torch.rand((di, n), generator=g) * 4
    h0 = torch.randn((b, di, n), generator=g)
    y, h_last = ssm.mamba_scan_chunk(h0, xc, dt, bc, cc, a)
    h = h0.double()
    ys = []
    for t in range(length):
        h = (torch.exp(dt[:, t, :, None].double() * a.double()) * h
             + (dt[:, t] * xc[:, t]).double()[..., None]
             * bc[:, t, None, :].double())
        ys.append((h * cc[:, t, None, :].double()).sum(-1))
    _close(y, torch.stack(ys, 1))
    _close(h_last, h)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _block(kind, dtype, seed):
    jcfg, tcfg = _cfgs(dtype)
    jp = jblocks.init_block(jax.random.PRNGKey(seed), jcfg, kind,
                            getattr(jnp, dtype))
    tp = jax.tree.map(_t, jp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["hymba", "hymba_local"])
def test_apply_block_matches_jax(kind, dtype):
    jcfg, tcfg, jp, tp = _block(kind, dtype, seed=6)
    assert set(tp) == {"ln1", "attn", "ln2", "mlp", "mamba", "norm_attn",
                       "norm_mamba"}
    assert tblocks.init_block(torch.Generator(), tcfg, kind,
                              getattr(torch, dtype)).keys() == tp.keys()
    jx, tx = _x((B, S, tcfg.d_model), dtype, seed=7)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want = jblocks.apply_block(jp, jx, jcfg, kind, positions=jnp.asarray(pos))
    got = tblocks.apply_block(tp, tx, tcfg, kind,
                              positions=torch.from_numpy(pos))
    assert got.dtype == tx.dtype
    _held(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["hymba", "hymba_local"])
def test_apply_block_decode_matches_jax(kind, dtype):
    """One token at position 40 of a cache whose first 40 rows and Mamba
    state are random: past the window of 32, so hymba_local's window
    bites.  The output, the KV rows and the new state equal JAX's."""
    jcfg, tcfg, jp, tp = _block(kind, dtype, seed=8)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pos = 40
    jcache = jblocks.init_block_cache(jcfg, kind, B, S, jdt)
    tcache = tblocks.init_block_cache(tcfg, kind, B, S, tdt, "cpu")
    assert set(tcache) == {"kv", "mamba"}
    rng = np.random.default_rng(9)
    kv = [np.zeros(jcache["kv"].k.shape, np.float32) for _ in range(2)]
    for a in kv:
        a[:, :pos] = rng.normal(size=a[:, :pos].shape)
    jkv = [jnp.asarray(a).astype(jdt) for a in kv]
    jst, tst = _state(tcfg, dtype)
    jcache = {"kv": jattn.KVCache(*jkv), "mamba": jst}
    tcache = {"kv": tattn.KVCache(*(_t(np.asarray(a)) for a in jkv)),
              "mamba": tst}
    jx, tx = _x((B, 1, tcfg.d_model), dtype, seed=10)
    want, jnew = jblocks.apply_block_decode(jp, jx, jcfg, kind, jcache,
                                            pos=pos)
    got, tnew = tblocks.apply_block_decode(tp, tx, tcfg, kind, tcache,
                                           pos=pos)
    _held(got, want, dtype, "output")
    for name, g, w in (("k", tnew["kv"].k, jnew["kv"].k),
                       ("v", tnew["kv"].v, jnew["kv"].v)):
        _held(g[:, pos], w[:, pos], dtype, name)
        np.testing.assert_array_equal(_f32(g[:, :pos]), _f32(w[:, :pos]))
    _held(tnew["mamba"].h, jnew["mamba"].h, dtype, "h")
    _held(tnew["mamba"].conv, jnew["mamba"].conv, dtype, "conv")


# ---------------------------------------------------------------------------
# the model: forward, decode, loss, gradients, training
# ---------------------------------------------------------------------------

def test_apply_and_loss_match_jax(pair):
    jcfg, jm, jp, tcfg, tp = pair
    tokens, labels = _tokens(jcfg.vocab_size)
    model = build_model(tcfg, "cpu", ParallelConfig(remat="none"))
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens)))
    _close(model.apply(tp, torch.from_numpy(tokens)), want)
    jl = float(jm.loss(jp, jnp.asarray(tokens), jnp.asarray(labels)))
    tl = model.loss(tp, torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), jl, rtol=RTOL)


def test_apply_matches_jax_at_the_full_layer_pattern():
    """All 32 layers of hymba's pattern (global at 0, 15, 31) at reduced
    widths: the weight bridge's five segments feed the right layers."""
    jcfg, jm, jp, tcfg, tp = _pair(num_layers=32)
    tokens, _ = _tokens(jcfg.vocab_size, seed=3, s=40)
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens)))
    model = build_model(tcfg, "cpu", ParallelConfig(remat="none"))
    _close(model.apply(tp, torch.from_numpy(tokens)), want)


def test_decode_matches_prefill(pair):
    """The JAX package's own decode-vs-prefill check on the port
    (``tests/test_arch_smoke.py``, same tolerances): the recurrence step
    by step against the chunked scan; and each step's logits and the
    final caches against JAX's decode steps."""
    jcfg, jm, jp, tcfg, tp = pair
    model = build_model(tcfg, "cpu")
    b, s = 2, 12
    tokens, _ = _tokens(jcfg.vocab_size, seed=2, b=b, s=s)
    full = model.apply(tp, torch.from_numpy(tokens))
    cache = model.init_cache(b, s + 4)
    jcache = jm.init_cache(b, s + 4)
    for t in range(s):
        tok = tokens[:, t]
        lg, cache = model.decode_step(tp, torch.from_numpy(tok), cache, t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=5e-2, atol=5e-3)
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, t)
        _close(lg, jl, err_msg=f"pos {t}")
    (unit, reps), = periodic_segments(jcfg)
    assert reps == 1
    for i in range(len(unit)):
        want = jcache["seg0"][f"u{i}"]
        _close(cache[i]["kv"].k, want["kv"].k)
        _close(cache[i]["kv"].v, want["kv"].v)
        _close(cache[i]["mamba"].h, want["mamba"].h)
        _close(cache[i]["mamba"].conv, want["mamba"].conv)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_gradients_match_jax(pair, remat):
    """Every leaf's gradient (a_log's float32 among them) against
    jax.grad, each within 1e-4 of its norm."""
    jcfg, jm, jp, tcfg, tp = pair
    tokens, labels = _tokens(jcfg.vocab_size, seed=1)
    jg = jax.grad(lambda p: jm.loss(p, jnp.asarray(tokens),
                                    jnp.asarray(labels)))(jp)
    want = params_from_jax(_np_tree(jg), tcfg, "cpu")
    model = build_model(tcfg, "cpu", ParallelConfig(remat=remat))
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(tp, torch.from_numpy(tokens),
                          torch.from_numpy(labels))
        got = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    assert any("a_log" in str(p) for p in paths)
    for path, g, w in zip(paths, got, tree.leaves(want)):
        g, w = g.double().numpy(), w.double().numpy()
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), path


def test_train_step_matches_jax():
    """One AdamW step through make_train_step (remat "full", as the
    launcher's "selective" runs) against JAX's jitted train step: loss,
    grad norm, lr and every updated parameter."""
    jcfg, tcfg = _cfgs()
    train = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jpar = JParallel(remat="none")
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**train)))
    tpar = ParallelConfig(remat="full")
    model = build_model(tcfg, "cpu", tpar)
    params = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    init = tree.tree_map(torch.clone, params)
    tstate = TrainState(params, opt.init_adamw(params))
    tstep = make_train_step(model, tcfg, tpar, TrainConfig(**train))
    jbatch = JPipeline(JData(vocab_size=jcfg.vocab_size, seq_len=40,
                             global_batch=2)).next()
    batch = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size, seq_len=40,
                                     global_batch=2)).next()
    for key in batch:
        np.testing.assert_array_equal(batch[key], jbatch[key])
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in jbatch.items()})
    tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=RTOL, err_msg=key)
    # each leaf's update as a norm ratio: Adam's first update
    # lr g / (|g| + eps) turns a gradient's rounding into a visible share
    # of lr wherever |g| is within some ten eps (one element of a w_in
    # moves by 7% of lr), so elementwise it is no test of the step
    want = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    for (path, g), w, p0 in zip(tree.leaves_with_paths(tstate.params),
                                tree.leaves(want), tree.leaves(init)):
        assert g.dtype == w.dtype, path
        du, dw = (g.double() - p0.double()), (w.double() - p0.double())
        assert (du - dw).norm() <= 1e-3 * dw.norm(), path
    assert int(tstate.opt.step) == int(jstate.opt.step) == 1


# ---------------------------------------------------------------------------
# serving: dense generate; the paged path refuses
# ---------------------------------------------------------------------------

def _margins(jm, jp, prompt, generated):
    """Top-1 margin of the JAX model at every generated position
    (teacher-forced full forward)."""
    seq = np.concatenate([prompt, generated[:-1]]).astype(np.int32)
    logits = np.asarray(jm.apply(jp, jnp.asarray(seq[None])))[0]
    rows = logits[len(prompt) - 1:]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_generate_greedy_matches_jax(pair):
    """Prompts of 30 tokens and 8 new: decode passes the reduced window
    of 32."""
    jcfg, jm, jp, tcfg, tp = pair
    n_new, prompt_len = 8, 30
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, prompt_len)).astype(np.int32)
    serve = dict(max_seq_len=prompt_len + n_new + 1, top_k=1)
    want = np.asarray(JEngine(model=jm, params=jp, cfg=jcfg,
                              serve=JServe(**serve)).generate(
        jnp.asarray(prompts), n_new))
    engine = ServeEngine(model=build_model(tcfg, "cpu"), params=tp,
                         cfg=tcfg, serve=ServeConfig(**serve))
    got = engine.generate(prompts, n_new)
    assert tuple(got.shape) == (2, n_new)
    compared = 0
    for row in range(2):
        margins = _margins(jm, jp, prompts[row], want[row])
        for t in range(n_new):
            if margins[t] < MARGIN:
                break                   # a near-tie: later tokens may fork
            assert int(got[row, t]) == int(want[row, t]), (row, t)
            compared += 1
    assert compared >= n_new


def test_paged_serving_refuses_hymba(pair):
    """hymba has no paged path, in the JAX package as here:
    init_paged_cache raises, and an EngineCore raises on its first step
    (it builds the pools lazily)."""
    jcfg, jm, jp, tcfg, tp = pair
    model = build_model(tcfg, "cpu")
    msg = "attention-cache blocks only"
    with pytest.raises(NotImplementedError, match=msg):
        jm.init_paged_cache(8, 16)
    with pytest.raises(NotImplementedError, match=msg):
        model.init_paged_cache(8, 16)
    serve = dict(max_batch=2, max_seq_len=32, page_size=16)
    prompt = np.arange(5, dtype=np.int32)
    jcore = JCore(jm, jp, jcfg, JServe(**serve))
    jcore.add_request(prompt, SamplingParams(max_new_tokens=2))
    with pytest.raises(NotImplementedError, match=msg):
        jcore.step()
    core = EngineCore(model, tp, tcfg, ServeConfig(**serve), device="cpu")
    core.add_request(prompt, SamplingParams(max_new_tokens=2))
    with pytest.raises(NotImplementedError, match=msg):
        core.step()


def test_model_axis_refuses_hymba(pair, tmp_path):
    """The Mamba heads' ``channels -> model`` layout is ported (the name
    is the test's from when it was not): the model builds at a model axis
    of 2, and two gloo ranks' forward, each over its half of the
    sequence and its half of the Mamba channels, gives JAX's logits."""
    jcfg, jm, jp, tcfg, tp = pair
    build_model(tcfg, "cpu", ParallelConfig(model=2))
    tokens, _ = _tokens(jcfg.vocab_size)
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens)))
    params = tree.tree_map(lambda t: t.numpy().copy(), tp)
    ranks = spawn(apply_rank, 2, tmp_path, ARCH, {}, dict(model=2), params,
                  {"tokens": tokens})
    assert [r["coords"] for r in ranks] == [{"data": 0, "model": m}
                                            for m in range(2)]
    _close(np.concatenate([r["logits"] for r in ranks], axis=1), want,
           rtol=1e-4)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("mesh", [[], ["--data", "2"]])
def test_train_cli_hymba_smoke(tmp_path, mesh):
    """One device, and a data-parallel mesh of two gloo ranks (the Mamba
    leaves replicated over it)."""
    out = _run("repro_torch.launch.train", "--arch", ARCH, "--smoke",
               "--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
               "40", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), *mesh)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout and "step     2 loss" in out.stdout


def test_serve_cli_hymba_generates_and_refuses_stream():
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "6", "--gen", "3"]
    out = _run("repro_torch.launch.serve", *common)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "generated (2, 3)" in out.stdout
    out = _run("repro_torch.launch.serve", *common, "--stream",
               "--requests", "2")
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "attention-cache blocks only" in out.stderr
