"""The port's xLSTM family (xlstm-125m) against the JAX package's, on the CPU.

The model runs on reduced xlstm-125m with ``num_layers=3`` -- blocks
(mlstm, mlstm, slstm) -- since ``reduce_for_smoke`` keeps two layers,
both mlstm, and the slstm block would go untested.  ``params_from_jax``
carries the JAX ``LM.init`` weights across; the JAX side runs its Pallas
mLSTM kernel in interpret mode where it has a kernel path.  Smoke configs
are float32 and the algorithms are the same, so logits, losses, gradients,
decode steps and train steps must agree to 1e-4 (gradients relative to
each one's scale); greedy tokens and refusals exactly.
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
from repro.layers import ssm as jssm  # noqa: E402
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
from repro_torch.kernels.mlstm.ops import mlstm_chunkwise_fwd  # noqa: E402
from repro_torch.layers import ssm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.core import EngineCore  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import SamplingParams  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "xlstm-125m"
TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4
B, S = 2, 24


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _cfgs(num_layers=3):
    jcfg = dataclasses.replace(reduce_for_smoke(get_model_config(ARCH)),
                               num_layers=num_layers)
    tcfg = dataclasses.replace(t_reduce(t_get(ARCH)), num_layers=num_layers)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, tp


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[0, :5] = -1                              # masked positions
    return tokens, labels


def _scaled_close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * scale, err_msg=err_msg)


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
    assert t_get(ARCH).blocks().count("slstm") == 2


@pytest.mark.parametrize("num_layers", [3, 12])
def test_params_from_jax_on_xlstm_segments(num_layers):
    """3 layers form one repeating unit (mlstm, mlstm, slstm); the full
    12-layer pattern has none and falls back to runs of one kind:
    [(mlstm,)x2, (slstm,)x1, (mlstm,)x5, (slstm,)x1, (mlstm,)x3]."""
    jcfg, tcfg = _cfgs(num_layers)
    segs = t_periodic_segments(tcfg)
    assert segs == periodic_segments(jcfg)
    if num_layers == 12:
        assert segs == [(("mlstm",), 2), (("slstm",), 1), (("mlstm",), 5),
                        (("slstm",), 1), (("mlstm",), 3)]
    jp = j_build(jcfg, JParallel(remat="none")).init(jax.random.PRNGKey(1))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    assert len(tp["layers"]) == num_layers
    layer = 0
    for si, (unit, reps) in enumerate(segs):
        for rep in range(reps):
            for i, kind in enumerate(unit):
                want = jp[f"seg{si}"][f"u{i}"]
                flat = jax.tree_util.tree_flatten_with_path(want)[0]
                for path, leaf in flat:
                    leaf = np.asarray(leaf)
                    leaf = leaf[rep] if reps > 1 else leaf
                    got = tp["layers"][layer]
                    for p in path:
                        got = got[p.key]
                    np.testing.assert_array_equal(got.numpy(), leaf)
                assert tcfg.blocks()[layer] == kind
                layer += 1
    assert layer == num_layers


def test_init_matches_jax_shapes_and_scale():
    jcfg, tcfg = _cfgs()
    jp = j_build(jcfg, JParallel(remat="none")).init(jax.random.PRNGKey(0))
    ref = params_from_jax(_np_tree(jp), tcfg, "cpu")
    model = build_model(tcfg, "cpu")
    got = model.init(model.generator(0))
    a, b = dict(tree.leaves_with_paths(got)), dict(
        tree.leaves_with_paths(ref))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    di = ssm._di(tcfg)
    cell = got["layers"][0]["cell"]
    torch.testing.assert_close(cell["b_if"], ref["layers"][0]["cell"]["b_if"])
    for w, fan_in in ((cell["wq"], di), (cell["w_up"], tcfg.d_model),
                      (got["layers"][2]["cell"]["w_gates"], di)):
        assert abs(w.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    hd = di // tcfg.num_heads
    r = got["layers"][2]["cell"]["r_gates"]
    assert abs(r.std().item() - hd ** -0.5) < 0.1 * hd ** -0.5


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _cell(kind, seed):
    jcfg, tcfg = _cfgs()
    init = jssm.init_mlstm if kind == "mlstm" else jssm.init_slstm
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).normal(
        size=(B, 20, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("impl,jimpl", [(None, "interpret"),
                                        ("kernel", "interpret"),
                                        ("reference", "reference")])
def test_apply_mlstm_train_matches_jax(impl, jimpl):
    jcfg, tcfg, jp, tp, x = _cell("mlstm", 3)
    want = jssm.apply_mlstm(jp, jnp.asarray(x), jcfg, chunk=8, impl=jimpl)
    got = ssm.apply_mlstm(tp, torch.from_numpy(x), tcfg, chunk=8, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mlstm_state(jcfg, seed):
    di = int(jcfg.d_model * jcfg.mlstm_proj_factor)
    nh = jcfg.num_heads
    hd = di // nh
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, nh, hd, hd)).astype(np.float32),
            rng.normal(size=(B, nh, hd)).astype(np.float32),
            rng.normal(size=(B, nh)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mlstm_decode_matches_jax(with_state):
    """The recurrent path from no state and from a given state, three
    steps at once and then one more from the returned state."""
    jcfg, tcfg, jp, tp, x = _cell("mlstm", 4)
    x = x[:, :3]
    jst = tst = None
    if with_state:
        c, n, m = _mlstm_state(jcfg, 5)
        z = np.zeros((0,), np.float32)
        jst = jssm.MLSTMState(*(jnp.asarray(a) for a in (c, n, m, z)))
        tst = ssm.MLSTMState(*(torch.from_numpy(a) for a in (c, n, m, z)))
    jy, jst = jssm.apply_mlstm(jp, jnp.asarray(x), jcfg, state=jst,
                               decode=True)
    ty, tst = ssm.mlstm_decode(tp, torch.from_numpy(x), tcfg, tst)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    x1 = x[:, :1] * 0.5
    jy, jst = jssm.apply_mlstm(jp, jnp.asarray(x1), jcfg, state=jst,
                               decode=True)
    ty, tst = ssm.mlstm_decode(tp, torch.from_numpy(x1), tcfg, tst)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for a, w in zip(tst[:3], jst[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("decode,with_state", [(False, False),
                                               (True, False), (True, True)])
def test_apply_slstm_matches_jax(decode, with_state):
    jcfg, tcfg, jp, tp, x = _cell("slstm", 6)
    jst = tst = None
    if with_state:
        di = int(jcfg.d_model * jcfg.mlstm_proj_factor)
        rng = np.random.default_rng(7)
        arrs = [rng.normal(size=(B, di)).astype(np.float32)
                for _ in range(4)]
        arrs[1] = np.abs(arrs[1]) + 0.5                 # n > 0
        jst = jssm.SLSTMState(*(jnp.asarray(a) for a in arrs))
        tst = ssm.SLSTMState(*(torch.from_numpy(a) for a in arrs))
    want = jssm.apply_slstm(jp, jnp.asarray(x), jcfg, state=jst,
                            decode=decode)
    if decode:
        got = ssm.slstm_decode(tp, torch.from_numpy(x), tcfg, tst)
    else:
        got = ssm.apply_slstm(tp, torch.from_numpy(x), tcfg)
    if not decode:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for a, w in zip(got[1], want[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients, training
# ---------------------------------------------------------------------------

def test_apply_and_loss_match_jax(pair):
    jcfg, jm, jp, tcfg, tp = pair
    tokens, labels = _tokens(jcfg.vocab_size)
    model = build_model(tcfg, "cpu", ParallelConfig(remat="none"))
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens), impl="interpret"))
    for impl in (None, "kernel", "reference"):
        before = mlstm_chunkwise_fwd.launches
        got = model.apply(tp, torch.from_numpy(tokens), impl=impl)
        assert mlstm_chunkwise_fwd.launches == before   # plain on CPU
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    jl = float(jm.loss(jp, jnp.asarray(tokens), jnp.asarray(labels),
                       impl="interpret"))
    tl = model.loss(tp, torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), jl, **TOL)


@pytest.mark.parametrize("remat,impl", [("none", None), ("full", "kernel"),
                                        ("selective", "reference")])
def test_loss_gradients_match_jax(pair, remat, impl):
    """Every parameter's gradient against jax.grad through the JAX kernel
    in interpret mode (its custom_vjp recomputes the plain chunkwise form,
    as the port's autograd op does)."""
    jcfg, jm, jp, tcfg, tp = pair
    tokens, labels = _tokens(jcfg.vocab_size, seed=1)
    jg = jax.grad(lambda p: jm.loss(p, jnp.asarray(tokens),
                                    jnp.asarray(labels),
                                    impl="interpret"))(jp)
    want = params_from_jax(_np_tree(jg), tcfg, "cpu")
    model = build_model(tcfg, "cpu", ParallelConfig(remat=remat))
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(tp, torch.from_numpy(tokens),
                          torch.from_numpy(labels), impl=impl)
        got = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    for path, g, w in zip(paths, got, tree.leaves(want)):
        _scaled_close(g.numpy(), w.numpy(), err_msg=path)


def test_train_steps_match_jax():
    jcfg, tcfg = _cfgs()
    train = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jpar = JParallel(remat="none")
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**train)))
    tpar = ParallelConfig(remat="full")
    model = build_model(tcfg, "cpu", tpar)
    params = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    tstate = TrainState(params, opt.init_adamw(params))
    tstep = make_train_step(model, tcfg, tpar, TrainConfig(**train))
    jdata = JPipeline(JData(vocab_size=jcfg.vocab_size, seq_len=16,
                            global_batch=4))
    data = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                                    global_batch=4))
    for _ in range(3):
        jbatch, batch = jdata.next(), data.next()
        for key in batch:
            np.testing.assert_array_equal(batch[key], jbatch[key])
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in jbatch.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       err_msg=key, **TOL)
    want = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    for g, w in zip(tree.leaves(tstate.params), tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3


# ---------------------------------------------------------------------------
# serving: dense decode and generate; the paged path refuses
# ---------------------------------------------------------------------------

def test_decode_step_matches_jax_at_every_position(pair):
    """decode_step logits at every position, and the recurrent states
    (f32) the caches hold at the end, against JAX's; and the teacher-
    forced decode logits against the port's own chunkwise LM.apply."""
    jcfg, jm, jp, tcfg, tp = pair
    model = build_model(tcfg, "cpu")
    tokens, _ = _tokens(jcfg.vocab_size, seed=2)
    jcache = jm.init_cache(B, S + 2)
    tcache = model.init_cache(B, S + 2)
    for c in tcache:
        assert all(t.dtype == torch.float32 for t in c[:3])
    full = model.apply(tp, torch.from_numpy(tokens))
    for pos in range(S):
        tok = tokens[:, pos]
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, pos)
        tl, tcache = model.decode_step(tp, torch.from_numpy(tok), tcache,
                                       pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"pos {pos}", **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, pos].numpy(),
                                   err_msg=f"pos {pos}", **TOL)
    (unit, reps), = periodic_segments(jcfg)
    assert reps == 1
    for i, kind in enumerate(unit):
        want = jcache["seg0"][f"u{i}"]
        assert type(tcache[i]).__name__ == type(want).__name__
        for a, w in zip(tcache[i], want):
            if np.asarray(w).size:
                _scaled_close(a.numpy(), np.asarray(w))


def _margins(jm, jp, prompt, generated):
    """Top-1 margin of the JAX model at every generated position
    (teacher-forced full forward)."""
    seq = np.concatenate([prompt, generated[:-1]]).astype(np.int32)
    logits = np.asarray(jm.apply(jp, jnp.asarray(seq[None])))[0]
    rows = logits[len(prompt) - 1:]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_generate_greedy_matches_jax(pair):
    jcfg, jm, jp, tcfg, tp = pair
    n_new, prompt_len = 8, 12
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
    assert engine.throughput_tokens_per_s(2, 4, n_new=2) > 0


def test_paged_serving_refuses_xlstm(pair):
    """Recurrent blocks have no paged path, in the JAX package as here:
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


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_cli_xlstm_smoke(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", ARCH, "--smoke",
               "--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
               "32", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout and "step     2 loss" in out.stdout


def test_serve_cli_xlstm_generates_and_refuses_stream():
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
