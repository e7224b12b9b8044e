"""The port's training path against the JAX package's, on the CPU.

``params_from_jax`` carries the JAX ``LM.init`` weights (and, with the
same tree structure, the JAX gradients) across; then the full forward,
the loss, its gradients, one AdamW update, three train steps, the data
pipeline and checkpoint resume are held to the JAX package.  Smoke
configs are float32.  Tolerances: logits, loss, gradients and train steps
1e-4 (float32 sums in another order through two layers, the LM head and
their backward; Adam divides by the root of the second moment, which
magnifies gradient differences on entries near 0); one AdamW update 1e-6
(the same float32 arithmetic, term for term); data batches and
checkpoints exactly.
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
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.config import (ModelConfig, ParallelConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             init_train_state,
                                             make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gemma2-2b", "qwen2.5-32b", "llama2-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[0, :5] = -1                              # masked positions
    return tokens, labels


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = reduce_for_smoke(get_model_config(arch))
    tcfg = t_reduce(t_get(arch))
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, tp


def test_apply_and_loss_match_jax(pair):
    jcfg, jm, jp, tcfg, tp = pair
    tokens, labels = _tokens(jcfg.vocab_size)
    model = build_model(tcfg, "cpu", ParallelConfig(remat="none"))
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens), impl="reference"))
    for impl in (None, "pallas"):      # plain version / kernel wrapper
        got = model.apply(tp, torch.from_numpy(tokens), impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    jl = float(jm.loss(jp, jnp.asarray(tokens), jnp.asarray(labels)))
    tl = model.loss(tp, torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), jl, **TOL)


@pytest.mark.parametrize("remat,impl", [("none", None), ("full", "kernel"),
                                        ("selective", None)])
def test_loss_gradients_match_jax(pair, remat, impl):
    """Every parameter's gradient, JAX's carried across by
    params_from_jax (same tree as the weights); remat and the autograd
    kernel op change nothing."""
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
                          torch.from_numpy(labels), impl=impl)
        got = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    for path, g, w in zip(paths, got, tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path,
                                   **TOL)


def _opt_inputs(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}

    def draw(scale=1.0, positive=False):
        def leaf(shape):
            x = rng.normal(size=shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(
            s, tuple))
    return draw(), draw(grad_scale), draw(0.1), draw(0.01, True)


@pytest.mark.parametrize("step0,grad_scale,clip", [
    (0, 0.1, 1.0),            # the first step
    (9, 0.1, 1.0),            # step 10 = warmup_steps: the warmup edge
    (4, 3.0, 0.5),            # global norm far above the clip
])
def test_adamw_update_matches_jax(step0, grad_scale, clip):
    cfg = dict(learning_rate=1e-2, warmup_steps=10, total_steps=50,
               grad_clip=clip)
    params, grads, mu, nu = _opt_inputs(step0, grad_scale)
    jp, jstate, jm = jopt.adamw_update(
        jax.tree.map(jnp.asarray, grads),
        jopt.AdamWState(step=jnp.int32(step0),
                        mu=jax.tree.map(jnp.asarray, mu),
                        nu=jax.tree.map(jnp.asarray, nu)),
        jax.tree.map(jnp.asarray, params), JTrain(**cfg))
    t = lambda x: jax.tree.map(torch.from_numpy, x)  # noqa: E731
    tp, tstate, tm = opt.adamw_update(
        t(grads), opt.AdamWState(step=torch.tensor(step0, dtype=torch.int32),
                                 mu=t(mu), nu=t(nu)),
        t(params), TrainConfig(**cfg))
    exact = dict(rtol=1e-6, atol=1e-6)
    assert int(tstate.step) == int(jstate.step) == step0 + 1
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **exact)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **exact)
    if clip < 1.0:
        assert float(jm["grad_norm"]) > clip
    for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **exact)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_jax(micro):
    arch = "llama2-7b"
    jcfg = reduce_for_smoke(get_model_config(arch))
    tcfg = t_reduce(t_get(arch))
    train = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jpar = JParallel(remat="none", microbatches=micro)
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**train)))
    tpar = ParallelConfig(remat="full", microbatches=micro)
    model = build_model(tcfg, "cpu", tpar)
    params = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    tstate = TrainState(params, opt.init_adamw(params))
    tstep = make_train_step(model, tcfg, tpar, TrainConfig(**train))
    data = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                                    global_batch=4))
    for _ in range(3):
        batch = data.next()
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       err_msg=key, **TOL)
    want = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    for g, w in zip(tree.leaves(tstate.params), tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3


@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=8, global_batch=4),
    dict(vocab_size=32000, seq_len=33, global_batch=6, seed=7),
    dict(vocab_size=500, seq_len=8, global_batch=8, host_count=2,
         host_index=1),
])
def test_token_pipeline_batches_equal_jax(kw):
    tp, jpipe = TokenPipeline(DataConfig(**kw)), JPipeline(JData(**kw))
    for _ in range(4):
        got, want = tp.next(), jpipe.next()
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    tp.restore({"step": 1})
    jpipe.restore({"step": 1})
    np.testing.assert_array_equal(tp.next()["tokens"],
                                  jpipe.next()["tokens"])


def test_token_pipeline_memmap_equals_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(5000, dtype=np.uint16).tofile(path)
    kw = dict(vocab_size=5000, seq_len=16, global_batch=4, path=path)
    tp, jpipe = TokenPipeline(DataConfig(**kw)), JPipeline(JData(**kw))
    for _ in range(3):
        np.testing.assert_array_equal(tp.next()["labels"],
                                      jpipe.next()["labels"])


def _steps_of(batches, cfg) -> list:
    """The stream position of each batch, read off ``next()``'s
    sequence."""
    ref = TokenPipeline(cfg)
    seq = [ref.next()["tokens"] for _ in range(16)]
    return [next(i for i, t in enumerate(seq)
                 if np.array_equal(t, b["tokens"])) for b in batches]


def test_token_pipeline_iterator_yields_next_batches():
    """The prefetching iterator yields ``next()``'s batches bit for bit
    from the current step, ``state()`` is the position after the last
    batch yielded (a resume repeats and skips nothing), and closing the
    generator stops the worker."""
    import threading
    kw = dict(vocab_size=1000, seq_len=8, global_batch=4, prefetch=2)
    assert dataclasses.asdict(DataConfig(**kw)) == \
        dataclasses.asdict(JData(**kw))
    want = TokenPipeline(DataConfig(**kw))
    want.restore({"step": 3})
    pipe = TokenPipeline(DataConfig(**kw), start_step=3)
    threads = threading.active_count()
    it = iter(pipe)
    for i in range(6):
        got, ref = next(it), want.next()
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        assert pipe.state() == {"step": 4 + i}
    it.close()
    assert threading.active_count() == threads
    np.testing.assert_array_equal(pipe.next()["tokens"],
                                  want.next()["tokens"])


def test_slow_consumer_skips_steps_in_jax_not_in_the_port():
    """Prefetch 1, 1.2 s between reads: JAX's worker drops each batch it
    cannot queue within 0.5 s (``src/repro/data/pipeline.py:72-77``), so
    its consumer skips steps and ``state()`` runs ahead of it; the port's
    keeps the batch (ROADMAP Queue 3)."""
    import time
    kw = dict(vocab_size=1000, seq_len=8, global_batch=4, prefetch=1)
    seen = {}
    for name, pipe in (("jax", JPipeline(JData(**kw))),
                       ("port", TokenPipeline(DataConfig(**kw)))):
        it, got = iter(pipe), []
        for i in range(3):
            if i:
                time.sleep(1.2)
            got.append(next(it))
        seen[name] = (_steps_of(got, DataConfig(**kw)), pipe.state())
        it.close()
    assert seen["port"] == ([0, 1, 2], {"step": 3})
    steps, state = seen["jax"]
    assert steps[:2] == [0, 1] and steps[2] > 2, steps
    assert state["step"] > 3, state


def _reduced_llama():
    return t_reduce(t_get("llama2-7b"))


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    """bf16 params, f32 moments and the int32 step come back bit for bit,
    with the JAX package's directory layout; async saves, gc, LATEST."""
    from dataclasses import replace
    cfg = replace(_reduced_llama(), param_dtype="bfloat16",
                  dtype="bfloat16")
    model = build_model(cfg, "cpu")
    state = init_train_state(model, model.generator(0))
    tree.leaves(state.opt.mu)[0].normal_()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state, extras={"data": {"step": step}}, async_=True)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002",
                                            "step_00000003"]
    assert mgr.latest_step() == 3
    files = os.listdir(tmp_path / "step_00000003")
    assert "manifest.json" in files and "arr_0.npy" in files
    fresh = init_train_state(model, model.generator(1))
    got, manifest = mgr.restore(fresh)
    assert manifest["extras"]["data"] == {"step": 3}
    for (path, a), b in zip(tree.leaves_with_paths(got), tree.leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b), path
    assert got.params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_checkpoint_resume_is_exact(tmp_path):
    """Mirrors tests/test_integration.py::test_checkpoint_resume_is_exact:
    6 steps with a checkpoint at 3, then restore at 3 and replay."""
    cfg = _reduced_llama()
    parallel = ParallelConfig(remat="none")
    model = build_model(cfg, "cpu", parallel)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=20, warmup_steps=2)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4))
    step = make_train_step(model, cfg, parallel, tcfg)

    def batch(pipe):
        return {k: torch.from_numpy(v) for k, v in pipe.next().items()}

    mgr = CheckpointManager(str(tmp_path))
    state = init_train_state(model, model.generator(0))
    for i in range(6):
        if i == 3:
            mgr.save(3, state, extras={"data": data.state()})
        state, m = step(state, batch(data))
    loss_direct = float(m["loss"])

    state2 = init_train_state(model, model.generator(0))
    state2, manifest = mgr.restore(state2)
    data2 = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=4))
    data2.restore(manifest["extras"]["data"])
    for _ in range(3):
        state2, m2 = step(state2, batch(data2))
    assert float(m2["loss"]) == loss_direct
    for a, b in zip(tree.leaves(state2), tree.leaves(state)):
        assert torch.equal(a, b)


def test_train_cli_smoke(tmp_path):
    """The port's launch script end to end on the CPU (6 steps)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama2-7b", "--smoke", "--device", "cpu", "--steps", "6",
           "--batch", "4", "--seq", "64", "--ckpt-every", "3",
           "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout and "step     5 loss" in out.stdout
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
    # the model axis over xlstm's recurrent cells (channels -> model):
    # two ranks, each running its heads of the mLSTM and sLSTM cells
    xcmd = [c if c != "llama2-7b" else "xlstm-125m" for c in cmd[:-2]]
    xcmd[xcmd.index("--steps") + 1] = "2"
    ran = subprocess.run(xcmd + ["--model-axis", "2", "--ckpt-dir",
                                 str(tmp_path / "x")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert ran.returncode == 0, ran.stderr[-2000:]
    assert "2 ranks (data=1, model=2) over gloo" in ran.stdout
    assert "done" in ran.stdout


def test_configs_refuse_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="pipeline"):
        ParallelConfig(pipeline_stages=2)
    with pytest.raises(NotImplementedError, match="grad_compression"):
        ParallelConfig(grad_compression="int8_ef")
    # the recurrent cells' channels -> model is ported
    build_model(t_reduce(t_get("xlstm-125m")), "cpu", ParallelConfig(model=2))
    ParallelConfig(data=2, model=2)     # accepted: the trainer's mesh
    build_model(t_reduce(t_get("xlstm-125m")), "cpu", ParallelConfig(data=2))
    with pytest.raises(ValueError, match="remat"):
        ParallelConfig(remat="some")
    assert t_get("llama2-7b").attention_impl == "auto"
    jcfg = reduce_for_smoke(get_model_config("llama2-7b"))
    assert ModelConfig(**jcfg.__dict__).attention_impl == "reference"
    assert TrainConfig().__dict__.keys() == JTrain().__dict__.keys()


def test_train_cli_defaults_to_cuda(tmp_path):
    """Without --device the trainer runs on the card, and without one it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "llama2-7b", "--smoke", "--steps", "1", "--batch",
              "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
