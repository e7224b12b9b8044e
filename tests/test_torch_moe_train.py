"""Training of the port's mixture-of-experts models against the JAX
package, on the CPU: reduced qwen3-moe-30b-a3b (4 experts top-2, SwiGLU)
and reduced grok-1-314b (GeGLU experts, attention softcap, a tied
embedding), JAX's own weights carried across (``params_from_jax``).

Each case runs at capacity factor 1.25, where the batch drops
assignments (asserted), and at 8.0, where it drops none (asserted).  A
dropped assignment adds nothing to its expert's gradient, but its gate
still enters the renormalisation, so the router's gradient follows
JAX's there too.

Held in float32: the loss within 1e-5 of its scale and every gradient
within 1e-4 of its leaf's norm against ``jax.grad`` of JAX's loss (remat
none and full); 3 AdamW steps against JAX's ``make_train_step`` within
rtol = atol = 1e-4 (loss, grad norm, lr and every parameter).  In bf16
(both packages' activations and weights) the loss within 1% and the
grad norm within 5% of JAX's (chip_smoke.py's LOSS_RTOL / GNORM_RTOL for
two rounding orders in bf16), and each gradient within 5% of its leaf's
norm.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             make_train_step)

ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
CFS = [1.25, 8.0]
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
B, S, STEPS = 4, 64, 3


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """torch on one intra-op thread while this module runs: it meets JAX
    in this process, and other test workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _configs(arch: str, cf: float, dtype: str = "float32"):
    kw = dict(moe_capacity_factor=cf, dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(reduce_for_smoke(get_model_config(arch)),
                                **kw),
            dataclasses.replace(t_reduce(t_get(arch)), **kw))


def _batches(vocab: int, n: int) -> list:
    """``n`` batches of B x S from the data pipeline, a few labels of row
    0 masked."""
    pipe = TokenPipeline(DataConfig(vocab_size=vocab, seq_len=S,
                                    global_batch=B))
    out = []
    for _ in range(n):
        b = pipe.next()
        b["labels"][0, :5] = -1
        out.append(b)
    return out


@pytest.fixture(scope="module", params=[(a, cf) for a in ARCHS
                                        for cf in CFS],
                ids=lambda p: f"{p[0]}-cf{p[1]}")
def pair(request):
    arch, cf = request.param
    jcfg, tcfg = _configs(arch, cf)
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tcfg, params_from_jax(_np_tree(jp), tcfg, "cpu")


def _grads(model, params, batch):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, torch.from_numpy(batch["tokens"]),
                          torch.from_numpy(batch["labels"]))
        return loss.detach(), torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)


def _counting_drops(monkeypatch) -> list:
    """Every MoE block's (dropped, total) assignments from here on."""
    log = []
    apply = moe.apply_moe

    def counting(params, x, cfg, **kw):
        log.append(moe.assignments_dropped(moe.routing(params, x, cfg)))
        return apply(params, x, cfg, **kw)
    monkeypatch.setattr(blocks.moe_mod, "apply_moe", counting)
    return log


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax_grad(pair, remat, monkeypatch):
    """The loss and every parameter's gradient against ``jax.grad`` of
    JAX's loss (carried across by params_from_jax, the same tree); the
    batch drops assignments at capacity factor 1.25 and none at 8."""
    jcfg, jm, jp, tcfg, tp = pair
    batch = _batches(tcfg.vocab_size, 1)[0]
    toks, labs = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, toks, labs))(jp)
    want = tree.leaves(params_from_jax(_np_tree(jg), tcfg, "cpu"))
    drops = _counting_drops(monkeypatch)
    loss, got = _grads(build_model(tcfg, "cpu", ParallelConfig(remat=remat)),
                       tp, batch)
    dropped = sum(d for d, _ in drops)
    assert len(drops) == tcfg.num_layers * (2 if remat == "full" else 1)
    assert (dropped > 0) if tcfg.moe_capacity_factor < 2 else dropped == 0
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    for path, g, w in zip(paths, got, want, strict=True):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.norm().item(), (path, err, w.norm().item())


def test_adamw_steps_match_jax_train_step(pair):
    """3 AdamW steps against JAX's make_train_step: every step's loss,
    grad norm and lr, and every parameter after them."""
    jcfg, jm, jp, tcfg, tp = pair
    batches = _batches(tcfg.vocab_size, STEPS)
    jpar = JParallel(remat="none")
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**TRAIN)))
    params = tree.tree_map(torch.clone, tp)
    state = TrainState(params, opt.init_adamw(params))
    model = build_model(tcfg, "cpu", ParallelConfig(remat="none"))
    step = make_train_step(model, tcfg, ParallelConfig(remat="none"),
                           TrainConfig(**TRAIN))
    for b in batches:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       err_msg=k, **TOL)
    want = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    for (path, got), w in zip(tree.leaves_with_paths(state.params),
                              tree.leaves(want), strict=True):
        np.testing.assert_allclose(got.numpy(), w.numpy(), err_msg=path,
                                   **TOL)


def test_bf16_loss_and_gradients_near_jax():
    """Reduced qwen3-moe in bf16 at capacity factor 1.25: the loss within
    1%, the grad norm within 5% and each gradient within 5% of its
    leaf's norm of JAX's (bf16 rounds at other points in the two
    packages; a token whose top-2 is a near-tie may route otherwise)."""
    jcfg, tcfg = _configs("qwen3-moe-30b-a3b", 1.25, "bfloat16")
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    batch = _batches(tcfg.vocab_size, 1)[0]
    toks, labs = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, toks, labs))(jp)
    want = [w.float() for w in tree.leaves(params_from_jax(
        _np_tree(jg), tcfg, "cpu"))]
    loss, got = _grads(build_model(tcfg, "cpu"), tp, batch)
    got = [g.float() for g in got]
    assert abs(loss.item() - float(jl)) <= 0.01 * abs(float(jl))
    gn = torch.sqrt(sum(g.square().sum() for g in got)).item()
    wn = torch.sqrt(sum(w.square().sum() for w in want)).item()
    assert abs(gn - wn) <= 0.05 * wn
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    for path, g, w in zip(paths, got, want, strict=True):
        err = (g - w).abs().max().item()
        assert err <= 0.05 * w.norm().item(), (path, err, w.norm().item())
