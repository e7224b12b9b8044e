"""The port's mixture-of-experts layer (``layers/moe.py``) against the JAX
package's, on the CPU.

The same numpy-seeded inputs and the JAX ``init_moe`` weights go through
both ``apply_moe``s in float32: outputs within 1e-5 (only the order of
float32 sums differs), at reduced qwen3-moe (4 experts top-2, SwiGLU) and
reduced grok-1 (GeGLU) under three capacity factors, and at qwen3-moe's
128 experts top-8 at a narrow width with JAX's drop counts exactly.
Routing is exact: ``top_k`` and ``route`` give ``jax.lax.top_k``'s expert
sets and order on the same probabilities, ties at the k-th place
included.  Padding rows past a chunk's ``n_valid`` never displace a
valid token, and the combine is the same bits run to run.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.layers import moe  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(arch, **overrides):
    jcfg = dataclasses.replace(reduce_for_smoke(get_model_config(arch)),
                               **overrides)
    tcfg = dataclasses.replace(t_reduce(t_get(arch)), **overrides)
    return jcfg, tcfg


def _weights(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _jax_keep(jp, x, cfg, cf):
    """JAX's kept-assignment mask, in its sorted order: the lines of
    ``repro.layers.moe.apply_moe`` that decide the drops."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = max(1, int(s * k / e * cf))
    logits = jnp.einsum("bsd,de->bse", x, jp["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = idx.reshape(b, s * k)
    order = jnp.argsort(flat, axis=-1)
    sorted_e = jnp.take_along_axis(flat, order, axis=-1)
    same = sorted_e[:, :, None] == jnp.arange(e)[None, None, :]
    pos = jnp.cumsum(same, axis=1) - 1
    slot = jnp.take_along_axis(pos, sorted_e[..., None], axis=-1)[..., 0]
    return np.asarray(slot < cap), cap


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies_of_jax(arch):
    got = dataclasses.asdict(t_get(arch))
    want = dataclasses.asdict(get_model_config(arch))
    assert got.pop("attention_impl") == "auto"
    want.pop("attention_impl")
    assert got == want
    assert t_get(arch).expert_dff == get_model_config(arch).expert_dff
    jcfg, tcfg = _configs(arch)
    assert tcfg.expert_dff == jcfg.expert_dff == 64
    assert tcfg.blocks() == ("moe",) * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_logical_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    jp, _ = _weights(jcfg)
    gen = torch.Generator().manual_seed(0)
    got = moe.init_moe(gen, tcfg, torch.float32)
    assert set(got) == set(jp) == {"router", "w_up", "w_gate", "w_down"}
    for name, w in got.items():
        want = np.asarray(jp[name])
        assert tuple(w.shape) == want.shape
        # the same distributions: standard deviations within 10%
        assert abs(float(w.std()) / float(want.std()) - 1) < 0.1, name
    assert moe.moe_logical(tcfg) == jmoe.moe_logical(jcfg)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, cf):
    jcfg, tcfg = _configs(arch)
    jp, tp = _weights(jcfg)
    x = np.random.default_rng(1).normal(
        size=(2, 16, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg,
                                     capacity_factor=cf))
    got = moe.apply_moe(tp, torch.from_numpy(x), tcfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    r = moe.routing(tp, torch.from_numpy(x), tcfg, capacity_factor=cf)
    dropped, total = moe.assignments_dropped(r)
    keep, cap = _jax_keep(jp, jnp.asarray(x), jcfg, cf)
    assert r.plan.cap == cap and total == 2 * 16 * 2
    assert dropped == int((~keep).sum())
    np.testing.assert_array_equal(r.plan.keep.numpy(), keep)
    if cf == 0.5:
        assert dropped > 0          # cap 4 of 8 a row's expert slots
    if cf == 8.0:
        assert dropped == 0


@pytest.mark.parametrize("s,cap", [(512, 40), (5, 1), (1, 1)])
def test_128_expert_top8_dispatch_matches_jax(s, cap):
    """qwen3-moe's routing (128 experts top-8, capacity factor 1.25) at
    d_model 64, moe_dff 32: a prefill chunk of 512 (cap 40), a speculative
    verify launch of 5 (cap 1: colliding assignments drop) and a decode
    step (cap 1: a token's 8 experts are distinct, nothing drops)."""
    jcfg = dataclasses.replace(
        get_model_config("qwen3-moe-30b-a3b"), num_layers=1, d_model=64,
        moe_dff=32, dtype="float32", param_dtype="float32")
    tcfg = dataclasses.replace(
        t_get("qwen3-moe-30b-a3b"), num_layers=1, d_model=64, moe_dff=32,
        dtype="float32", param_dtype="float32")
    jp, tp = _weights(jcfg, seed=s)
    x = np.random.default_rng(s).normal(size=(2, s, 64)).astype(np.float32)
    want = np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg))
    got = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    r = moe.routing(tp, torch.from_numpy(x), tcfg)
    keep, jcap = _jax_keep(jp, jnp.asarray(x), jcfg, 1.25)
    assert r.plan.cap == jcap == cap
    dropped, total = moe.assignments_dropped(r)
    assert total == 2 * s * 8 and dropped == int((~keep).sum())
    np.testing.assert_array_equal(r.plan.keep.numpy(), keep)
    if s == 1:
        assert dropped == 0
    if s == 5:
        assert dropped > 0


def test_top_k_breaks_ties_to_the_lower_index():
    p = torch.tensor([[0.1, .5, .5, .5, .2, .5]])
    vals, idx = moe.top_k(p, 2)
    assert idx.tolist() == [[1, 2]]
    want = jax.lax.top_k(jnp.asarray(p.numpy()), 2)[1]
    assert np.asarray(want).tolist() == [[1, 2]]


def test_route_matches_jax_top_k_with_ties():
    """bf16-rounded 128-way logits (ties are common: a row's 8th and 9th
    largest often round to one value), fed as the same float32 numbers to
    both packages: the same expert ids in the same order and the same
    renormalised gates."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(4096, 128)).astype(
        np.float32)).to(torch.bfloat16).float()
    srt = torch.sort(logits, dim=-1, descending=True).values
    ties = int((srt[:, 7] == srt[:, 8]).sum())
    assert ties >= 1
    jl = jnp.asarray(logits.numpy())
    jprobs = jax.nn.softmax(jl, axis=-1)
    jg, ji = jax.lax.top_k(jprobs, 8)
    jg = jg / jnp.clip(jnp.sum(jg, -1, keepdims=True), 1e-9)
    # top_k on the same float32 probabilities
    _, idx = moe.top_k(torch.from_numpy(np.array(jprobs)), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    # route from the same logits
    gates, idx = moe.route(logits, 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), **TOL)
    # torch.topk orders these ties otherwise: the tie rule is load-bearing
    assert not torch.equal(torch.topk(logits, 8).indices, idx)


def test_padding_never_displaces_a_valid_token():
    """A chunk's padded rows past n_valid route too, but each row's
    stable sort gives them slots only after its valid tokens: the valid
    tokens' slots, drops and outputs are the same whatever the padding
    holds."""
    _, tcfg = _configs("qwen3-moe-30b-a3b", moe_capacity_factor=0.75)
    _, tp = _weights(_configs("qwen3-moe-30b-a3b")[0])
    rng = np.random.default_rng(2)
    s, n_valid = 16, np.array([9, 16, 0])
    x = torch.from_numpy(rng.normal(size=(3, s, tcfg.d_model)).astype(
        np.float32))
    k = tcfg.num_experts_per_tok
    outs, plans = [], []
    for seed in (3, 4):
        pad = torch.from_numpy(np.random.default_rng(seed).normal(
            size=x.shape).astype(np.float32) * 5)
        valid = torch.arange(s)[None, :, None] < torch.from_numpy(
            n_valid)[:, None, None]
        xs = torch.where(valid, x, pad)
        outs.append(moe.apply_moe(tp, xs, tcfg))
        plans.append(moe.routing(tp, xs, tcfg))
    nv = torch.from_numpy(n_valid)
    for row, n in enumerate(n_valid):
        assert torch.equal(outs[0][row, :n], outs[1][row, :n])
        for p in plans:
            token = p.plan.order[row] // k
            # every valid assignment sorts before the row's padding in
            # its expert's run
            for ex in range(tcfg.num_experts):
                run = token[p.idx[row].reshape(-1)[p.plan.order[row]] == ex]
                is_pad = (run >= n).int()
                assert torch.equal(is_pad, torch.sort(is_pad).values)
    # padding does drop here (cap 6 of 8 a row's expert slots), valid
    # tokens of the full row too
    d0 = moe.assignments_dropped(plans[0], nv)
    assert d0 == moe.assignments_dropped(plans[1], nv)
    assert moe.assignments_dropped(plans[0])[0] > d0[0] > 0


def test_combine_is_deterministic():
    """bf16: the output is the same bits on a second run, and agrees with
    each token's expert outputs computed one row at a time, weighted and
    summed in expert-id order in bf16 (the order JAX's scatter-add visits
    the slots) -- within bf16 rounding of the products, which differ
    between a batched and a one-row product."""
    jcfg, tcfg = _configs("qwen3-moe-30b-a3b", dtype="bfloat16",
                          param_dtype="bfloat16", num_experts=8,
                          num_experts_per_tok=4)
    gen = torch.Generator().manual_seed(5)
    tp = moe.init_moe(gen, tcfg, torch.bfloat16)
    x = torch.randn((2, 12, tcfg.d_model), generator=gen).to(torch.bfloat16)
    y = moe.apply_moe(tp, x, tcfg, capacity_factor=8.0)
    assert torch.equal(y, moe.apply_moe(tp, x, tcfg, capacity_factor=8.0))
    r = moe.routing(tp, x, tcfg, capacity_factor=8.0)
    assert moe.assignments_dropped(r)[0] == 0
    want = torch.zeros_like(x)
    for b in range(2):
        for t in range(12):
            acc = torch.zeros(tcfg.d_model, dtype=torch.bfloat16)
            for j in torch.argsort(r.idx[b, t]).tolist():
                ex = int(r.idx[b, t, j])
                xt = x[b, t]
                h = torch.nn.functional.silu(xt @ tp["w_gate"][ex]) * (
                    xt @ tp["w_up"][ex])
                out = h @ tp["w_down"][ex]
                acc = acc + out * r.gates[b, t, j].to(torch.bfloat16)
            want[b, t] = acc
    torch.testing.assert_close(y.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
