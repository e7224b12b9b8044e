"""The port's vision-stub model (qwen2-vl-72b: M-RoPE, the frontend stub,
patch embeddings in, text served) against the JAX package's, on the CPU.

``params_from_jax`` carries the JAX weights across (the frontend
included); inputs come from numpy seeds.  Positions follow Qwen2-VL's own
layout (Hugging Face ``Qwen2VLForConditionalGeneration.get_rope_index``):
text tokens at t = h = w = i, an image grid of gh x gw patches at
t = n, h = n + r, w = n + c, and text resuming at n + max(gh, gw) -- so
t, h and w differ and a wrong section order would show.

Tolerances: float32 outputs within rtol 1e-5 plus 1e-5 of the output's
scale; bf16 outputs within 2e-2 plus 1e-2 of each row's largest |output|
(the two packages round their elementwise chains at other points);
M-RoPE at t = h = w equal to RoPE bit for bit in each package; gradients
leaf by leaf within 1e-4 of the leaf's norm, the token table's exactly
zero; parameters after a train step within 1e-4 (``tests/
test_torch_train.py``'s: Adam divides by the root of the second moment,
which magnifies gradient differences on entries near 0 -- the K bias's,
near-invariant under the softmax), the token table's pure weight decay
within 1e-6; greedy tokens under the top-1 margin rule; engine host
state exactly; the (2, 2) gloo ranks within 1e-4 (phase 4's CPU
tolerance).

Torch runs on one intra-op thread throughout the module (ROADMAP Queue 3
item 12), as in ``tests/test_torch_hymba.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.flops import param_count as j_param_count  # noqa: E402
from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.config import ServeConfig as JServe  # noqa: E402
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import rotary as jrot  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.analysis.flops import param_count  # noqa: E402
from repro_torch.config import (ParallelConfig, ServeConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import rotary as trot  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             _accumulate,
                                             _value_and_grad,
                                             init_train_state,
                                             make_loss_fn, make_train_step,
                                             microbatches)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_engine_pair import (Pair, drive, host_state,  # noqa: E402
                                streams_match)
from _torch_tp_ranks import serve_rank, to_numpy  # noqa: E402
from _torch_tp_ranks import spawn as tp_spawn  # noqa: E402
from _torch_train_ranks import spawn as train_spawn  # noqa: E402
from _torch_train_ranks import train_rank  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-vl-72b"
RTOL = 1e-5                     # float32, with atol RTOL x the scale
GRAD_RTOL = 1e-4                # a leaf's gradient, of the leaf's norm
STEP_TOL = dict(rtol=1e-4, atol=1e-4)    # parameters after a step
MARGIN = 1e-4
B, S = 2, 24
GRID = (3, 4)                   # the image's patch rows x columns
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of the same dtype (bf16
    through its bits: numpy's bfloat16 has no torch bridge)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = a.view(np.uint16).astype(np.int32) << 16
        return torch.from_numpy(bits).view(torch.float32).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


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


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(reduce_for_smoke(get_model_config(ARCH)),
                               dtype=dtype, param_dtype=dtype)
    tcfg = dataclasses.replace(t_reduce(t_get(ARCH)), dtype=dtype,
                               param_dtype=dtype)
    return jcfg, tcfg


def _pair(dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(dtype)
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def layout_positions(b: int, s: int, seed: int = 0, grid=GRID):
    """Qwen2-VL's (3, b, s) int32 positions of rows that each hold one
    image of ``grid`` patches after a seeded number of text tokens:
    text at t = h = w = i, patch (r, c) at (n, n + r, n + c), text after
    the image from n + max(grid).  Also returns the (b, s) mask of the
    image's patches."""
    gh, gw = grid
    rng = np.random.default_rng(seed)
    pos = np.zeros((3, b, s), np.int32)
    image = np.zeros((b, s), bool)
    for row in range(b):
        n = int(rng.integers(1, s - gh * gw))
        pos[:, row, :n] = np.arange(n)
        r, c = np.divmod(np.arange(gh * gw), gw)
        pos[:, row, n:n + gh * gw] = (np.full(gh * gw, n), n + r, n + c)
        rest = s - n - gh * gw
        pos[:, row, n + gh * gw:] = n + max(gh, gw) + np.arange(rest)
        image[row, n:n + gh * gw] = True
    return pos, image


def _embeds(cfg, seed=0, b=B, s=S):
    """N(0, 1) float32 patch and token embeddings (b, s, d_model)."""
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _model(tcfg, remat="none"):
    return build_model(tcfg, "cpu", ParallelConfig(remat=remat))


def _vision_batch(cfg, b=4, s=S, seed=12):
    """A vision training batch: embeddings, layout positions and next
    tokens as labels, masked (-1) on each row's image span (every row
    masks as many, so that microbatches weigh alike)."""
    pos, image = layout_positions(b, s, seed)
    labels = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels[image] = -1
    return {"inputs_embeds": _embeds(cfg, seed, b, s), "positions": pos,
            "labels": labels}


def test_layout_positions_differ_in_t_h_and_w():
    pos, image = layout_positions(3, S, seed=4)
    assert pos.shape == (3, 3, S) and image.sum(1).tolist() == [12] * 3
    for row in range(3):
        t, h, w = pos[:, row]
        n = int(np.argmax(image[row]))
        assert (t[:n] == np.arange(n)).all() and (h[:n] == t[:n]).all()
        assert (t[image[row]] == n).all()
        assert sorted(set(h[image[row]] - n)) == [0, 1, 2]
        assert sorted(set(w[image[row]] - n)) == [0, 1, 2, 3]
        after = ~image[row] & (np.arange(S) > n)
        assert (t[after] == h[after]).all() and (t[after] == w[after]).all()
        assert t[after][0] == n + 4
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()


# ---------------------------------------------------------------------------
# config, weights, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_a_copy_of_jax(reduced):
    """Field for field, but the impl default: "auto" in the port (the
    kernel on the card), "reference" in the JAX package."""
    j, t = get_model_config(ARCH), t_get(ARCH)
    if reduced:
        j, t = reduce_for_smoke(j), t_reduce(t)
    want, got = dict(j.__dict__), dict(t.__dict__)
    assert (want.pop("attention_impl"), got.pop("attention_impl")) == (
        "reference", "auto")
    assert got == want
    assert t.mrope_sections == ((2, 3, 3) if reduced else (16, 24, 24))
    assert (t.rope_type, t.modality, t.qkv_bias) == ("mrope", "vision_stub",
                                                     True)


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_equals_jax_formula(reduced):
    """The port's formula counts as JAX's; the reduced model's tensors
    hold that count plus the frontend's d_model^2 + d_model (which the
    formula leaves out: ROADMAP Queue 3)."""
    j, t = get_model_config(ARCH), t_get(ARCH)
    if reduced:
        j, t = reduce_for_smoke(j), t_reduce(t)
    assert param_count(t) == j_param_count(j)
    if not reduced:
        assert param_count(t) == 72_773_320_704 - 67_117_056
        return
    model = _model(t)
    n = sum(x.numel() for x in tree.leaves(model.init(model.generator(0))))
    assert n == param_count(t) + t.d_model ** 2 + t.d_model


def _paths(tree_):
    if isinstance(tree_, dict):
        for k, v in tree_.items():
            for p, x in _paths(v):
                yield f"/{k}{p}", x
    elif isinstance(tree_, list):
        for i, v in enumerate(tree_):
            for p, x in _paths(v):
                yield f"/{i}{p}", x
    else:
        yield "", tree_


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_params_from_jax_carry_the_frontend(dtype):
    """The port's init has JAX's tree -- the frontend's adapter and its
    one pos_embed row included -- leaf for leaf in shape and dtype, its
    top level in params_from_jax's order; the frontend's weights cross
    unchanged."""
    jcfg, jm, jp, tcfg, tp = _pair(dtype)
    model = _model(tcfg)
    init = model.init(model.generator(0))
    assert list(init) == list(tp) == ["embedding", "final_norm", "frontend",
                                      "layers"]
    got, want = dict(_paths(init)), dict(_paths(tp))
    assert sorted(got) == sorted(want)
    assert "/frontend/adapter" in got and "/frontend/pos_embed" in got
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype == getattr(torch, dtype), k
    for k in ("adapter", "pos_embed"):
        np.testing.assert_array_equal(_f32(tp["frontend"][k]),
                                      _f32(jp["frontend"][k]))
    assert tuple(tp["frontend"]["pos_embed"].shape) == (1, tcfg.d_model)


def test_logical_tree_matches_jax(pair):
    """The frontend's logical axes are JAX's, and logical() lists the
    leaves in init's order."""
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    logical = model.logical()
    assert list(logical) == list(tp)
    jl = jm.logical()["frontend"]
    for k, (axes, shape) in logical["frontend"].items():
        assert (tuple(axes), tuple(shape)) == (tuple(jl[k][0]),
                                               tuple(jl[k][1])), k


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d, sections", [(128, (16, 24, 24)),
                                         (16, (2, 3, 3))])
def test_apply_mrope_matches_jax(d, sections, dtype):
    """On layout positions (t, h and w differ), theta 1e6."""
    pos, _ = layout_positions(B, S, seed=d)
    x = np.random.default_rng(d).normal(size=(B, S, 3, d)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jrot.apply_mrope(jx, jnp.asarray(pos), sections=sections,
                            theta=1e6)
    got = trot.apply_mrope(_t(np.asarray(jx)), torch.from_numpy(pos),
                           sections=sections, theta=1e6)
    assert got.dtype == getattr(torch, dtype)
    _held(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d, sections", [(128, (16, 24, 24)),
                                         (16, (2, 3, 3))])
def test_mrope_at_equal_components_is_rope_bit_for_bit(d, sections, dtype):
    """At t = h = w both packages' M-RoPE equals their RoPE exactly: what
    every serving site relies on."""
    p2 = np.random.default_rng(d).integers(0, 4000, size=(B, S)).astype(
        np.int32)
    p3 = np.broadcast_to(p2, (3, B, S))
    x = np.random.default_rng(d + 1).normal(size=(B, S, 2, d)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    np.testing.assert_array_equal(
        _f32(jrot.apply_mrope(jx, jnp.asarray(p3), sections=sections,
                              theta=1e6)),
        _f32(jrot.apply_rope(jx, jnp.asarray(p2), theta=1e6)))
    tx = _t(np.asarray(jx))
    got = trot.apply_mrope(tx, torch.from_numpy(p3.copy()),
                           sections=sections, theta=1e6)
    assert torch.equal(got, trot.apply_rope(tx, torch.from_numpy(p2),
                                            theta=1e6))


def test_mrope_sections_must_cover_half_the_head_dim():
    x = torch.zeros((1, 4, 2, 16))
    pos = torch.zeros((3, 1, 4), dtype=torch.long)
    with pytest.raises(AssertionError):
        trot.apply_mrope(x, pos, sections=(2, 3, 2))
    with pytest.raises(AssertionError):
        trot.apply_mrope(x, pos, sections=(16, 24, 24))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_kernel_in_interpret_mode(dtype):
    """One attention module on layout positions against JAX's Pallas
    ``fastattn_fwd`` in interpret mode (as the JAX package's own tests
    run it on the CPU), at the reduced 16/2 heads of 16."""
    jcfg, jm, jp, tcfg, tp = _pair(dtype, seed=3)
    pos, _ = layout_positions(B, S, seed=5)
    x = jnp.asarray(_embeds(tcfg, seed=5)).astype(dtype)
    bp = tp["layers"][0]["attn"]
    # JAX stacks the two layers: take layer 0's slice
    jbp = jax.tree.map(lambda a: a[0], jp["seg0"]["u0"]["attn"])
    want = jattn.apply_attention(jbp, x, jcfg, positions=jnp.asarray(pos),
                                 impl="interpret")
    got = tattn.apply_attention(bp, _t(np.asarray(x)), tcfg,
                                positions=torch.from_numpy(pos))
    _held(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_apply_matches_jax(dtype):
    """LM.apply(inputs_embeds=, positions=) on layout positions, through
    the frontend; and with no positions, JAX's default (3, B, S)
    broadcast of each row's index."""
    jcfg, jm, jp, tcfg, tp = _pair(dtype, seed=1)
    model = _model(tcfg)
    emb = _embeds(tcfg, seed=2)
    pos, _ = layout_positions(B, S, seed=2)
    want = jm.apply(jp, inputs_embeds=jnp.asarray(emb),
                    positions=jnp.asarray(pos))
    got = model.apply(tp, inputs_embeds=torch.from_numpy(emb),
                      positions=torch.from_numpy(pos))
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    _held(got, want, dtype, "layout positions")
    want = jm.apply(jp, inputs_embeds=jnp.asarray(emb))
    got = model.apply(tp, inputs_embeds=torch.from_numpy(emb))
    _held(got, want, dtype, "default positions")


def test_frontend_pos_embed_applies_to_one_row_inputs(pair):
    """The stub's single pos_embed row is added only to an input of one
    row, in JAX as here."""
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    emb = _embeds(tcfg, seed=3, b=2, s=1)
    want = jm.apply(jp, inputs_embeds=jnp.asarray(emb))
    got = model.apply(tp, inputs_embeds=torch.from_numpy(emb))
    _close(got, want)
    zero = dict(tp, frontend=dict(tp["frontend"], pos_embed=torch.zeros_like(
        tp["frontend"]["pos_embed"])))
    assert not torch.allclose(model.apply(zero, inputs_embeds=torch.from_numpy(
        emb)), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_apply_matches_jax(dtype):
    jcfg, jm, jp, tcfg, tp = _pair(dtype, seed=2)
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    want = jm.apply(jp, jnp.asarray(tokens))
    got = _model(tcfg).apply(tp, torch.from_numpy(tokens))
    _held(got, want, dtype)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_vision_loss_and_every_gradient_match_jax(pair, remat):
    """JAX's vision loss (f32 cross entropy masked on the image span) and
    jax.grad of it, leaf by leaf within 1e-4 of its norm; the token table
    and the one-row pos_embed are never read, and get exact zeros in
    both."""
    jcfg, jm, jp, tcfg, tp = pair
    batch = _vision_batch(tcfg)
    jloss, jg = jax.value_and_grad(jts.make_loss_fn(jm, jcfg))(
        jp, _jax_batch(batch))
    want = params_from_jax(_np_tree(jg), tcfg, "cpu")
    model = _model(tcfg, remat)
    loss, got = _value_and_grad(make_loss_fn(model, tcfg), tp,
                                _torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    assert len(paths) == len(got) == len(tree.leaves(want))
    for path, g, w in zip(paths, got, tree.leaves(want)):
        if path.endswith(("embedding/embed", "frontend/pos_embed")):
            assert not g.any() and not np.asarray(w).any(), path
            continue
        g, w = g.double().numpy(), w.double().numpy()
        assert np.linalg.norm(g) > 0, path
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), path


def test_vision_loss_masks_the_image_span(pair):
    """Masking the image span changes the loss; masking every label
    gives 0 (the count clamps to 1), as in JAX."""
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    batch = _vision_batch(tcfg)
    loss_fn = make_loss_fn(model, tcfg)
    with torch.no_grad():
        masked = loss_fn(tp, _torch_batch(batch)).item()
        full = dict(batch, labels=np.abs(batch["labels"]))
        unmasked = loss_fn(tp, _torch_batch(full)).item()
        none = dict(batch, labels=np.full_like(batch["labels"], -1))
        assert loss_fn(tp, _torch_batch(none)).item() == 0.0
    assert masked != unmasked
    jl = float(jts.make_loss_fn(jm, jcfg)(jp, _jax_batch(full)))
    np.testing.assert_allclose(unmasked, jl, rtol=RTOL)


def test_vision_train_step_matches_jax():
    """One AdamW step through make_train_step (remat "full", as the
    launcher's "selective" runs) against JAX's jitted step on the same
    vision batch: loss, grad norm, lr and every leaf's update -- the
    token table's only weight decay."""
    jcfg, tcfg = _cfgs()
    jpar = JParallel(remat="none")
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**TRAIN)))
    tpar = ParallelConfig(remat="full")
    model = build_model(tcfg, "cpu", tpar)
    params = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    init = tree.tree_map(torch.clone, params)
    tstate = TrainState(params, opt.init_adamw(params))
    tstep = make_train_step(model, tcfg, tpar, TrainConfig(**TRAIN))
    batch = _vision_batch(tcfg)
    jstate, jmet = jstep(jstate, _jax_batch(batch))
    tstate, tmet = tstep(tstate, _torch_batch(batch))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=RTOL, err_msg=key)
    want = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    for (path, g), w, p0 in zip(tree.leaves_with_paths(tstate.params),
                                tree.leaves(want), tree.leaves(init)):
        assert g.dtype == w.dtype, path
        assert not torch.equal(g, p0), path
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path,
                                   **STEP_TOL)
        if path.endswith("embedding/embed"):
            # no gradient: AdamW's weight decay alone, term for term
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       err_msg=path)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 1


def test_microbatches_split_positions_along_the_batch():
    """Microbatch i holds rows [i*mb, (i+1)*mb) of every array -- of
    M-RoPE's (3, B, S) positions along dim 1, every t/h/w component."""
    _, tcfg = _cfgs()
    batch = _torch_batch(_vision_batch(tcfg))
    micro = microbatches(batch, 2)
    for i, mb in enumerate(micro):
        rows = slice(2 * i, 2 * i + 2)
        assert torch.equal(mb["positions"], batch["positions"][:, rows])
        assert torch.equal(mb["inputs_embeds"], batch["inputs_embeds"][rows])
        assert torch.equal(mb["labels"], batch["labels"][rows])


def test_vision_microbatches_two_match_one_and_jax():
    """microbatches = 2 against 1 on one vision batch whose rows mask
    equally many labels: loss within 1e-4 and every parameter after the
    step within 1e-4.  On JAX's weights the two microbatches' mean
    gradient is jax.grad's of the whole batch (JAX's own two-microbatch
    reshape cuts the positions' t/h/w axis, ROADMAP Queue 3), each leaf
    within 1e-4 of its norm, and the step's loss and grad norm JAX's
    one-microbatch step's within 1e-4."""
    jcfg, tcfg = _cfgs()
    train = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    batch = _vision_batch(tcfg, seed=21)
    runs = []
    for mb in (1, 2):
        par = ParallelConfig(remat="none", microbatches=mb)
        model = build_model(tcfg, "cpu", par)
        state = init_train_state(model, model.generator(0))
        state, met = make_train_step(model, tcfg, par, TrainConfig(**train))(
            state, _torch_batch(batch))
        runs.append((float(met["loss"]), state.params))
    assert abs(runs[0][0] - runs[1][0]) < 1e-4
    for a, b in zip(tree.leaves(runs[0][1]), tree.leaves(runs[1][1])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **STEP_TOL)

    jpar = JParallel(remat="none")
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    jg = jax.grad(jts.make_loss_fn(jm, jcfg))(jstate.params,
                                              _jax_batch(batch))
    want = params_from_jax(_np_tree(jg), tcfg, "cpu")
    _, jmet = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**train)))(
        jstate, _jax_batch(batch))
    par = ParallelConfig(remat="none", microbatches=2)
    model = build_model(tcfg, "cpu", par)
    params = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    _, got = _accumulate(make_loss_fn(model, tcfg), params,
                         microbatches(_torch_batch(batch), 2), "cpu")
    for (path, _), g, w in zip(tree.leaves_with_paths(params), got,
                               tree.leaves(want)):
        g, w = g.double().numpy(), w.double().numpy()
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), path
    _, met = make_train_step(model, tcfg, par, TrainConfig(**train))(
        TrainState(params, opt.init_adamw(params)), _torch_batch(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-4, err_msg=key)


def test_mesh_2x2_vision_step_matches_one_device(tmp_path):
    """Two AdamW steps on four gloo ranks at (data=2, model=2) -- each
    rank its rows of the batch and of the sequence, positions cut along
    dims 1 and 2 -- against JAX's step on one device: every rank's loss,
    grad norm and lr, and the final parameters gathered whole, within
    1e-4."""
    jcfg, tcfg = _cfgs()
    jpar = JParallel(remat="none")
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    init = tree.tree_map(lambda t: t.numpy().copy(), params_from_jax(
        _np_tree(jstate.params), tcfg, "cpu"))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**TRAIN)))
    batches = [_vision_batch(tcfg, b=4, s=32, seed=30 + i) for i in (0, 1)]
    metrics = []
    for b in batches:
        jstate, m = jstep(jstate, _jax_batch(b))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    final = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    ranks = train_spawn(train_rank, 4, tmp_path, ARCH,
                        dict(data=2, model=2), init, batches, TRAIN,
                        {"dir": str(tmp_path / "ck")})
    assert sorted(tuple(r["coords"].values()) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["step"] == 2
        for got, want in zip(r["metrics"], metrics, strict=True):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **STEP_TOL)
    paths = [p for p in ranks[0]["paths"] if p.startswith("/params/")]
    want = tree.leaves_with_paths(final)
    assert paths == [f"/params{p}" for p, _ in want]
    assert "/params/frontend/adapter" in paths
    for got, (path, w) in zip(ranks[0]["final"], want):
        np.testing.assert_allclose(got, w.numpy(), err_msg=path, **STEP_TOL)


# ---------------------------------------------------------------------------
# serving: text requests, t = h = w
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    return Pair(ARCH)


def test_decode_steps_match_text_apply(pair):
    """Dense decode_step (positions broadcast to (3, B, 1)) teacher-forced
    against the port's text LM.apply, as JAX's test does for every arch
    (rtol 5e-2, atol 5e-3 in float32)."""
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    tokens = np.random.default_rng(8).integers(
        0, tcfg.vocab_size, size=(B, 10)).astype(np.int32)
    full = model.apply(tp, torch.from_numpy(tokens))
    cache = model.init_cache(B, 12)
    for t in range(10):
        lg, cache = model.decode_step(tp, torch.from_numpy(tokens[:, t]),
                                      cache, t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=5e-2, atol=5e-3)
        _close(lg, full[:, t], rtol=1e-4, err_msg=f"pos {t}")


def test_generate_greedy_matches_jax(engines):
    """ServeEngine.generate against JAX's on the same weights, greedy
    tokens under the margin rule."""
    p = engines
    n_new, prompt_len = 6, 7
    prompts = np.random.default_rng(4).integers(
        0, p.vocab, size=(2, prompt_len)).astype(np.int32)
    serve = dict(max_seq_len=prompt_len + n_new + 1, top_k=1)
    want = np.asarray(JEngine(model=p.jm, params=p.jp, cfg=p.jcfg,
                              serve=JServe(**serve)).generate(
        jnp.asarray(prompts), n_new))
    got = ServeEngine(model=p.tm, params=p.tp, cfg=p.tcfg,
                      serve=ServeConfig(**serve)).generate(prompts, n_new)
    assert tuple(got.shape) == (2, n_new)
    compared = 0
    for row in range(2):
        margins = p.margins(prompts[row], want[row])
        for t in range(n_new):
            if margins[t] < MARGIN:
                break                   # a near-tie: later tokens may fork
            assert int(got[row, t]) == int(want[row, t]), (row, t)
            compared += 1
    assert compared >= n_new


def _traffic(vocab):
    rng = np.random.default_rng(7)
    return [[(i, rng.integers(0, vocab, size=n), dict(max_new_tokens=8))
             for i, n in enumerate((5, 23, 40))]]


SERVE = dict(max_batch=3, max_seq_len=96, page_size=16, prefill_chunk=16,
             num_pages=24)


def test_engine_core_streams_and_host_state_match_jax(engines):
    """The paged EngineCore (chunked prefill and decode through the
    paged attention paths, positions broadcast to (3, B, S)) against
    JAX's on three requests: streams under the margin rule, host state
    exactly, no page left."""
    p = engines
    waves = _traffic(p.vocab)
    jcore = p.jax_core(**SERVE)
    want, jerr = drive(jcore, waves)
    core = p.torch_core(**SERVE)
    got, err = drive(core, waves)
    assert not jerr and not err
    prompts = {rid: pr for w in waves for rid, pr, _ in w}
    exact = streams_match(p, prompts, got, want)
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    assert core.stats()["pages_used"] == 0


JAX_TP_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
import numpy as np
from repro.config import (ParallelConfig, ServeConfig, get_model_config,
                          reduce_for_smoke)
from repro.models import build_model
from repro.serving.core import EngineCore
from repro.serving.scheduler import SamplingParams
from _torch_tp_ranks import host_state
serve, waves = json.loads(sys.argv[2])
cfg = reduce_for_smoke(get_model_config("qwen2-vl-72b"))
model = build_model(cfg, ParallelConfig(remat="none"))
params = model.init(jax.random.PRNGKey(0))
core = EngineCore(model=model, params=params, cfg=cfg,
                  serve=ServeConfig(**serve))
toks = {}
for wave in waves:
    for rid, prompt, kw in wave:
        core.add_request(prompt, SamplingParams(**kw), request_id=rid)
        toks[rid] = []
    while core.has_work:
        for ev in core.step():
            toks[ev.request_id].append(ev.token)
print(json.dumps({"devices": jax.device_count(), "tokens": toks,
                  "host_all": host_state(core, tokens_equal=False),
                  "tp": core.stats()["tp"]}))
"""


def test_tp2_ranks_match_jax_tp2_engine(engines, tmp_path):
    """The port at tp=2 (g=2, s=1) as two gloo ranks on the CPU against
    JAX's tp=2 engine on two forced host devices, the same weights and
    requests: every rank's streams equal each other and JAX's under the
    margin rule, host state and plan exactly."""
    p = engines
    waves = _traffic(p.vocab)
    serve = dict(SERVE, tp=2, tp_collectives="tiled")
    plain = [[(rid, pr.tolist(), kw) for rid, pr, kw in w] for w in waves]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_TP_CHILD,
                          os.path.dirname(os.path.abspath(__file__)),
                          json.dumps([serve, plain])], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    jres = json.loads(out.stdout.strip().splitlines()[-1])
    assert jres["devices"] == 2
    want = {int(k): v for k, v in jres["tokens"].items()}
    ranks = tp_spawn(serve_rank, 2, tmp_path, ARCH, to_numpy(p.tp),
                     {"basic": (serve, waves)},
                     dict(pcie_gbps=13.2, host_gflops=140.0,
                          device_tflops=197.0))
    for r in ranks:
        got = r["basic"]
        assert got["tokens"] == ranks[0]["basic"]["tokens"]
        assert got["tp"] == jres["tp"] == {"tp": 2, "g": 2, "s": 1,
                                           "collectives": "tiled"}
        assert got["pool"] == (p.tcfg.num_kv_heads // 2, SERVE["num_pages"],
                               SERVE["page_size"], p.tcfg.head_dim)
    prompts = {rid: pr for w in waves for rid, pr, _ in w}
    streams_match(p, prompts, ranks[0]["basic"]["tokens"], want)
    assert ranks[0]["basic"]["host_all"] == jres["host_all"]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("stream", [False, True])
def test_serve_cli_serves_qwen2_vl(stream):
    """``launch.serve --arch qwen2-vl-72b`` serves text, dense and
    --stream, as JAX's launcher does."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen", "3"]
    if stream:
        args += ["--stream", "--requests", "2"]
    out = _run("repro_torch.launch.serve", *args)
    assert out.returncode == 0, out.stderr[-2000:]
    if not stream:
        assert "generated (2, 3)" in out.stdout


def test_train_cli_refuses_qwen2_vl(tmp_path):
    """The launcher's TokenPipeline makes no patch embeddings or M-RoPE
    positions (nor does JAX's): it refuses the arch, naming them."""
    out = _run("repro_torch.launch.train", "--arch", ARCH, "--smoke",
               "--device", "cpu", "--steps", "2", "--ckpt-dir",
               str(tmp_path))
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "inputs_embeds" in out.stderr and "positions" in out.stderr
