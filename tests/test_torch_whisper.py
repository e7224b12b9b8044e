"""The port's encoder-decoder (whisper-small: the frontend stub, the
bidirectional encoder, the decoder's self- and cross-attention) against
the JAX package's, on the CPU.

``params_from_jax`` carries the JAX weights across; inputs come from
numpy seeds.  JAX runs its ``attention_impl="reference"`` (its EncDec's
default: its Pallas kernel masks a non-causal partial sub-tile causally,
ROADMAP Queue 3 item 3, so it is not run here).  float32 outputs are held
to rtol 1e-5 with an absolute slack of 1e-5 of the output's scale; bf16
outputs to 2e-2 plus 1e-2 of each row's largest |output| (the two round
their elementwise chains at other points); the sinusoid to 4 float32
ulps of its angle (XLA's CPU ``exp`` is one ulp off torch's for some
frequencies, and an angle carries that times the position).  Gradients
are held leaf by leaf to 1e-4 of the leaf's norm, greedy tokens under
the top-1 margin rule, refusals exactly.

Torch runs on one intra-op thread throughout the module, as in
``tests/test_torch_hymba.py`` (ROADMAP Queue 3 item 12): under six
pytest-xdist workers the default eight threads a worker spin on the
others' cores.
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
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import frontend as jfront  # noqa: E402
from repro.layers.embedding import lm_logits  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.config import (ParallelConfig, ServeConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import common as tcommon  # noqa: E402
from repro_torch.layers import frontend as tfront  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.serving.core import EngineCore  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.sharding.rules import axis_rules  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             init_train_state,
                                             make_train_step)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import apply_rank, spawn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-small"
RTOL = 1e-5                     # float32, with atol RTOL x the scale
GRAD_RTOL = 1e-4                # a leaf's gradient, of the leaf's norm
MARGIN = 1e-4
B, S = 2, 12                    # decoder rows and tokens


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


def _pair(dtype="float32", seed=0, **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    jm = j_build(jcfg, JParallel(remat="none"))
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _frames(cfg, seed=0, b=B, s=None):
    """N(0, 1) float32 frame embeddings (b, s or encoder_seq, d_model)."""
    s = cfg.encoder_seq if s is None else s
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _tokens(vocab, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1                              # masked positions
    return tokens, labels


def _model(tcfg, remat="none"):
    return build_model(tcfg, "cpu", ParallelConfig(remat=remat))


# ---------------------------------------------------------------------------
# config, weights, init
# ---------------------------------------------------------------------------

def test_config_is_a_copy_of_jax():
    """Field for field, but the impl default: "auto" in the port (the
    kernel on the card), "reference" in the JAX package."""
    got = dataclasses.asdict(t_get(ARCH))
    want = dataclasses.asdict(get_model_config(ARCH))
    assert got.pop("attention_impl") == "auto"
    want.pop("attention_impl")
    assert got == want
    assert isinstance(build_model(t_reduce(t_get(ARCH)), "cpu"),
                      tencdec.EncDec)


@pytest.mark.parametrize("layers", [(2, 2), (12, 12), (1, 3)])
def test_params_from_jax_unstacks_each_layer(layers):
    """``enc_blocks`` / ``dec_blocks`` stack every layer (one included):
    layer i of the port is slice i of every leaf, each stack with its own
    depth."""
    enc, dec = layers
    jcfg, tcfg = _cfgs(encoder_layers=enc, num_layers=dec)
    jp = j_build(jcfg, JParallel(remat="none")).init(jax.random.PRNGKey(1))
    tp = params_from_jax(_np_tree(jp), tcfg, "cpu")
    assert set(tp) == set(jp)
    assert (len(tp["enc_blocks"]), len(tp["dec_blocks"])) == (enc, dec)
    for stack, n in (("enc_blocks", enc), ("dec_blocks", dec)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp[stack])[0]:
            for i in range(n):
                got = tp[stack][i]
                for p in path:
                    got = got[p.key]
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(leaf)[i])
    for k in ("frontend", "embedding", "enc_norm", "final_norm"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp[k])[0]:
            got = tp[k]
            for p in path:
                got = got[p.key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    with pytest.raises(ValueError, match="layers in the tree"):
        params_from_jax(_np_tree(jp), dataclasses.replace(
            tcfg, num_layers=dec + 1), "cpu")


def _paths(tree_):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]:
        out[tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path)] = leaf
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_jax_shapes_dtypes_and_scales(dtype):
    """Every leaf's shape and dtype are JAX's (per layer); norms, biases
    and the deterministic leaves equal JAX's; the random leaves have the
    reference's scale (dense: in_dim ** -0.5, wo: q_dim ** -0.5,
    pos_embed 0.02, embed d ** -0.5)."""
    jcfg, tcfg = _cfgs(dtype, d_model=64, num_heads=4, num_kv_heads=4,
                       d_ff=256, encoder_seq=40)
    jp = j_build(jcfg, JParallel(remat="none")).init(jax.random.PRNGKey(0))
    want = params_from_jax(_np_tree(jp), tcfg, "cpu")
    model = build_model(tcfg, "cpu")
    got = model.init(model.generator(0))
    gl, wl = tree.leaves_with_paths(got), tree.leaves_with_paths(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    d, qd = tcfg.d_model, tcfg.q_dim
    for (path, g), (_, w) in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        name = path.split("/")[-1]
        if name in ("scale", "bias"):
            assert torch.equal(g, w), path
            continue
        scale = {"wo": qd ** -0.5, "w_down": tcfg.d_ff ** -0.5,
                 "pos_embed": 0.02}.get(name, d ** -0.5)
        assert abs(g.float().std().item() - scale) < 0.1 * scale, path
        assert abs(w.float().std().item() - scale) < 0.1 * scale, path
    assert tfront.init_frontend(model.generator(0), t_reduce(
        t_get("llama2-7b")), torch.float32) == {}


def test_logical_trees_match_jax(pair):
    """The port's per-layer logical trees, stacked as JAX stacks them,
    equal JAX's ``EncDec.logical``; ``cache_logical`` per layer equals
    JAX's stacked one without its layer axis."""
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    got = model.logical()
    want = jm.logical()
    for k in ("frontend", "embedding", "enc_norm", "final_norm"):
        assert got[k] == want[k], k
    for k in ("enc_blocks", "dec_blocks"):
        assert all(b == got[k][0] for b in got[k])
        assert tcommon.stack_logical(got[k][0]) == want[k], k
    cl, jl = model.cache_logical(B, 20), jm.cache_logical(B, 20)
    assert len(cl["self"]) == len(cl["cross"]) == tcfg.num_layers
    (ax, shape) = jl["self"].k
    assert cl["self"][0].k == (ax[1:], shape[1:]) == cl["self"][0].v
    (cax, cshape) = jl["cross"][0]
    assert cl["cross"][0] == ((cax[1:], cshape[1:]),) * 2


# ---------------------------------------------------------------------------
# the sinusoid, the frontend, cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 7, 32, 768])
def test_sinusoid_matches_jax(d):
    """``[sin | cos]`` of position x exp(-log(1e4) i / max(d/2 - 1, 1)),
    float32: within 4 ulps of each element's angle (pos x freq), which
    a one-ulp frequency difference moves by up to pos ulps of the
    frequency."""
    pos = np.random.default_rng(d).integers(0, 1500, size=(2, 50)).astype(
        np.int32)
    pos[0, :4] = [0, 1, 448, 1499]
    want = np.asarray(jencdec.sinusoid(jnp.asarray(pos), d))
    got = tencdec.sinusoid(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    half = d // 2
    ang = pos[..., None] * np.exp(-np.log(1e4) * np.arange(half)
                                  / max(half - 1, 1))
    tol = 2.0 ** -21 * (np.concatenate([ang, ang], -1) + 1)
    assert (np.abs(got.numpy() - want) <= tol).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", ["encoder_seq", "other"])
def test_frontend_matches_jax(rows, dtype):
    """The adapter and, only at S = encoder_seq, the position rows; at
    another length JAX adds no positions, and neither does the port."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jfront.init_frontend(jax.random.PRNGKey(2), jcfg,
                              getattr(jnp, dtype))
    tp = jax.tree.map(_t, jp)
    assert tuple(tp["pos_embed"].shape) == (tcfg.encoder_seq, tcfg.d_model)
    s = tcfg.encoder_seq if rows == "encoder_seq" else tcfg.encoder_seq + 5
    x = _frames(tcfg, seed=3, s=s)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = _t(np.asarray(jx))
    want = jfront.apply_frontend(jp, jx, jcfg)
    got = tfront.apply_frontend(tp, tx, tcfg)
    assert got.dtype == tx.dtype
    _held(got, want, dtype)
    plain = jcommon.dense(jx, jp["adapter"])
    with_pos = not np.array_equal(_f32(got), np.asarray(plain, np.float32))
    assert with_pos == (rows == "encoder_seq")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, S])
def test_cross_attention_matches_jax(sq, dtype):
    """``project_cross_kv`` (the (B, S_enc, Hkv, D) layout of JAX) and
    ``apply_cross_attention`` of S decoder rows, and of one (a decode
    step), against the encoder's K/V."""
    jcfg, tcfg = _cfgs(dtype)
    jdt = getattr(jnp, dtype)
    jp = jattn.init_attention(jax.random.PRNGKey(4), jcfg, jdt)
    tp = jax.tree.map(_t, jp)
    enc = jnp.asarray(_frames(tcfg, seed=5)).astype(jdt)
    x = jnp.asarray(_frames(tcfg, seed=6, s=sq)).astype(jdt)
    jk, jv = jattn.project_cross_kv(jp, enc, jcfg)
    tk, tv = tattn.project_cross_kv(tp, _t(np.asarray(enc)), tcfg)
    assert tuple(tk.shape) == (B, tcfg.encoder_seq, tcfg.num_kv_heads,
                               tcfg.head_dim)
    _held(tk, jk, dtype, "k")
    _held(tv, jv, dtype, "v")
    want = jattn.apply_cross_attention(jp, x, jk, jv, jcfg)
    got = tattn.apply_cross_attention(tp, _t(np.asarray(x)), _t(
        np.asarray(jk)), _t(np.asarray(jv)), tcfg)
    assert got.dtype == tk.dtype and tuple(got.shape) == (B, sq,
                                                          tcfg.d_model)
    _held(got, want, dtype)


# ---------------------------------------------------------------------------
# the model: blocks, encode, decode_states, apply, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_encoder_and_one_decoder_block_match_jax(dtype):
    """One layer a stack: ``encode`` is the frontend, one encoder block
    (ln1, non-causal attention, ln2, MLP) and ``enc_norm``;
    ``decode_states`` the sinusoid, one decoder block (ln1, causal
    self-attention, ln_x, cross-attention, ln2, MLP) and ``final_norm``."""
    jcfg, jm, jp, tcfg, tp = _pair(dtype, seed=3, encoder_layers=1,
                                   num_layers=1)
    model = _model(tcfg)
    jdt = getattr(jnp, dtype)
    frames = _frames(tcfg, seed=7)
    tokens, _ = _tokens(tcfg.vocab_size, seed=8)
    jenc = jm.encode(jp, jnp.asarray(frames))
    tenc = model.encode(tp, torch.from_numpy(frames))
    assert tenc.dtype == getattr(torch, dtype)
    _held(tenc, jenc, dtype, "encode")
    enc = jnp.asarray(_frames(tcfg, seed=9)).astype(jdt)
    want = jm.decode_states(jp, jnp.asarray(tokens), enc)
    got = model.decode_states(tp, torch.from_numpy(tokens),
                              _t(np.asarray(enc)))
    _held(got, want, dtype, "decode_states")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decode_states_match_jax(dtype):
    jcfg, jm, jp, tcfg, tp = _pair(dtype, seed=4)
    model = _model(tcfg)
    frames = _frames(tcfg, seed=10)
    tokens, _ = _tokens(tcfg.vocab_size, seed=11)
    jenc = jm.encode(jp, jnp.asarray(frames))
    tenc = model.encode(tp, torch.from_numpy(frames))
    _held(tenc, jenc, dtype, "encode")
    want = jm.decode_states(jp, jnp.asarray(tokens), jenc)
    got = model.decode_states(tp, torch.from_numpy(tokens),
                              _t(np.asarray(jenc)))
    _held(got, want, dtype, "decode_states")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_loss_match_jax(dtype):
    """Logits at 2 + 2 layers under the dtype's rule; the loss (float32
    on both sides) within rtol 1e-5 in a float32 model, 1e-2 in bf16."""
    jcfg, jm, jp, tcfg, tp = _pair(dtype)
    frames = _frames(tcfg, seed=1)
    tokens, labels = _tokens(tcfg.vocab_size, seed=1)
    model = _model(tcfg)
    want = jm.apply(jp, jnp.asarray(frames), jnp.asarray(tokens))
    got = model.apply(tp, torch.from_numpy(frames), torch.from_numpy(tokens))
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    _held(got, want, dtype)
    jl = float(jm.loss(jp, jnp.asarray(frames), jnp.asarray(tokens),
                       jnp.asarray(labels)))
    tl = model.loss(tp, torch.from_numpy(frames), torch.from_numpy(tokens),
                    torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), jl,
                               rtol=RTOL if dtype == "float32" else 1e-2)


def test_apply_matches_jax_at_12_layers_a_stack():
    """whisper-small's depth, 12 + 12 layers, at reduced widths and in
    float32 (24 layers of bf16 roundings at other points compound past
    the bf16 rule, which holds one layer's): each layer's weights go to
    its own block, and the frame input is not encoder_seq long (no
    position rows)."""
    jcfg, jm, jp, tcfg, tp = _pair(seed=5, encoder_layers=12, num_layers=12)
    frames = _frames(tcfg, seed=2, s=tcfg.encoder_seq - 3)
    tokens, _ = _tokens(tcfg.vocab_size, seed=2, s=10)
    want = jm.apply(jp, jnp.asarray(frames), jnp.asarray(tokens))
    got = _model(tcfg).apply(tp, torch.from_numpy(frames),
                             torch.from_numpy(tokens))
    _close(got, want)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_gradients_match_jax(pair, remat):
    """Every leaf's gradient (the frontend's, the LayerNorm biases, both
    stacks') against jax.grad, each within 1e-4 of its norm."""
    jcfg, jm, jp, tcfg, tp = pair
    frames = _frames(tcfg, seed=3)
    tokens, labels = _tokens(tcfg.vocab_size, seed=3)
    jg = jax.grad(lambda p: jm.loss(p, jnp.asarray(frames),
                                    jnp.asarray(tokens),
                                    jnp.asarray(labels)))(jp)
    want = params_from_jax(_np_tree(jg), tcfg, "cpu")
    model = _model(tcfg, remat)
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(tp, torch.from_numpy(frames),
                          torch.from_numpy(tokens), torch.from_numpy(labels))
        got = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    assert any("pos_embed" in p for p in paths)
    assert any("ln_x/bias" in p for p in paths)
    for path, g, w in zip(paths, got, tree.leaves(want)):
        g, w = g.double().numpy(), w.double().numpy()
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), path


def _batch(cfg, b=4, s=S, seed=12, masked=True):
    tokens, labels = _tokens(cfg.vocab_size, seed=seed, b=b, s=s)
    if not masked:
        labels = np.roll(tokens, -1, axis=1)
    return {"enc_embeds": _frames(cfg, seed=seed, b=b), "tokens": tokens,
            "labels": labels}


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(micro):
    """One AdamW step through make_train_step (remat "full", as the
    launcher's "selective" runs) against JAX's jitted train step on the
    same {enc_embeds, tokens, labels} batch and microbatches: loss, grad
    norm, lr and every updated parameter."""
    jcfg, tcfg = _cfgs()
    train = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jpar = JParallel(remat="none", microbatches=micro)
    jm = j_build(jcfg, jpar)
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jm, jcfg, jpar, JTrain(**train)))
    tpar = ParallelConfig(remat="full", microbatches=micro)
    model = build_model(tcfg, "cpu", tpar)
    params = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    init = tree.tree_map(torch.clone, params)
    tstate = TrainState(params, opt.init_adamw(params))
    tstep = make_train_step(model, tcfg, tpar, TrainConfig(**train))
    batch = _batch(tcfg)
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=RTOL, err_msg=key)
    # each leaf's update as a norm ratio (Adam's first update turns a
    # gradient's rounding into a visible share of lr where |g| ~ eps)
    want = params_from_jax(_np_tree(jstate.params), tcfg, "cpu")
    for (path, g), w, p0 in zip(tree.leaves_with_paths(tstate.params),
                                tree.leaves(want), tree.leaves(init)):
        assert g.dtype == w.dtype, path
        du, dw = (g.double() - p0.double()), (w.double() - p0.double())
        assert (du - dw).norm() <= 1e-3 * dw.norm(), path
    assert int(tstate.opt.step) == int(jstate.opt.step) == 1


def test_microbatches_two_match_one():
    """The JAX package's own equivalence check on the port: microbatches
    = 2 (enc_embeds split with the tokens) against 1 on one global
    batch with no masked label (a masked label weighs the microbatches'
    means apart, in JAX as here), loss within 1e-4 and every
    gradient-driven update within 1e-3 of its norm."""
    _, tcfg = _cfgs()
    train = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg, masked=False).items()}
    runs = []
    for mb in (1, 2):
        par = ParallelConfig(remat="none", microbatches=mb)
        model = build_model(tcfg, "cpu", par)
        state = init_train_state(model, model.generator(0))
        init = tree.tree_map(torch.clone, state.params)
        state, met = make_train_step(model, tcfg, par, train)(state, batch)
        runs.append((float(met["loss"]), init, state.params))
    assert abs(runs[0][0] - runs[1][0]) < 1e-4
    for a, b, p0 in zip(tree.leaves(runs[0][2]), tree.leaves(runs[1][2]),
                        tree.leaves(runs[0][1])):
        da, db = a.double() - p0.double(), b.double() - p0.double()
        assert (da - db).norm() <= 1e-3 * da.norm()


# ---------------------------------------------------------------------------
# serving: init_cache, decode_step, dense generate
# ---------------------------------------------------------------------------

def test_init_cache_matches_jax(pair):
    """With the encoder states: each layer's cross K/V are JAX's
    ``project_cross_kv`` of that layer (JAX's stacked cache, slice i);
    without: zeros of encoder_seq rows.  The self caches are zeros."""
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    frames = _frames(tcfg, seed=13)
    jenc = jm.encode(jp, jnp.asarray(frames))
    want = jm.init_cache(B, 20, enc_out=jenc, params=jp)
    got = model.init_cache(B, 20, enc_out=_t(np.asarray(jenc)), params=tp)
    assert len(got["self"]) == len(got["cross"]) == tcfg.num_layers
    for i in range(tcfg.num_layers):
        for j in range(2):
            _close(got["cross"][i][j], want["cross"][j][i],
                   err_msg=f"layer {i} cross {'kv'[j]}")
        assert tuple(got["self"][i].k.shape) == want["self"].k.shape[1:]
        assert not got["self"][i].k.any() and not got["self"][i].v.any()
    zero = model.init_cache(B, 20)
    jzero = jm.init_cache(B, 20)
    for i in range(tcfg.num_layers):
        for j in range(2):
            assert tuple(zero["cross"][i][j].shape) == \
                jzero["cross"][j].shape[1:]
            assert not zero["cross"][i][j].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_and_prefill(dtype):
    """JAX's own transcription loop (``tests/test_arch_smoke.py``):
    encode, init_cache with the encoder states, then decode_step token by
    token.  Each step's logits are held to JAX's decode_step and to the
    port's own teacher-forced ``apply`` (JAX's tolerances, rtol 5e-2 and
    atol 5e-3, in float32; in bf16 the bf16 rule)."""
    jcfg, jm, jp, tcfg, tp = _pair(dtype, seed=6)
    model = _model(tcfg)
    frames = _frames(tcfg, seed=14)
    tokens, _ = _tokens(tcfg.vocab_size, seed=14)
    full = model.apply(tp, torch.from_numpy(frames),
                       torch.from_numpy(tokens))
    enc = model.encode(tp, torch.from_numpy(frames))
    cache = model.init_cache(B, S + 4, enc_out=enc, params=tp)
    jenc = jm.encode(jp, jnp.asarray(frames))
    jcache = jm.init_cache(B, S + 4, enc_out=jenc, params=jp)
    for t in range(S):
        tok = tokens[:, t]
        lg, cache = model.decode_step(tp, torch.from_numpy(tok), cache, t)
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, t)
        _held(lg, jl, dtype, f"pos {t} vs JAX")
        if dtype == "float32":
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                       rtol=5e-2, atol=5e-3)
        else:
            _bf16_close(lg, full[:, t], f"pos {t} vs apply")
    for i in range(tcfg.num_layers):
        _held(cache["self"][i].k, jcache["self"].k[i], dtype, f"k {i}")
        _held(cache["self"][i].v, jcache["self"].v[i], dtype, f"v {i}")


def _margins(jm, jp, prompt, generated):
    """Top-1 margin of the JAX model at every generated position,
    teacher-forced against encoder states of zeros: their bias-free
    cross K/V are the zeros its dense engine decodes against."""
    seq = np.concatenate([prompt, generated[:-1]]).astype(np.int32)
    cfg = jm.cfg
    zeros = jnp.zeros((1, cfg.encoder_seq, cfg.d_model), jnp.dtype(cfg.dtype))
    x = jm.decode_states(jp, jnp.asarray(seq[None]), zeros)
    logits = np.asarray(lm_logits(jp["embedding"], x, cfg))[0]
    top2 = np.sort(logits[len(prompt) - 1:], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_generate_greedy_matches_jax(pair):
    """The dense engine over the zero cross cache (JAX's
    ``ServeEngine.generate`` passes no encoder states)."""
    jcfg, jm, jp, tcfg, tp = pair
    n_new, prompt_len = 6, 5
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, prompt_len)).astype(np.int32)
    serve = dict(max_seq_len=prompt_len + n_new + 1, top_k=1)
    want = np.asarray(JEngine(model=jm, params=jp, cfg=jcfg,
                              serve=JServe(**serve)).generate(
        jnp.asarray(prompts), n_new))
    engine = ServeEngine(model=_model(tcfg), params=tp, cfg=tcfg,
                         serve=ServeConfig(**serve))
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


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

def test_engine_core_refuses_an_encdec(pair):
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    with pytest.raises(NotImplementedError, match="EncDec"):
        EngineCore(model, tp, tcfg, ServeConfig(max_batch=2, max_seq_len=32,
                                                page_size=16), device="cpu")
    engine = ServeEngine(model=model, params=tp, cfg=tcfg)
    with pytest.raises(NotImplementedError, match="EncDec"):
        engine.core


def test_a_mesh_of_more_than_one_rank_is_refused(pair, tmp_path):
    """A mesh of more than one rank is ported (the name is the test's
    from when it was refused): the model's specs are the rule table's on
    a (2, 2) mesh, and two gloo ranks at a model axis of 2, each over its
    half of the frames and of the tokens, give JAX's logits.  One rank
    runs as before."""
    jcfg, jm, jp, tcfg, tp = pair
    model = _model(tcfg)
    frames = _frames(tcfg)
    tokens = _tokens(tcfg.vocab_size, s=16)[0]
    specs = model.param_specs(make_mesh((2, 2), ("data", "model"), rank=1))
    assert specs["embedding"]["embed"] == ("model",)
    want = np.asarray(jm.apply(jp, jnp.asarray(frames), jnp.asarray(tokens)))
    params = tree.tree_map(lambda t: t.numpy().copy(), tp)
    ranks = spawn(apply_rank, 2, tmp_path, ARCH, {}, dict(model=2), params,
                  {"enc_embeds": frames, "tokens": tokens})
    assert [r["coords"] for r in ranks] == [{"data": 0, "model": m}
                                            for m in range(2)]
    _close(np.concatenate([r["logits"] for r in ranks], axis=1), want,
           rtol=1e-4)
    with axis_rules(mesh=make_mesh((1, 1), ("data", "model"))):
        assert model.apply(tp, torch.from_numpy(frames),
                           torch.from_numpy(tokens)).shape == (
                               B, 16, tcfg.vocab_size)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_serve_cli_whisper_generates_and_refuses_stream():
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "6", "--gen", "3"]
    out = _run("repro_torch.launch.serve", *common)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "generated (2, 3)" in out.stdout
    out = _run("repro_torch.launch.serve", *common, "--stream",
               "--requests", "2")
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "EncDec" in out.stderr


def test_train_cli_refuses_whisper(tmp_path):
    """The launcher's TokenPipeline makes no frame embeddings (nor does
    JAX's): it refuses the arch, naming the missing input."""
    out = _run("repro_torch.launch.train", "--arch", ARCH, "--smoke",
               "--device", "cpu", "--steps", "2", "--ckpt-dir",
               str(tmp_path))
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "enc_embeds" in out.stderr
