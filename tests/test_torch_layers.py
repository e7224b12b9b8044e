"""PyTorch port, layer by layer, against the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through ``repro.layers``
and ``repro_torch.layers``.  Everything is float32, so the two must agree
to 1e-5 (only the order of float32 sums may differ).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.layers import embedding as j_emb  # noqa: E402
from repro.layers import mlp as j_mlp  # noqa: E402
from repro.layers import norms as j_norms  # noqa: E402
from repro.layers import rotary as j_rot  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.layers import common as t_common  # noqa: E402
from repro_torch.layers import embedding as t_emb  # noqa: E402
from repro_torch.layers import mlp as t_mlp  # noqa: E402
from repro_torch.layers import norms as t_norms  # noqa: E402
from repro_torch.layers import rotary as t_rot  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a):
    return jnp.asarray(a, jnp.float32), torch.from_numpy(
        np.asarray(a, np.float32))


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(norm_type):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)) * 3 + 1
    scale = rng.normal(size=(48,))
    bias = rng.normal(size=(48,))
    jx, tx = _both(x)
    jp = {"scale": jnp.asarray(scale, jnp.float32)}
    tp = {"scale": torch.from_numpy(scale.astype(np.float32))}
    if norm_type == "layernorm":
        jp["bias"] = jnp.asarray(bias, jnp.float32)
        tp["bias"] = torch.from_numpy(bias.astype(np.float32))
    _close(j_norms.apply_norm(jp, jx, norm_type, 1e-6),
           t_norms.apply_norm(tp, tx, norm_type, 1e-6))


def test_norm_keeps_bf16_dtype():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    p = t_norms.init_norm(16, "rmsnorm", torch.bfloat16, torch.device("cpu"))
    assert t_norms.apply_norm(p, x).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16))
    pos = rng.integers(0, 4000, size=(2, 7))
    jx, tx = _both(x)
    _close(j_rot.apply_rope(jx, jnp.asarray(pos, jnp.int32), theta=theta),
           t_rot.apply_rope(tx, torch.from_numpy(pos), theta=theta),
           rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama2-7b"])
def test_embed_and_logits_match_jax(arch):
    """gemma2-2b: embed_scale, tied head, final softcap; llama2-7b:
    untied lm_head, no softcap."""
    jcfg = reduce_for_smoke(get_model_config(arch))
    tcfg = t_reduce(t_get(arch))
    # field for field, but for the attention default: "auto" puts CUDA
    # tensors on the kernel in the port, JAX's "reference" would not
    assert tcfg.attention_impl == "auto"
    assert jcfg == jcfg.__class__(**{**tcfg.__dict__, "attention_impl":
                                     jcfg.attention_impl})
    rng = np.random.default_rng(2)
    embed = rng.normal(size=(jcfg.vocab_size, jcfg.d_model))
    head = rng.normal(size=(jcfg.d_model, jcfg.vocab_size)) * 0.2
    jp = {"embed": jnp.asarray(embed, jnp.float32)}
    tp = {"embed": torch.from_numpy(embed.astype(np.float32))}
    if not jcfg.tie_embeddings:
        jp["lm_head"] = jnp.asarray(head, jnp.float32)
        tp["lm_head"] = torch.from_numpy(head.astype(np.float32))
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 6))
    jx = j_emb.embed_tokens(jp, jnp.asarray(tokens, jnp.int32), jcfg)
    tx = t_emb.embed_tokens(tp, torch.from_numpy(tokens), tcfg)
    _close(jx, tx)
    h = rng.normal(size=(2, 6, jcfg.d_model))
    jh, th = _both(h)
    _close(j_emb.lm_logits(jp, jh, jcfg), t_emb.lm_logits(tp, th, tcfg),
           rtol=1e-5, atol=5e-5)


def test_embed_scale_rounds_in_activation_dtype():
    cfg = t_get("gemma2-2b")
    tp = {"embed": torch.randn(10, cfg.d_model).to(torch.bfloat16)}
    x = t_emb.embed_tokens(tp, torch.tensor([[1, 2]]), cfg)
    want = tp["embed"][[1, 2]] * torch.tensor(cfg.d_model ** 0.5,
                                              dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x[0], want)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(mlp_type):
    rng = np.random.default_rng(3)
    d, f = 32, 80
    w = {"w_up": rng.normal(size=(d, f)) * d ** -0.5,
         "w_down": rng.normal(size=(f, d)) * f ** -0.5}
    if mlp_type != "gelu":
        w["w_gate"] = rng.normal(size=(d, f)) * d ** -0.5
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in w.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    x = rng.normal(size=(2, 5, d))
    jx, tx = _both(x)
    _close(j_mlp.apply_mlp(jp, jx, mlp_type), t_mlp.apply_mlp(tp, tx,
                                                              mlp_type))


def test_dense_init_distribution():
    gen = torch.Generator().manual_seed(0)
    w = t_common.dense_init(gen, 256, 512, torch.float32)
    assert w.shape == (256, 512)
    assert abs(w.mean().item()) < 5e-3
    assert abs(w.std().item() - 256 ** -0.5) < 2e-3
    wo = t_common.dense_init(gen, 64, 8, torch.bfloat16, scale=0.5)
    assert wo.dtype == torch.bfloat16


def test_dense_bias_and_dtype():
    x = torch.randn(2, 3, 4)
    w = torch.randn(4, 5)
    b = torch.randn(5)
    torch.testing.assert_close(t_common.dense(x, w, b), x @ w + b)
    assert t_common.dense(x, w, dtype=torch.bfloat16).dtype == torch.bfloat16
