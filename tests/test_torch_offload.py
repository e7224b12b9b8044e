"""The port's cooperative-offload module against the JAX package's, on the
CPU.

``plan_offload``, ``table3_row``, ``max_context_length``,
``kv_page_bytes`` and ``preempt_cost_model`` take the same configs and an
explicit ``OffloadLatencyModel`` on both sides (the port's defaults are
the H100's, the JAX package's a TPU v5e's and the paper's V100 host):
integers must be equal, floats within 1e-9 relative.  ``param_count`` is
the port's own copy of the JAX analytic model.  ``HostOffloadEngine`` is
held to JAX's on the same K/V (float32, rtol 1e-4, atol 1e-5, as
``tests/test_offload.py`` holds JAX's to its oracle).
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.analysis import flops as JF  # noqa: E402
from repro.analysis.flops import param_count as j_param_count  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.core import offload as J  # noqa: E402
from repro_torch.analysis import flops as TF  # noqa: E402
from repro_torch.analysis.flops import param_count  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.config import available_archs  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.core import offload as T  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCHS = ["pangu-38b", "llama2-7b", "gemma2-2b"]
CONSTS = dict(pcie_gbps=13.2, host_gflops=140.0, device_tflops=197.0)


def _models():
    """The same latency model on both sides (the JAX one charges device
    bytes at a fixed 819 GB/s)."""
    return (J.OffloadLatencyModel(**CONSTS),
            T.OffloadLatencyModel(**CONSTS, device_gbps=819.0))


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (bool, int, np.integer)):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq,n_dev,mem", [(16384, 8, 16.0),
                                           (262144, 8, 16.0),
                                           (131072, 1, 80.0),
                                           (4096, 1, 80.0)])
def test_plan_and_table3_match_jax(arch, seq, n_dev, mem):
    jcfg, tcfg = get_model_config(arch), t_get(arch)
    for batch in (1, 4):
        want = J.plan_offload(jcfg, batch=batch, seq_len=seq, gen_len=64,
                              n_devices=n_dev, device_memory_gb=mem)
        got = T.plan_offload(tcfg, batch=batch, seq_len=seq, gen_len=64,
                             n_devices=n_dev, device_memory_gb=mem)
        _same(got.__dict__, want.__dict__)
        assert got.summary() == want.summary()
    jm, tm = _models()
    want = J.table3_row(jcfg, seq, n_devices=n_dev, model=jm,
                        device_memory_gb=mem)
    got = T.table3_row(tcfg, seq, n_devices=n_dev, model=tm,
                       device_memory_gb=mem)
    _same(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_max_context_and_page_costs_match_jax(arch):
    jcfg, tcfg = get_model_config(arch), t_get(arch)
    for n_dev, dmem, hmem in ((8, 16, 768), (1, 80, 96), (1, 80, 1)):
        _same(T.max_context_length(tcfg, batch=1, n_devices=n_dev,
                                   device_memory_gb=dmem,
                                   host_memory_gb=hmem),
              J.max_context_length(jcfg, batch=1, n_devices=n_dev,
                                   device_memory_gb=dmem,
                                   host_memory_gb=hmem))
    jm, tm = _models()
    for ps in (16, 128):
        assert T.kv_page_bytes(tcfg, ps) == J.kv_page_bytes(jcfg, ps)
        for n_pages, n_tok in ((1, 10), (40, 5000)):
            _same(T.preempt_cost_model(tcfg, n_pages=n_pages,
                                       n_tokens=n_tok, page_size=ps,
                                       model=tm),
                  J.preempt_cost_model(jcfg, n_pages=n_pages,
                                       n_tokens=n_tok, page_size=ps,
                                       model=jm))


@settings(max_examples=50, deadline=None)
@given(seq=st.integers(1024, 1 << 19), mem=st.floats(8, 80))
def test_planner_invariants(seq, mem):
    cfg = t_get("pangu-38b")
    p = T.plan_offload(cfg, batch=1, seq_len=seq, gen_len=64, n_devices=8,
                       device_memory_gb=mem)
    assert 0 <= p.l_gpu <= cfg.num_layers
    assert p.l_gpu + p.l_cpu == cfg.num_layers
    if not p.needs_offload:
        assert p.l_cpu == 0


def test_defaults_are_the_h100s():
    """No TPU v5e (197 TFLOP/s, 819 GB/s, 16 GB) or V100-host constant in
    the port's defaults."""
    m = T.OffloadLatencyModel()
    assert (m.device_tflops, m.device_gbps) == (989.0, 3350.0)
    assert (m.pcie_gbps, m.host_gflops) != (13.2, 140.0)
    assert ParallelConfig().device_memory_gb == 80.0
    cfg = t_get("llama2-7b")
    assert T.plan_offload(cfg, batch=1, seq_len=4096, gen_len=64,
                          n_devices=1).device_budget == 80 * 2 ** 30
    # one 80 GB card holds llama2-7b's KV up to ~132K tokens at B=1
    assert not T.table3_row(cfg, 131072, n_devices=1)["offload"]
    assert T.table3_row(cfg, 196608, n_devices=1)["l_cpu"] == 11


@pytest.mark.parametrize("arch", list(available_archs())
                         + ["xlstm-125m"])
def test_param_count_matches_jax(arch):
    """Every config the port registers (MoE, hymba and the
    encoder-decoder whisper-small among them).  The formula is the
    reference's: it counts hymba's dt projection as DI x 1 and A as DI,
    where ``init_mamba`` makes DI x DI and DI x N, and leaves out conv_b,
    dt_bias and d_skip; for whisper it leaves out the frontend, every
    LayerNorm bias, ``ln_x`` and ``enc_norm`` (ROADMAP Queue 3)."""
    jcfg = get_model_config(arch)
    tcfg = t_get(arch)
    for active in (False, True):
        assert param_count(tcfg, active) == j_param_count(jcfg, active)


@pytest.mark.parametrize("arch", list(available_archs())
                         + ["xlstm-125m"])
def test_model_and_attention_flops_match_jax(arch):
    """``model_flops`` and ``attention_flops``, the roofline's and the
    MFU's FLOP counts, for every registered config at every shape of
    ``SHAPES``: the same float, formula for formula."""
    from repro.config import SHAPES as JSHAPES
    from repro_torch.config import SHAPES
    jcfg, tcfg = get_model_config(arch), t_get(arch)
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        assert TF.model_flops(tcfg, shape) == JF.model_flops(
            jcfg, JSHAPES[name]), name
        assert TF.attention_flops(tcfg, shape) == JF.attention_flops(
            jcfg, JSHAPES[name]), name


@pytest.mark.parametrize("l_cpu,layer", [(1, 0), (2, 1)])
def test_host_engine_matches_jax(l_cpu, layer):
    jcfg = reduce_for_smoke(get_model_config("llama2-7b"))
    tcfg = t_reduce(t_get("llama2-7b"))
    plan = dict(l_gpu=tcfg.num_layers - l_cpu, l_cpu=l_cpu,
                bytes_weights=0, bytes_kv_layer=0, bytes_mid=0,
                bytes_vocab=0, device_budget=0, needs_offload=True)
    jeng = J.HostOffloadEngine(jcfg, J.OffloadPlan(**plan), max_batch=2,
                               max_seq=32)
    teng = T.HostOffloadEngine(tcfg, T.OffloadPlan(**plan), max_batch=2,
                               max_seq=32)
    assert teng.host == torch.device("cpu")
    assert teng.is_host_layer(layer) and not teng.is_host_layer(l_cpu)
    rng = np.random.default_rng(0)
    shape = (2, 8, tcfg.num_kv_heads, tcfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jeng.prefill_offload(layer, jnp.asarray(k), jnp.asarray(v))
    teng.prefill_offload(layer, torch.from_numpy(k), torch.from_numpy(v))
    # a device-KV layer is left alone
    teng.prefill_offload(l_cpu, torch.from_numpy(k), torch.from_numpy(v))
    kn, vn = (rng.normal(size=(2, 1) + shape[2:]).astype(np.float32)
              for _ in range(2))
    jeng.decode_append(layer, jnp.asarray(kn), jnp.asarray(vn), 8)
    teng.decode_append(layer, torch.from_numpy(kn), torch.from_numpy(vn), 8)
    q = rng.normal(size=(2, 1, tcfg.num_heads, tcfg.head_dim)).astype(
        np.float32)
    want = np.asarray(jeng.decode_attention(layer, jnp.asarray(q),
                                            kv_len=[9, 6]))
    got = teng.decode_attention(layer, torch.from_numpy(q), kv_len=[9, 6])
    assert got.shape == (2, 1, tcfg.num_heads, tcfg.head_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    kh, vh = teng._host_kv[layer]
    np.testing.assert_array_equal(kh[:, :8].numpy(), k)
    np.testing.assert_array_equal(vh[:, 8:9].numpy(), vn)


def test_unread_offload_settings_are_refused():
    """Host KV asked for where no decode path reads it is refused, not
    silently served from device KV."""
    with pytest.raises(NotImplementedError, match="offload_kv"):
        ParallelConfig(offload_kv=True)
    cfg = t_reduce(t_get("llama2-7b"))
    plan = T.plan_offload(cfg, batch=1, seq_len=32, gen_len=4, n_devices=1)
    eng = T.HostOffloadEngine(cfg, plan, max_batch=1, max_seq=32)
    model = build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="offload"):
        ServeEngine(model=model, params={}, cfg=cfg, offload=eng)
