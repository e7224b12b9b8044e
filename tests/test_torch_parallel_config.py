"""The port's parallel and run configs against the JAX package's: every
``ParallelConfig`` field with JAX's default (but the recorded hardware
defaults, which take one H100's), the mesh helpers, ``SHAPES``,
``RunConfig`` and ``describe``; and the values no port path serves,
refused with NotImplementedError."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.config as J  # noqa: E402
import repro_torch.config as T  # noqa: E402

# defaults that describe the hardware: one H100 SXM, not a v5e
HARDWARE = {"device_memory_gb": 80.0, "pcie_gbps": 64.0}
ARCHS = ["llama2-7b", "gemma2-2b", "qwen2.5-32b", "stablelm-3b",
         "phi3-mini-3.8b", "xlstm-125m"]


def _defaults(cls) -> dict:
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(cls)}


def test_every_jax_parallel_field_has_jax_default():
    jd, td = _defaults(J.ParallelConfig), _defaults(T.ParallelConfig)
    assert list(td) == list(jd)
    for name, want in jd.items():
        assert td[name] == HARDWARE.get(name, want), name
    assert set(HARDWARE) <= set(jd)


@pytest.mark.parametrize("kw", [
    {}, dict(data=2, model=2), dict(pods=2, data=1, model=2),
    dict(pods=2, data=16, model=16), dict(data=4),
    dict(attn_mode="replicated", tiled_allreduce=True, ar_chunks=2,
         first_chunk_frac=0.25, scan_layers=False,
         seq_shard_activations=False, microbatches=4, remat="full"),
])
def test_parallel_configs_jax_accepts_the_port_accepts(kw):
    j, t = J.ParallelConfig(**kw), T.ParallelConfig(**kw)
    assert t.dp == j.dp
    assert t.mesh_shape() == j.mesh_shape()
    assert t.mesh_axes() == j.mesh_axes()
    assert t.dp_axes() == j.dp_axes()
    for name in kw:
        assert getattr(t, name) == getattr(j, name)


@pytest.mark.parametrize("kw,match", [
    (dict(grad_compression="int8_ef"), "grad_compression"),
    (dict(pipeline_stages=2), "pipeline_stages"),
    (dict(offload_kv=True), "offload_kv"),
])
def test_values_no_port_path_serves_are_refused(kw, match):
    J.ParallelConfig(**kw)                  # valid in the reference
    with pytest.raises(NotImplementedError, match=match):
        T.ParallelConfig(**kw)


def test_shapes_run_config_and_describe_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(T.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(J.ShapeConfig)]
    assert [f.name for f in dataclasses.fields(T.RunConfig)] == \
        [f.name for f in dataclasses.fields(J.RunConfig)]
    run = T.RunConfig(model=T.get_model_config("llama2-7b"))
    assert run.shape == T.SHAPES["train_4k"]
    assert run.parallel == T.ParallelConfig()
    assert run.train == T.TrainConfig() and run.serve == T.ServeConfig()
    for arch in ARCHS:
        assert T.describe(T.get_model_config(arch)) == \
            J.describe(J.get_model_config(arch)), arch
        assert T.describe(T.reduce_for_smoke(T.get_model_config(arch))) \
            == J.describe(J.reduce_for_smoke(J.get_model_config(arch)))
