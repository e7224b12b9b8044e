"""Fault tolerance and elasticity (``training/fault_tolerance.py``) against
the JAX package's, on the CPU.

``HeartbeatMonitor`` and ``elastic_plan`` are held to JAX's over drawn
beat times, alive counts and (pods, data, model) layouts, JAX's
RuntimeError included; and a checkpoint saved on a (2, 2) mesh of gloo
ranks restores at the (1, 2) layout ``elastic_plan`` gives for two live
hosts, every restored piece the rule table's slice of the saved leaf and
the next step's loss the (2, 2) run's.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.training import fault_tolerance as J  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding.rules import flatten, is_spec, shard_of  # noqa: E402
from repro_torch.training import fault_tolerance as T  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.train_step import state_specs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_ranks import resume_rank, spawn, train_rank  # noqa: E402


@settings(max_examples=40, deadline=None)
@given(beats=st.lists(st.tuples(st.integers(0, 4), st.floats(0, 100)),
                      max_size=20),
       now=st.floats(0, 150), timeout=st.floats(1, 60))
def test_heartbeat_monitor_is_jaxs(beats, now, timeout):
    hosts = [f"h{i}" for i in range(5)]
    j, t = (m.HeartbeatMonitor(hosts, timeout_s=timeout) for m in (J, T))
    for mon in (j, t):
        for h in hosts:
            mon.beat(h, t=0.0)
        for i, at in beats:
            mon.beat(hosts[i], t=at)
    assert t.dead_hosts(now=now) == j.dead_hosts(now=now)
    assert t.alive_hosts(now=now) == j.alive_hosts(now=now)
    assert t.last_seen == j.last_seen


@settings(max_examples=80, deadline=None)
@given(pods=st.integers(1, 3), data=st.sampled_from([1, 2, 4, 8, 16]),
       model=st.sampled_from([1, 2, 4, 16]), alive=st.integers(0, 600))
def test_elastic_plan_is_jaxs(pods, data, model, alive):
    kw = dict(pods=pods, data=data, model=model)
    try:
        want = J.elastic_plan(JParallel(**kw), alive)
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            T.elastic_plan(ParallelConfig(**kw), alive)
        assert str(got.value) == str(e)
        return
    got = T.elastic_plan(ParallelConfig(**kw), alive)
    assert dataclasses.asdict(got) == {
        k: v for k, v in dataclasses.asdict(want).items()
        if k not in ("device_memory_gb", "pcie_gbps")} | {
        "device_memory_gb": got.device_memory_gb, "pcie_gbps": got.pcie_gbps}
    assert got.model == model and got.pods * got.data * got.model <= \
        max(alive, pods * data * model)


def test_a_2x2_checkpoint_resumes_at_the_elastic_plan(tmp_path):
    """Two of four hosts die after a (2, 2) run's checkpoint: the plan
    keeps the model axis, (data=1, model=2), and its ranks restore their
    pieces of the saved state and step on."""
    arch, train = "llama2-7b", dict(learning_rate=1e-3, warmup_steps=1,
                                    total_steps=3)
    cfg = reduce_for_smoke(get_model_config(arch))
    model = build_model(cfg, "cpu", ParallelConfig())
    init = tree.tree_map(lambda t: t.numpy().copy(),
                         model.init(model.generator(0)))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4))
    batches = [pipe.next() for _ in range(3)]
    ck = tmp_path / "ck"
    ranks = spawn(train_rank, 4, tmp_path, arch, dict(data=2, model=2),
                  init, batches[:2], train,
                  {"dir": str(ck), "save": True, "next": batches[2]})
    plan = T.elastic_plan(ParallelConfig(data=2, model=2), alive_hosts=2)
    assert (plan.pods, plan.data, plan.model) == (1, 1, 2)
    par_kw = dict(data=plan.data, model=plan.model)
    res = spawn(resume_rank, 2, tmp_path, arch, par_kw, init, train,
                str(ck), batches[2])
    saved = ranks[0]["final"]
    for rank, r in enumerate(res):
        assert r["restored_step"] == 2 and r["step"] == 3
        np.testing.assert_allclose(r["loss"], ranks[0]["next_loss"],
                                   rtol=1e-4, atol=1e-4)
        mesh = make_mesh(plan.mesh_shape(), plan.mesh_axes(), rank)
        specs = flatten(state_specs(build_model(
            cfg, "cpu", plan).param_specs(mesh)), is_spec)
        for got, whole, spec in zip(r["restored"], saved, specs,
                                    strict=True):
            np.testing.assert_array_equal(
                got, shard_of(torch.from_numpy(whole), spec, mesh).numpy())
