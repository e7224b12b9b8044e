"""Mixture-of-experts models served tensor-parallel by the port, on the
CPU, against the JAX package's tp engine: reduced qwen3-moe-30b-a3b and
reduced grok-1-314b (4 experts top-2, 2 kv heads) at tp=2 (g=2, s=1:
head parallelism) and tp=4 (g=2, s=2: page-row sub-shards, the LSE
merge), each rank a gloo process (``tests/_torch_tp_ranks.py``), JAX's
engine on forced host devices in a subprocess.

The expert FFN runs whole on every rank, on the hidden state after the
O-proj all-reduce (JAX replicates it the same way): each rank holds
every moe leaf whole.  Held: the ranks' streams exactly equal, equal to
JAX's under the margin rule of ``tests/_torch_engine_pair.py``, the host
state and the plan exactly.  The prompts are chunked identically in both
packages (capacity counts a launch's rows).  Also ``launch.serve
--stream --tp 2`` on a moe arch.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import (pair_on_one_thread,  # noqa: E402
                                streams_match)
from _torch_tp_ranks import serve_rank, to_numpy  # noqa: E402
from _torch_tp_ranks import spawn as tp_spawn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
# 16-token chunks: cap 10 of a chunk's 32 assignments an expert
SERVE = dict(max_batch=3, max_seq_len=96, page_size=16, prefill_chunk=16,
             num_pages=24)
PLANS = {2: {"tp": 2, "g": 2, "s": 1}, 4: {"tp": 4, "g": 2, "s": 2}}

JAX_TP_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
from repro.config import (ParallelConfig, ServeConfig, get_model_config,
                          reduce_for_smoke)
from repro.models import build_model
from repro.serving.core import EngineCore
from repro.serving.scheduler import SamplingParams
from _torch_tp_ranks import host_state
archs, serve, waves = json.loads(sys.argv[2])
out = {"devices": jax.device_count()}
for arch in archs:
    cfg = reduce_for_smoke(get_model_config(arch))
    model = build_model(cfg, ParallelConfig(remat="none"))
    params = model.init(jax.random.PRNGKey(0))
    core = EngineCore(model=model, params=params, cfg=cfg,
                      serve=ServeConfig(**serve))
    toks = {}
    for wave in waves[arch]:
        for rid, prompt, kw in wave:
            core.add_request(prompt, SamplingParams(**kw), request_id=rid)
            toks[rid] = []
        while core.has_work:
            for ev in core.step():
                toks[ev.request_id].append(ev.token)
    out[arch] = {"tokens": toks, "tp": core.stats()["tp"],
                 "host_all": host_state(core, tokens_equal=False)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    with pair_on_one_thread(request.param) as p:
        yield p


def _traffic(vocab):
    rng = np.random.default_rng(7)
    return [[(i, rng.integers(0, vocab, size=n), dict(max_new_tokens=8))
             for i, n in enumerate((5, 23, 40))]]


_JAX_RUNS: dict = {}


def _jax_tp(arch: str, tp: int) -> dict:
    """JAX's tp engine on ``tp`` forced host devices over every arch's
    traffic (one subprocess a tp, shared by the archs' cases)."""
    if tp not in _JAX_RUNS:
        plain = {a: [[(rid, pr.tolist(), kw) for rid, pr, kw in w]
                     for w in _traffic(256)] for a in ARCHS}
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={tp}",
                   JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, "-c", JAX_TP_CHILD,
             os.path.dirname(os.path.abspath(__file__)),
             json.dumps([ARCHS, _serve(tp), plain])], env=env,
            capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        _JAX_RUNS[tp] = json.loads(out.stdout.strip().splitlines()[-1])
        assert _JAX_RUNS[tp]["devices"] == tp
    res = dict(_JAX_RUNS[tp][arch])
    res["tokens"] = {int(k): v for k, v in res["tokens"].items()}
    return res


def _serve(tp: int) -> dict:
    return dict(SERVE, tp=tp, tp_collectives="tiled")


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_ranks_match_jax_tp_engine(pair, tp, tmp_path):
    """The port at tp (g=2, s=tp/2) as gloo ranks against JAX's tp engine
    on the same weights and requests: every rank's streams equal each
    other and JAX's under the margin rule, host state and plan exactly,
    each rank's pool its (Hkv/g, P, ps/s, D) share and every moe leaf
    (router and experts) whole."""
    p = pair
    cfg = p.tcfg
    waves = _traffic(p.vocab)
    assert p.vocab == 256
    jres = _jax_tp(cfg.name, tp)
    ranks = tp_spawn(serve_rank, tp, tmp_path, cfg.name, to_numpy(p.tp),
                     {"basic": (_serve(tp), waves)},
                     dict(pcie_gbps=13.2, host_gflops=140.0,
                          device_tflops=197.0))
    plan = dict(PLANS[tp], collectives="tiled")
    whole = [{k: tuple(v.shape) for k, v in bp["moe"].items()}
             for bp in p.tp["layers"]]
    assert len(whole) == cfg.num_layers and whole[0]["w_up"][0] == 4
    for r in ranks:
        got = r["basic"]
        assert got["tokens"] == ranks[0]["basic"]["tokens"]
        assert got["tp"] == jres["tp"] == plan
        assert got["pool"] == (cfg.num_kv_heads // 2, SERVE["num_pages"],
                               SERVE["page_size"] // PLANS[tp]["s"],
                               cfg.head_dim)
        assert got["moe"] == whole
    prompts = {rid: pr for w in waves for rid, pr, _ in w}
    streams_match(p, prompts, ranks[0]["basic"]["tokens"], jres["tokens"])
    assert ranks[0]["basic"]["host_all"] == jres["host_all"]


def test_serve_cli_streams_a_moe_arch_at_tp2():
    """``launch.serve --stream --tp 2`` on reduced qwen3-moe: two gloo
    ranks serve every request; rank 0 reports."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--stream",
         "--tp", "2", "--requests", "3", "--prompt-len", "12", "--gen",
         "5"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "2 ranks over gloo" in out.stdout
    for rid in range(3):
        assert f"req {rid} finished (5 tokens)" in out.stdout
    assert "15 tokens in" in out.stdout
