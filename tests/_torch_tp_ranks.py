"""Rank bodies of the tensor-parallel tests: each runs in a process of
its own, started by ``repro_torch.launch.mesh.spawn_ranks`` on ``gloo``,
and imports only ``torch``, ``numpy`` and ``repro_torch`` (never JAX).
Inputs arrive as numpy arrays; results go back as plain Python and
numpy, to be held to the JAX package in the test process.

``host_state`` is the engine state that must equal the JAX engine's
exactly (``tests/_torch_engine_pair.py`` uses it too).
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import spawn_ranks

INIT_TIMEOUT_S = 60.0      # every collective of a rank
DEADLINE_S = 240.0         # a spawned group as a whole


def spawn(fn, tp: int, tmp_path, *args) -> list:
    """``fn(rank, *args)`` on ``tp`` CPU ranks over gloo, rendezvous
    through a file under ``tmp_path`` (no port, so parallel test workers
    cannot collide)."""
    pg = tmp_path / f"pg-{fn.__name__}-{tp}"
    return spawn_ranks(fn, tp, args=args, backend="gloo",
                       init_method=f"file://{pg}", timeout_s=DEADLINE_S,
                       init_timeout_s=INIT_TIMEOUT_S)


def host_state(core, *, tokens_equal: bool = True) -> dict:
    """The host counters two engines must agree on exactly.  The
    token-dependent ones are left out unless ``tokens_equal``."""
    st = core.stats()
    out = {k: st[k] for k in ("steps", "finished", "pages_used",
                              "pages_peak", "prefill_launches",
                              "events_emitted", "waiting", "resuming",
                              "active_slots", "host_pool_pages")}
    out["pressure"] = st["pressure"]
    health = dict(st["health"])
    health.pop("step_s_high_water")
    out["health"] = health
    if "prefix" in st:
        out["prefix"] = st["prefix"]
        out["prefix_cached_pages"] = st["prefix_cached_pages"]
    if "spec" in st:
        out["spec"] = {k: st["spec"][k] for k in (
            "drafted", "accepted", "accept_rate", "verify_launches")}
    if core.injector is not None:
        out["fired_log"] = list(core.injector.fired_log)
        out["calls"] = core.injector.stats()["calls"]
    if not tokens_equal:
        out.pop("spec", None)
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collectives_rank(rank: int, cases: dict) -> dict:
    """Every variant of core/tiled_allreduce.py on this rank's shards.
    ``cases``: name -> (x (T, F), w (F, D)); the rank takes its 1/world
    of F (x's columns, w's rows).  Returns name/variant -> this rank's
    output, and the all-reduces each variant issued."""
    from repro_torch.core import tiled_allreduce as ta
    torch.set_num_threads(1)
    n = dist.get_world_size()
    calls = []
    real = dist.all_reduce

    def counting(t, *a, **kw):
        calls.append(t.shape[0])
        return real(t, *a, **kw)

    dist.all_reduce = counting
    out = {}
    for name, (x, w) in cases.items():
        f = x.shape[1] // n
        xs, ws = _t(x[:, rank * f:(rank + 1) * f]), _t(w[rank * f:])[:f]
        for var, fn in (
                ("tiled", lambda: ta.tiled_matmul_allreduce(xs, ws)),
                ("single", lambda: ta.single_matmul_allreduce(xs, ws)),
                ("ring", lambda: ta.ring_matmul_allreduce(xs, ws)),
                ("dispatch-tiled", lambda: ta.matmul_allreduce(
                    xs, ws, mode="tiled")),
                ("dispatch-single", lambda: ta.matmul_allreduce(
                    xs, ws, mode="single")),
                ("rs", lambda: ta.tiled_matmul_reducescatter(xs, ws)),
                ("rs1", lambda: ta.tiled_matmul_reducescatter(
                    xs, ws, n_chunks=1))):
            del calls[:]
            try:
                out[(name, var)] = _np(fn())
            except ValueError as e:
                out[(name, var)] = f"ValueError: {e}"
            out[(name, var, "calls")] = list(calls)
    dist.all_reduce = real
    return out


def fused_rank(rank: int, q, k, v, w_o) -> dict:
    """fused_attention_linear on this rank's heads, tiled and single."""
    from repro_torch.core.tiled_allreduce import sharded_fused_block
    torch.set_num_threads(1)
    return {mode: _np(sharded_fused_block(_t(q), _t(k), _t(v), _t(w_o),
                                          mode=mode))
            for mode in ("tiled", "single")}


# ---------------------------------------------------------------------------
# distributed decode
# ---------------------------------------------------------------------------

def decode_rank(rank: int, q, k, v, kv_len, q_pos) -> dict:
    """attend_with_positions on this rank's strided page rows merged by
    merge_partial_attention; context_parallel_decode on its contiguous
    slice of the cache, with and without a window."""
    from repro_torch.core import distributed_decode as dd
    torch.set_num_threads(1)
    n = dist.get_world_size()
    kv = k.shape[2]
    mine = np.arange(rank, kv, n)           # strided: every n-th key
    out, lse = dd.attend_with_positions(
        _t(q), _t(k[:, :, mine]), _t(v[:, :, mine]), q_positions=_t(q_pos),
        kv_positions=_t(mine), kv_len=_t(kv_len))
    res = {"merged": _np(dd.merge_partial_attention(out, lse))}
    q1 = _t(q[:, :, 0])
    res["cp"] = _np(dd.context_parallel_decode(q1, _t(k), _t(v),
                                               _t(kv_len)))
    res["cp_window"] = _np(dd.context_parallel_decode(
        q1, _t(k), _t(v), _t(kv_len), window=64))
    return res


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return _np(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return _t(tree)


def _drive(core, waves):
    from repro_torch.serving.scheduler import SamplingParams
    toks = {}
    for wave in waves:
        for rid, prompt, kw in wave:
            core.add_request(prompt, SamplingParams(**kw), request_id=rid)
            toks[rid] = []
        while core.has_work:
            for ev in core.step():
                assert ev.kind == "token", ev
                toks[ev.request_id].append(ev.token)
    return toks


def serve_rank(rank: int, arch: str, params, runs: dict,
               latency: dict) -> dict:
    """The port's EngineCore on this rank for every run of ``runs``
    (name -> (ServeConfig keywords, waves of (id, prompt, sampling
    keywords))), the pressure manager on the ``latency`` constants.
    Returns name -> streams, stats()["tp"], host state and the rank's
    local pool shape."""
    from repro_torch.config import ServeConfig, get_model_config
    from repro_torch.config import reduce_for_smoke
    from repro_torch.core.offload import OffloadLatencyModel
    from repro_torch.models import build_model
    from repro_torch.serving.core import EngineCore
    torch.set_num_threads(1)
    cfg = reduce_for_smoke(get_model_config(arch))
    model = build_model(cfg, "cpu")
    params = _to_torch(params)
    out = {}
    for name, (serve, waves) in runs.items():
        core = EngineCore(model, params, cfg, ServeConfig(**serve),
                          device="cpu")
        core.pressure.lat = OffloadLatencyModel(**latency)
        toks = _drive(core, waves)
        out[name] = {"tokens": toks, "tp": core.stats().get("tp"),
                     "host": host_state(core),
                     "host_all": host_state(core, tokens_equal=False),
                     "pool": tuple(core.pools[0].k.shape),
                     "stash": len(core.pressure.host_pool)}
    return out


def all_collectives_rank(rank: int, cases: dict, fused: tuple,
                         decode: tuple) -> dict:
    """collectives_rank, fused_rank and decode_rank in one spawn."""
    return {"collectives": collectives_rank(rank, cases),
            "fused": fused_rank(rank, *fused),
            "decode": decode_rank(rank, *decode)}
