"""Tensor-parallel plan, per-rank context and weight slicing for the
paged serving engine.

The paged engine shards attention and the per-layer KV page pools over
``tp = g * s`` ranks, one process each (``launch/mesh.py``):

  * ``g = gcd(tp, num_kv_heads)`` kv-head groups -- classic Megatron head
    parallelism; every rank of a group holds the group's KV heads for its
    rows of every page.
  * ``s = tp // g`` page-row sub-shards: rank ``(gi, si)`` holds rows
    ``[si * ps/s, (si + 1) * ps/s)`` of every page.  Each sub-shard
    attends over its own rows only and the partial outputs merge exactly
    by the log-sum-exp combination of ``core/distributed_decode.py``,
    over the group's page-row subgroup.

Rank ``r`` is mesh coordinate ``(gi, si) = divmod(r, s)``.  The factoring
means a 4-way group still works when the model has only 2 KV heads (the
smoke configs): ``tp=4, Hkv=2 -> g=2, s=2``.  With ``s == 1`` there is no
merge -- pure head parallelism.

Model code discovers the active rank through a contextvar
(``current_tp()``); ``EngineCore`` enters ``tp_context`` around its model
calls, so the same layer code serves the single-device and the sharded
engine.  The weights are sliced once, at construction
(``shard_params``): each rank keeps its projection columns and rows and
the replicated embeddings, norms and LM head.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

from repro_torch.config import ModelConfig


@dataclass(frozen=True)
class TPPlan:
    """Static tensor-parallel factoring."""
    g: int                       # kv-head groups
    s: int                       # page-row sub-shards
    collectives: str = "tiled"   # O-proj/down-proj allreduce: tiled|single
    ar_chunks: int = 4
    first_chunk_frac: float = 0.5

    @property
    def tp(self) -> int:
        return self.g * self.s


def plan_tp(cfg: ModelConfig, tp: int, page_size: int, *,
            collectives: str = "tiled", ar_chunks: int = 4,
            first_chunk_frac: float = 0.5) -> TPPlan:
    """Factor ``tp`` into (kv-head groups) x (page-row sub-shards) and
    validate the shapes divide.  Raises ValueError on impossible
    combinations rather than silently mis-sharding."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if collectives not in ("tiled", "single"):
        raise ValueError(f"tp_collectives must be 'tiled' or 'single', "
                         f"got {collectives!r}")
    g = math.gcd(tp, cfg.num_kv_heads)
    s = tp // g
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(
            f"GQA requires num_heads ({cfg.num_heads}) divisible by "
            f"num_kv_heads ({cfg.num_kv_heads})")
    hq_group = cfg.num_heads // g
    if hq_group % s:
        raise ValueError(
            f"tp={tp}: the {hq_group} query heads of each of the {g} "
            f"kv-head groups do not split over {s} page-row sub-shards "
            f"(O-proj is row-parallel over query-head slices)")
    if page_size % s:
        raise ValueError(
            f"tp={tp}: page_size={page_size} does not split into {s} "
            f"page-row sub-shards; pick a page size divisible by "
            f"tp // gcd(tp, num_kv_heads)")
    return TPPlan(g=g, s=s, collectives=collectives, ar_chunks=ar_chunks,
                  first_chunk_frac=first_chunk_frac)


def mlp_sharded(cfg: ModelConfig, plan: TPPlan) -> bool:
    """The MLP is column->row parallel only when d_ff divides over the
    ranks; otherwise every rank runs it whole (replicated)."""
    return cfg.d_ff % plan.tp == 0


@dataclass(frozen=True)
class TPContext:
    """An active plan bound to this process's rank and its groups."""
    plan: TPPlan
    rank: int
    world_group: object          # every rank (O-proj, down-proj)
    seq_group: object            # ranks [gi*s, (gi+1)*s) (the LSE merge)
    shard_mlp: bool              # mlp_sharded(cfg, plan)

    @property
    def gi(self) -> int:
        return self.rank // self.plan.s

    @property
    def si(self) -> int:
        return self.rank % self.plan.s


# (s, gi) -> the page-row subgroup of kv-head group gi under s sub-shards
_SEQ_GROUPS: dict = {}


def make_seq_groups(tp: int, timeout: datetime.timedelta) -> None:
    """Create every page-row subgroup a plan over a world of ``tp`` ranks
    can ask for: for each divisor ``s`` of ``tp``, ranks
    ``[gi * s, (gi + 1) * s)`` of each kv-head group ``gi``.
    ``new_group`` is collective: every rank calls this right after
    joining the world, so every rank creates every group in the same
    order."""
    _SEQ_GROUPS.clear()
    for s in range(2, tp + 1):
        if tp % s:
            continue
        for gi in range(tp // s):
            ranks = list(range(gi * s, (gi + 1) * s))
            _SEQ_GROUPS[(s, gi)] = (dist.group.WORLD if s == tp else
                                    dist.new_group(ranks, timeout=timeout))


def rank_context(cfg: ModelConfig, plan: TPPlan) -> TPContext:
    """This process's ``TPContext`` for ``plan``.  Raises ValueError
    unless a process group of exactly ``plan.tp`` ranks is initialised
    with its page-row subgroups (``launch.mesh.init_tp_group``)."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else None)
    if world != plan.tp:
        raise ValueError(
            f"tp={plan.tp} needs a torch.distributed process group of "
            f"{plan.tp} ranks (launch.mesh.init_tp_group), found "
            f"{'none' if world is None else f'{world} ranks'}")
    rank = dist.get_rank()
    seq = None
    if plan.s > 1:
        seq = _SEQ_GROUPS.get((plan.s, rank // plan.s))
        if seq is None:
            raise ValueError(f"no page-row subgroup for s={plan.s}: create "
                             "the process group with init_tp_group")
    return TPContext(plan=plan, rank=rank, world_group=dist.group.WORLD,
                     seq_group=seq, shard_mlp=mlp_sharded(cfg, plan))


_TP: contextvars.ContextVar = contextvars.ContextVar("tp_context",
                                                     default=None)


@contextlib.contextmanager
def tp_context(ctx: Optional[TPContext]):
    """Activate tensor parallelism for model code run inside (``None``:
    none).  ``layers/attention.py``, ``layers/mlp.py`` and the paged pool
    allocation read it and switch to their per-rank bodies."""
    token = _TP.set(ctx)
    try:
        yield
    finally:
        _TP.reset(token)


def current_tp() -> Optional[TPContext]:
    return _TP.get()


def shard_params(params: dict, cfg: ModelConfig, plan: TPPlan,
                 rank: int) -> dict:
    """Rank ``rank``'s slices of the model's parameters.

    QKV are column-parallel over the kv-head group ``gi`` (every page-row
    sub-shard of a group computes the group's full Q: the LSE merge needs
    every query head); the O-proj is row-parallel over the rank's 1/s
    query-head slice of its group; the MLP's up/gate columns and down
    rows are the rank's 1/tp of d_ff when it divides (``mlp_sharded``).
    Embeddings, norms and the LM head stay whole, as tensors shared with
    ``params``."""
    gi, si = divmod(rank, plan.s)
    dh = cfg.head_dim
    kvl = cfg.num_kv_heads // plan.g       # kv heads per group
    hq_g = cfg.num_heads // plan.g         # q heads per group
    hq_s = hq_g // plan.s                  # q heads per O-proj row slice
    q0, k0 = gi * hq_g * dh, gi * kvl * dh
    o0 = (gi * hq_g + si * hq_s) * dh
    q_cols = slice(q0, q0 + hq_g * dh)
    kv_cols = slice(k0, k0 + kvl * dh)

    def attn(p: dict) -> dict:
        out = {"wq": p["wq"][:, q_cols], "wk": p["wk"][:, kv_cols],
               "wv": p["wv"][:, kv_cols],
               "wo": p["wo"][o0:o0 + hq_s * dh]}
        if "bq" in p:
            out.update(bq=p["bq"][q_cols], bk=p["bk"][kv_cols],
                       bv=p["bv"][kv_cols])
        return {k: v.contiguous() for k, v in out.items()}

    fl = cfg.d_ff // plan.tp
    ff = slice(rank * fl, (rank + 1) * fl)

    def mlp(p: dict) -> dict:
        out = {k: p[k][:, ff] for k in ("w_up", "w_gate") if k in p}
        out["w_down"] = p["w_down"][ff]
        return {k: v.contiguous() for k, v in out.items()}

    layers = []
    for bp in params["layers"]:
        bp = dict(bp)
        if "attn" in bp:
            bp["attn"] = attn(bp["attn"])
        if "mlp" in bp and mlp_sharded(cfg, plan):
            bp["mlp"] = mlp(bp["mlp"])
        layers.append(bp)
    return {**params, "layers": layers}


def local_pool_shape(cfg: ModelConfig, num_pages: int,
                     page_size: int) -> tuple:
    """One layer's (Hkv, P, page_size, D) pool shape on this rank: under
    an active plan the group's kv heads and the rank's rows of every page.
    The page axis stays third from the end (``serving/pressure.py``)."""
    tpc = current_tp()
    if tpc is None:
        return (cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return (cfg.num_kv_heads // tpc.plan.g, num_pages,
            page_size // tpc.plan.s, cfg.head_dim)
