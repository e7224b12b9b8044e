"""Mixture-of-experts FFN with argsort-based capacity dispatch: the JAX
package's ``layers/moe.py`` with its exact semantics.

Top-k routing (``route``) -> per-row stable argsort by expert id and a
static capacity (``dispatch``) -> gather into (E, B * cap, D)
(``expert_inputs``) -> batched expert products (``expert_ffn``,
``torch.bmm``) -> weighted combine (``combine``).  The last three take
a contiguous range of experts: under expert parallelism each rank runs
its own experts' slots of the whole rows and the ranks' partial combines
are summed (``models/blocks.py``).  Each batch
row is its own group: capacity ``max(1, int(s * k / e * cf))`` counts
one row's assignments in one launch, so a decode step (s = 1) never
drops an assignment and a long prefill chunk may.  Assignments past an
expert's capacity are dropped (their slot is the dummy ``e * cap``); a
row's tokens claim slots in token order, so padding past a chunk's
``n_valid`` never displaces a valid token.

Where JAX's results depend on an order, the port keeps JAX's:
``top_k`` breaks ties to the lower expert index, as ``jax.lax.top_k``
does (``torch.topk`` does not); the argsort is stable; and the combine
sums each token's k weighted slot outputs in the order JAX's scatter-add
visits them (expert id ascending), in the activations' dtype, as a
gather -- no atomics, so a CUDA run is bit-identical run to run, its
backward too.

No kernel: JAX computes the block in plain code outside any Pallas call.
The expert products run over every (expert, slot), occupied or not, as
JAX's do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.layers import common


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    """Router (D, E) and expert weights (E, D, F), (E, F, D) from the JAX
    package's distributions, drawn from ``gen``."""
    d, f, e = cfg.d_model, cfg.expert_dff, cfg.num_experts

    def normal(shape, scale):
        return (common.normal(gen, shape) * scale).to(dtype)
    p = {"router": common.dense_init(gen, d, e, dtype),
         "w_up": normal((e, d, f), d ** -0.5),
         "w_down": normal((e, f, d), f ** -0.5)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = normal((e, d, f), d ** -0.5)
    return p


def moe_logical(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.expert_dff, cfg.num_experts
    p = {"router": (("d_model", None), (d, e)),
         "w_up": (("expert", "d_model", "ff"), (e, d, f)),
         "w_down": (("expert", "ff", "d_model"), (e, f, d))}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = (("expert", "d_model", "ff"), (e, d, f))
    return p


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, equal values by ascending index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, k: int):
    """Router logits (..., E) float32 -> (gates (..., k) float32,
    renormalised to sum 1, expert ids (..., k) int64)."""
    gates, idx = top_k(torch.softmax(logits, dim=-1), k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


class Dispatch(NamedTuple):
    """Each row's k * S assignments in sorted (expert, token) order."""
    order: torch.Tensor     # (B, S*k) flat assignment (token * k + j)
    dest: torch.Tensor      # (B, S*k) expert * cap + slot; e * cap: dropped
    keep: torch.Tensor      # (B, S*k) bool, slot < cap
    cap: int


def dispatch(idx: torch.Tensor, num_experts: int, cap: int) -> Dispatch:
    """Slots for expert ids ``idx`` (B, S, k): a stable argsort of each
    row's assignments by expert id; an assignment's slot is its place in
    its expert's run, kept when below ``cap``."""
    b, s, k = idx.shape
    flat = idx.reshape(b, s * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = torch.gather(flat, 1, order)
    experts = torch.arange(num_experts, device=idx.device)
    first = torch.searchsorted(sorted_e,
                               experts.expand(b, num_experts).contiguous())
    slot = (torch.arange(s * k, device=idx.device)
            - torch.gather(first, 1, sorted_e))
    keep = slot < cap
    dest = torch.where(keep, sorted_e * cap + slot, num_experts * cap)
    return Dispatch(order, dest, keep, cap)


class Routing(NamedTuple):
    gates: torch.Tensor     # (B, S, k) float32
    idx: torch.Tensor       # (B, S, k) expert ids
    plan: Dispatch


def routing(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
            capacity_factor: Optional[float] = None) -> Routing:
    """The router's logits (in x's dtype, then float32, as JAX), the
    top-k gates and the capacity dispatch of ``x`` (B, S, D)."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cf = capacity_factor or cfg.moe_capacity_factor
    cap = max(1, int(s * k / e * cf))       # JAX's expression, as floats
    logits = common.dense(x, params["router"]).float()
    gates, idx = route(logits, k)
    return Routing(gates, idx, dispatch(idx, e, cap))


def assignments_dropped(r: Routing, n_valid=None) -> tuple:
    """(dropped, total) assignments of a routing; with ``n_valid`` (B,)
    only those of each row's first n_valid tokens."""
    plan = r.plan
    k = r.idx.shape[-1]
    counted = torch.ones_like(plan.keep)
    if n_valid is not None:
        token = plan.order // k
        counted = token < n_valid.to(token.device)[:, None]
    return (int((counted & ~plan.keep).sum()), int(counted.sum()))


def expert_inputs(x: torch.Tensor, r: Routing, num_experts: int,
                  experts: tuple) -> torch.Tensor:
    """The tokens of experts ``[e0, e1)``'s slots, (e1 - e0, B * cap, D):
    slot (e, b, c) reads row b's token ``inv[b, e * cap + c]`` of x padded
    with a zero row (token s, the dummy: an empty slot)."""
    b, s, d = x.shape
    plan, cap = r.plan, r.plan.cap
    k = r.idx.shape[-1]
    e0, e1 = experts
    rows = torch.arange(b, device=x.device)[:, None]
    inv = torch.full((b, num_experts * cap + 1), s, dtype=torch.long,
                     device=x.device)
    inv.scatter_(1, plan.dest, plan.order // k)
    inv = inv[:, e0 * cap:e1 * cap] + rows * (s + 1)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1).reshape(-1, d)
    src = inv.reshape(b, e1 - e0, cap).transpose(0, 1).reshape(-1)
    # indexing, not index_select: its backward accumulates a token's slot
    # gradients by index_put's sorted sum, not index_add's atomics, so a
    # CUDA training step is bit-identical run to run
    return x_pad[src].reshape(e1 - e0, b * cap, d)


def expert_ffn(params: dict, xe: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The experts' FFN over every slot, occupied or not, as JAX's:
    (E', B * cap, D) -> (E', B * cap, D) against ``params``' E' experts."""
    dt = xe.dtype
    h = torch.bmm(xe, params["w_up"].to(dt))
    if "w_gate" in params:
        g = torch.bmm(xe, params["w_gate"].to(dt))
        act = (F.silu(g) if cfg.mlp_type == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["w_down"].to(dt))


def sum_slots(take, k: int) -> torch.Tensor:
    """``take(0) + take(1) + ... + take(k - 1)``, in that order and in
    their dtype: a token's k weighted expert outputs summed as JAX's
    combine sums them."""
    y = take(0)
    for j in range(1, k):
        y = y + take(j)
    return y


def combine(ye: torch.Tensor, r: Routing, num_experts: int,
            experts: tuple, slots: bool = False) -> torch.Tensor:
    """The partial combine of experts ``[e0, e1)``: each token's weighted
    outputs from the slots of those experts (``ye``, (e1 - e0, B * cap,
    D)) summed in expert order, (B, S, D); zero for a token with none.
    Over every expert it is the block's output; the partials of disjoint
    ranges sum to it (JAX's combine plan: only (B, S, D) crosses
    shards).

    With ``slots``: each token's k weighted outputs unsummed, (B, S, k,
    D) in summing order, zero in a slot that another range's expert (or
    a drop) holds.  The ranges' slot tensors then sum exactly (no slot
    is nonzero in two), and ``sum_slots`` over that sum is the block's
    output bit for bit."""
    el, _, d = ye.shape
    b, s, k = r.idx.shape
    plan, cap = r.plan, r.plan.cap
    e0, e1 = experts
    rows = torch.arange(b, device=ye.device)[:, None]
    # each slot's gate (f32, cast to the activations' dtype before the
    # multiply)
    gate_sorted = torch.gather(r.gates.reshape(b, s * k), 1, plan.order)
    slot_gate = torch.zeros((b, num_experts * cap + 1), dtype=torch.float32,
                            device=ye.device)
    slot_gate.scatter_(1, plan.dest, gate_sorted)
    slot_gate = slot_gate[:, e0 * cap:e1 * cap].reshape(
        b, el, cap).transpose(0, 1)
    weighted = (ye * slot_gate.reshape(el, b * cap, 1).to(ye.dtype)
                ).reshape(-1, d)
    weighted = torch.cat([weighted, weighted.new_zeros((1, d))])
    # each assignment's row of ``weighted`` -- the zero row when dropped
    # (expert id e) or another range's -- in assignment order, then each
    # token's k sorted by expert id
    dest = torch.empty_like(plan.dest).scatter_(1, plan.order, plan.dest)
    ex, c = dest // cap, dest % cap
    mine = (ex >= e0) & (ex < e1)
    src = torch.where(mine, ((ex - e0) * b + rows) * cap + c, el * b * cap)
    by_expert = torch.argsort(r.idx, dim=-1)
    src = torch.gather(src.reshape(b, s, k), 2, by_expert)
    if slots:
        return weighted[src]
    return sum_slots(lambda j: weighted[src[..., j]], k)


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: Optional[float] = None,
              experts: Optional[tuple] = None,
              slots: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Routing and dispatch of whole rows,
    then the expert FFN and the combine over experts ``[e0, e1)``
    (``experts``; by default every expert): ``params``' expert leaves
    then hold those e1 - e0 experts (the router is whole), and the result
    is their partial combine (``combine``; with ``slots`` unsummed)."""
    e = cfg.num_experts
    experts = experts or (0, e)
    r = routing(params, x, cfg, capacity_factor=capacity_factor)
    ye = expert_ffn(params, expert_inputs(x, r, e, experts), cfg)
    return combine(ye, r, e, experts, slots)
