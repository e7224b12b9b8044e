"""Configuration for the PyTorch port: model, parallel, train and serving
configs.

A copy of the JAX package's ``ModelConfig``, ``TrainConfig``,
``ServeConfig``, registry and ``reduce_for_smoke`` (the port imports
nothing of that package), field for field, so one set of keyword
arguments configures both; ``ParallelConfig`` keeps the part the trainer
and the offload planner read.  Fields of subsystems not ported yet (MoE,
SSM, M-RoPE, preemption/swap, prefix cache, speculation, tensor
parallelism) are kept for that reason; the model, the trainer and the
engine refuse the settings that would need them.  Configs are plain
frozen dataclasses; ``repro_torch.configs`` registers the architectures
the port runs.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block kinds understood by models/lm.py.  A model is a (possibly repeating)
# pattern of these:
#   attn        -- pre-norm GQA attention + MLP (dense transformer layer)
#   attn_local  -- same but sliding-window attention
#   moe         -- attention + mixture-of-experts FFN
#   mlstm       -- xLSTM matrix-LSTM block (no separate FFN)
#   slstm       -- xLSTM scalar-LSTM block
#   hymba       -- parallel attention + mamba heads sharing one residual
#   hymba_local -- hymba with sliding-window attention heads
# (the port serves attn and attn_local; models/blocks.py refuses the rest)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Per-layer block pattern.  ``block_pattern`` is tiled/truncated to
    # ``num_layers``; default is all-"attn".
    block_pattern: tuple = ("attn",)

    # --- attention options -------------------------------------------------
    # auto | kernel | reference: "auto" is the CUDA kernel for CUDA tensors
    # and the plain version for CPU tensors; "pallas" (the JAX package's
    # name) is accepted for "kernel"
    attention_impl: str = "auto"
    causal: bool = True
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    window_size: Optional[int] = None   # for *_local blocks
    rope_type: str = "rope"             # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: tuple = (16, 24, 24)  # M-RoPE split of head_dim//2

    # --- norms / mlp --------------------------------------------------------
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    mlp_type: str = "swiglu"            # swiglu | geglu | gelu
    post_norm: bool = False             # gemma2-style post-block norms

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_dff: int = 0                    # per-expert hidden (0 -> use d_ff)

    # --- SSM / recurrent ----------------------------------------------------
    ssm_state_size: int = 16            # mamba state (hymba)
    mlstm_proj_factor: float = 2.0      # xLSTM up-projection factor
    conv_kernel: int = 4                # mamba local conv width

    # --- encoder-decoder (whisper) ------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500             # audio frames after conv stub
    modality: str = "text"              # text | audio_stub | vision_stub

    # --- embeddings / dtypes -------------------------------------------------
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    embed_scale: bool = False           # gemma-style sqrt(d) embedding scale

    # ------------------------------------------------------------------
    def blocks(self) -> tuple:
        """The per-layer block-kind tuple, length == num_layers."""
        pat = self.block_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# ---------------------------------------------------------------------------
# Parallel / memory configuration (the part the trainer and the offload
# planner read)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    # Mesh shape.  The port trains on one device: data or model above 1
    # raise NotImplementedError (tensor parallelism is a later slice).
    data: int = 1
    model: int = 1
    # none | full | selective.  "full" recomputes each block in the
    # backward (torch.utils.checkpoint, non-reentrant); "selective" runs
    # as "full" -- the same numbers with more recompute (the JAX policy
    # keeps the matmul outputs, which torch's checkpoint cannot select).
    remat: str = "selective"
    microbatches: int = 1               # gradient accumulation steps

    # --- paper T4: CPU-GPU cooperative offload (core/offload.py) ---------
    # offload_kv=True raises NotImplementedError: no decode path routes
    # its layers to a HostOffloadEngine yet (nor does the JAX package's)
    offload_kv: bool = False
    host_memory_gb: float = 512.0
    device_memory_gb: float = 80.0      # one H100 SXM's HBM3

    def __post_init__(self):
        if self.data != 1 or self.model != 1:
            raise NotImplementedError(
                f"data={self.data}, model={self.model}: the port trains on "
                "one device (tensor/data parallelism is not ported yet)")
        if self.offload_kv:
            raise NotImplementedError(
                "offload_kv: no decode path reads host KV yet; drive "
                "core.offload.HostOffloadEngine directly")
        if self.remat not in ("none", "full", "selective"):
            raise ValueError(f"unknown remat {self.remat!r}")


# ---------------------------------------------------------------------------
# Training runtime config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3
    log_every: int = 10


# ---------------------------------------------------------------------------
# Serving runtime config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq_len: int = 4096
    # DEPRECATED engine-global sampling knobs: requests carry their own
    # frozen SamplingParams (serving/scheduler.py) with a counter-based
    # per-request RNG stream.  These fields survive only as the defaults
    # for requests submitted without params (the EngineCore warns once
    # per core when they were changed from these values) and for the
    # dense ServeEngine.generate path.
    temperature: float = 1.0
    top_k: int = 0                 # 0 = no truncation (1 = greedy)
    seed: int = 0

    # --- paged KV + continuous batching (EngineCore) --------------------
    # Tokens per KV page; the paged CUDA kernels take any page size.
    page_size: int = 128
    # Physical pages in the shared pool (page 0 is scratch).  0 = auto:
    # enough for max_batch sequences of max_seq_len, i.e. a dense cache's
    # worth.  The port's EngineCore refuses a smaller pool (oversubscribing
    # needs the preemption subsystem, which is not ported yet).
    num_pages: int = 0
    # paged attention impl: auto | paged | paged_reference
    # (auto = the CUDA kernels for CUDA tensors, the plain PyTorch
    # versions for CPU tensors).
    paged_impl: str = "auto"

    # --- chunked prefill (Sarathi-style prefill/decode interleaving) ---
    # Prompt tokens per prefill kernel launch (the tiled-forward chunk).
    # 0 = auto: 4 pages.  Jit traces are keyed by this, never by prompt
    # length.
    prefill_chunk: int = 0
    # Prefill tokens per engine step before the fused decode step for
    # all running slots; 0 = auto (one chunk).  A soft cap, rounded up
    # to whole chunks (worst case budget + prefill_chunk - 1 tokens).
    # Smaller = lower decode latency under long-prompt arrival, larger
    # = faster TTFT.
    prefill_token_budget: int = 0
    # "chunked" = tiled full-forward prefill (the fast path); "scan" =
    # legacy token-at-a-time teacher forcing, kept as the equivalence
    # oracle.
    prefill_mode: str = "chunked"

    # --- page pressure: optimistic admission + preemption ---------------
    # "optimistic" admits a request when its *prompt* fits beside a small
    # watermark reserve -- decode growth is backed by preemption instead
    # of a reservation.  "reserved" is the PR 1 worst-case-reservation
    # baseline (admission gated on prompt + max_new_tokens; never
    # preempts), kept for the over-subscription bench comparison.
    admission: str = "optimistic"
    # Free pages held back at admission so steady decode growth rarely
    # trips a preemption the very next step.  0 = auto (half the slots).
    watermark_pages: int = 0
    # Victim handling under OutOfPages: "swap" copies the victim's KV
    # pages to the host page pool and restores them on resume (exact);
    # "recompute" re-prefills prompt + generated tokens through chunked
    # prefill; "auto" picks per victim via the PCIe/FLOPs cost model
    # (core/offload.py:preempt_cost_model).
    preempt_policy: str = "auto"
    # Host page pool capacity (in pages) for swapped-out KV; 0 =
    # unbounded.  A full host pool downgrades swap victims to recompute.
    host_pool_pages: int = 0
    # Run PagedKVCache.check_invariants every engine step (debug/tests).
    debug_invariants: bool = False

    # --- prefix cache: cross-request KV reuse ---------------------------
    # Radix-tree prefix cache (serving/prefix_cache.py): retiring
    # sequences publish their page-aligned prefix blocks; a new request
    # shares the longest matching cached page run copy-on-write and
    # skips recomputing it (chunked prefill starts at matched_len).  The
    # paged state (page manager, index, device pools) then persists
    # across generate_stream calls on the same engine.  Greedy outputs
    # stay bit-identical to a cold run -- shared pages hold exactly the
    # KV the prefix would recompute.
    prefix_cache: bool = False
    # Cap on pages the index may keep resident (LRU leaf eviction);
    # 0 = unbounded -- the pool itself is the bound, with leaves
    # reclaimed whenever the free list runs low.
    prefix_cache_pages: int = 0

    # --- fault tolerance & graceful degradation (serving/faults.py) -----
    # Non-finite (NaN/Inf) logits: "fail" quarantines only the offending
    # request (terminal FAILED state + a structured error event, pages
    # freed, co-tenants untouched); "ignore" keeps the pre-guard
    # behaviour (argmax over a NaN row is garbage-but-defined).
    logit_guard: str = "fail"
    # Bound on the waiting queue (0 = unbounded, the legacy behaviour).
    # An over-offered engine then degrades by policy instead of queueing
    # without limit.
    max_waiting: int = 0
    # What a full waiting queue does to the next submit: "reject" raises
    # a structured RequestRejected at add_request; "shed_oldest" fails
    # the oldest waiting request (error event) and admits the newcomer.
    queue_policy: str = "reject"
    # Transient swap DMA failures (device<->host page copies) are
    # retried this many times with bounded exponential backoff before
    # the victim is downgraded to recompute via the preemption cost
    # path -- a swap fault never fails the request.
    swap_retries: int = 3
    # Base of the retry backoff (seconds); attempt k sleeps
    # min(base * 2**k, 0.1).  0 disables sleeping (tests).
    swap_retry_backoff_s: float = 0.0

    # --- telemetry (serving/metrics.py) ---------------------------------
    # Master switch for the engine telemetry subsystem: per-step phase
    # timings, per-request lifecycle spans (TTFT/TPOT/queue-delay
    # histograms) and the step flight recorder.  The registry itself
    # (counters backing ``stats()``) always runs -- it is a handful of
    # integer adds per step; this gates the clock reads.  All telemetry
    # is host-side only and can never change jit trace counts.
    metrics: bool = True
    # Ring-buffer depth of the step flight recorder: how many recent
    # step records survive for an ``EngineError``/quarantine postmortem
    # dump (and the Chrome trace_event export).
    flight_recorder_steps: int = 64

    # --- speculative decoding (serving/spec.py) -------------------------
    # "off" keeps the one-token-per-launch decode step byte-for-byte;
    # "lookup" drafts continuation tokens from each request's own
    # prompt+generated text (prompt-lookup n-gram matching, no second
    # model) and verifies all of them in one chunked paged-prefill
    # launch.  Greedy token streams are bit-identical either way.
    spec_mode: str = "off"
    # Max drafted tokens per request per step (the verify launch scores
    # spec_tokens + 1 positions).  Per-request adaptive K shrinks below
    # this from a running accept-rate EMA.
    spec_tokens: int = 4
    # Suffix n-gram lengths the prompt-lookup drafter matches, tried
    # longest-first.
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # EMA smoothing for the per-request accept-rate estimate driving
    # adaptive K; 0 disables adaptation (always draft spec_tokens).
    spec_ema_alpha: float = 0.5

    # --- tensor parallelism (sharding/tp.py) ----------------------------
    # Device count to shard attention + KV page pools over.  Factored as
    # gcd(tp, num_kv_heads) kv-head groups x within-page row sub-shards
    # (partial attention outputs merge exactly via the LSE combination),
    # so tp may exceed the KV head count.  1 = single-device engine.
    tp: int = 1
    # O-proj / down-proj partial-sum collectives: "tiled" overlaps the
    # AllReduce with per-chunk matmuls (paper §4.2 T3); "single" is the
    # monolithic baseline the serving benchmark compares against.
    tp_collectives: str = "tiled"
    tp_ar_chunks: int = 4
    tp_first_chunk_frac: float = 0.5

    @property
    def sampling_overridden(self) -> bool:
        """True when the deprecated engine-global sampling knobs were
        changed from their defaults -- the EngineCore warns (once) only
        when a params-less request actually inherits such a change."""
        return (self.temperature, self.top_k) != (1.0, 0)

    @property
    def watermark(self) -> int:
        return self.watermark_pages or max(1, self.max_batch // 2)

    @property
    def max_pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    @property
    def prefill_chunk_tokens(self) -> int:
        return self.prefill_chunk or 4 * self.page_size

    @property
    def prefill_budget_tokens(self) -> int:
        return max(self.prefill_token_budget or self.prefill_chunk_tokens, 1)

    def pool_pages(self) -> int:
        if self.num_pages:
            return self.num_pages
        return self.max_batch * self.max_pages_per_seq + 1



# ---------------------------------------------------------------------------
# Registry + CLI
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(name: str, fn: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = fn


def available_archs() -> Sequence[str]:
    _load_builtin_configs()
    return sorted(_REGISTRY)


def get_model_config(name: str) -> ModelConfig:
    _load_builtin_configs()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name]()


_LOADED = False


def _load_builtin_configs() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import repro_torch.configs  # noqa: F401  (imports register all built-ins)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """A tiny config of the same family for CPU smoke tests.

    Keeps the block pattern (truncated), GQA-ness, and every structural
    feature; shrinks widths/layers/vocab.
    """
    n_layers = min(cfg.num_layers, 2 if not cfg.is_encoder_decoder else 2)
    kv = min(cfg.num_kv_heads, 2)
    q_per_kv = max(1, cfg.num_heads // cfg.num_kv_heads)
    heads = kv * q_per_kv
    head_dim = 16
    updates = dict(
        num_layers=n_layers,
        d_model=heads * head_dim,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=4 * heads * head_dim if cfg.d_ff else 0,
        vocab_size=256,
        window_size=32 if cfg.window_size else None,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.num_experts:
        updates.update(num_experts=4,
                       num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                       moe_dff=64)
    if cfg.is_encoder_decoder:
        updates.update(encoder_layers=2, encoder_seq=16)
    if cfg.mrope_sections and cfg.rope_type == "mrope":
        updates.update(mrope_sections=(2, 3, 3))
    return replace(cfg, **updates)

