"""Shared set-up of the tests that hold the port's EngineCore to the JAX
package's: reduced gemma2-2b with the JAX model's own weights on both
sides (``params_from_jax``), one engine of each package on the same
traffic, the greedy margin rule and the host state compared exactly.

Greedy streams must equal the JAX engine's up to the first token whose
top-1 margin in the JAX model is under ``MARGIN`` (a float32 near-tie the
two frameworks may break differently).  Every host counter listed in
``host_state`` must be equal exactly; a counter that depends on the
tokens (drafts, prefix hits on generated blocks) is compared only when
every stream is equal, which ``streams_match`` reports.
"""
import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.config import ParallelConfig
from repro.config import ServeConfig as JServe
from repro.config import get_model_config, reduce_for_smoke
from repro.models import build_model as j_build
from repro.serving.core import EngineCore as JCore
from repro.serving.faults import FaultInjector as JInjector
from repro.serving.scheduler import SamplingParams as JParams
from repro_torch.config import ServeConfig
from repro_torch.config import get_model_config as t_get
from repro_torch.config import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serving.core import EngineCore
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.scheduler import SamplingParams

from _torch_tp_ranks import host_state  # noqa: F401  (shared with ranks)

MARGIN = 1e-4


class Pair:
    """The JAX model and its port on the same weights, and engines of
    both packages on them.  ``head_dim`` replaces the reduced config's
    (16) on both sides."""

    def __init__(self, arch: str = "gemma2-2b",
                 head_dim: Optional[int] = None):
        self.jcfg = reduce_for_smoke(get_model_config(arch))
        self.tcfg = t_reduce(t_get(arch))
        if head_dim is not None:
            self.jcfg = dataclasses.replace(self.jcfg, head_dim=head_dim)
            self.tcfg = dataclasses.replace(self.tcfg, head_dim=head_dim)
        self.jm = j_build(self.jcfg, ParallelConfig(remat="none"))
        self.jp = self.jm.init(jax.random.PRNGKey(0))
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")
        self.tm = build_model(self.tcfg, "cpu")
        self.vocab = self.jcfg.vocab_size
        # the JAX engines share their jitted paged functions, so each
        # shape compiles once per test module
        self._jax_fns: dict = {}

    def jax_core(self, *, injector=None, **serve):
        return JCore(self.jm, self.jp, self.jcfg, JServe(**serve),
                     fn_cache=self._jax_fns, injector=injector)

    def torch_core(self, *, injector=None, **serve):
        return EngineCore(self.tm, self.tp, self.tcfg, ServeConfig(**serve),
                          device="cpu", injector=injector)

    def margins(self, prompt, generated) -> np.ndarray:
        """Top-1 margin of the JAX model at every generated position
        (teacher-forced full forward)."""
        seq = np.concatenate([np.asarray(prompt),
                              np.asarray(generated[:-1], np.int64)])
        logits = np.asarray(self.jm.apply(
            self.jp, jnp.asarray(seq.astype(np.int32)[None])))[0]
        rows = logits[len(prompt) - 1:]
        top2 = np.sort(rows, axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]


@contextlib.contextmanager
def pair_on_one_thread(arch: str = "gemma2-2b",
                       head_dim: Optional[int] = None):
    """A Pair with torch on one intra-op thread while a test module uses
    it: the reduced model's ops are too small to gain from threads, and
    idle pool threads would spin on cores the other test workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield Pair(arch, head_dim)
    finally:
        torch.set_num_threads(n)


def injectors(seed: int = 0, **arms):
    """One FaultInjector of each package with the same seed and
    schedules: ``arms`` maps a site to its ``arm`` keywords."""
    out = []
    for cls in (JInjector, FaultInjector):
        inj = cls(seed=seed)
        for site, kw in arms.items():
            inj.arm(site, **kw)
        out.append(inj)
    return out


def drive(core, waves, max_steps: int = 5000):
    """Submit each wave of ``(request_id, prompt, sampling kwargs)`` and
    step ``core`` until it is idle before the next wave.  Returns
    ({id: tokens}, {id: error detail}) -- the same on either package's
    core."""
    params = SamplingParams if isinstance(core, EngineCore) else JParams
    toks, errs = {}, {}
    steps = 0
    for wave in waves:
        for rid, prompt, kw in wave:
            core.add_request(prompt, params(**kw), request_id=rid)
            toks[rid] = []
        while core.has_work:
            steps += 1
            assert steps < max_steps, "engine never went idle"
            for ev in core.step():
                if ev.kind == "token":
                    toks[ev.request_id].append(ev.token)
                elif ev.kind == "error":
                    errs[ev.request_id] = ev.detail
    return toks, errs


def streams_match(pair: Pair, prompts: dict, got: dict, want: dict) -> bool:
    """Hold the port's streams ``got`` to the JAX engine's ``want`` under
    the margin rule; True when every stream is equal exactly."""
    assert got.keys() == want.keys()
    exact = True
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        exact = False
        margins = pair.margins(prompts[rid], np.asarray(w))
        for t, (a, b) in enumerate(zip(g, w)):
            if margins[t] < MARGIN:
                break                   # a near-tie: later tokens may fork
            assert a == b, (rid, t, g, w)
        else:
            assert len(g) == len(w), (rid, g, w)
    return exact
