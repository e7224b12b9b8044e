"""The port's repro-lint (``repro_torch.analysis.lint``) against the JAX
package's, on the CPU.

* JAX's fixture snippets (``tests/test_lint.py``), their paths mapped
  from ``repro/`` to ``repro_torch/``, give the same findings -- rule,
  code, line, column, severity, message -- from both engines under
  REPRO001-003 and 006-008, the rules the port keeps as they are;
* REPRO004 and REPRO005 read PyTorch's capture: they fire on functions
  given to ``torch.compile``, ``torch.jit.script`` / ``trace`` and
  ``torch.cuda.make_graphed_callables`` and on ``torch.cuda.graph``
  blocks, and stay silent on pure ones;
* suppressions, both reporters, the CLI's flags and exit codes;
* the port's own tree (``src/repro_torch``, ``tests/``) is clean, every
  intentional site suppressed with its reason.

Fixture modules are written under tmp_path as string literals, never as
checked-in files, so that neither package's sweep of the tree sees the
deliberate positives.
"""
from __future__ import annotations

import json
import os
import textwrap

import pytest

from repro.analysis import lint as jlint
from repro.analysis.lint.cli import build_rules as j_build_rules
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.lint.cli import build_rules, main as lint_main

SERVING = "repro_torch/serving/mod.py"
KEPT = ["unresolvable-except", "raw-wall-clock", "mutable-default",
        "metric-name-hygiene", "silent-drop", "swallowed-exception"]


def write(root, sources: dict) -> str:
    for rel, code in sources.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(code))
    return str(root)


def run_lint(tmp_path, sources, rules=None):
    """sources: {relpath: code} (or one code string at SERVING) written
    under tmp_path, then swept by the port's engine."""
    if isinstance(sources, str):
        sources = {SERVING: sources}
    engine = tlint.LintEngine(tlint.default_rules() if rules is None
                              else rules)
    return engine.run([write(tmp_path, sources)])


def active_rules(result):
    return sorted({f.rule for f in result.active})


# ---------------------------------------------------------------------------
# JAX's fixtures, both engines
# ---------------------------------------------------------------------------

# JAX's tests/test_lint.py fixtures, at their JAX paths (one code string:
# repro/serving/mod.py), each with the number of findings it must give
# under the kept rules (so that two empty results never pass for equal)
JAX_FIXTURES = {
    "unresolvable_except_positive": ("""
        def admit(self):
            try:
                self.alloc()
            except OutOfPages:
                return None
    """, 1),
    "unresolvable_except_negative": ("""
        from repro.serving.paging import OutOfPages
        import errors

        def admit(self):
            LocalError = ValueError
            try:
                self.alloc()
            except (OutOfPages, errors.Timeout, LocalError):
                return None
            except ValueError:
                return None
    """, 0),
    "raw_wall_clock_positive": ("""
        import time
        from time import perf_counter

        def step(self):
            t0 = time.perf_counter()
            t1 = perf_counter()
            return t1 - t0
    """, 2),
    "raw_wall_clock_negative": ("""
        import time

        class Core:
            def __init__(self, clock=None):
                self._clock = clock or time.monotonic

            def step(self):
                return self._clock()
    """, 0),
    "raw_wall_clock_out_of_scope": ({"repro/kernels/mod.py": """
        import time

        def bench():
            return time.perf_counter()
    """}, 0),
    "mutable_default_positive": ("""
        from dataclasses import dataclass

        def collect(x, acc=[], *, index={}):
            acc.append(x)

        @dataclass
        class Params:
            stop_strings: list = []
    """, 3),
    "mutable_default_negative": ("""
        from dataclasses import dataclass, field

        def collect(x, acc=None, *, index=None, k=3, name="q"):
            acc = [] if acc is None else acc

        @dataclass
        class Params:
            stop_strings: list = field(default_factory=list)

        class NotADataclass:
            registry = {}
    """, 0),
    "metric_names_positive": ({"repro/serving/m.py": """
        def setup(m):
            m.counter("engine_steps", help="missing total suffix")
            m.counter("requests_total", help="unknown prefix")
            m.histogram("engine_step_ms", (), help="bad unit")
    """}, 3),
    "metric_names_negative": ({"repro/serving/m.py": """
        def setup(m, k, phase):
            m.counter("engine_steps_total", help="ok")
            m.histogram("engine_step_seconds", (), help="ok")
            m.gauge("kv_pages_used", help="ok")
            m.inc(f"pressure_{k}_total")
            m.observe(f"engine_phase_{phase}_seconds", 0.1)
            arr.at[0].set(1.0)
            counter_obj.inc(3)
    """}, 0),
    "metric_duplicate_site": ({
        "repro/serving/a.py": """
            def setup(m):
                m.counter("engine_dup_total", help="owner")
        """,
        "repro/serving/b.py": """
            def setup(m):
                m.counter("engine_dup_total", help="squatter")
        """}, 1),
    "silent_drop_positive": ("""
        from collections import deque

        class EventBus:
            def __init__(self):
                self.orphans = deque(maxlen=1024)
    """, 1),
    "silent_drop_negative": ("""
        from collections import deque

        class CountingBus:
            def __init__(self):
                self.orphans = deque(maxlen=1024)
                self.dropped = 0

        class Unbounded:
            def __init__(self):
                self.log = deque()
                self.log2 = deque(maxlen=None)
    """, 0),
    "swallowed_exception_positive": ("""
        def step(self):
            try:
                self.launch()
            except:
                pass

        def drain(self):
            try:
                self.flush()
            except Exception:
                self.ok = False
    """, 2),
    "swallowed_exception_negative": ("""
        def step(self):
            try:
                self.launch()
            except Exception as e:
                raise EngineError(str(e))

        def drain(self):
            try:
                self.flush()
            except ValueError:
                pass

        def log_it(self):
            try:
                self.flush()
            except Exception as e:
                self.log.warning("flush failed: %s", e)
    """, 0),
    "inline_suppression": ("""
        import time

        def step(self):
            return time.perf_counter()  # repro-lint: disable=raw-wall-clock (why)
    """, 0),
    "standalone_suppression": ("""
        import time

        def step(self):
            # repro-lint: disable=raw-wall-clock
            return time.perf_counter()
    """, 0),
    "file_pragma_and_disable_all": ("""
        # repro-lint: disable-file=raw-wall-clock
        import time

        def a(self):
            return time.time()

        def b(self, x=[]):       # repro-lint: disable=all
            return time.monotonic()

        def c(self, y={}):
            pass
    """, 1),
    "suppression_does_not_leak": ("""
        import time

        def step(self):
            return time.perf_counter()  # repro-lint: disable=silent-drop
    """, 1),
    "syntax_error": ({"broken.py": "def f(:\n"}, 1),
}


def _key(f, root: str) -> tuple:
    """A finding as (path under the sweep's root, rule, code, line, col,
    severity, message with the root's paths relative, suppressed)."""
    rel = os.path.relpath(f.path, root).replace(os.sep, "/")
    return (rel, f.rule, f.code, f.line, f.col, f.severity,
            f.message.replace(root + "/", ""), f.suppressed)


@pytest.mark.parametrize("name", sorted(JAX_FIXTURES))
def test_kept_rules_give_jax_findings_on_jax_fixtures(tmp_path, name):
    sources, n_active = JAX_FIXTURES[name]
    if isinstance(sources, str):
        sources = {"repro/serving/mod.py": sources}
    ported = {rel.replace("repro/", "repro_torch/", 1): code
              for rel, code in sources.items()}
    jroot = write(tmp_path / "jax", sources)
    troot = write(tmp_path / "port", ported)
    jres = jlint.LintEngine(j_build_rules(select=KEPT)).run([jroot])
    tres = tlint.LintEngine(build_rules(select=KEPT)).run([troot])
    want = [_key(f, jroot) for f in jres.findings]
    got = [_key(f, troot) for f in tres.findings]
    assert got == [(rel.replace("repro/", "repro_torch/", 1), *rest[:5],
                    rest[5].replace("repro/", "repro_torch/"), rest[6])
                   for rel, *rest in want]
    assert len(tres.active) == n_active
    assert tres.files_checked == jres.files_checked


def test_rule_catalogue_is_jaxs():
    assert [(r.name, r.code, r.severity) for r in tlint.ALL_RULES] == \
        [(r.name, r.code, r.severity) for r in jlint.ALL_RULES]
    for r in tlint.ALL_RULES:
        assert r.description and all(
            p.startswith("repro_torch/") for p in r.paths), r.name


def test_kept_rules_are_scoped_to_the_port(tmp_path):
    """The port's rules read ``repro_torch/...``, not the JAX package's
    ``repro/...``: a raw clock read in JAX's serving code is not theirs."""
    res = run_lint(tmp_path, {"repro/serving/mod.py": """
        import time

        def step(self):
            return time.perf_counter()
    """})
    assert res.active == []


# ---------------------------------------------------------------------------
# REPRO004 trace-impurity: PyTorch's capture
# ---------------------------------------------------------------------------

def test_capture_impurity_torch_compile(tmp_path):
    res = run_lint(tmp_path, """
        import random
        import time
        import torch

        def decode(params, tok, core):
            core.count += 1
            print("decoding", tok)
            t = time.perf_counter()
            r = random.random()
            core.metrics.observe("engine_step_seconds", t)
            return tok

        run = torch.compile(decode)
    """)
    msgs = [f.message for f in res.active if f.rule == "trace-impurity"]
    assert len(msgs) == 5, msgs
    assert any("mutates attribute" in m for m in msgs)
    assert any("print()" in m for m in msgs)
    assert any("host clock" in m for m in msgs)
    assert any("host RNG" in m for m in msgs)
    assert any("metrics-registry" in m for m in msgs)
    assert all("captured function 'decode'" in m
               or "function 'decode'" in m for m in msgs)
    assert not any("jit" in m for m in msgs)


@pytest.mark.parametrize("decorator", [
    "@torch.compile", "@torch.compile(mode='reduce-overhead')",
    "@torch.jit.script", "@functools.partial(torch.compile, dynamic=False)",
    "@compile_"])
def test_capture_impurity_decorated_and_aliased(tmp_path, decorator):
    res = run_lint(tmp_path, f"""
        import functools
        import torch
        from torch import compile as compile_

        {decorator}
        def step(x, core):
            core.steps += 1
            return x
    """)
    hits = [f for f in res.active if f.rule == "trace-impurity"]
    assert len(hits) == 1 and "core.steps" in hits[0].message


def test_capture_impurity_graph_block_and_callees(tmp_path):
    """The body of a ``torch.cuda.graph`` block, and a module-local
    function it calls, are captured; the code around the block is not."""
    res = run_lint(tmp_path, """
        import time
        import torch

        def body(model, x):
            print("in the graph")
            return model(x)

        def capture(model, x, g):
            print("before capture")
            with torch.cuda.graph(g):
                y = body(model, x)
                t = time.perf_counter()
            return y
    """)
    hits = [f for f in res.active if f.rule == "trace-impurity"]
    assert sorted(f.line for f in hits) == [6, 13], hits
    assert any("torch.cuda.graph block in capture" in f.message
               for f in hits)


def test_capture_impurity_graphed_callables_and_partial(tmp_path):
    res = run_lint(tmp_path, """
        import functools
        import numpy as np
        import torch

        def fwd(x, scale):
            return x * np.random.rand()

        def bwd(x, state):
            state.calls += 1
            return x

        fns = torch.cuda.make_graphed_callables((fwd, bwd), (None,))
        step = torch.jit.trace(functools.partial(fwd, scale=2), (None,))
    """)
    msgs = sorted(f.message for f in res.active
                  if f.rule == "trace-impurity")
    assert len(msgs) == 2
    assert "host RNG np.random.rand()" in msgs[1]
    assert "'state.calls'" in msgs[0]


@pytest.mark.parametrize("test_expr", ["torch.isnan(logits).any()",
                                       "logits.max().item() > 0",
                                       "torch.any(logits > 1)"])
def test_capture_impurity_branch_on_tensor_value(tmp_path, test_expr):
    res = run_lint(tmp_path, f"""
        import torch

        @torch.compile
        def guard(logits):
            if {test_expr}:
                return logits * 0
            return logits
    """)
    hits = [f for f in res.active if f.rule == "trace-impurity"]
    assert len(hits) == 1 and "tensor's value" in hits[0].message
    assert hits[0].line == 6 and "torch.where" in hits[0].message


def test_capture_impurity_true_negative(tmp_path):
    """A pure captured function; host effects outside the captured
    region; an uncaptured function of the same impurities."""
    res = run_lint(tmp_path, """
        import time
        import torch

        @torch.compile
        def decode(params, tok, causal=True):
            if causal:                      # static python flag: fine
                tok = tok + 1
            return torch.maximum(tok, torch.zeros_like(tok))

        def host_loop(core, clock, g, x):
            print("stepping")
            core.steps += 1
            with torch.cuda.graph(g):
                y = decode(None, x)
            return clock(), time.perf_counter(), y
    """)
    assert "trace-impurity" not in active_rules(res)


# ---------------------------------------------------------------------------
# REPRO005 retrace-hazard: recompiles and graph misses
# ---------------------------------------------------------------------------

def test_retrace_hazard_torch_compile(tmp_path):
    res = run_lint(tmp_path, """
        import torch

        run = torch.compile(lambda p, t: t)

        def prefill(self, req, start):
            toks = req.prefill_tokens[start:]
            return run(self.params, torch.as_tensor(toks[None]))
    """)
    hits = [f for f in res.active if f.rule == "retrace-hazard"]
    assert len(hits) == 1 and hits[0].line == 8
    assert "prefill_tokens" in hits[0].message
    assert "compiled or graphed 'run'" in hits[0].message


def test_retrace_hazard_graphed_attribute_and_decorated(tmp_path):
    res = run_lint(tmp_path, """
        import torch

        @torch.compile
        def verify(params, x):
            return x

        class Core:
            def __init__(self, fn, sample):
                self._step = torch.cuda.make_graphed_callables(fn, sample)

            def step(self, req):
                n = len(req.prompt)
                self._step(torch.zeros(n))
                return verify(self.params, x=req.drafts[:3])
    """)
    hits = [f for f in res.active if f.rule == "retrace-hazard"]
    assert [f.line for f in hits] == [14, 15]
    assert "len() of per-request 'prompt'" in hits[0].message
    assert "sliced from per-request 'drafts'" in hits[1].message


def test_retrace_hazard_true_negative(tmp_path):
    res = run_lint(tmp_path, """
        import torch

        run = torch.compile(lambda p, t: t)

        def prefill(self, req):
            chunk = torch.zeros((self.serve.prefill_chunk,), dtype=torch.int32)
            return run(self.params, chunk)

        def eager(self, req):
            toks = req.prompt[1:]
            return self.model(toks)
    """)
    assert "retrace-hazard" not in active_rules(res)


def test_no_compiled_names_by_default():
    rule = tlint.RULE_INDEX["retrace-hazard"]()
    assert rule.config["extra_jitted_names"] == ()


# ---------------------------------------------------------------------------
# suppressions, reporters, the CLI
# ---------------------------------------------------------------------------

def test_capture_suppression_with_reason(tmp_path):
    res = run_lint(tmp_path, """
        import torch

        def body(core, x):
            core.captures += 1  # repro-lint: disable=trace-impurity (capture count)
            return x

        step = torch.compile(body)
    """)
    assert res.active == [] and len(res.suppressed) == 1
    assert res.suppressed[0].code == "REPRO004"


def test_reporters(tmp_path):
    res = run_lint(tmp_path, """
        import time

        def step(self):
            return time.time()
    """)
    payload = json.loads(tlint.render_json(res))
    assert payload["tool"] == "repro-lint" and payload["version"] == 1
    assert payload["files_checked"] == 1
    assert payload["summary"] == {"errors": 1, "warnings": 0,
                                  "suppressed": 0}
    (f,) = payload["findings"]
    assert f["rule"] == "raw-wall-clock" and f["code"] == "REPRO002"
    assert f["line"] == 5 and f["path"].endswith(SERVING)
    out = tlint.render_text(res)
    assert "mod.py:5:" in out and "[REPRO002 raw-wall-clock]" in out
    assert "1 findings (0 suppressed)" in out


def test_cli_exit_codes_and_flags(tmp_path, capsys):
    clean = tmp_path / "repro_torch" / "serving" / "ok.py"
    clean.parent.mkdir(parents=True)
    clean.write_text("x = 1\n")
    assert lint_main([str(tmp_path)]) == 0
    dirty = tmp_path / "repro_torch" / "serving" / "bad.py"
    dirty.write_text("import time\n\n\ndef f(x=[]):\n"
                     "    return time.time()\n")
    capsys.readouterr()
    assert lint_main([str(tmp_path), "--format=json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["summary"]["errors"] == 2
    assert lint_main([str(tmp_path), "--select", "silent-drop"]) == 0
    assert lint_main([str(tmp_path), "--ignore", "raw-wall-clock",
                      "--ignore", "mutable-default"]) == 0
    assert lint_main([str(tmp_path), "--severity", "raw-wall-clock=warning",
                      "--severity", "mutable-default=warning"]) == 0
    capsys.readouterr()
    assert lint_main([str(tmp_path), "--show-suppressed"]) == 1
    assert lint_main([]) == 2                      # no paths
    assert lint_main([str(tmp_path), "--select", "nope"]) == 2
    assert lint_main([str(tmp_path), "--severity", "raw-wall-clock"]) == 2
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    for r in tlint.ALL_RULES:
        assert f"{r.code}  {r.name}" in listing
    assert "repro_torch/serving/" in listing


def test_build_rules_select_ignore_severity():
    names = [r.name for r in build_rules(select=["trace-impurity"])]
    assert names == ["trace-impurity"]
    assert "retrace-hazard" not in [r.name for r in
                                    build_rules(ignore=["retrace-hazard"])]
    (rule,) = [r for r in build_rules(severity=["silent-drop=warning"])
               if r.name == "silent-drop"]
    assert rule.severity == "warning"
    with pytest.raises(ValueError, match="error|warning"):
        build_rules(severity=["silent-drop=fatal"])


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_tree_lints_clean():
    """``python -m repro_torch.analysis.lint src/repro_torch tests/``
    finds nothing; the intentional sites are suppressed, each with its
    reason, not absent."""
    res = tlint.lint_paths(os.path.join(ROOT, "src", "repro_torch"),
                           os.path.join(ROOT, "tests"))
    assert res.files_checked > 100
    assert res.active == [], "\n" + tlint.render_text(res)
    by_rule = {}
    for f in res.suppressed:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        line = open(f.path, encoding="utf-8").read().splitlines()[f.line - 1]
        assert "repro-lint: disable=" in line and "(" in line.split(
            "repro-lint:")[1], f.location()
    assert by_rule == {"raw-wall-clock": 13, "silent-drop": 3}


def test_cli_on_the_port_tree_exits_zero(capsys):
    assert lint_main([os.path.join(ROOT, "src", "repro_torch"),
                      os.path.join(ROOT, "tests")]) == 0
    assert "0 findings (16 suppressed): clean" in capsys.readouterr().out
