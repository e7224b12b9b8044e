"""The repro-lint rule catalogue of the port: the serving engine's bug
taxonomy, with the JAX package's rule names, codes, messages and
suppression syntax, scoped to the port's paths (``repro_torch/...``).

Two rules read PyTorch's capture instead of JAX's tracing.  A CUDA graph
(``torch.cuda.graph``, ``torch.cuda.make_graphed_callables``) runs a
function's host effects once, at capture, and replays only its kernels;
``torch.compile`` and ``torch.jit.script`` / ``trace`` run them when
they compile.  A host clock, a host RNG draw, a metrics touch or a
branch on a tensor's value inside the captured region is baked in, and
shapes that vary per request recompile or miss the graph, as they
retrace a jit:

========================  =========  =====================================
rule                      code       bug class / guarantee
========================  =========  =====================================
unresolvable-except       REPRO001   ``except OutOfPages:`` with the name
                                     never imported -- a latent NameError
                                     on a rarely-taken path
raw-wall-clock            REPRO002   a stray ``time.perf_counter()`` in
                                     ``EngineCore.step`` corrupting phase
                                     telemetry; all engine timing must
                                     ride the injectable clock
mutable-default           REPRO003   shared mutable dataclass / keyword
                                     defaults
trace-impurity            REPRO004   host-side effects inside a function
                                     captured by torch.compile, TorchScript
                                     or a CUDA graph run once at capture
retrace-hazard            REPRO005   compiled or graphed callables given
                                     shapes from per-request values
                                     (prompt length) recompile or miss the
                                     graph per request
metric-name-hygiene       REPRO006   registry names must follow the
                                     ``engine_*|kv_*|pressure_*|prefix_*``
                                     + ``_total``/``_seconds`` conventions
                                     and be created at exactly one site
silent-drop               REPRO007   bounded deques that evict without
                                     counting (orphan events)
swallowed-exception       REPRO008   bare ``except:`` / broad handlers
                                     that swallow errors in engine code
========================  =========  =====================================
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.lint.framework import (Finding, ModuleContext,
                                                 Rule, dotted_name)

__all__ = ["ALL_RULES", "default_rules", "RULE_INDEX"]

_CLOCK_ATTRS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
                "monotonic_ns", "process_time", "process_time_ns",
                "time_ns"}


# ---------------------------------------------------------------------------
# REPRO001 -- unresolvable-except
# ---------------------------------------------------------------------------

class UnresolvableExcept(Rule):
    name = "unresolvable-except"
    code = "REPRO001"
    description = ("every name in an except clause must resolve to an "
                   "import or binding visible in the module (a "
                   "never-imported OutOfPages handler is a latent "
                   "NameError on the rarely-taken path)")
    node_types = (ast.ExceptHandler,)

    def visit(self, node: ast.ExceptHandler, ctx: ModuleContext
              ) -> Iterable[Finding]:
        if node.type is None:
            return                      # bare except: REPRO008's domain
        roots: List[ast.Name] = []
        exprs = (node.type.elts if isinstance(node.type, ast.Tuple)
                 else [node.type])
        for expr in exprs:
            while isinstance(expr, ast.Attribute):
                expr = expr.value
            if isinstance(expr, ast.Name):
                roots.append(expr)
        known = ctx.module_names
        for root in roots:
            if root.id in known:
                continue
            if any(root.id in ctx.scope_locals(s)
                   for s in ctx.enclosing_scopes(node)):
                continue
            yield self.finding(
                ctx, root,
                f"name {root.id!r} in except clause resolves to no "
                f"import or binding in this module -- the handler "
                f"raises NameError the first time the exception "
                f"actually fires")


# ---------------------------------------------------------------------------
# REPRO002 -- raw-wall-clock
# ---------------------------------------------------------------------------

class RawWallClock(Rule):
    name = "raw-wall-clock"
    code = "REPRO002"
    description = ("no direct time.time/perf_counter/monotonic calls in "
                   "engine/launch/training code: route timing through an "
                   "injectable clock attribute (EngineCore._clock) so "
                   "frozen-clock tests cover every timing path")
    paths = ("repro_torch/serving/", "repro_torch/launch/",
             "repro_torch/training/")
    node_types = (ast.Call,)
    default_config = {"clock_attrs": ("_clock", "clock")}

    def start_module(self, ctx: ModuleContext) -> None:
        imports = ctx.imported_modules()
        self._time_aliases = {local for local, mod in imports.items()
                              if mod == "time"}
        self._from_time = {local for local, mod in imports.items()
                           if mod.startswith("time.")
                           and mod.split(".", 1)[1] in _CLOCK_ATTRS}

    def visit(self, node: ast.Call, ctx: ModuleContext
              ) -> Iterable[Finding]:
        func = node.func
        hit: Optional[str] = None
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id in self._time_aliases \
                and func.attr in _CLOCK_ATTRS:
            hit = f"{func.value.id}.{func.attr}"
        elif isinstance(func, ast.Name) and func.id in self._from_time:
            hit = func.id
        if hit is not None:
            attrs = ", ".join(f"self.{a}"
                              for a in self.config["clock_attrs"])
            yield self.finding(
                ctx, node,
                f"direct wall-clock read {hit}() -- route timing "
                f"through an injectable clock attribute ({attrs}) so "
                f"frozen-clock tests observe it; bind the clock "
                f"function once (e.g. `clock or time.monotonic`) "
                f"instead of calling the module directly")


# ---------------------------------------------------------------------------
# REPRO003 -- mutable-default
# ---------------------------------------------------------------------------

_MUTABLE_FACTORIES = {"list", "dict", "set", "deque", "defaultdict",
                      "Counter", "OrderedDict", "bytearray"}


def _mutable_default(node: Optional[ast.AST]) -> Optional[str]:
    """Describe the mutable default, or None when the value is safe."""
    if node is None:
        return None
    if isinstance(node, ast.List):
        return "[]" if not node.elts else "a list literal"
    if isinstance(node, ast.Dict):
        return "{}" if not node.keys else "a dict literal"
    if isinstance(node, ast.Set):
        return "a set literal"
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp)):
        return "a comprehension"
    if isinstance(node, ast.Call):
        dn = dotted_name(node.func)
        if dn is not None and dn.split(".")[-1] in _MUTABLE_FACTORIES:
            return f"{dn}()"
    return None


def _is_dataclass_decorated(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        dn = dotted_name(target)
        if dn is not None and dn.split(".")[-1] == "dataclass":
            return True
    return False


class MutableDefault(Rule):
    name = "mutable-default"
    code = "REPRO003"
    description = ("keyword defaults and dataclass field defaults must "
                   "not be []/{}/set() or other shared mutable "
                   "instances: one instance is shared by every "
                   "call/instance")
    node_types = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                  ast.ClassDef)

    def visit(self, node: ast.AST, ctx: ModuleContext
              ) -> Iterable[Finding]:
        if isinstance(node, ast.ClassDef):
            if not _is_dataclass_decorated(node):
                return
            for stmt in node.body:
                value = None
                if isinstance(stmt, ast.AnnAssign):
                    value = stmt.value
                elif isinstance(stmt, ast.Assign):
                    value = stmt.value
                desc = _mutable_default(value)
                if desc:
                    yield self.finding(
                        ctx, stmt,
                        f"dataclass field default is {desc}: one "
                        f"instance is shared by every {node.name} -- "
                        f"use field(default_factory=...)")
            return
        args = node.args
        # defaults align with the *last* len(defaults) positional params
        pos = (list(args.posonlyargs) + list(args.args)
               if hasattr(args, "posonlyargs") else list(args.args))
        for arg, default in zip(pos[len(pos) - len(args.defaults):],
                                args.defaults):
            desc = _mutable_default(default)
            if desc:
                yield self.finding(
                    ctx, default,
                    f"default for parameter {arg.arg!r} is {desc}: "
                    f"one instance is shared across calls -- default "
                    f"to None (or use field(default_factory=...))")
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            desc = _mutable_default(default)
            if desc:
                yield self.finding(
                    ctx, default,
                    f"default for parameter {arg.arg!r} is {desc}: "
                    f"one instance is shared across calls -- default "
                    f"to None (or use field(default_factory=...))")


# ---------------------------------------------------------------------------
# REPRO004 -- trace-impurity (PyTorch's capture)
# ---------------------------------------------------------------------------

# callables that capture or compile the function they are given (by the
# dotted name an import resolves them to)
_CAPTURE_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.cuda.make_graphed_callables",
                  "torch.cuda.graphs.make_graphed_callables"}
# context managers whose body a CUDA graph captures
_GRAPH_BLOCKS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
_HOST_RNG_ROOTS = {"random"}


def _resolved(expr: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """The dotted name of ``expr`` with its root replaced by the module
    it was imported as (``import torch as th`` makes ``th.compile``
    ``torch.compile``; ``from torch import compile`` makes ``compile``
    ``torch.compile``)."""
    dn = dotted_name(expr)
    if dn is None:
        return None
    root, _, rest = dn.partition(".")
    base = imports.get(root, root)
    return f"{base}.{rest}" if rest else base


def _is_capture(expr: ast.AST, imports: Dict[str, str]) -> bool:
    """True for ``torch.compile`` / ``torch.jit.script`` /
    ``torch.jit.trace`` / ``torch.cuda.make_graphed_callables``, bare,
    called with options (``torch.compile(mode=...)``) or behind
    ``functools.partial``."""
    if isinstance(expr, ast.Call):
        dn = dotted_name(expr.func)
        if dn is not None and dn.split(".")[-1] == "partial":
            return any(_is_capture(a, imports) for a in expr.args)
        if _is_capture(expr.func, imports):
            return not expr.args     # torch.compile(mode=...): a decorator
        return False
    return _resolved(expr, imports) in _CAPTURE_CALLS


def _captured_names(arg: ast.AST) -> List[ast.AST]:
    """The function expressions a capture call is given: a name, a
    lambda, ``functools.partial(f, ...)``'s f, or each element of a
    tuple (``make_graphed_callables((a, b), ...)``)."""
    if isinstance(arg, (ast.Tuple, ast.List)):
        return [n for e in arg.elts for n in _captured_names(e)]
    if isinstance(arg, ast.Call):
        dn = dotted_name(arg.func)
        if dn is not None and dn.split(".")[-1] == "partial" and arg.args:
            return _captured_names(arg.args[0])
        return []
    return [arg]


class TraceImpurity(Rule):
    name = "trace-impurity"
    code = "REPRO004"
    description = ("functions captured by torch.compile, torch.jit.script "
                   "/ trace, torch.cuda.make_graphed_callables or a "
                   "torch.cuda.graph block must be pure functions of "
                   "their tensors: no attribute mutation, print, host "
                   "clocks, host RNG, metrics-registry touches, or "
                   "branching on a tensor's value -- a CUDA graph runs "
                   "host effects once, at capture, and bakes in the "
                   "branch taken; a compile runs them when it compiles")
    node_types = (ast.Module,)           # whole-module analysis

    def start_module(self, ctx: ModuleContext) -> None:
        self._imports = ctx.imported_modules()
        self._time_aliases = {local for local, mod in self._imports.items()
                              if mod == "time"}
        self._torch_roots = {local for local, mod in self._imports.items()
                             if mod == "torch" or mod.startswith("torch.")}
        self._torch_roots.add("torch")

    # -- entry-point discovery ----------------------------------------
    def _captured_roots(self, ctx: ModuleContext) -> List[ast.AST]:
        """Captured functions and graph blocks, and (transitively) the
        module-local functions they call by name."""
        imports = self._imports
        roots: List[ast.AST] = []
        defs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        seeds: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_capture(d, imports) for d in node.decorator_list):
                    roots.append(node)
            elif isinstance(node, ast.Call) and _is_capture(node.func,
                                                            imports):
                for arg in node.args[:1]:
                    for fn in _captured_names(arg):
                        if isinstance(fn, ast.Name):
                            seeds.add(fn.id)
                        elif isinstance(fn, ast.Lambda):
                            roots.append(fn)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(isinstance(item.context_expr, ast.Call)
                       and _resolved(item.context_expr.func, imports)
                       in _GRAPH_BLOCKS for item in node.items):
                    roots.append(node)
        worklist = [d for name in seeds for d in defs.get(name, ())]
        worklist += roots
        roots.extend(d for name in seeds for d in defs.get(name, ()))
        seen = {id(r) for r in roots}
        while worklist:
            fn = worklist.pop()
            for node in self._region(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name):
                    for d in defs.get(node.func.id, ()):
                        if id(d) not in seen:
                            seen.add(id(d))
                            roots.append(d)
                            worklist.append(d)
        return roots

    @staticmethod
    def _region(root: ast.AST) -> Iterable[ast.AST]:
        """The nodes a capture runs: a function's whole body, or the
        statements inside a graph block (not its context expression)."""
        if isinstance(root, (ast.With, ast.AsyncWith)):
            for stmt in root.body:
                yield from ast.walk(stmt)
        else:
            yield from ast.walk(root)

    def _label(self, root: ast.AST, ctx: ModuleContext) -> str:
        if isinstance(root, (ast.With, ast.AsyncWith)):
            scopes = ctx.enclosing_scopes(root)
            where = getattr(scopes[0], "name", "<lambda>") if scopes \
                else "<module>"
            return f"torch.cuda.graph block in {where}"
        return getattr(root, "name", "<lambda>")

    # -- impurity checks ----------------------------------------------
    def _value_test(self, test: ast.AST) -> Optional[str]:
        """The call in an if / while test that reads a tensor's value: a
        ``torch.*`` call or ``.item()``."""
        for sub in ast.walk(test):
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "item":
                return dotted_name(sub.func) or "<tensor>.item"
            sdn = dotted_name(sub.func)
            if sdn and sdn.split(".")[0] in self._torch_roots:
                return sdn
        return None

    def _check_body(self, fn: ast.AST, ctx: ModuleContext
                    ) -> Iterable[Finding]:
        label = self._label(fn, ctx)
        for node in self._region(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        dn = dotted_name(t) or f"<expr>.{t.attr}"
                        yield self.finding(
                            ctx, node,
                            f"captured function {label!r} mutates "
                            f"attribute state {dn!r}: host-side effects "
                            f"run once at capture or compile, not on "
                            f"each replay -- hoist out of the captured "
                            f"region")
            elif isinstance(node, ast.Call):
                dn = dotted_name(node.func)
                if dn is None:
                    continue
                parts = dn.split(".")
                if dn == "print":
                    yield self.finding(
                        ctx, node,
                        f"print() inside captured function {label!r}: "
                        f"runs at capture or compile only, not on each "
                        f"replay")
                elif parts[0] in self._time_aliases \
                        and parts[-1] in _CLOCK_ATTRS:
                    yield self.finding(
                        ctx, node,
                        f"host clock read {dn}() inside captured "
                        f"function {label!r}: evaluates once at capture "
                        f"-- time the replay from outside the captured "
                        f"region (CUDA events around it)")
                elif (parts[0] in _HOST_RNG_ROOTS
                      or (len(parts) >= 2 and parts[0] in ("np", "numpy")
                          and parts[1] == "random")):
                    yield self.finding(
                        ctx, node,
                        f"host RNG {dn}() inside captured function "
                        f"{label!r}: draws once at capture and bakes the "
                        f"value into the graph -- draw on the device from "
                        f"a torch.Generator")
                elif "metrics" in parts[:-1] or parts[-1] == "metrics":
                    yield self.finding(
                        ctx, node,
                        f"metrics-registry touch {dn!r} inside captured "
                        f"function {label!r}: telemetry must stay "
                        f"host-side, outside the captured region")
            elif isinstance(node, (ast.If, ast.While)):
                sdn = self._value_test(node.test)
                if sdn is not None:
                    yield self.finding(
                        ctx, node,
                        f"captured function {label!r} branches on a "
                        f"tensor's value ({sdn}(...)): a CUDA graph "
                        f"replays the branch taken at capture and "
                        f"torch.compile breaks its graph there -- use "
                        f"torch.where",
                        line=node.lineno)

    def visit(self, node: ast.Module, ctx: ModuleContext
              ) -> Iterable[Finding]:
        emitted: Set[Tuple[int, str]] = set()
        for fn in self._captured_roots(ctx):
            for f in self._check_body(fn, ctx):
                key = (f.line, f.message)
                if key not in emitted:
                    emitted.add(key)
                    yield f


# ---------------------------------------------------------------------------
# REPRO005 -- retrace-hazard (recompiles and graph misses)
# ---------------------------------------------------------------------------

def _callee_name(func: ast.AST) -> Optional[str]:
    """``f`` of ``f(...)`` and of ``self.f(...)``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class RetraceHazard(Rule):
    name = "retrace-hazard"
    code = "REPRO005"
    description = ("arguments to compiled or graphed callables whose "
                   "shape derives from per-request values (prompt length, "
                   "token counts) recompile (torch.compile) or miss the "
                   "captured graph (a CUDA graph replays fixed shapes) per "
                   "request; shapes must be bounded by config (chunk "
                   "size, power-of-two widths)")
    node_types = (ast.Module,)
    default_config = {
        # attribute/variable names that carry per-request token streams
        "request_value_names": ("prompt", "prompt_tokens",
                                "prefill_tokens", "generated", "toks",
                                "tokens", "drafts", "draft"),
        # names the engine binds to compiled or graphed callables on top
        # of the module's own `x = torch.compile(...)` bindings and
        # `@torch.compile` functions: none yet
        "extra_jitted_names": (),
    }

    def _compiled_names(self, ctx: ModuleContext) -> Set[str]:
        imports = ctx.imported_modules()
        names: Set[str] = set(self.config["extra_jitted_names"])
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and _is_capture(node.value.func, imports):
                for t in node.targets:
                    n = _callee_name(t)
                    if n is not None:
                        names.add(n)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(_is_capture(d, imports)
                            for d in node.decorator_list):
                names.add(node.name)
        return names

    def _tainted_names(self, scope: ast.AST) -> Dict[str, str]:
        """local name -> reason, for names assigned from unbounded
        per-request slices/lengths."""
        req_names = set(self.config["request_value_names"])
        tainted: Dict[str, str] = {}
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            reason = self._request_shaped(node.value, req_names)
            if reason:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tainted[t.id] = reason
        return tainted

    @staticmethod
    def _request_shaped(expr: ast.AST, req_names: Set[str]
                        ) -> Optional[str]:
        """A slice or len() over a per-request token stream."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.slice, ast.Slice):
                base = node.value
                base_name = (base.attr if isinstance(base, ast.Attribute)
                             else base.id if isinstance(base, ast.Name)
                             else None)
                if base_name in req_names:
                    return (f"sliced from per-request "
                            f"{base_name!r}")
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "len" and node.args:
                a = node.args[0]
                a_name = (a.attr if isinstance(a, ast.Attribute)
                          else a.id if isinstance(a, ast.Name) else None)
                if a_name in req_names:
                    return f"len() of per-request {a_name!r}"
        return None

    def visit(self, node: ast.Module, ctx: ModuleContext
              ) -> Iterable[Finding]:
        compiled = self._compiled_names(ctx)
        if not compiled:
            return
        req_names = set(self.config["request_value_names"])
        for scope in ast.walk(ctx.tree):
            if not isinstance(scope, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            tainted = self._tainted_names(scope)
            for call in ast.walk(scope):
                if not (isinstance(call, ast.Call)
                        and _callee_name(call.func) in compiled):
                    continue
                name = _callee_name(call.func)
                for arg in list(call.args) + [k.value for k in
                                              call.keywords]:
                    reason = self._request_shaped(arg, req_names)
                    if reason is None:
                        for sub in ast.walk(arg):
                            if isinstance(sub, ast.Name) \
                                    and sub.id in tainted:
                                reason = tainted[sub.id]
                                break
                    if reason:
                        yield self.finding(
                            ctx, call,
                            f"argument to compiled or graphed {name!r} "
                            f"is {reason}: its shape varies per request, "
                            f"so every distinct length recompiles "
                            f"(torch.compile) or misses the captured "
                            f"graph (a CUDA graph replays fixed shapes) "
                            f"-- pad to a config-bounded width (chunk "
                            f"size / power-of-two rows)")
                        break


# ---------------------------------------------------------------------------
# REPRO006 -- metric-name-hygiene
# ---------------------------------------------------------------------------

_METRIC_CTORS = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram"}
_METRIC_USES = {"inc": "counter", "observe": "histogram", "set": "gauge"}
_METRIC_NAME_RE = re.compile(
    r"^(engine|kv|pressure|prefix)_[a-z0-9_]+$")


class MetricNameHygiene(Rule):
    name = "metric-name-hygiene"
    code = "REPRO006"
    description = ("registry metric names must match "
                   "engine_*|kv_*|pressure_*|prefix_* with _total "
                   "(counters) / _seconds-style unit (histograms) "
                   "suffixes, and each name must be created at exactly "
                   "one site")
    paths = ("repro_torch/",)
    node_types = (ast.Call,)
    default_config = {
        "prefixes": ("engine", "kv", "pressure", "prefix"),
        "histogram_suffixes": ("_seconds", "_rate", "_length", "_bytes",
                               "_tokens"),
    }

    def __init__(self, **config):
        super().__init__(**config)
        # literal name -> [(path, line, suppressed)]
        self._creation_sites: Dict[str, List[Tuple[str, int, bool]]] = {}

    def _name_findings(self, kind: str, name_node: ast.AST,
                       ctx: ModuleContext, call: ast.Call
                       ) -> Iterable[Finding]:
        prefixes = self.config["prefixes"]
        hist_sfx = tuple(self.config["histogram_suffixes"])
        if isinstance(name_node, ast.Constant) \
                and isinstance(name_node.value, str):
            name = name_node.value
            head, tail = name, name
        elif isinstance(name_node, ast.JoinedStr) and name_node.values:
            first, last = name_node.values[0], name_node.values[-1]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                yield self.finding(
                    ctx, call,
                    f"{kind} name is an f-string with a dynamic "
                    f"prefix: the registry prefix must be a static "
                    f"literal so conventions are checkable")
                return
            head = first.value
            tail = (last.value if isinstance(last, ast.Constant)
                    and isinstance(last.value, str) else None)
            name = None
        else:
            return                      # dynamic: not statically checkable
        if not any(head.startswith(p + "_") for p in prefixes):
            yield self.finding(
                ctx, call,
                f"{kind} name {head!r}... does not start with one of "
                f"the registry prefixes {'|'.join(prefixes)}_")
        if name is not None and not _METRIC_NAME_RE.match(name):
            if any(name.startswith(p + "_") for p in prefixes):
                yield self.finding(
                    ctx, call,
                    f"{kind} name {name!r} must be snake_case "
                    f"[a-z0-9_] after its registry prefix")
        if tail is not None:
            if kind == "counter" and not tail.endswith("_total"):
                yield self.finding(
                    ctx, call,
                    f"counter name {tail!r} must end in _total "
                    f"(Prometheus counter convention)")
            elif kind == "histogram" and not tail.endswith(hist_sfx):
                yield self.finding(
                    ctx, call,
                    f"histogram name {tail!r} must end in a unit "
                    f"suffix ({', '.join(hist_sfx)})")

    def visit(self, node: ast.Call, ctx: ModuleContext
              ) -> Iterable[Finding]:
        if not isinstance(node.func, ast.Attribute) or not node.args:
            return
        attr = node.func.attr
        kind = _METRIC_CTORS.get(attr) or _METRIC_USES.get(attr)
        if kind is None:
            return
        name_node = node.args[0]
        # non-registry .set()/.inc()/... calls (a tensor's .fill_ or a
        # Counter object's) never pass a string first: the literal filter
        # is the discriminator
        if not isinstance(name_node, (ast.Constant, ast.JoinedStr)):
            return
        if isinstance(name_node, ast.Constant) \
                and not isinstance(name_node.value, str):
            return
        yield from self._name_findings(kind, name_node, ctx, node)
        if attr in _METRIC_CTORS and isinstance(name_node, ast.Constant):
            self._creation_sites.setdefault(name_node.value, []).append(
                (ctx.rel, node.lineno,
                 ctx.is_suppressed(self.name, node.lineno)))

    def finalize(self) -> Iterable[Finding]:
        for name, sites in sorted(self._creation_sites.items()):
            if len(sites) <= 1:
                continue
            first = f"{sites[0][0]}:{sites[0][1]}"
            for path, line, suppressed in sites[1:]:
                f = Finding(
                    rule=self.name, code=self.code,
                    severity=self.severity, path=path, line=line, col=1,
                    message=f"metric {name!r} is created at more than "
                            f"one site (first at {first}): one name = "
                            f"one owner, share the metric object "
                            f"instead")
                f.suppressed = suppressed or sites[0][2]
                yield f


# ---------------------------------------------------------------------------
# REPRO007 -- silent-drop
# ---------------------------------------------------------------------------

class SilentDrop(Rule):
    name = "silent-drop"
    code = "REPRO007"
    description = ("bounded deques evict their oldest entry silently on "
                   "append; engine-visible buffers must count evictions "
                   "(orphan-event drops) or carry an explicit "
                   "suppression naming the eviction policy")
    paths = ("repro_torch/serving/",)
    node_types = (ast.Call,)

    @staticmethod
    def _class_counts_drops(cls: Optional[ast.ClassDef]) -> bool:
        if cls is None:
            return False
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and "dropped" in t.attr:
                        return True
        return False

    def visit(self, node: ast.Call, ctx: ModuleContext
              ) -> Iterable[Finding]:
        dn = dotted_name(node.func)
        if dn is None or dn.split(".")[-1] != "deque":
            return
        maxlen = next((kw.value for kw in node.keywords
                       if kw.arg == "maxlen"), None)
        if maxlen is None or (isinstance(maxlen, ast.Constant)
                              and maxlen.value is None):
            return
        if self._class_counts_drops(ctx.enclosing_class(node)):
            return
        yield self.finding(
            ctx, node,
            f"bounded deque(maxlen=...) evicts silently on append: "
            f"count evictions (cf. _CountingDeque / "
            f"stats()['orphans_dropped']) or suppress with the "
            f"eviction policy spelled out")


# ---------------------------------------------------------------------------
# REPRO008 -- swallowed-exception
# ---------------------------------------------------------------------------

_BROAD_EXCEPTIONS = {"Exception", "BaseException"}


class SwallowedException(Rule):
    name = "swallowed-exception"
    code = "REPRO008"
    description = ("no bare except:, and no broad Exception handler "
                   "that swallows silently, in engine code -- a fault "
                   "the engine cannot classify must propagate (the "
                   "quarantine/EngineError taxonomy depends on it)")
    paths = ("repro_torch/serving/",)
    node_types = (ast.ExceptHandler,)

    def visit(self, node: ast.ExceptHandler, ctx: ModuleContext
              ) -> Iterable[Finding]:
        if node.type is None:
            yield self.finding(
                ctx, node,
                "bare except: catches everything including "
                "KeyboardInterrupt/SystemExit -- name the exceptions "
                "the handler can actually handle")
            return
        names = (node.type.elts if isinstance(node.type, ast.Tuple)
                 else [node.type])
        broad = [dotted_name(n) for n in names]
        if not any(b in _BROAD_EXCEPTIONS for b in broad if b):
            return
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Raise, ast.Call, ast.Return,
                                ast.Yield)):
                return                   # observable: re-raise/handle/log
        yield self.finding(
            ctx, node,
            "broad except Exception: handler swallows the error with "
            "no raise/call/return -- engine faults must feed the "
            "quarantine/EngineError taxonomy, not vanish")


ALL_RULES = (UnresolvableExcept, RawWallClock, MutableDefault,
             TraceImpurity, RetraceHazard, MetricNameHygiene, SilentDrop,
             SwallowedException)

RULE_INDEX = {r.name: r for r in ALL_RULES}


def default_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULES]
