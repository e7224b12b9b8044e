"""repro-lint framework: single-pass AST visitor engine + rule registry.

The serving stack's bug history is statically detectable: a
never-imported name in an ``except`` clause (a latent NameError on a
rarely-taken path), a stray ``time.perf_counter()`` in
``EngineCore.step`` that corrupted phase telemetry, shared mutable
dataclass defaults.  Each runtime guarantee ("metrics are never captured
into a graph", "all engine timing goes through ``self._clock``") becomes
a static gate here.  The engine is the JAX package's, rule for rule; the
rules (``rules.py``) are scoped to the port's paths and its two capture
rules read ``torch.compile`` and CUDA graphs.

Design:

* stdlib-``ast`` only -- no third-party dependencies, importable and
  runnable anywhere the repo is.
* one parse + one tree walk per module: rules register the node types
  they care about (``node_types``) and the engine dispatches each node
  to every interested rule during a single traversal.  Shared analyses
  (parent links, module-level bindings, per-scope local names) are
  computed once on the :class:`ModuleContext` and reused by all rules.
* per-rule severity and config: every rule carries a ``config`` dict
  seeded from ``default_config`` and a ``severity`` that the CLI can
  override (``--severity rule=warning``).
* inline suppressions: ``# repro-lint: disable=<rule>[,<rule>]`` on the
  offending line (or on a comment line directly above it) suppresses
  matching findings on that line; ``# repro-lint: disable-file=<rule>``
  anywhere in the first ``FILE_PRAGMA_LINES`` lines suppresses the rule
  for the whole module.  ``disable=all`` suppresses every rule.
* cross-module rules: after every module is swept, each rule's
  ``finalize()`` runs once (metric-name uniqueness needs the whole
  tree's creation sites).
"""
from __future__ import annotations

import ast
import builtins
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "Rule", "ModuleContext", "LintEngine",
           "dotted_name", "iter_child_nodes_deep"]

FILE_PRAGMA_LINES = 12
_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9_\-, ]+)")

_BUILTIN_NAMES = frozenset(dir(builtins))


@dataclass
class Finding:
    """One lint finding, pointing at a file:line."""
    rule: str                  # kebab-case rule name (the disable token)
    code: str                  # stable REPROxxx identifier
    severity: str              # "error" | "warning"
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "code": self.code,
                "severity": self.severity, "path": self.path,
                "line": self.line, "col": self.col,
                "message": self.message, "suppressed": self.suppressed}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_child_nodes_deep(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` minus the root."""
    for child in ast.walk(node):
        if child is not node:
            yield child


# ---------------------------------------------------------------------------
# per-module shared analyses
# ---------------------------------------------------------------------------

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _bound_names(node: ast.AST) -> Set[str]:
    """Names bound by one statement/expression (targets, imports,
    defs); does not recurse into nested scopes."""
    names: Set[str] = set()
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        for alias in node.names:
            if alias.name == "*":
                continue
            names.add((alias.asname or alias.name).split(".")[0])
    elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        names.add(node.name)
    elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                           ast.For, ast.AsyncFor)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    names.add(n.id)
    elif isinstance(node, (ast.With, ast.AsyncWith)):
        for item in node.items:
            if item.optional_vars is not None:
                for n in ast.walk(item.optional_vars):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    elif isinstance(node, ast.ExceptHandler):
        if node.name:
            names.add(node.name)
    elif isinstance(node, (ast.Global, ast.Nonlocal)):
        names.update(node.names)
    elif isinstance(node, ast.NamedExpr):
        if isinstance(node.target, ast.Name):
            names.add(node.target.id)
    elif isinstance(node, ast.comprehension):
        for n in ast.walk(node.target):
            if isinstance(n, ast.Name):
                names.add(n.id)
    elif isinstance(node, ast.MatchAs):
        if node.name:
            names.add(node.name)
    return names


def _scope_locals(scope: ast.AST) -> Set[str]:
    """Every name bound anywhere inside ``scope`` (params, assignments,
    for/with/except targets, comprehension targets, nested def names),
    recursing through nested scopes too -- deliberately loose: the
    unresolvable-except rule must never flag a name that *any* enclosing
    binding could provide."""
    names: Set[str] = set()
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
        a = scope.args
        for arg in (list(a.posonlyargs) + list(a.args)
                    + list(a.kwonlyargs)
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            names.add(arg.arg)
    for n in ast.walk(scope):
        names.update(_bound_names(n))
    return names


class ModuleContext:
    """Everything rules need about one parsed module, computed once."""

    def __init__(self, path: str, rel: str, source: str, tree: ast.Module):
        self.path = path
        self.rel = rel                      # forward-slash path for scoping
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # names importable/bound at module level (cached), plus builtins
        self._module_names: Optional[Set[str]] = None
        self._scope_cache: Dict[ast.AST, Set[str]] = {}
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        self._parse_suppressions()

    # -- suppressions --------------------------------------------------
    def _parse_suppressions(self) -> None:
        pending: Set[str] = set()       # from standalone comment lines
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            stripped = line.strip()
            if m:
                rules = {r.strip() for r in m.group(2).split(",")
                         if r.strip()}
                if m.group(1) == "disable-file":
                    if i <= FILE_PRAGMA_LINES:
                        self.file_suppressions |= rules
                    continue
                self.line_suppressions.setdefault(i, set()).update(rules)
                if stripped.startswith("#"):
                    # standalone comment: also applies to the next
                    # non-comment line
                    pending |= rules
                continue
            if pending and stripped and not stripped.startswith("#"):
                self.line_suppressions.setdefault(i, set()).update(pending)
                pending = set()

    def is_suppressed(self, rule: str, line: int) -> bool:
        for pool in (self.file_suppressions,
                     self.line_suppressions.get(line, ())):
            if rule in pool or "all" in pool:
                return True
        return False

    # -- shared name analyses ------------------------------------------
    @property
    def module_names(self) -> Set[str]:
        if self._module_names is None:
            names: Set[str] = set(_BUILTIN_NAMES)
            for node in ast.walk(self.tree):
                names.update(_bound_names(node))
            self._module_names = names
        return self._module_names

    def enclosing_scopes(self, node: ast.AST) -> List[ast.AST]:
        """Function/lambda scopes around ``node``, innermost first."""
        scopes: List[ast.AST] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _SCOPE_NODES):
                scopes.append(cur)
            cur = self.parents.get(cur)
        return scopes

    def scope_locals(self, scope: ast.AST) -> Set[str]:
        if scope not in self._scope_cache:
            self._scope_cache[scope] = _scope_locals(scope)
        return self._scope_cache[scope]

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parents.get(cur)
        return None

    def imported_modules(self) -> Dict[str, str]:
        """local alias -> imported module path (``import time as t`` ->
        {"t": "time"}); ``from x import y`` -> {"y": "x.y"}."""
        out: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    out[local] = alias.name if alias.asname else \
                        alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    out[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"
        return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

class Rule:
    """Base class: subclasses set ``name``/``code``/``description``,
    register ``node_types`` and implement ``visit``.  ``paths`` scopes a
    rule to files whose path contains any of the given fragments (empty
    = every file).  State for cross-module checks accumulates on the
    instance; ``finalize`` yields whole-run findings."""

    name: str = ""
    code: str = ""
    description: str = ""
    severity: str = "error"
    paths: Tuple[str, ...] = ()
    node_types: Tuple[type, ...] = ()
    default_config: Dict[str, object] = {}

    def __init__(self, **config):
        self.config = dict(self.default_config)
        self.config.update(config)

    def applies_to(self, ctx: ModuleContext) -> bool:
        if not self.paths:
            return True
        return any(p in ctx.rel for p in self.paths)

    def start_module(self, ctx: ModuleContext) -> None:
        pass

    def visit(self, node: ast.AST, ctx: ModuleContext
              ) -> Iterable[Finding]:
        return ()

    def finish_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        return ()

    def finalize(self) -> Iterable[Finding]:
        return ()

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str,
                *, line: Optional[int] = None) -> Finding:
        ln = line if line is not None else getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=self.name, code=self.code,
                       severity=self.severity, path=ctx.rel, line=ln,
                       col=col + 1, message=message)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    files_checked: int = 0

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.active if f.severity == "error"]


class LintEngine:
    """Runs a set of rules over a file tree in a single AST pass per
    module, applies suppressions, and aggregates cross-module state."""

    def __init__(self, rules: Sequence[Rule]):
        self.rules = list(rules)

    # -- file discovery ------------------------------------------------
    @staticmethod
    def discover(paths: Sequence[str]) -> List[str]:
        files: List[str] = []
        for p in paths:
            if os.path.isfile(p):
                if p.endswith(".py"):
                    files.append(p)
                continue
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__")
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
        return files

    @staticmethod
    def _rel(path: str) -> str:
        rel = os.path.relpath(path)
        if rel.startswith(".."):
            rel = path
        return rel.replace(os.sep, "/")

    # -- the sweep -----------------------------------------------------
    def run(self, paths: Sequence[str]) -> LintResult:
        result = LintResult()
        for path in self.discover(paths):
            result.files_checked += 1
            rel = self._rel(path)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=path)
            except (SyntaxError, ValueError, UnicodeDecodeError) as e:
                line = getattr(e, "lineno", 1) or 1
                result.findings.append(Finding(
                    rule="syntax-error", code="REPRO000",
                    severity="error", path=rel, line=line, col=1,
                    message=f"could not parse: {e.__class__.__name__}: "
                            f"{e}"))
                continue
            ctx = ModuleContext(path, rel, source, tree)
            self._run_module(ctx, result)
        for rule in self.rules:
            for f in rule.finalize():
                result.findings.append(f)
        result.findings.sort(key=lambda f: (f.path, f.line, f.col,
                                            f.rule))
        return result

    def _run_module(self, ctx: ModuleContext, result: LintResult) -> None:
        live = [r for r in self.rules if r.applies_to(ctx)]
        if not live:
            return
        for rule in live:
            rule.start_module(ctx)
        # one walk, dispatch by node type
        interest: Dict[type, List[Rule]] = {}
        for rule in live:
            for nt in rule.node_types:
                interest.setdefault(nt, []).append(rule)
        found: List[Finding] = []
        for node in ast.walk(ctx.tree):
            for rule in interest.get(type(node), ()):
                found.extend(rule.visit(node, ctx))
        for rule in live:
            found.extend(rule.finish_module(ctx))
        for f in found:
            f.suppressed = ctx.is_suppressed(f.rule, f.line)
            result.findings.append(f)
