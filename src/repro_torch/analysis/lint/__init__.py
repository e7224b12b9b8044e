"""repro-lint for the port: stdlib-ast static analysis encoding the
serving engine's observed bug taxonomy (see
:mod:`repro_torch.analysis.lint.rules`), scoped to ``repro_torch/``.

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch tests/
"""
from repro_torch.analysis.lint.framework import (Finding, LintEngine,
                                                 LintResult, ModuleContext,
                                                 Rule)
from repro_torch.analysis.lint.report import render_json, render_text
from repro_torch.analysis.lint.rules import (ALL_RULES, RULE_INDEX,
                                             default_rules)

__all__ = ["Finding", "LintEngine", "LintResult", "ModuleContext",
           "Rule", "ALL_RULES", "RULE_INDEX", "default_rules",
           "render_json", "render_text", "lint_paths"]


def lint_paths(*paths: str) -> LintResult:
    """Convenience: run the default rule set over ``paths``."""
    return LintEngine(default_rules()).run(list(paths))
