"""Reporters for repro-lint: human text and machine JSON."""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.analysis.lint.framework import Finding, LintResult

__all__ = ["render_text", "render_json"]


def render_text(result: LintResult, *, show_suppressed: bool = False
                ) -> str:
    lines: List[str] = []
    shown = result.findings if show_suppressed else result.active
    for f in shown:
        tag = " (suppressed)" if f.suppressed else ""
        lines.append(f"{f.location()}: {f.severity} "
                     f"[{f.code} {f.rule}]{tag} {f.message}")
    by_rule: Dict[str, int] = {}
    for f in result.active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = (", ".join(f"{n} {rule}" for rule, n in sorted(
        by_rule.items())) or "clean")
    lines.append(f"repro-lint: {result.files_checked} files, "
                 f"{len(result.active)} findings "
                 f"({len(result.suppressed)} suppressed): {summary}")
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    payload = {
        "tool": "repro-lint",
        "version": 1,
        "files_checked": result.files_checked,
        "findings": [f.to_json() for f in result.active],
        "suppressed": [f.to_json() for f in result.suppressed],
        "summary": {
            "errors": len(result.errors),
            "warnings": len([f for f in result.active
                             if f.severity != "error"]),
            "suppressed": len(result.suppressed),
        },
    }
    return json.dumps(payload, indent=2, sort_keys=True)
