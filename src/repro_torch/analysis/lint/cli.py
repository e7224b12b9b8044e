"""repro-lint CLI for the port.

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch tests/
    PYTHONPATH=src python -m repro_torch.analysis.lint src/ --format=json
    PYTHONPATH=src python -m repro_torch.analysis.lint --list-rules

Exit status: 0 when no active error-severity finding, 1 otherwise,
2 on usage errors.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.lint.framework import LintEngine, LintResult, Rule
from repro_torch.analysis.lint.report import render_json, render_text
from repro_torch.analysis.lint.rules import ALL_RULES, RULE_INDEX

__all__ = ["build_rules", "main"]


def build_rules(select: Optional[Sequence[str]] = None,
                ignore: Sequence[str] = (),
                severity: Sequence[str] = ()) -> List[Rule]:
    """Instantiate the configured rule set.

    ``select`` keeps only the named rules (None = all), ``ignore`` drops
    names, ``severity`` entries look like ``rule=warning``.
    """
    known = set(RULE_INDEX)
    for name in list(select or ()) + list(ignore):
        if name not in known:
            raise ValueError(f"unknown rule {name!r} "
                             f"(known: {', '.join(sorted(known))})")
    overrides = {}
    for spec in severity:
        if "=" not in spec:
            raise ValueError(f"--severity expects rule=level, got "
                             f"{spec!r}")
        name, level = spec.split("=", 1)
        if name not in known:
            raise ValueError(f"unknown rule {name!r} in --severity")
        if level not in ("error", "warning"):
            raise ValueError(f"severity must be error|warning, got "
                             f"{level!r}")
        overrides[name] = level
    rules: List[Rule] = []
    for cls in ALL_RULES:
        if select is not None and cls.name not in select:
            continue
        if cls.name in ignore:
            continue
        rule = cls()
        if cls.name in overrides:
            rule.severity = overrides[cls.name]
        rules.append(rule)
    return rules


def _list_rules() -> str:
    lines = []
    for cls in ALL_RULES:
        scope = ", ".join(cls.paths) if cls.paths else "all files"
        lines.append(f"{cls.code}  {cls.name}  [{cls.severity}; "
                     f"scope: {scope}]")
        lines.append(f"    {' '.join(cls.description.split())}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repro-lint: project-specific static analysis "
                    "encoding the engine's bug taxonomy")
    ap.add_argument("paths", nargs="*", default=(),
                    help="files or directories to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE", help="run only the named rule "
                    "(repeatable)")
    ap.add_argument("--ignore", action="append", default=[],
                    metavar="RULE", help="skip the named rule "
                    "(repeatable)")
    ap.add_argument("--severity", action="append", default=[],
                    metavar="RULE=LEVEL",
                    help="override a rule's severity (error|warning)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed findings in text output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0
    if not args.paths:
        ap.print_usage(sys.stderr)
        print("error: no paths given (try: src/repro_torch tests/)",
              file=sys.stderr)
        return 2
    try:
        rules = build_rules(select=args.select, ignore=args.ignore,
                            severity=args.severity)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    result: LintResult = LintEngine(rules).run(args.paths)
    if args.format == "json":
        print(render_json(result))
    else:
        print(render_text(result, show_suppressed=args.show_suppressed))
    return 1 if result.errors else 0


if __name__ == "__main__":
    sys.exit(main())
