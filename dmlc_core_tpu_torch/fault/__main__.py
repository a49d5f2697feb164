"""Fault-plan CLI: validate a plan and list the instrumented sites.

Usage::

    python -m dmlc_core_tpu_torch.fault list-sites
    python -m dmlc_core_tpu_torch.fault validate plan.json  # or - for stdin

``validate`` exits 0 on a well-formed plan (printing each parsed rule) and
2 on a malformed one — wire it before a chaos run so a typo'd plan fails
the job instead of silently injecting nothing.

Counterpart of ``dmlc_core_tpu/fault/__main__.py`` (a copy).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from dmlc_core_tpu_torch.fault import SITES, FaultPlan, FaultPlanError


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.fault",
        description="fault-injection plan tools (docs/robustness.md)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list-sites", help="print the instrumented sites")
    val = sub.add_parser("validate", help="parse a plan; exit 0/2")
    val.add_argument("plan", help="plan file path, or - for stdin")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "list-sites":
        width = max(len(s) for s in SITES)
        for site in sorted(SITES):
            print(f"{site:<{width}}  {SITES[site]}")
        return 0
    # validate
    try:
        if args.plan == "-":
            text = sys.stdin.read()
        else:
            with open(args.plan, encoding="utf-8") as f:
                text = f.read()
        plan = FaultPlan(text)
    except OSError as exc:
        print(f"fault: cannot read plan: {exc}", file=sys.stderr)
        return 2
    except FaultPlanError as exc:
        print(f"fault: invalid plan: {exc}", file=sys.stderr)
        return 2
    known = set(SITES)
    print(f"fault: plan ok — {len(plan.rules)} rule(s), seed={plan.seed!r}")
    for rule in plan.rules:
        print(f"  {rule.describe()}")
        # wildcard sites can't be checked statically; exact ones can
        if not any(ch in rule.site for ch in "*?[") and rule.site not in known:
            print(f"  warning: site {rule.site!r} is not an instrumented "
                  "site (list-sites)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
