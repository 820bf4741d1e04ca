"""``python -m fraud_detection_tpu_torch.analysis``: the port's static
rules over its tree, gated against ``analysis/baseline.json``, and with
``--contracts`` the program contracts and the lock discipline.

The port's counterpart of the JAX package's ``graftcheck`` CLI. Exit
status 0 ⇔ no finding beyond the baseline at or above ``--fail-on`` and,
with ``--contracts``, no contract or lock violation key beyond it; 1
otherwise; 2 for a usage error (an unknown ``--rules`` id, no card for
``--contracts`` on ``cuda``). The lint pass reads source only, on any
machine. ``--contracts`` runs :func:`~.contracts.check_budgets` and
:func:`~.contracts.check_programs` on ``DEVICE`` (default ``cuda``, as
every entry point; ``DEVICE=cpu`` runs them on the CPU) and
:func:`~.lockcheck.build_lock_report` over the package.

    python -m fraud_detection_tpu_torch.analysis                 # lint the package
    DEVICE=cpu python -m fraud_detection_tpu_torch.analysis --contracts
    python -m fraud_detection_tpu_torch.analysis --contracts --format json --output out.json
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fraud_detection_tpu_torch.analysis",
        description="the port's static rules, its program contracts and its lock discipline",
    )
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: the fraud_detection_tpu_torch "
                         "package, its build/ pruned)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="the baseline file (default: analysis/baseline.json in the package)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept every current finding into the baseline file and exit 0")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the collective budgets, the program contracts (on DEVICE, "
                         "default cuda) and the lock-order pass")
    ap.add_argument("--contracts-only", action="store_true",
                    help="run only the contracts and the lock-order pass")
    ap.add_argument("--rules", default=None, help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--fail-on", default="info", choices=("info", "warning", "error"),
                    help="the least severity of a new finding that fails the run")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--output", default=None, help="write the report here as well as stdout")
    args = ap.parse_args(argv)
    if args.contracts_only:
        args.contracts = True

    from fraud_detection_tpu_torch.analysis import baseline as baseline_mod
    from fraud_detection_tpu_torch.analysis import report
    from fraud_detection_tpu_torch.analysis.core import (
        Severity,
        analyze_paths,
        get_rule,
        iter_rules,
    )

    if args.list_rules:
        for r in iter_rules():
            print(f"{r.id:24s} {r.severity.name.lower():8s} {r.description}")
        return 0

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg_dir)
    baseline_path = args.baseline or baseline_mod.DEFAULT_BASELINE

    rules = None
    if args.rules:
        wanted = {s.strip() for s in args.rules.split(",") if s.strip()}
        unknown = wanted - {r.id for r in iter_rules()}
        if unknown:
            print(f"unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [get_rule(rule_id) for rule_id in sorted(wanted)]

    if args.write_baseline and args.contracts_only:
        print("--write-baseline needs the lint pass; drop --contracts-only (writing here "
              "would empty the baseline's findings)", file=sys.stderr)
        return 2

    findings = [] if args.contracts_only else analyze_paths(args.paths or [pkg_dir], root=root,
                                                            rules=rules)
    if args.write_baseline:
        baseline_mod.save(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}", file=sys.stderr)
        return 0
    result = baseline_mod.apply(findings, baseline_mod.load(baseline_path))

    contracts = locks = None
    if args.contracts:
        from fraud_detection_tpu_torch.analysis import lockcheck
        from fraud_detection_tpu_torch.analysis.contracts import check_budgets, check_programs
        from fraud_detection_tpu_torch.device import resolve_device

        try:
            device = resolve_device()
        except RuntimeError as e:
            print(f"--contracts: {e}", file=sys.stderr)
            return 2
        runs: list = []
        keys = check_budgets(device) + check_programs(device, report=runs)
        new, stale = baseline_mod.apply_keys(
            keys, baseline_mod.load_section(baseline_path, "contracts"))
        contracts = {"device": str(device), "violations": keys, "new": new, "stale": stale,
                     "runs": runs}
        lock_report = lockcheck.build_lock_report(root)
        new, stale = baseline_mod.apply_keys(
            lockcheck.violation_keys(lock_report),
            baseline_mod.load_section(baseline_path, "lockcheck"))
        locks = {"report": lock_report, "new": new, "stale": stale}

    if args.format == "json":
        out = report.render_json(result, contracts=contracts, locks=locks)
    else:
        out = report.render_text(result, verbose=args.verbose, contracts=contracts, locks=locks)
    print(out)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    return report.exit_code(result, fail_on=Severity.parse(args.fail_on), contracts=contracts,
                            locks=locks)


if __name__ == "__main__":
    sys.exit(main())
