"""``python -m fraud_detection_tpu_torch.analysis``: the port's static
rules over its tree, gated against ``analysis/baseline.json``, and with
``--contracts`` the program contracts, the lock discipline and the shape
pass.

The port's counterpart of the JAX package's ``graftcheck`` CLI. Exit
status 0 ⇔ no finding beyond the baseline at or above ``--fail-on``, no
failed shape-pass row and, with ``--contracts``, no contract or lock
violation key beyond the baseline; 1 otherwise; 2 for a usage error (an
unknown ``--rules`` id, ``--write-baseline`` without the lint pass, no
card for a device pass on ``cuda``). The lint pass reads source only, on
any machine. The device passes run on ``DEVICE`` (default ``cuda``, as
every entry point; ``DEVICE=cpu`` runs them on the CPU): ``--contracts``
runs :func:`~.contracts.check_budgets`, :func:`~.contracts.check_programs`,
:func:`~.lockcheck.build_lock_report` over the package and the shape pass
(:func:`~.meshcheck.verify_all`; ``--contracts-only`` and
``--no-shape-check`` drop it); ``--shape-check-only`` runs the shape pass
without the lint. Unlike JAX's CLI, the default is the lint alone: the
shape pass runs the programs, so it rides the device passes.

    python -m fraud_detection_tpu_torch.analysis                 # lint the package
    DEVICE=cpu python -m fraud_detection_tpu_torch.analysis --contracts
    DEVICE=cpu python -m fraud_detection_tpu_torch.analysis --shape-check-only --mesh-sizes 4
    python -m fraud_detection_tpu_torch.analysis --contracts --format json --output out.json
"""

from __future__ import annotations

import argparse
import os
import sys
import time


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
                    help="also run the collective budgets, the program contracts and the shape "
                         "pass (on DEVICE, default cuda) and the lock-order pass")
    ap.add_argument("--contracts-only", action="store_true",
                    help="run only the contracts and the lock-order pass")
    ap.add_argument("--no-shape-check", action="store_true",
                    help="skip the shape pass (every program at every mesh size)")
    ap.add_argument("--shape-check-only", action="store_true",
                    help="run only the shape pass (on DEVICE, default cuda)")
    ap.add_argument("--mesh-sizes", default=None,
                    help="comma-separated mesh sizes for the shape pass (default: 1,2,8, the "
                         "grid programs on 1x1,2x2,4x2,2x4)")
    ap.add_argument("--rules", default=None, help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--fail-on", default="info", choices=("info", "warning", "error"),
                    help="the least severity of a new finding that fails the run")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--output", default=None, help="write the report here as well as stdout")
    args = ap.parse_args(argv)
    if args.contracts_only:
        args.contracts = True
        args.no_shape_check = True
    shape_check = args.shape_check_only or (args.contracts and not args.no_shape_check)

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

    if args.write_baseline and (args.contracts_only or args.shape_check_only):
        print("--write-baseline needs the lint pass; drop --contracts-only/--shape-check-only "
              "(writing here would empty the baseline's findings)", file=sys.stderr)
        return 2

    findings = [] if args.contracts_only or args.shape_check_only else analyze_paths(
        args.paths or [pkg_dir], root=root, rules=rules)
    if args.write_baseline:
        baseline_mod.save(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}", file=sys.stderr)
        return 0
    result = baseline_mod.apply(findings, baseline_mod.load(baseline_path))

    device = None
    if args.contracts or shape_check:
        from fraud_detection_tpu_torch.device import resolve_device

        try:
            device = resolve_device()
        except RuntimeError as e:
            print(f"{'--contracts' if args.contracts else '--shape-check-only'}: {e}",
                  file=sys.stderr)
            return 2

    mesh = mesh_seconds = None
    if shape_check:
        from fraud_detection_tpu_torch.analysis import meshcheck

        sizes = tuple(int(s) for s in args.mesh_sizes.split(",")) if args.mesh_sizes else None
        t = time.perf_counter()
        mesh = meshcheck.verify_all(sizes, device)
        mesh_seconds = time.perf_counter() - t

    contracts = locks = None
    if args.contracts:
        from fraud_detection_tpu_torch.analysis import lockcheck
        from fraud_detection_tpu_torch.analysis.contracts import check_budgets, check_programs

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
        out = report.render_json(result, contracts=contracts, locks=locks, mesh=mesh,
                                 mesh_seconds=mesh_seconds)
    else:
        out = report.render_text(result, verbose=args.verbose, contracts=contracts, locks=locks,
                                 mesh=mesh)
    print(out)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    return report.exit_code(result, fail_on=Severity.parse(args.fail_on), contracts=contracts,
                            locks=locks, mesh=mesh)


if __name__ == "__main__":
    sys.exit(main())
