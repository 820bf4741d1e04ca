"""The analysis report (text and JSON) and its exit-code policy.

The port's counterpart of the JAX package's ``analysis/report.py``. A
run's passes arrive as the lint pass's :class:`~.baseline.BaselineResult`
and, with ``--contracts``, two dicts:

- ``contracts``: ``device`` (where the programs ran), ``violations`` (the
  sorted stable keys of :func:`~.contracts.check_budgets` and
  :func:`~.contracts.check_programs`), ``new`` and ``stale`` (their diff
  against the baseline's ``contracts`` section) and ``runs`` (each
  program run's :func:`~.contracts.run_program` result: its shards, units,
  dispatches and, on the card, launches by kernel);
- ``locks``: ``report`` (:func:`~.lockcheck.build_lock_report`), ``new``
  and ``stale`` (against the ``lockcheck`` section);

and, with the shape pass, ``mesh``: the rows of
:func:`~.meshcheck.verify_all`, in JAX's forms (text ``meshcheck:``
lines, JSON ``mesh_verification`` and ``summary.mesh_failures``; the
JSON also gives the pass's wall, ``summary.mesh_seconds``).
"""

from __future__ import annotations

import json
from typing import Any

from fraud_detection_tpu_torch.analysis.baseline import BaselineResult
from fraud_detection_tpu_torch.analysis.core import Severity, iter_rules


def render_text(result: BaselineResult, verbose: bool = False, contracts: dict | None = None,
                locks: dict | None = None, mesh: list | None = None) -> str:
    lines: list[str] = []
    for f in result.new:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.severity.name.lower()} [{f.rule_id}] "
                     f"{f.message}")
        if f.snippet:
            lines.append(f"    {f.snippet}")
    for r in mesh or []:
        if not r["ok"]:
            lines.append(f"meshcheck: error [{r['entrypoint']}] mesh size {r['mesh_size']}: "
                         f"{r['error']}")
        elif verbose:
            lines.append(f"meshcheck: ok [{r['entrypoint']}] mesh size {r['mesh_size']} "
                         f"({r['out']})")
    if contracts is not None:
        new = set(contracts["new"])
        for key in contracts["violations"]:
            lines.append(f"contracts: {'error' if key in new else 'baselined'} [{key}]")
        if verbose:
            for r in contracts["runs"]:
                counts = r["launches"] if r["launches"] is not None else r["dispatches"]
                lines.append(f"contracts: ran [{r['entrypoint']}] shards {tuple(r['shards'])}: "
                             f"{json.dumps({k: v for k, v in counts.items() if v}, sort_keys=True)}")
    if locks is not None:
        report, new = locks["report"], set(locks["new"])
        for cyc in report["cycles"]:
            tag = "error" if f"lock-cycle:{cyc}" in new else "baselined"
            lines.append(f"lockcheck: {tag} acquisition cycle: {cyc}")
        for d in report["inventory_drift"]:
            lines.append(f"lockcheck: error [{d['diagnostic']}] {d['detail']}")
        if verbose:
            for e in report["edges"]:
                lines.append(f"lockcheck: edge {e['src']} -> {e['dst']} ({e['sites'][0]})")
    summary = f"analysis: {len(result.new)} finding(s), {len(result.suppressed)} baselined"
    if result.stale:
        summary += f", {len(result.stale)} stale baseline entr(y/ies)"
    if mesh is not None:
        summary += (f"; mesh verification: {len(mesh) - _failures(mesh)}/{len(mesh)} checks "
                    "passed")
    if contracts is not None:
        summary += (f"; contracts on {contracts['device']}: {len(contracts['runs'])} program "
                    f"runs, {len(contracts['violations'])} violation(s), "
                    f"{len(contracts['new'])} new, {len(contracts['stale'])} stale")
    if locks is not None:
        report = locks["report"]
        summary += (f"; lockcheck: {len(report['edges'])} order edge(s), "
                    f"{len(report['cycles'])} cycle(s), {len(report['inventory_drift'])} drift, "
                    f"{len(locks['stale'])} stale")
    lines.append(summary)
    if verbose:
        lines.extend(f"  stale baseline entry: [{e.get('rule')}] {e.get('path')} — "
                     f"{e.get('snippet', '')!r}" for e in result.stale)
    return "\n".join(lines)


def _failures(mesh: list) -> int:
    return sum(1 for r in mesh if not r["ok"])


def render_json(result: BaselineResult, contracts: dict | None = None,
                locks: dict | None = None, mesh: list | None = None,
                mesh_seconds: float | None = None) -> str:
    doc: dict[str, Any] = {
        "findings": [f.to_dict() for f in result.new],
        "baselined": [f.to_dict() for f in result.suppressed],
        "stale_baseline": result.stale,
        "rules": [{"id": r.id, "severity": r.severity.name.lower(),
                   "description": r.description} for r in iter_rules()],
        "summary": {"new": len(result.new), "baselined": len(result.suppressed),
                    "stale": len(result.stale)},
    }
    if mesh is not None:
        doc["mesh_verification"] = mesh
        doc["summary"]["mesh_failures"] = _failures(mesh)
        if mesh_seconds is not None:  # the pass's wall, beside JAX's keys
            doc["summary"]["mesh_seconds"] = mesh_seconds
    if contracts is not None:
        doc["contracts"] = contracts
        doc["summary"].update(contract_violations=len(contracts["violations"]),
                              contract_new=list(contracts["new"]),
                              contract_stale=list(contracts["stale"]))
    if locks is not None:
        doc["lockcheck"] = locks["report"]
        doc["summary"].update(lock_cycles=len(locks["report"]["cycles"]),
                              lock_drift=len(locks["report"]["inventory_drift"]),
                              lock_new=list(locks["new"]), lock_stale=list(locks["stale"]))
    return json.dumps(doc, indent=2)


def exit_code(result: BaselineResult, fail_on: Severity = Severity.INFO,
              contracts: dict | None = None, locks: dict | None = None,
              mesh: list | None = None) -> int:
    """1 when a finding the baseline does not cover is at or above
    ``fail_on``, a shape-pass row failed, or a contract or lock violation
    key is new; else 0. Stale entries are reported, never failed on."""
    if any(f.severity >= fail_on for f in result.new):
        return 1
    if mesh and _failures(mesh):
        return 1
    if (contracts is not None and contracts["new"]) or (locks is not None and locks["new"]):
        return 1
    return 0
