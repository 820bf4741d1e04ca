"""promtool-style validation of the monitoring configs.

The JAX package's ``monitor/promlint.py`` as it is, with its CLI as
``python -m fraud_detection_tpu_torch.monitor.promlint [monitoring_dir]``
(exit 1 on any finding):

- when a ``promtool`` binary is on PATH, rule files are checked with
  ``promtool check rules``;
- otherwise a structural lint runs: YAML parse (PyYAML when it imports,
  imported inside the function; a conservative regex fallback otherwise),
  required keys (``groups[].name``, ``rules[].alert/expr``), balanced
  brackets and quotes in every expr, valid ``for:`` durations and known
  severity labels; the scrape config and the Grafana dashboard too.

Returns error strings rather than raising, so callers aggregate every
problem in one report.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess

_DURATION = re.compile(r"^\d+(\.\d+)?(ms|s|m|h|d|w|y)$")
_SEVERITIES = {"critical", "warning", "info", "none"}
_PAIRS = {")": "(", "]": "[", "}": "{"}


def _load_yaml(path: str):
    """Parse YAML; returns (data, error). Uses PyYAML when installed."""
    try:
        import yaml
    except ImportError:
        return None, None  # caller falls back to the regex lint
    try:
        with open(path) as f:
            return yaml.safe_load(f), None
    except yaml.YAMLError as e:
        return None, f"{path}: YAML parse error: {e}"


def check_expr(expr: str) -> str | None:
    """Balanced (), [], {} and quotes — the syntax slips a fat-fingered
    PromQL edit actually makes."""
    if not expr or not expr.strip():
        return "empty expr"
    stack: list[str] = []
    in_str: str | None = None
    for ch in expr:
        if in_str:
            if ch == in_str:
                in_str = None
            continue
        if ch in "'\"":
            in_str = ch
        elif ch in "([{":
            stack.append(ch)
        elif ch in ")]}":
            if not stack or stack.pop() != _PAIRS[ch]:
                return f"unbalanced {ch!r} in expr: {expr.strip()[:80]}"
    if in_str:
        return f"unterminated string in expr: {expr.strip()[:80]}"
    if stack:
        return f"unclosed {stack[-1]!r} in expr: {expr.strip()[:80]}"
    return None


def _lint_rule(path: str, group: str, rule, idx: int) -> list[str]:
    where = f"{path}: group {group!r} rule #{idx}"
    errors: list[str] = []
    if not isinstance(rule, dict):
        return [f"{where}: not a mapping"]
    if "alert" not in rule and "record" not in rule:
        errors.append(f"{where}: needs 'alert' or 'record'")
    expr = rule.get("expr")
    if not isinstance(expr, str):
        errors.append(f"{where}: missing/non-string 'expr'")
    else:
        err = check_expr(expr)
        if err:
            errors.append(f"{where}: {err}")
    if "for" in rule and not _DURATION.match(str(rule["for"]).strip()):
        errors.append(f"{where}: bad 'for' duration {rule['for']!r}")
    labels = rule.get("labels") or {}
    sev = labels.get("severity")
    if "alert" in rule and sev is not None and sev not in _SEVERITIES:
        errors.append(f"{where}: unknown severity {sev!r}")
    if "alert" in rule and not (rule.get("annotations") or {}).get("summary"):
        errors.append(f"{where}: alert without an annotations.summary")
    return errors


def _regex_lint_rules(path: str) -> list[str]:
    """No-PyYAML fallback: every alert must carry an expr, exprs must
    balance, and the file must declare a groups: root."""
    with open(path) as f:
        text = f.read()
    errors: list[str] = []
    if not re.search(r"^groups:\s*$", text, re.M):
        errors.append(f"{path}: no top-level 'groups:' key")
    n_alerts = len(re.findall(r"^\s*-?\s*alert:\s*\S+", text, re.M))
    n_exprs = len(re.findall(r"^\s*expr:", text, re.M))
    if n_alerts > n_exprs:
        errors.append(f"{path}: {n_alerts} alerts but only {n_exprs} exprs")
    for m in re.finditer(r"expr:\s*([^\n|]+)\n", text):
        err = check_expr(m.group(1))
        if err:
            errors.append(f"{path}: {err}")
    return errors


def lint_rules_file(path: str) -> list[str]:
    """Validate one Prometheus rule file; [] when clean."""
    promtool = shutil.which("promtool")
    if promtool:
        r = subprocess.run(
            [promtool, "check", "rules", path],
            capture_output=True, text=True, timeout=60,
        )
        if r.returncode != 0:
            return [f"{path}: promtool: {(r.stderr or r.stdout).strip()}"]
        return []
    data, err = _load_yaml(path)
    if err:
        return [err]
    if data is None:
        return _regex_lint_rules(path)
    errors: list[str] = []
    groups = data.get("groups") if isinstance(data, dict) else None
    if not isinstance(groups, list) or not groups:
        return [f"{path}: expected a non-empty top-level 'groups' list"]
    for g in groups:
        if not isinstance(g, dict) or "name" not in g:
            errors.append(f"{path}: group without a 'name'")
            continue
        rules = g.get("rules")
        if not isinstance(rules, list) or not rules:
            errors.append(f"{path}: group {g['name']!r} has no rules")
            continue
        for i, rule in enumerate(rules):
            errors.extend(_lint_rule(path, g["name"], rule, i))
    return errors


def lint_prometheus_config(path: str) -> list[str]:
    """Validate the scrape config: parseable + scrape_configs present."""
    data, err = _load_yaml(path)
    if err:
        return [err]
    if data is None:
        return []  # no YAML parser available; rule files still regex-lint
    errors = []
    if not isinstance(data, dict) or not data.get("scrape_configs"):
        errors.append(f"{path}: no scrape_configs")
    return errors


def lint_grafana_dashboard(path: str) -> list[str]:
    """Validate the dashboard JSON: parseable, panels carry non-empty
    target exprs."""
    try:
        with open(path) as f:
            data = json.load(f)
    except json.JSONDecodeError as e:
        return [f"{path}: JSON parse error: {e}"]
    errors = []
    panels = data.get("panels")
    if not isinstance(panels, list) or not panels:
        return [f"{path}: no panels"]
    for p in panels:
        title = p.get("title", "<untitled>")
        for t in p.get("targets", []):
            err = check_expr(t.get("expr", ""))
            if err:
                errors.append(f"{path}: panel {title!r}: {err}")
    return errors


def lint_monitoring_tree(monitoring_dir: str) -> list[str]:
    """Lint every config the ``monitoring/`` tree ships: all Prometheus rule
    files (top level + ``prometheus/rules/``), the scrape config, and the
    Grafana dashboard. Returns every error found, aggregated."""
    import glob
    import os

    errors: list[str] = []
    rule_files = sorted(
        glob.glob(os.path.join(monitoring_dir, "alert_rules.yml"))
        + glob.glob(os.path.join(monitoring_dir, "prometheus", "rules", "*.yml"))
    )
    if not rule_files:
        errors.append(f"{monitoring_dir}: no Prometheus rule files found")
    for path in rule_files:
        errors.extend(lint_rules_file(path))
    scrape = os.path.join(monitoring_dir, "prometheus.yml")
    if os.path.exists(scrape):
        errors.extend(lint_prometheus_config(scrape))
    dashboard = os.path.join(monitoring_dir, "grafana_dashboard.json")
    if os.path.exists(dashboard):
        errors.extend(lint_grafana_dashboard(dashboard))
    return errors


def main(argv: list[str] | None = None) -> int:
    """CLI for CI: ``python -m fraud_detection_tpu_torch.monitor.promlint
    [monitoring_dir]`` — exits 1 on any error, printing each one."""
    import sys

    args = argv if argv is not None else sys.argv[1:]
    monitoring_dir = args[0] if args else "monitoring"
    errors = lint_monitoring_tree(monitoring_dir)
    for err in errors:
        print(err)
    if not errors:
        print(f"{monitoring_dir}: all monitoring configs clean")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
