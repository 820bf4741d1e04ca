"""The monitoring configs against the port: ``monitor/promlint.py`` gives
the JAX package's findings on the shipped ``monitoring/`` tree and on a
broken one, with PyYAML and with it blocked (the regex fallback), and its
CLI exits as JAX's does; and every metric that the rules file of each
ported tier names is exported by the port — the API's registry, or the
store server's own (``service/netserver.store_metrics``) for the
``fraud_store_*`` series."""

import glob
import os
import re
import sys
from types import SimpleNamespace

import pytest
import torch

from fraud_detection_tpu.monitor import promlint as jax_promlint
from fraud_detection_tpu_torch.monitor import promlint
from fraud_detection_tpu_torch.service import metrics, netserver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONITORING = os.path.join(ROOT, "monitoring")
RULES_DIR = os.path.join(MONITORING, "prometheus", "rules")

#: the rules files of the tiers the port serves
PORTED = ["alert_rules.yml", "fraud-detection-alerts.yml", "watchtower-alerts.yml",
          "lifecycle-alerts.yml", "telemetry-alerts.yml", "slo-alerts.yml",
          "ledger-alerts.yml", "wide-alerts.yml", "ingest-alerts.yml",
          "lifeboat-alerts.yml", "mesh-alerts.yml", "longhaul-alerts.yml"]
#: the rules files of tiers still to be ported, and the ROADMAP item that
#: ports each (none: every shipped tier is ported)
WAITING: dict[str, str] = {}

_PROMQL_WORDS = {"and", "or", "unless", "bool", "offset"}


def _path(name: str) -> str:
    return os.path.join(MONITORING if name == "alert_rules.yml" else RULES_DIR, name)


def _referenced_metrics(path: str) -> set[str]:
    """The metric names a rules file's exprs read: quoted label values
    (``device_compute``, ``gate_failed``, ``rolling_back``), label matchers,
    ``by``/``on`` lists, range selectors and function names stripped."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    names: set[str] = set()
    for group in doc["groups"]:
        for rule in group["rules"]:
            e = re.sub(r'"[^"]*"', '""', rule["expr"])
            e = re.sub(r"\{[^}]*\}", "", e)
            e = re.sub(r"\b(by|without|on|ignoring|group_left|group_right)\s*\([^)]*\)", "", e)
            e = re.sub(r"\[[^\]]*\]", "", e)
            names |= set(re.findall(r"\b[a-zA-Z_:][a-zA-Z0-9_:]*\b(?!\s*\()", e))
    return names - _PROMQL_WORDS


def _exported() -> set[str]:
    """Every series name the port exports: a counter's ``_total``, a
    histogram's ``_bucket``/``_sum``/``_count``, a gauge's name."""
    stub = SimpleNamespace(broker=SimpleNamespace(depth=lambda: 0))
    names = set()
    for m in list(metrics.REGISTRY) + netserver.store_metrics(stub):
        if m.kind == "counter":
            names.add(f"{m.name}_total")
        elif m.kind == "histogram":
            names |= {f"{m.name}_{s}" for s in ("bucket", "sum", "count")}
        else:
            names.add(m.name)
    return names


@pytest.fixture()
def no_promtool(monkeypatch):
    monkeypatch.setattr(promlint.shutil, "which", lambda *_: None)
    monkeypatch.setattr(jax_promlint.shutil, "which", lambda *_: None)


def _broken_tree(root):
    (root / "prometheus" / "rules").mkdir(parents=True)
    (root / "alert_rules.yml").write_text(
        "groups:\n  - name: g\n    rules:\n"
        "      - alert: NoExpr\n        labels: {severity: warning}\n"
        "        annotations: {summary: s}\n"
        "      - alert: Unbalanced\n        expr: sum(rate(x[5m])) > (1\n"
        "        for: 5minutes\n        labels: {severity: mystery}\n")
    (root / "prometheus" / "rules" / "empty.yml").write_text("not_groups: []\n")
    (root / "prometheus.yml").write_text("global: {}\n")
    (root / "grafana_dashboard.json").write_text(
        '{"panels": [{"title": "p", "targets": [{"expr": "sum(x"}]}]}')
    return str(root)


@pytest.mark.parametrize("yaml_blocked", [False, True])
def test_lint_findings_match_jax(yaml_blocked, no_promtool, tmp_path, monkeypatch):
    if yaml_blocked:
        monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises
    assert promlint.lint_monitoring_tree(MONITORING) == \
        jax_promlint.lint_monitoring_tree(MONITORING) == []
    broken = _broken_tree(tmp_path / "monitoring")
    got = promlint.lint_monitoring_tree(broken)
    assert got == jax_promlint.lint_monitoring_tree(broken)
    assert got  # the broken tree is caught either way
    for name in PORTED:
        assert promlint.lint_rules_file(_path(name)) == \
            jax_promlint.lint_rules_file(_path(name)) == []


@pytest.mark.parametrize("expr", [
    "sum(rate(x[5m]))", "sum(rate(x[5m]))) > 1", "sum(rate(x[5m])", 'x{job="api} > 1',
    "   ", "", "max by (a) (y{l='v'}) > 0", "a[5m] ] ",
])
def test_check_expr_matches_jax(expr):
    assert promlint.check_expr(expr) == jax_promlint.check_expr(expr)


def test_promlint_cli_exits_as_jax(no_promtool, tmp_path, capsys):
    assert promlint.main([MONITORING]) == jax_promlint.main([MONITORING]) == 0
    assert "clean" in capsys.readouterr().out
    broken = _broken_tree(tmp_path / "monitoring")
    assert promlint.main([broken]) == jax_promlint.main([broken]) == 1


@pytest.mark.parametrize("name", PORTED)
def test_every_metric_a_ported_rules_file_names_is_exported(name):
    referenced = _referenced_metrics(_path(name))
    assert referenced, f"{name} names no metric?"
    missing = referenced - _exported()
    assert not missing, f"{name} reads series the port does not export: {sorted(missing)}"


def test_every_rules_file_is_ported_or_waiting():
    shipped = {os.path.basename(p) for p in glob.glob(os.path.join(RULES_DIR, "*.yml"))}
    shipped.add("alert_rules.yml")
    assert shipped == set(PORTED) | set(WAITING)
    exported = _exported()
    for name in WAITING:  # their series arrive with the scale-out slice
        assert _referenced_metrics(_path(name)) - exported
