"""The monitoring contract: alert expressions name live series only.

The port's counterpart of the JAX package's
``analysis/rules_monitoring.py``. The dead-series alert: a rule file names
a metric nothing exports (a rename on one side, a typo on the other) and
the alert never fires, because an absent series is an empty vector to
PromQL, not an error. ``tests/test_torch_monitoring_configs.py`` catches
it by importing the live registry; this rule catches it from source alone.
When the scan reaches the port's ``service/metrics.py`` it collects every
name registered there and in the sanctioned exporter beside it
(``service/netserver.py``'s store gauges, each registered by its literal
name), then checks every ``expr:`` of ``monitoring/prometheus/rules/*.yml``
(read with the standard library's regular expressions: no YAML package is
needed) against that set. The rules directory is the one found walking up
from the scanned file, so a copy of the repository checks its own.

Token extraction is conservative: quoted strings, label selectors
``{...}``, range windows ``[5m]``, grouping clauses (``by (...)``,
``on (...)``, ...) and function names are stripped first; what remains
counts as a metric only when it holds an underscore (every series the port
exports does; PromQL keywords and label names such as ``le`` do not).
Counter ``_total`` and histogram ``_bucket``/``_sum``/``_count`` suffixes
are normalised first, as the exposition writes them.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Iterator

from fraud_detection_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Severity,
    register_rule,
)

#: the constructors whose first string argument registers a name
_METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram", "Summary", "Info", "Enum"})

_EXPR_RE = re.compile(r"^\s*expr:\s*(.+?)\s*$", re.M)
_STRING_RE = re.compile(r"'[^']*'|\"[^\"]*\"")
_SELECTOR_RE = re.compile(r"\{[^}]*\}")
_RANGE_RE = re.compile(r"\[[^\]]*\]")
_GROUP_RE = re.compile(r"\b(?:by|without|on|ignoring|group_left|group_right)\s*\([^)]*\)")
_FUNC_RE = re.compile(r"\b[A-Za-z_][A-Za-z0-9_:]*\s*\(")
_TOKEN_RE = re.compile(r"\b[A-Za-z_][A-Za-z0-9_:]*\b")

#: PromQL words with an underscore the extractor could still catch
_PROMQL_WORDS = frozenset({"group_left", "group_right", "bool", "offset", "unless"})

_SUFFIXES = ("_bucket", "_sum", "_count", "_total")

_METRICS_MODULE = "service/metrics.py"
#: exporters beside the shared registry whose names count too: the store
#: server's ``fraud_store_*`` gauges, in a registry of their own
#: (``netserver.store_metrics``; the prom-foreign-registry rule sanctions it)
EXTRA_EXPORTERS = ("netserver.py",)


def _normalize(name: str) -> str:
    for sfx in _SUFFIXES:
        if name.endswith(sfx):
            return name[: -len(sfx)]
    return name


def registered_metric_names(tree: ast.AST) -> set[str]:
    """The names a module registers: the first positional string argument
    of each ``Counter``/``Gauge``/``Histogram``/... call (``metrics.Gauge``
    too)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        ctor = getattr(node.func, "id", None) or getattr(node.func, "attr", None)
        first = node.args[0]
        if (ctor in _METRIC_CTORS and isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            names.add(first.value)
    return names


def metric_tokens(expr: str) -> set[str]:
    """The metric names one PromQL expression may reference."""
    s = expr
    for pattern in (_STRING_RE, _SELECTOR_RE, _RANGE_RE, _GROUP_RE, _FUNC_RE):
        s = pattern.sub(" ", s)  # _FUNC_RE drops a function's name, keeps its args
    return {tok for tok in _TOKEN_RE.findall(s) if "_" in tok and tok not in _PROMQL_WORDS}


def _rules_dir_for(path: str) -> str | None:
    """``monitoring/prometheus/rules`` of the nearest directory above the
    scanned file that holds one."""
    d = os.path.dirname(os.path.abspath(path))
    for _ in range(8):
        cand = os.path.join(d, "monitoring", "prometheus", "rules")
        if os.path.isdir(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None


@register_rule(
    "alert-metric-registered",
    Severity.ERROR,
    "an alert rule expression (monitoring/prometheus/rules/*.yml) names a "
    "metric registered neither in service/metrics.py nor by name in "
    "service/netserver.py — the alert never fires (an empty vector, not an "
    "error)",
)
def check_alert_metrics_registered(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_alert_metrics_registered.rule
    if not mod.rel_path.replace(os.sep, "/").endswith(_METRICS_MODULE):
        return
    rules_dir = _rules_dir_for(mod.path)
    registered = registered_metric_names(mod.tree)
    if rules_dir is None or not registered:
        return
    here = os.path.dirname(os.path.abspath(mod.path))
    for sibling in EXTRA_EXPORTERS:
        try:
            with open(os.path.join(here, sibling), encoding="utf-8") as f:
                registered |= registered_metric_names(ast.parse(f.read()))
        except (OSError, SyntaxError):
            continue  # a fixture tree need not hold every exporter
    for yml in sorted(glob.glob(os.path.join(rules_dir, "*.yml"))):
        try:
            with open(yml, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        dead = {tok for m in _EXPR_RE.finditer(text) for tok in metric_tokens(m.group(1))
                if _normalize(tok) not in registered and tok not in registered}
        if dead:
            yield mod.finding(rule, ast.Module(body=[], type_ignores=[]),
                              f"{os.path.basename(yml)} references metric(s) not registered "
                              f"in service/metrics.py or service/netserver.py: {sorted(dead)} "
                              "— the alert would never fire (an empty vector, not an error)")
