"""The port's static rules (``analysis/rules_*.py``) against the JAX
package's, on the CPU.

Each rule that keeps its JAX id runs on JAX's bad and good fixtures from
``tests/analysis_fixtures/`` (read, never written) beside the JAX rule:
the port's rule reads the same source written to ``tmp_path`` in the
port's idiom — the ``graftcheck`` markers as ``lockcheck`` ones,
``prometheus_client`` imports as the port's ``service.metrics``, the JAX
package as the port's, and ``jax.numpy`` as ``torch`` — and must give the
same (rule id, line) list; the good twins are silent. The port's own
fixtures (source strings written to ``tmp_path``: no fixture directory
under ``tests/``) hold the torch allocators, the three capture rules, the
port's metric constructors and ``torch.save``; then the sanction tag's
scope, the markers' tokenisation, a file that does not parse, and the
alert rule on a fixture tree.
"""

from __future__ import annotations

import os
import textwrap

import pytest
import torch

from fraud_detection_tpu.analysis import core as jax_core
from fraud_detection_tpu_torch.analysis import core
from fraud_detection_tpu_torch.analysis.core import Severity, analyze_file, get_rule

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "analysis_fixtures")
METRICS = "fraud_detection_tpu_torch.service.metrics"

#: the rules that keep their JAX id (the alert rule reads a tree: below)
SHARED = ("socket-no-timeout", "silent-except", "thread-nondaemon-nojoin",
          "prom-foreign-registry", "retry-no-backoff", "artifact-nonatomic-write",
          "hot-path-alloc", "hot-path-json")

#: JAX's fixture pairs those rules read, with the findings JAX's rules give
#: on each bad one (so a fixture that stops firing fails here too)
PAIRS = {
    "service": 6, "prometheus": 3, "retry_backoff": 3, "artifact_write": 5,
    "hot_path_alloc": 6, "decode_alloc": 2, "hot_path_json": 4,
}


def as_port(source: str) -> str:
    """A JAX fixture in the port's idiom, line for line."""
    return (source.replace("graftcheck:", "lockcheck:")
            .replace("from prometheus_client import", f"from {METRICS} import")
            .replace("fraud_detection_tpu.", "fraud_detection_tpu_torch.")
            .replace("import jax.numpy as jnp", "import torch as jnp"))


def _write(tmp_path, name: str, source: str) -> str:
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


def _hits(findings) -> list[tuple[str, int]]:
    return sorted((f.rule_id, f.line) for f in findings)


def _port(path: str, root: str, *ids: str):
    return analyze_file(path, root=root, rules=[get_rule(i) for i in (ids or SHARED)])


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_the_shared_rules_read_jaxs_fixtures_as_jaxs_do(tmp_path, pair, kind):
    fixture = os.path.join(FIXTURES, f"{kind}_{pair}.py")
    theirs = jax_core.analyze_file(fixture, root=FIXTURES,
                                   rules=[jax_core.get_rule(i) for i in SHARED])
    with open(fixture) as f:
        mine = _port(_write(tmp_path, f"{kind}_{pair}.py", as_port(f.read())), str(tmp_path))
    assert _hits(mine) == _hits(theirs)
    assert len(mine) == (PAIRS[pair] if kind == "bad" else 0), [f.to_dict() for f in mine]
    # each rule keeps JAX's severity
    assert sorted((f.rule_id, f.severity.name) for f in mine) == sorted(
        (f.rule_id, f.severity.name) for f in theirs)


# -- the port's idiom ---------------------------------------------------------------

BAD_TORCH_ALLOC = """\
import torch
import torch as T

_BUF = torch.zeros(1024, 30)  # module init: not a hot path


def flush(rows):
    # lockcheck: hot-path — once a micro-batch flush
    x = torch.cat(rows)  # 9: no out=
    pad = torch.empty_like(x)  # 10
    mask = T.ones(8)  # 11: through the alias
    both = torch.concat([x, pad])  # 12: no out=
    torch.cat(rows, out=_BUF[: len(rows)])  # into staging: fine
    return x, pad, mask, both


def cold(rows):
    return torch.zeros(len(rows), 30)  # unmarked
"""

GOOD_TORCH_ALLOC = """\
import torch

_BUF = torch.zeros(1024, 30)


def flush(rows):
    # lockcheck: hot-path — stacks into the preallocated staging buffer
    n = len(rows)
    torch.cat(rows, out=_BUF[:n])
    _BUF[n:].zero_()
    tmp = torch.zeros(4)  # lockcheck: ignore[hot-path-alloc] — tiny, reviewed
    return _BUF, tmp
"""


def test_hot_path_alloc_reads_torch_allocators(tmp_path):
    bad = _port(_write(tmp_path, "bad.py", BAD_TORCH_ALLOC), str(tmp_path), "hot-path-alloc")
    assert _hits(bad) == [("hot-path-alloc", n) for n in (9, 10, 11, 12)]
    assert "torch.empty_like" in bad[1].message and "'flush'" in bad[1].message
    good = _port(_write(tmp_path, "good.py", GOOD_TORCH_ALLOC), str(tmp_path), "hot-path-alloc")
    assert good == []


CAPTURE_FIXTURES = {
    "capture-host-sync": ("""\
import torch


@torch.compile
def score(x, w):
    s = (x @ w).sum()
    if s.item() > 0:  # 7
        return x
    return x.cpu()  # 9


def capture(g, x, out):
    with torch.cuda.graph(g):
        y = x * 2
        torch.cuda.synchronize()  # 15
        out.copy_(y)
    return out.tolist()  # after the capture: the caller's fetch
""", [7, 9, 15], """\
import torch


@torch.compile
def score(x, w):
    return torch.sigmoid(x @ w)


def fetch(x, w):
    return score(x, w).cpu()


def capture(g, x, out):
    with torch.cuda.graph(g):
        out.copy_(x * 2)
    torch.cuda.synchronize()
    return g
"""),
    "capture-scalar-closure": ("""\
import torch


def make_scorer(scale, bias):
    @torch.compile
    def score(x):
        return x * scale + bias  # 7: scale and bias
    return score


def make_head(k):
    def head(x):
        return x[:k]  # 13
    return torch.jit.script(head)
""", [7, 7, 13], """\
import functools

import torch


@functools.lru_cache(maxsize=None)
def make_scorer(scale, bias):
    @torch.compile
    def score(x):
        return x * scale + bias
    return score


def make_scorer_args():
    @torch.compile
    def score(x, scale, bias):
        return x * scale + bias
    return score


@torch.compile
def head(x, k: int):
    return x[:k]
"""),
    "capture-tensor-global": ("""\
import torch

_LAST = None
_SEEN = []


class Flusher:
    def __init__(self):
        self.out = torch.zeros(8)
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, x):
        with torch.cuda.graph(self.graph):
            y = x * 2
            self.out = y  # 15
            _SEEN.append(y)  # 16


@torch.compile
def step(x):
    global _LAST  # 21
    _LAST = x + 1
    return _LAST
""", [15, 16, 21], """\
import torch


class Flusher:
    def __init__(self):
        self.out = torch.zeros(8)
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, x):
        with torch.cuda.graph(self.graph):
            self.out.copy_(x * 2)
            self.out[:4] = x[:4]

    def result(self):
        self.last = self.out.clone()
        return self.last
"""),
}


@pytest.mark.parametrize("rule_id", sorted(CAPTURE_FIXTURES))
def test_a_capture_rule_fires_on_its_bad_fixture_and_not_its_good_twin(tmp_path, rule_id):
    bad, lines, good = CAPTURE_FIXTURES[rule_id]
    found = _port(_write(tmp_path, "bad.py", bad), str(tmp_path), rule_id)
    assert [f.line for f in sorted(found, key=lambda f: (f.line, f.col))] == lines
    assert {f.severity for f in found} == {get_rule(rule_id).severity}
    assert _port(_write(tmp_path, "good.py", good), str(tmp_path), rule_id) == []
    # nor does any other rule
    every = analyze_file(str(tmp_path / "good.py"), root=str(tmp_path))
    assert every == []


def test_the_closure_rule_names_what_it_captures(tmp_path):
    found = _port(_write(tmp_path, "bad.py", CAPTURE_FIXTURES["capture-scalar-closure"][0]),
                  str(tmp_path), "capture-scalar-closure")
    assert sorted(f.message.split("captures ")[1].split(" ")[0] for f in found) == [
        "'bias'", "'k'", "'scale'"]


PORT_METRICS_BAD = f"""\
from fraud_detection_tpu_torch.service import metrics
from {METRICS} import REGISTRY, _Metric

seen = metrics.Counter("seen", "rows seen")  # 4: on the shared registry
depth = metrics.Gauge("depth", "d", registry=REGISTRY)  # 5: the shared one by name
raw = _Metric("gauge", "raw", "d")  # 6: not the constructors
"""

PORT_METRICS_GOOD = """\
from fraud_detection_tpu_torch.service import metrics


def store_metrics(srv):
    registry: list = []
    metrics.Gauge("store_depth", "d", registry=registry).set_function(srv.depth)
    return registry
"""


def test_prom_foreign_registry_reads_the_ports_constructors(tmp_path):
    bad = _port(_write(tmp_path, "app.py", PORT_METRICS_BAD), str(tmp_path),
                "prom-foreign-registry")
    assert [f.line for f in bad] == [4, 5, 6]
    assert _port(_write(tmp_path, "store.py", PORT_METRICS_GOOD), str(tmp_path),
                 "prom-foreign-registry") == []
    # the shared registry's own module, and the store server's exporter
    for rel in ("service/metrics.py", "service/netserver.py"):
        path = os.path.join(ROOT, "fraud_detection_tpu_torch", rel)
        assert _port(path, ROOT, "prom-foreign-registry") == []


def test_torch_save_to_an_artifact_path_is_a_nonatomic_write(tmp_path):
    path = _write(tmp_path, "ckpt.py", """\
        import io
        import os

        import torch

        CKPT_FILE = "state.pt"


        def save(state, directory):
            torch.save(state, os.path.join(directory, "model.pt"))  # 10
            torch.save(state, CKPT_FILE)  # 11


        def to_bytes(state):
            buf = io.BytesIO()
            torch.save(state, buf)  # a buffer, not an artifact path
            return buf.getvalue()
        """)
    found = _port(path, str(tmp_path), "artifact-nonatomic-write")
    assert [f.line for f in found] == [10, 11]
    assert all(f.severity is Severity.ERROR for f in found)


# -- sanctions and markers ------------------------------------------------------------


def test_the_sanction_tag_is_rule_scoped(tmp_path):
    path = _write(tmp_path, "m.py", """\
        import socket
        def a():
            # lockcheck: ignore[socket-no-timeout] — reviewed
            return socket.create_connection(('h', 1))
        def b():
            # lockcheck: ignore[silent-except]
            return socket.create_connection(('h', 1))
        def c():
            # graftcheck: ignore[socket-no-timeout]
            return socket.create_connection(('h', 1))
        """)
    # a(): the matching tag; b(): a tag of another rule; c(): JAX's marker
    assert [f.line for f in analyze_file(path, root=str(tmp_path))] == [7, 10]


def test_a_bare_tag_covers_every_rule(tmp_path):
    path = _write(tmp_path, "m.py", """\
        import socket
        s = socket.create_connection(('h', 1))  # lockcheck: ignore
        try:
            pass
        except Exception:  # lockcheck: ignore
            pass
        """)
    assert analyze_file(path, root=str(tmp_path)) == []


def test_a_tag_or_a_marker_inside_a_string_is_inert(tmp_path):
    path = _write(tmp_path, "m.py", """\
        import socket

        import numpy as np

        MSG = '# lockcheck: ignore'
        s = socket.create_connection(('h', 1))


        def f(n):
            note = "# lockcheck: hot-path"
            return np.zeros(n), note
        """)
    assert _hits(analyze_file(path, root=str(tmp_path))) == [("socket-no-timeout", 6)]
    marked = path.replace("m.py", "n.py")
    with open(marked, "w") as f:
        f.write("import numpy as np\n\n\ndef f(n):\n    # lockcheck: hot-path\n"
                "    return np.zeros(n)\n")
    assert _hits(analyze_file(marked, root=str(tmp_path))) == [("hot-path-alloc", 6)]


def test_a_file_that_does_not_parse_is_a_syntax_error_finding(tmp_path):
    path = _write(tmp_path, "m.py", "def broken(:\n")
    (f,) = analyze_file(path, root=str(tmp_path))
    assert f.rule_id == "syntax-error" and f.severity is Severity.ERROR
    assert f.path == "m.py" and f.line == 1


def test_severity_parse_and_the_registry():
    assert Severity.parse("Warning") is Severity.WARNING
    with pytest.raises(ValueError, match="info|warning|error"):
        Severity.parse("fatal")
    ids = {r.id for r in core.iter_rules()}
    assert ids >= set(SHARED) | {"alert-metric-registered", "capture-host-sync",
                                 "capture-scalar-closure", "capture-tensor-global"}
    with pytest.raises(KeyError):
        get_rule("jit-missing-donate")


# -- alert-metric-registered ---------------------------------------------------------


def _monitoring_tree(tmp_path, expr: str, helper: bool = False) -> str:
    """The shape the rule dispatches on, in the port's idiom: a
    ``service/metrics.py`` with its constructors, the store exporter
    beside it (its series by literal name, or through a local helper), and
    one rule file with ``expr``."""
    svc = tmp_path / "pkg" / "service"
    svc.mkdir(parents=True)
    (svc / "metrics.py").write_text(textwrap.dedent("""\
        REGISTRY = []
        def Counter(name, documentation, labelnames=(), registry=None): ...
        def Gauge(name, documentation, labelnames=(), registry=None): ...
        def Histogram(name, documentation, labelnames=(), registry=None): ...
        c = Counter('demo_requests', 'd')
        g = Gauge('demo_depth', 'd', ['shard'])
        h = Histogram('demo_latency_seconds', 'd')
        """))
    store = ("    def gauge(name, doc):\n        metrics.Gauge(name, doc, registry=registry)\n"
             "    gauge('demo_store_seq', 'd')\n") if helper else (
             "    metrics.Gauge('demo_store_seq', 'd', registry=registry)\n")
    (svc / "netserver.py").write_text(
        "from fraud_detection_tpu_torch.service import metrics\n\n\n"
        "def store_metrics(srv):\n    registry: list = []\n" + store + "    return registry\n")
    rules = tmp_path / "monitoring" / "prometheus" / "rules"
    rules.mkdir(parents=True)
    (rules / "alerts.yml").write_text(
        "groups:\n  - name: g\n    rules:\n      - alert: A\n"
        f"        expr: {expr}\n        labels: {{severity: warning}}\n")
    return str(svc / "metrics.py")


def _alert(path: str, root: str) -> list:
    return _port(path, root, "alert-metric-registered")


def test_the_alert_rule_catches_a_dead_series_as_jaxs_does(tmp_path):
    path = _monitoring_tree(
        tmp_path, "rate(demo_requests_total[5m]) + rate(demo_ghost_total[5m]) > 1")
    (dead,) = _alert(path, str(tmp_path))
    assert "demo_ghost_total" in dead.message and "demo_requests" not in dead.message
    assert dead.severity is Severity.ERROR and dead.line == 1
    theirs = jax_core.analyze_file(path, root=str(tmp_path),
                                   rules=[jax_core.get_rule("alert-metric-registered")])
    assert _hits(theirs) == _hits([dead])


def test_the_alert_rule_accepts_live_series_and_the_store_exporter(tmp_path):
    path = _monitoring_tree(
        tmp_path,
        'histogram_quantile(0.95, sum by (le_bin) '
        '(rate(demo_latency_seconds_bucket{stage="a_b"}[5m]))) > 1 '
        "and on() sum without (shard_id) (demo_depth) > 0 and on() demo_store_seq > 0")
    assert _alert(path, str(tmp_path)) == []


def test_a_series_registered_through_a_helper_is_not_seen(tmp_path):
    """Why the store exporter registers each series by its literal name:
    the rule reads a constructor's first literal argument."""
    path = _monitoring_tree(tmp_path, "demo_store_seq > 0", helper=True)
    (dead,) = _alert(path, str(tmp_path))
    assert "demo_store_seq" in dead.message


def test_the_alert_rule_skips_other_modules(tmp_path):
    _monitoring_tree(tmp_path, "demo_ghost > 0")
    other = _write(tmp_path, "pkg/service/app.py", "x = 1\n")
    assert _alert(other, str(tmp_path)) == []
