"""Service-tier rules: the operational hazards of the port's sockets,
threads, handlers and metrics.

The port's counterpart of the JAX package's ``analysis/rules_service.py``,
by intent. The store tier (``service/netserver``, ``service/sentinel``,
``service/netclient``) and the longhaul fleet are hand-rolled sockets and
threads; these rules hold the review checklist that chaos testing kept
finding: blocking I/O with no bound, faults swallowed without a trace,
threads that hold up interpreter exit, metrics that the alert rules and
the ``/metrics`` exposition cannot see, and retry loops that hammer a
failing dependency in lockstep. A reviewed exception carries ``#
lockcheck: ignore[rule-id]`` with its reason (:mod:`.core`).
"""

from __future__ import annotations

import ast
from typing import Iterator

from fraud_detection_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Severity,
    dotted_name,
    register_rule,
)

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


def _assign_target_name(mod: ModuleInfo, call: ast.Call) -> str | None:
    """The dotted name a call's result is bound to (``s = socket.socket()``
    → ``s``; ``self._sock = ...`` → ``self._sock``; ``conn, addr =
    sock.accept()`` → ``conn``)."""
    parent = mod.parents.get(call)
    if isinstance(parent, ast.withitem):
        return dotted_name(parent.optional_vars) if parent.optional_vars is not None else None
    if not isinstance(parent, ast.Assign) or len(parent.targets) != 1:
        return None
    target = parent.targets[0]
    if isinstance(target, ast.Tuple) and target.elts:
        return dotted_name(target.elts[0])
    return dotted_name(target)


def _method_receivers(mod: ModuleInfo, method: str) -> set[str]:
    """Every dotted name X of the module with an ``X.<method>(...)`` call."""
    return {base for node in mod.nodes
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == method and (base := dotted_name(node.func.value))}


@register_rule(
    "socket-no-timeout",
    Severity.WARNING,
    "socket made or accepted without a timeout (socket.socket(), "
    "socket.create_connection() without timeout=, .accept()) — a silently dead "
    "peer blocks the calling thread until TCP gives up (~15 min) or forever; "
    "settimeout() it, or sanction a listener that blocks in accept by design",
)
def check_socket_timeout(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_socket_timeout.rule
    timed = None
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func)
        if callee not in ("socket.create_connection", "socket.socket") and not (
                isinstance(node.func, ast.Attribute) and node.func.attr == "accept"
                and not node.args):
            continue
        if timed is None:
            timed = _method_receivers(mod, "settimeout")
        if callee == "socket.create_connection":
            # create_connection(address, timeout=..., ...)
            has_timeout = len(node.args) >= 2 or any(kw.arg == "timeout" for kw in node.keywords)
            if not has_timeout and _assign_target_name(mod, node) not in timed:
                yield mod.finding(rule, node, "socket.create_connection without a timeout — "
                                  "connect can hang for the kernel default (minutes)")
        elif callee == "socket.socket":
            if _assign_target_name(mod, node) not in timed:
                yield mod.finding(rule, node, "socket.socket() whose handle never gets "
                                  "settimeout() — blocking send/recv on it can wedge the thread")
        elif (isinstance(node.func, ast.Attribute) and node.func.attr == "accept"
              and not node.args):
            if _assign_target_name(mod, node) not in timed:
                yield mod.finding(rule, node, "accepted connection never gets settimeout() — "
                                  "a stalled peer wedges this handler thread")


_LOGGING_HINTS = ("log", "logger", "logging", "warn", "print_exc", "exception")


def _handler_leaves_a_trace(handler: ast.ExceptHandler) -> bool:
    """True when the handler re-raises or logs."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            parts = (dotted_name(node.func) or "").lower().split(".")
            if any(h in parts[0] or h in parts[-1] for h in _LOGGING_HINTS):
                return True
    return False


@register_rule(
    "silent-except",
    Severity.WARNING,
    "`except Exception:` (or a bare except) that neither logs nor re-raises — "
    "swallows real faults invisibly; log it, narrow it, or sanction it with "
    "`# lockcheck: ignore[silent-except]` and the reason",
)
def check_silent_except(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_silent_except.rule
    for node in mod.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is not None and dotted_name(node.type) not in ("Exception", "BaseException"):
            continue  # a narrowed handler may stay quiet
        if not _handler_leaves_a_trace(node):
            kind = "bare except" if node.type is None else "except Exception"
            yield mod.finding(rule, node,
                              f"{kind} swallows the error without logging or re-raising")


def _daemon_set(mod: ModuleInfo, target: str) -> bool:
    """``<target>.daemon = True`` anywhere in the module."""
    return any(isinstance(node, ast.Assign) and len(node.targets) == 1
               and isinstance(t := node.targets[0], ast.Attribute) and t.attr == "daemon"
               and dotted_name(t.value) == target
               and isinstance(node.value, ast.Constant) and node.value.value is True
               for node in mod.nodes)


@register_rule(
    "thread-nondaemon-nojoin",
    Severity.WARNING,
    "non-daemon threading.Thread that is never joined — keeps the process "
    "alive after main exits; pass daemon=True or join it on shutdown",
)
def check_thread_daemon(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_thread_daemon.rule
    joined = None
    for node in mod.nodes:
        if not isinstance(node, ast.Call) or dotted_name(node.func) not in (
                "threading.Thread", "Thread"):
            continue
        if joined is None:
            joined = _method_receivers(mod, "join")
        daemon = next((kw for kw in node.keywords if kw.arg == "daemon"), None)
        if daemon is not None and (not isinstance(daemon.value, ast.Constant)
                                   or daemon.value.value is True):
            continue  # daemon=True, or a value decided at run time: trusted
        target = _assign_target_name(mod, node)
        if target is not None and (target in joined or _daemon_set(mod, target)):
            continue
        yield mod.finding(rule, node, "threading.Thread without daemon=True and no matching "
                          "join() — can block interpreter shutdown indefinitely")


#: the metric constructors (the port's ``service/metrics``, named as
#: prometheus_client names them)
METRIC_CLASSES = frozenset({"Counter", "Gauge", "Histogram", "Summary", "Info", "Enum"})
#: the module whose constructors make the port's metrics, and the one that
#: holds the shared registry
METRICS_MODULE = "fraud_detection_tpu_torch.service.metrics"
_CANONICAL_METRICS = "service/metrics.py"


def _metric_bindings(mod: ModuleInfo):
    """Names bound to a metric constructor (local name → ``(origin,
    class)``, the origin ``"ours"`` or ``"foreign"``), module aliases (name
    → origin) of the port's metrics module and of prometheus_client, and
    the names bound to the bare ``_Metric``. Import-tracked, so
    ``collections.Counter`` never counts."""
    ctors: dict[str, tuple[str, str]] = {}
    aliases: dict[str, str] = {}
    raw: set[str] = set()
    for node in mod.nodes:
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                bound = alias.asname or alias.name
                if node.module == METRICS_MODULE and alias.name in METRIC_CLASSES:
                    ctors[bound] = ("ours", alias.name)
                elif node.module == METRICS_MODULE and alias.name == "_Metric":
                    raw.add(bound)
                elif node.module == "prometheus_client" and alias.name in METRIC_CLASSES:
                    ctors[bound] = ("foreign", alias.name)
                elif f"{node.module}.{alias.name}" == METRICS_MODULE:
                    aliases[bound] = "ours"
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == METRICS_MODULE and alias.asname:
                    aliases[alias.asname] = "ours"
                elif alias.name == "prometheus_client":
                    aliases[alias.asname or alias.name] = "foreign"
    return ctors, aliases, raw


def _local_registries(mod: ModuleInfo) -> set[str]:
    """Names bound to a registry of the module's own: an empty list (the
    port's registry is a list of metrics), ``list()``, or a
    ``CollectorRegistry()`` — netserver's store gauges are the sanctioned
    case."""
    out: set[str] = set()
    for node in mod.nodes:
        value = node.value if isinstance(node, (ast.Assign, ast.AnnAssign)) else None
        fresh = (isinstance(value, ast.List) and not value.elts) or (
            isinstance(value, ast.Call) and not value.args
            and (dotted_name(value.func) or "").split(".")[-1] in ("list", "CollectorRegistry"))
        if not fresh:
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        out.update(name for t in targets if (name := dotted_name(t)))
    return out


@register_rule(
    "prom-foreign-registry",
    Severity.WARNING,
    "metric made outside service/metrics.py on the shared registry (no "
    "registry=, or registry= the shared one), or not by service/metrics' "
    "constructors at all — the alert-rule cross-check and the registry tests "
    "only see service/metrics.py; declare it there, or give it a registry of "
    "the module's own (netserver.store_metrics' list)",
)
def check_prom_foreign_registry(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_prom_foreign_registry.rule
    if mod.rel_path.replace("\\", "/").endswith(_CANONICAL_METRICS):
        return
    ctors, aliases, raw = _metric_bindings(mod)
    if not (ctors or aliases or raw):
        return
    local = _local_registries(mod)
    for node in mod.nodes:
        if not isinstance(node, ast.Call) or (callee := dotted_name(node.func)) is None:
            continue
        head, _, cls = callee.rpartition(".")
        if callee in raw or (head in aliases and cls == "_Metric"):
            yield mod.finding(rule, node, f"{callee}() bypasses service/metrics' constructors "
                              "— make the series with Counter/Gauge/Histogram")
            continue
        if not head and callee in ctors:
            origin, cls = ctors[callee]
        elif head in aliases and cls in METRIC_CLASSES:
            origin = aliases[head]
        else:
            continue
        if origin == "foreign":
            yield mod.finding(rule, node, f"prometheus_client {cls}() is not the port's metric: "
                              "make it with service/metrics' constructors")
            continue
        registry = next((kw.value for kw in node.keywords if kw.arg == "registry"), None)
        if registry is None:
            yield mod.finding(rule, node, f"{cls}() without registry= lands on the shared "
                              "REGISTRY outside service/metrics.py — declare it there, or "
                              "pass a registry of this module's own")
            continue
        name = dotted_name(registry) or ""
        if name not in local:
            yield mod.finding(rule, node, f"{cls}(registry={name or '...'}) minted on a shared "
                              "registry outside service/metrics.py — declare it there, or "
                              "use a registry of this module's own")


def _module_constants(mod: ModuleInfo) -> set[str]:
    """Module-level names bound once to a number (``RETRY_DELAY = 5.0``)."""
    counts: dict[str, int] = {}
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, (int, float))):
            counts[node.targets[0].id] = counts.get(node.targets[0].id, 0) + 1
    return {name for name, n in counts.items() if n == 1}


def _constant_delay(arg: ast.AST, consts: set[str]) -> bool:
    """A sleep argument that is the same number every iteration: a literal,
    a module constant, or ± one. Anything touching loop state, a call or
    an unknown name counts as a real backoff: the rule does not guess."""
    if isinstance(arg, ast.Constant):
        return isinstance(arg.value, (int, float))
    if isinstance(arg, ast.UnaryOp) and isinstance(arg.op, (ast.USub, ast.UAdd)):
        return _constant_delay(arg.operand, consts)
    return isinstance(arg, ast.Name) and arg.id in consts


def _walk_skip_nested_funcs(node: ast.AST):
    """A loop's body without the functions defined in it (a closure runs
    on its own schedule)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if not isinstance(cur, _FuncDef):
            stack.extend(ast.iter_child_nodes(cur))


def _sleep_names(mod: ModuleInfo) -> set[str]:
    """``time.sleep`` and the names ``from time import sleep [as s]`` binds."""
    return {"time.sleep"} | {
        alias.asname or alias.name for node in mod.nodes
        if isinstance(node, ast.ImportFrom) and node.module == "time"
        for alias in node.names if alias.name == "sleep"}


@register_rule(
    "retry-no-backoff",
    Severity.WARNING,
    "retry loop (a for/while whose body handles an exception) sleeping a "
    "constant or zero delay — every client retries in lockstep and hammers "
    "the failing dependency when it can least answer; back off exponentially "
    "with jitter (service/netclient's retry ladder)",
)
def check_retry_no_backoff(mod: ModuleInfo) -> Iterator[Finding]:
    """A poll or serve loop with no exception handling is a schedule, not a
    retry, and is exempt."""
    rule = check_retry_no_backoff.rule
    sleeps = _sleep_names(mod)
    if not any(isinstance(n, ast.Call) and dotted_name(n.func) in sleeps for n in mod.nodes):
        return
    consts = _module_constants(mod)
    flagged: set[int] = set()  # nested loops walk shared subtrees
    for loop in mod.nodes:
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        body = list(_walk_skip_nested_funcs(loop))
        if not any(isinstance(n, ast.ExceptHandler) for n in body):
            continue
        for node in body:
            if (isinstance(node, ast.Call) and node.args and id(node) not in flagged
                    and dotted_name(node.func) in sleeps
                    and _constant_delay(node.args[0], consts)):
                flagged.add(id(node))
                yield mod.finding(rule, node, "retry loop sleeps a constant delay — no "
                                  "exponential backoff, no jitter; a dependency outage gets "
                                  "hammered at a fixed frequency by every replica at once")
