"""Static lock order and lock hygiene over the port's named locks.

The port's counterpart of the JAX package's ``analysis/lockcheck.py``, by
intent. Three checks ride the :mod:`.locknames` inventory:

1. **The acquisition-order graph** (:func:`build_lock_report`): every
   ``with <lock>:`` site of the package is resolved to a canonical lock
   name; a directly nested acquisition records an order edge, and a one-hop
   closure adds an edge for a call made while a lock is held to a function
   that itself takes a named lock (``take_snapshot`` holding
   ``lifeboat.flush`` calls ``journal.rotate``, which takes
   ``lifeboat.journal``: the edge ``lifeboat.flush → lifeboat.journal``).
   A cycle is an ABBA deadlock waiting for its timing; the graph must be
   acyclic. The runtime witness (:mod:`fraud_detection_tpu_torch.utils.lockdep`)
   checks the same property on the orders a run takes: static for
   coverage, dynamic for call chains deeper than one hop.

2. **Inventory drift**: every ``lockdep.lock("name")`` /
   ``lockdep.rlock("name")`` creation site must have a matching
   :class:`~.locknames.LockDecl` (same module, same kind), and every
   declaration a creation site.

3. **Two rules** (per module; a sanction is a ``# lockcheck:
   ignore[rule-id]`` comment with its reason, :mod:`.core`):

   - ``blocking-under-lock``: a blocking call — a host wait (fsync, socket
     I/O, sleep, a future's result) or a device wait
     (:func:`.core.device_wait`: ``torch.cuda.synchronize``, a stream's or
     event's ``.synchronize``, and ``.item()``, ``.cpu()``, ``.tolist()``,
     ``.numpy()`` with no arguments) — or a call to a same-module function
     that makes one, inside a held named lock. Each hit is a fault or a
     reviewed design point carrying a sanction (the journal's group-commit
     fsync under its own lock is the canonical one).
   - ``lock-in-capture``: a threading primitive created, or a named lock
     taken, inside a captured body (``torch.compile``, ``torch.jit.script``,
     a ``torch.cuda.graph`` block): a graph replay skips the lock.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from fraud_detection_tpu_torch.analysis import locknames
from fraud_detection_tpu_torch.analysis.core import (
    DEFAULT_EXCLUDES,
    ModuleInfo,
    Severity,
    device_wait,
    dotted_name,
    iter_python_files,
    register_rule,
)
from fraud_detection_tpu_torch.analysis.locknames import LockDecl

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

#: dotted-name suffixes that block the calling thread on the host, whatever
#: their arguments; the device waits are :func:`.core.device_wait`'s.
#: Narrow on purpose: a hit under a held lock is worth a human decision
#: (fix or sanction) — no ``.join`` (``str.join``) or broad "I/O-ish" names.
BLOCKING_SUFFIXES: frozenset[str] = frozenset({
    "os.fsync",
    "os.fdatasync",
    "time.sleep",
    ".sendall",
    ".recv",
    ".recv_into",
    ".accept",
    ".connect",
    ".result",
})

_THREADING_PRIMITIVES: frozenset[str] = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Event", "threading.Semaphore", "threading.BoundedSemaphore",
    "threading.Barrier", "lockdep.lock", "lockdep.rlock",
})


def _by_attr(locks: tuple[LockDecl, ...]) -> dict[str, list[LockDecl]]:
    out: dict[str, list[LockDecl]] = {}
    for d in locks:
        out.setdefault(d.attr, []).append(d)
    return out


def _hint_matches(hint: str, cls: str) -> bool:
    """Receiver name ↔ class name: ``boat`` ↔ ``Lifeboat``, ``drift`` ↔
    ``DriftMonitor``, ``journal`` ↔ ``Journal``. A receiver under 3
    characters (``self._f``, loop variables) carries no type evidence and
    never matches."""
    h, c = hint.lower().lstrip("_"), cls.lower()
    return len(h) >= 3 and (h in c or c in h)


# -- lock-name resolution ------------------------------------------------------


class _ClassMap:
    """class name → base-class names, by name and not by object: a subclass
    in another module names its base textually, which is all the resolver
    needs (``MeshDriftMonitor(DriftMonitor)`` inherits ``drift.window``)."""

    def __init__(self):
        self.bases: dict[str, set[str]] = {}

    def add_module(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                names = {dn.split(".")[-1] for dn in map(dotted_name, node.bases) if dn}
                self.bases.setdefault(node.name, set()).update(names)

    def is_a(self, cls: str, base: str) -> bool:
        seen: set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop()
            if c == base:
                return True
            if c not in seen:
                seen.add(c)
                stack.extend(self.bases.get(c, ()))
        return False


def resolve_lock_name(expr: ast.AST, enclosing_cls: str | None,
                      classes: _ClassMap) -> str | None:
    """The canonical name of a ``with <expr>:`` item, or None when the
    expression is not (recognisably) a named lock of the inventory."""
    dn = dotted_name(expr)
    if dn is None:
        return None
    parts = dn.split(".")
    decls = _by_attr(locknames.LOCKS).get(parts[-1])
    if not decls:
        return None
    # self.<attr>: the owning class, or a subclass of it, declares it
    if parts[:-1] == ["self"] and enclosing_cls is not None:
        for d in decls:
            if d.cls and classes.is_a(enclosing_cls, d.cls):
                return d.name
    # an attribute name unique in the inventory (flush_lock, _retrain_lock, ...)
    if len(decls) == 1:
        return decls[0].name
    # a receiver hint: boat.flush_lock / self.pool._lock / journal._lock
    if len(parts) >= 2 and parts[-2] != "self":
        for d in decls:
            if d.cls and _hint_matches(parts[-2], d.cls):
                return d.name
    return None


# -- the package index: every function, what it takes, what it calls under it --


@dataclass
class _Func:
    module: str  # relative to the scan's root
    cls: str | None
    name: str
    node: ast.AST
    #: named locks this function takes anywhere in its own body
    acquires: list[tuple[str, int]] = field(default_factory=list)
    #: direct nesting: (held, taken, line)
    edges: list[tuple[str, str, int]] = field(default_factory=list)
    #: calls made while a lock is held: (the innermost held lock, the call)
    calls_under: list[tuple[str, ast.Call]] = field(default_factory=list)


def _walk_function(fn: _Func, classes: _ClassMap) -> None:
    """One pass over a function's body keeping the stack of held locks; a
    nested definition is a function of its own and is skipped here."""

    def visit(node: ast.AST, held: tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (*_FuncDef, ast.Lambda)):
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                names = [ln for item in child.items if (ln := resolve_lock_name(
                    item.context_expr, fn.cls, classes)) is not None]
                for ln in names:
                    fn.acquires.append((ln, child.lineno))
                    fn.edges.extend((h, ln, child.lineno) for h in held if h != ln)
                visit(child, held + tuple(names))
                continue
            if isinstance(child, ast.Call) and held:
                fn.calls_under.append((held[-1], child))
            visit(child, held)

    visit(fn.node, ())


def _enclosing_class(node: ast.AST, parents: dict) -> str | None:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = parents.get(cur)
    return None


def _index_package(package_dir: str, root: str):
    """Every function of the package (``build/`` and ``__pycache__``
    pruned), the class map and every ``lockdep.lock``/``rlock`` creation
    site."""
    classes = _ClassMap()
    funcs: list[_Func] = []
    creation_sites: list[dict] = []
    trees: list[tuple[str, ast.AST]] = []
    for path in iter_python_files([package_dir], DEFAULT_EXCLUDES):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue  # a file that does not parse is a rule finding, not this graph's
        trees.append((rel, tree))
        classes.add_module(tree)
    for rel, tree in trees:
        nodes = list(ast.walk(tree))
        parents = {child: parent for parent in nodes for child in ast.iter_child_nodes(parent)}
        for node in nodes:
            if isinstance(node, ast.Call):
                dn = dotted_name(node.func)
                if (dn in ("lockdep.lock", "lockdep.rlock") and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    creation_sites.append({
                        "name": node.args[0].value, "module": rel,
                        "kind": "rlock" if dn.endswith("rlock") else "lock",
                        "line": node.lineno,
                    })
            elif isinstance(node, _FuncDef):
                funcs.append(_Func(module=rel, cls=_enclosing_class(node, parents),
                                   name=node.name, node=node))
    for fn in funcs:
        _walk_function(fn, classes)
    return funcs, classes, creation_sites


def _callee_candidates(call: ast.Call, caller: _Func, funcs_by_name: dict[str, list[_Func]],
                       classes: _ClassMap) -> list[_Func]:
    dn = dotted_name(call.func)
    if dn is None:
        return []
    parts = dn.split(".")
    cands = [f for f in funcs_by_name.get(parts[-1], []) if f.acquires]
    if not cands:
        return []
    if len(parts) == 1:  # a bare call: a function of the same module (or class)
        return [f for f in cands if f.module == caller.module and f.cls in (None, caller.cls)]
    recv = parts[-2]
    if recv == "self" and len(parts) == 2 and caller.cls is not None:
        return [f for f in cands if f.cls and (
            classes.is_a(caller.cls, f.cls) or classes.is_a(f.cls, caller.cls))]
    # a method of another object: the receiver's name must hint at the class
    # (``rows.append`` must not resolve to ``Journal.append``)
    return [f for f in cands if f.cls and _hint_matches(recv, f.cls)]


# -- the report ------------------------------------------------------------------


def _find_cycles(edges: dict[tuple[str, str], list[str]]) -> list[list[str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: list[list[str]] = []
    seen: set[tuple[str, ...]] = set()

    def dfs(node: str, stack: list[str], on_stack: set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_stack:
                body = stack[stack.index(nxt):]
                i = body.index(min(body))  # one rotation a cycle
                canon = tuple(body[i:] + body[:i])
                if canon not in seen:
                    seen.add(canon)
                    cycles.append(list(canon) + [canon[0]])
                continue
            stack.append(nxt)
            on_stack.add(nxt)
            dfs(nxt, stack, on_stack)
            on_stack.discard(nxt)
            stack.pop()

    for start in sorted(graph):
        dfs(start, [start], {start})
    return cycles


def check_inventory(creation_sites: list[dict]) -> list[dict]:
    """Drift between the creation sites and the inventory, both ways."""
    decls = {d.name: d for d in locknames.LOCKS}
    drift: list[dict] = []
    seen: set[str] = set()
    for site in creation_sites:
        d = decls.get(site["name"])
        if d is None:
            drift.append({
                "diagnostic": "undeclared-lock",
                "detail": f"{site['module']}:{site['line']} creates "
                f"lockdep.{site['kind']}({site['name']!r}) with no LockDecl in "
                "analysis/locknames.py",
            })
            continue
        if d.module != site["module"] or d.kind != site["kind"]:
            drift.append({
                "diagnostic": "lock-inventory-drift",
                "detail": f"{site['name']!r} declared as {d.kind} in {d.module} but "
                f"created as {site['kind']} in {site['module']}:{site['line']}",
            })
        seen.add(site["name"])
    drift.extend({
        "diagnostic": "lock-inventory-drift",
        "detail": f"{name!r} declared in locknames.py but no lockdep.{d.kind}({name!r}) "
        f"creation site exists (expected in {d.module})",
    } for name, d in decls.items() if name not in seen)
    return drift


def build_edges(funcs: list[_Func], classes: _ClassMap) -> dict[tuple[str, str], list[str]]:
    """(src, dst) → up to four example sites, from direct nesting and the
    one-hop closure over calls made while a lock is held."""
    funcs_by_name: dict[str, list[_Func]] = {}
    for f in funcs:
        funcs_by_name.setdefault(f.name, []).append(f)
    edges: dict[tuple[str, str], list[str]] = {}

    def add_edge(a: str, b: str, site: str) -> None:
        sites = edges.setdefault((a, b), []) if a != b else None
        if sites is not None and len(sites) < 4 and site not in sites:
            sites.append(site)

    for fn in funcs:
        where = f"{fn.module}:{fn.cls + '.' if fn.cls else ''}{fn.name}"
        for a, b, line in fn.edges:
            add_edge(a, b, f"{where}:{line} (nested with)")
        for held, call in fn.calls_under:
            for cand in _callee_candidates(call, fn, funcs_by_name, classes):
                for acq, _line in cand.acquires:
                    add_edge(held, acq, f"{where}:{call.lineno} -> "
                             f"{cand.cls + '.' if cand.cls else ''}{cand.name}")
    return edges


def package_root() -> str:
    """The directory holding the port's package (the checkout's root)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_lock_report(root: str | None = None, package_dir: str | None = None) -> dict:
    """The whole package's lock report: edges (with sites), cycles,
    inventory drift and the inventory itself, in the JAX package's format.
    ``package_dir`` overrides the scanned tree (a fixture package), whose
    drift is not checked: the inventory describes the port's package under
    ``root``."""
    root = package_root() if root is None else root
    overridden = package_dir is not None
    if package_dir is None:
        package_dir = os.path.join(root, "fraud_detection_tpu_torch")
    funcs, classes, creation_sites = _index_package(package_dir, root)
    edges = build_edges(funcs, classes)
    cycles = _find_cycles(edges)
    drift = [] if overridden else check_inventory(creation_sites)
    return {
        "locks": [{"name": d.name, "module": d.module, "cls": d.cls, "attr": d.attr,
                   "kind": d.kind, "purpose": d.purpose}
                  for d in locknames.LOCKS],
        "edges": [{"src": a, "dst": b, "sites": sites}
                  for (a, b), sites in sorted(edges.items())],
        "cycles": [" -> ".join(c) for c in cycles],
        "inventory_drift": drift,
        "ok": not cycles and not drift,
    }


def violation_keys(report: dict) -> list[str]:
    """Stable keys: one a cycle, one a drift entry."""
    keys = [f"lock-cycle:{c}" for c in report["cycles"]]
    keys.extend(f"{d['diagnostic']}:{d['detail'].split(' ', 1)[0]}"
                for d in report["inventory_drift"])
    return keys


# -- the rules ----------------------------------------------------------------------


def _module_classes(mod: ModuleInfo) -> _ClassMap:
    cm = _ClassMap()
    cm.add_module(mod.tree)
    return cm


def blocking_call(node: ast.Call) -> str | None:
    """The dotted name of a blocking call, or None."""
    dn = dotted_name(node.func)
    if dn is None:
        return None
    for suffix in BLOCKING_SUFFIXES:
        if suffix.startswith("."):
            if dn.endswith(suffix) and dn != suffix[1:]:
                return dn
        elif dn == suffix or dn.endswith("." + suffix):
            return dn
    return device_wait(node)


def _directly_blocking_functions(mod: ModuleInfo) -> dict[str, str]:
    """function name → the blocking call it makes (the same-module one-hop
    closure: ``_sync_locked`` fsyncs, so calling it under a lock is a hit
    at the call)."""
    out: dict[str, str] = {}
    for node in mod.nodes:
        if isinstance(node, _FuncDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and (op := blocking_call(sub)) is not None:
                    out[node.name] = op
                    break
    return out


@register_rule(
    "blocking-under-lock",
    Severity.WARNING,
    "a blocking call (fsync, socket I/O, sleep, a device wait) while holding a "
    "named lock: a latency cliff for every thread queued on that lock; fix it "
    "or sanction it with its reason",
)
def check_blocking_under_lock(mod: ModuleInfo):
    classes = _module_classes(mod)
    blocking_fns = _directly_blocking_functions(mod)
    for node in mod.nodes:
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        cls = _enclosing_class(node, mod.parents)
        held = next((ln for item in node.items if (ln := resolve_lock_name(
            item.context_expr, cls, classes)) is not None), None)
        if held is None:
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) or any(
                    isinstance(p, (*_FuncDef, ast.Lambda)) for p in _parents_upto(mod, sub, node)):
                continue  # a definition under a lock does not run under it
            op = blocking_call(sub)
            if op is not None:
                yield mod.finding(check_blocking_under_lock.rule, sub,
                                  f"{op}() while holding {held!r}")
                continue
            dn = dotted_name(sub.func)
            if dn is None:
                continue
            callee = dn.split(".")[-1]
            via = blocking_fns.get(callee)
            if via is not None and dn in (callee, f"self.{callee}"):
                yield mod.finding(check_blocking_under_lock.rule, sub,
                                  f"{callee}() blocks ({via}) and is called while "
                                  f"holding {held!r}")


def _parents_upto(mod: ModuleInfo, node: ast.AST, top: ast.AST):
    cur = mod.parents.get(node)
    while cur is not None and cur is not top:
        yield cur
        cur = mod.parents.get(cur)


@register_rule(
    "lock-in-capture",
    Severity.ERROR,
    "a threading primitive or named lock inside a captured body (torch.compile, "
    "torch.jit.script, a torch.cuda.graph block): the capture records it once and "
    "a graph replay skips it",
)
def check_lock_in_capture(mod: ModuleInfo):
    if not (mod.captured_functions or mod.captured_blocks):
        return
    classes = _module_classes(mod)
    for node in mod.nodes:
        if not mod.in_capture_context(node):
            continue
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            if dn in _THREADING_PRIMITIVES or (
                    dn is not None and dn.split(".")[0] == "threading"
                    and len(dn.split(".")) == 2):
                yield mod.finding(check_lock_in_capture.rule, node,
                                  f"{dn}() created inside a captured body")
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            cls = _enclosing_class(node, mod.parents)
            for item in node.items:
                ln = resolve_lock_name(item.context_expr, cls, classes)
                if ln is not None:
                    yield mod.finding(
                        check_lock_in_capture.rule, node,
                        f"named lock {ln!r} taken inside a captured body (recorded once, "
                        "skipped by every replay)")


LOCK_RULES = (check_blocking_under_lock.rule, check_lock_in_capture.rule)
