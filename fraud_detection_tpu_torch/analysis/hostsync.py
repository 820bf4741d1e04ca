"""The static half of the program contracts' host-sync check: no host sync
in a flush body, read from the source.

The intent of the JAX package's ``forbid`` list and of its
``rules_jax.check_host_sync``: between the staged batch and the caller's
fetch a flush only enqueues device work, so the fetch is its one host
sync. On the card the program check runs the flush under
``torch.cuda.set_sync_debug_mode("error")``; on the CPU, where nothing
waits for a device, this rule reads the bodies a contract names, and the
port functions they call (one hop: a name defined in the same module,
imported from a port module, or a port module's attribute), for a call
that would wait for the device:

- a device wait (:func:`.core.device_wait`, the lock rule's too):
  ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` with no arguments,
  ``torch.cuda.synchronize`` and a stream's or event's ``.synchronize()``;
- a copy from host memory to the device: ``torch.tensor``,
  ``torch.as_tensor`` or ``torch.asarray`` with a ``device=`` argument, and
  ``.to(device=...)`` without ``non_blocking=True`` (a pageable host
  buffer's copy waits for the device; tables a flush reads are made once,
  outside it);
- ``float(e)``, ``int(e)``, ``bool(e)`` of an expression that may be a
  tensor: anything but a constant, a shape or length, or a parameter
  annotated as a host scalar.

A body is named ``"<path under the package>:<function>"`` (a method as
``Class.method``), such as ``"monitor/drift.py:_fused_flush"``.
"""

from __future__ import annotations

import ast
import os

from fraud_detection_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Severity,
    device_wait,
    dotted_name,
)

PACKAGE = "fraud_detection_tpu_torch"
_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

SCALAR_CASTS = frozenset({"float", "int", "bool"})
#: constructors that copy host data when given a device
H2D_CONSTRUCTORS = frozenset({"torch.tensor", "torch.as_tensor", "torch.asarray"})
#: names whose presence makes a cast's argument a host value
_HOST_HINTS = frozenset({"shape", "ndim", "dim", "numel", "size", "len", "bit_length"})
_HOST_ANNOTATIONS = frozenset({"int", "float", "bool", "str"})

RULE_ID = "host-sync"


def _package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Modules:
    """Parsed port modules, by path under the package."""

    def __init__(self):
        self.package_dir = _package_dir()
        self._mods: dict[str, ModuleInfo | None] = {}

    def get(self, rel: str) -> ModuleInfo | None:
        if rel not in self._mods:
            path = os.path.join(self.package_dir, rel)
            try:
                with open(path, encoding="utf-8") as f:
                    self._mods[rel] = ModuleInfo(path, f"{PACKAGE}/{rel}", f.read())
            except (OSError, SyntaxError):
                self._mods[rel] = None
        return self._mods[rel]


def _find_def(mod: ModuleInfo, qualname: str):
    scope = mod.tree.body
    node = None
    for part in qualname.split("."):
        node = next((n for n in scope if isinstance(n, (*_FuncDef, ast.ClassDef))
                     and n.name == part), None)
        if node is None:
            return None
        scope = node.body
    return node if isinstance(node, _FuncDef) else None


def _module_rel(mods: _Modules, dotted: str) -> str | None:
    """``fraud_detection_tpu_torch.ops.kernels`` → ``ops/kernels.py`` (a
    package → its ``__init__.py``); None outside the port or when absent."""
    if not dotted.startswith(PACKAGE + "."):
        return None
    base = dotted[len(PACKAGE) + 1:].replace(".", "/")
    for rel in (base + ".py", base + "/__init__.py"):
        if os.path.isfile(os.path.join(mods.package_dir, rel)):
            return rel
    return None


def _imports(mods: _Modules, mod: ModuleInfo):
    """Names imported from port modules (name → (module, attr)) and port
    modules bound to a name (alias → module), anywhere in the module (the
    port imports inside functions too)."""
    names: dict[str, tuple[str, str]] = {}
    modules: dict[str, str] = {}
    for node in mod.nodes:
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            rel = _module_rel(mods, node.module)
            for alias in node.names:
                bound = alias.asname or alias.name
                sub = _module_rel(mods, f"{node.module}.{alias.name}")
                if sub is not None:
                    modules[bound] = sub
                elif rel is not None:
                    names[bound] = (rel, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                rel = _module_rel(mods, alias.name)
                if rel is not None and alias.asname:
                    modules[alias.asname] = rel
    return names, modules


def _callees(mods: _Modules, rel: str, mod: ModuleInfo, fn) -> list[tuple[str, str]]:
    """The port functions ``fn`` calls by name: ``(module, qualname)``."""
    names, modules = _imports(mods, mod)
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func)
        if dn is None:
            continue
        parts = dn.split(".")
        if len(parts) == 1:
            if _find_def(mod, parts[0]) is not None:
                out.append((rel, parts[0]))
            elif parts[0] in names:
                out.append(names[parts[0]])
        elif len(parts) == 2 and parts[0] in modules:
            out.append((modules[parts[0]], parts[1]))
    return out


def _host_params(fn) -> set[str]:
    args = fn.args
    return {a.arg for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]
            if a.annotation is not None
            and (dotted_name(a.annotation) or "").split(".")[-1] in _HOST_ANNOTATIONS}


def _maybe_tensor(expr: ast.AST, host: set[str]) -> bool:
    if isinstance(expr, ast.Constant):
        return False
    if isinstance(expr, ast.Name) and expr.id in host:
        return False
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) and sub.attr in _HOST_HINTS:
            return False
        if isinstance(sub, ast.Name) and sub.id in _HOST_HINTS:
            return False
    return True


def sync_calls(fn) -> list[tuple[ast.Call, str]]:
    """The calls in ``fn`` that would wait for the device."""
    host = _host_params(fn)
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func) or ""
        keywords = {k.arg: k.value for k in node.keywords}
        non_blocking = keywords.get("non_blocking")
        asynchronous = isinstance(non_blocking, ast.Constant) and non_blocking.value is True
        if device_wait(node) is not None:
            out.append((node, f"{dn}()"))
        elif "device" in keywords and (
                dn in H2D_CONSTRUCTORS or (dn.endswith(".to") and not asynchronous)):
            out.append((node, f"{dn}(device=...), a host-to-device copy,"))
        elif dn in SCALAR_CASTS and len(node.args) == 1 and _maybe_tensor(node.args[0], host):
            out.append((node, f"{dn}() of {ast.unparse(node.args[0])}"))
    return out


def check_bodies(bodies) -> list[Finding]:
    """Every host sync in ``bodies`` and in the port functions they call
    (one hop), sorted by place; a body that cannot be found is a finding
    too (the contract names a function that is gone)."""
    mods = _Modules()
    todo: list[tuple[str, str]] = []
    findings: list[Finding] = []
    for spec in bodies:
        rel, _, qual = spec.partition(":")
        mod = mods.get(rel)
        fn = _find_def(mod, qual) if mod is not None else None
        if fn is None:
            findings.append(Finding(RULE_ID, Severity.ERROR, f"{PACKAGE}/{rel}", 1, 0,
                                    f"flush body {qual!r} not found", ""))
            continue
        todo.append((rel, qual))
        todo.extend(_callees(mods, rel, mod, fn))
    seen: set[tuple[str, str]] = set()
    for rel, qual in todo:
        if (rel, qual) in seen:
            continue
        seen.add((rel, qual))
        mod = mods.get(rel)
        fn = _find_def(mod, qual) if mod is not None else None
        if fn is None:
            continue  # a one-hop name that is not a function (a class, a constant)
        for node, what in sync_calls(fn):
            if not mod.suppressed(node.lineno, RULE_ID):
                findings.append(Finding(RULE_ID, Severity.ERROR, mod.rel_path, node.lineno,
                                        node.col_offset, f"{what} in {qual}: a host sync",
                                        mod.line_text(node.lineno)))
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings
