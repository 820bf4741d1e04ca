"""Capture rules: the failure modes of a recorded body that an eager run on
the CPU cannot show.

The port's counterpart of the JAX package's ``analysis/rules_jax.py``, by
intent. A captured body (:mod:`.core`: a ``torch.compile``,
``torch.jit.script`` or ``torch.jit.trace`` function, or the block of a
``with torch.cuda.graph(...)``) is recorded once and replayed, so three
things that are harmless eagerly go wrong in it:

- ``capture-host-sync``: a device wait (:func:`.core.device_wait`, the
  lock and host-sync rules' own: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()`` with no arguments, any ``.synchronize()``). A CUDA-graph
  capture raises on it; ``torch.compile`` breaks the graph there, and the
  eager remainder waits for the device every call;
- ``capture-scalar-closure``: a ``torch.compile``/``torch.jit.script``
  function nested in another that reads one of the enclosing function's
  arguments. Each new value is a new guard and a recompile. A function
  made inside an ``lru_cache``d factory, whose cache key is exactly the
  captured values, is exempt;
- ``capture-tensor-global``: a value made inside a captured body and
  stored to module-global state or a ``self`` attribute (a ``global``
  statement, a rebinding of ``self.x`` or ``module_global.x``, an
  ``append``-style mutation of either). Under ``torch.cuda.graph`` its
  storage is the graph pool's and the next replay overwrites it; under
  ``torch.compile`` the store escapes the graph. Writing into a static
  buffer's storage (``self.buf[:n] = y``, ``self.buf.copy_(y)``) is the
  remedy and is not flagged.

JAX's ``jit-missing-donate`` has no rule here: donation is XLA's buffer
reuse, and its intent — state updated in place, not rebound — is held on
every program at run time by ``analysis/contracts.check_programs``'
"state in place" check (diagnostic ``dropped-donation``), so a second,
static checker would only restate it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from fraud_detection_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Severity,
    device_wait,
    dotted_name,
    register_rule,
)

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

#: the captures that compile a function, and recompile on a new closure value
_COMPILERS = frozenset({"torch.compile", "torch.jit.script", "jit.script"})
#: container mutators (not ``add``: a tensor's ``.add`` is out of place)
_MUTATORS = frozenset({"append", "extend", "update", "setdefault", "insert"})


def _enclosing_functions(mod: ModuleInfo, node: ast.AST) -> list[ast.AST]:
    """The functions containing ``node``, innermost first."""
    out = []
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, _FuncDef):
            out.append(cur)
        cur = mod.parents.get(cur)
    return out


@register_rule(
    "capture-host-sync",
    Severity.ERROR,
    "a device wait (.item(), .cpu(), .tolist(), .numpy(), .synchronize()) "
    "inside a captured body (torch.compile, torch.jit.script, a "
    "torch.cuda.graph block) — a graph capture raises on it, a compiled "
    "function breaks its graph there and waits for the device every call",
)
def check_capture_host_sync(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_capture_host_sync.rule
    if not (mod.captured_functions or mod.captured_blocks):
        return
    for node in mod.nodes:
        if isinstance(node, ast.Call) and (dn := device_wait(node)) is not None \
                and mod.in_capture_context(node):
            yield mod.finding(rule, node, f"{dn}() waits for the device inside a captured body")


def _compiled(mod: ModuleInfo, fn: ast.AST) -> bool:
    """``fn`` is compiled by ``torch.compile``/``torch.jit.script`` (a
    decorator, ``partial(torch.compile, ...)``, or handed over by name)."""
    for dec in fn.decorator_list:
        name = dotted_name(dec.func if isinstance(dec, ast.Call) else dec)
        if name in _COMPILERS or (isinstance(dec, ast.Call) and name in (
                "partial", "functools.partial") and dec.args
                and dotted_name(dec.args[0]) in _COMPILERS):
            return True
    return any(isinstance(node, ast.Call) and dotted_name(node.func) in _COMPILERS
               and any(isinstance(sub, ast.Name) and sub.id == fn.name
                       for arg in [*node.args, *(kw.value for kw in node.keywords)]
                       for sub in ast.walk(arg))
               for node in mod.nodes)


def _cached(fn: ast.AST) -> bool:
    return any((dotted_name(dec.func if isinstance(dec, ast.Call) else dec) or "")
               .split(".")[-1] in ("lru_cache", "cache") for dec in fn.decorator_list)


def _params(fn: ast.AST) -> set[str]:
    args = fn.args
    names = {a.arg for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]}
    names.update(a.arg for a in (args.vararg, args.kwarg) if a is not None)
    return names


def _captured_outer_args(fn: ast.AST, enclosing: list[ast.AST]) -> list[tuple[str, ast.AST]]:
    """(name, first load) of each enclosing function's argument that ``fn``
    reads and does not bind itself."""
    local = _params(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
            local.add(node.id)
        elif isinstance(node, _FuncDef) and node is not fn:
            local.add(node.name)
    outer = set().union(*(_params(f) for f in enclosing)) - local
    seen: dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                and node.id in outer and node.id not in seen):
            seen[node.id] = node
    return sorted(seen.items(), key=lambda kv: (kv[1].lineno, kv[1].col_offset))


@register_rule(
    "capture-scalar-closure",
    Severity.WARNING,
    "a torch.compile/torch.jit.script function closes over an enclosing "
    "function's argument — each new value is a new guard and a recompile; "
    "pass it as an argument, or make the function in an lru_cache'd factory",
)
def check_capture_scalar_closure(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_capture_scalar_closure.rule
    for fn in mod.captured_functions:
        enclosing = _enclosing_functions(mod, fn)
        if not enclosing or any(_cached(f) for f in enclosing) or not _compiled(mod, fn):
            continue
        for name, node in _captured_outer_args(fn, enclosing):
            yield mod.finding(rule, node, f"compiled {fn.name!r} captures {name!r} from its "
                              "enclosing function's arguments — each distinct value guards "
                              "and recompiles")


def _module_names(mod: ModuleInfo) -> set[str]:
    """Names bound by module-level assignments (imports and definitions
    aside: reading or calling those is fine)."""
    out: set[str] = set()
    for stmt in mod.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            out.update(sub.id for t in targets for sub in ast.walk(t) if isinstance(sub, ast.Name))
    return out


def _attr_root(node: ast.AST) -> str | None:
    """The root name of an attribute chain (``self.a.b`` → ``self``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@register_rule(
    "capture-tensor-global",
    Severity.ERROR,
    "a value made inside a captured body stored to module-global state or a "
    "self attribute (global, self.x = ..., module_global.append(...)) — under "
    "torch.cuda.graph its storage is the graph pool's and the next replay "
    "overwrites it; copy into a static buffer (self.buf.copy_(y)) instead",
)
def check_capture_tensor_global(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_capture_tensor_global.rule
    if not (mod.captured_functions or mod.captured_blocks):
        return
    holders = _module_names(mod) | {"self"}
    for node in mod.nodes:
        if not mod.in_capture_context(node):
            continue
        if isinstance(node, ast.Global):
            yield mod.finding(rule, node, f"`global {', '.join(node.names)}` inside a captured "
                              "body — the store escapes the capture")
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and _attr_root(t) in holders:
                    yield mod.finding(rule, node, f"{dotted_name(t)} rebound inside a captured "
                                      "body — a graph replay overwrites that storage")
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in _MUTATORS and _attr_root(node.func.value) in holders):
            yield mod.finding(rule, node, f"{dotted_name(node.func)}(...) keeps a value made "
                              "inside a captured body — a graph replay overwrites that storage")
