"""Performance rules: allocation churn and per-row interpreter work on the
marked hot paths.

The port's counterpart of the JAX package's ``analysis/rules_perf.py``.
The serving flush stages its rows in recycled, pinned staging slots
(:class:`fraud_detection_tpu_torch.ops.scorer.StagingPool`), the ingest
lane decodes fixed-layout frames into them (``service/binlane``) and the
worker's batched explain pads into one; these rules keep fresh batch
arrays and per-row Python objects from creeping back. A ``# lockcheck:
hot-path`` comment inside a function marks that function (the innermost
one enclosing the comment) as a steady-state hot region; the marker is
read from comment tokens (:mod:`.core`), so it costs nothing at run time
and can sit on the line that says why the region is hot.

- ``hot-path-alloc``: ``zeros``/``empty``/``ones``/``full`` and their
  ``_like`` forms of numpy or torch (any name ``import numpy``/``import
  torch`` binds), and ``stack``/``concatenate``/``cat``/``concat``/
  ``vstack``/``hstack``/``multiply``/``divide`` without ``out=``;
- ``hot-path-json``: ``json.loads``/``json.dumps`` and list, dict and set
  comprehensions.

A reviewed exception carries ``# lockcheck: ignore[hot-path-alloc]`` (or
``[hot-path-json]``) with its reason.
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

#: constructors that always make a fresh buffer (views, in-place ops and
#: ``copyto``/``copy_`` are the replacements; ``asarray`` stays off: the
#: d2h fetch of a result materialises its output by design)
ALLOC_FNS = frozenset({
    "zeros", "empty", "ones", "full", "zeros_like", "empty_like", "ones_like", "full_like",
})
#: combinators that allocate unless written into a preallocated buffer with
#: ``out=`` (``np.stack(rows, out=slot.f32[:n])``; the return-wire decode
#: ``np.multiply(raw, s, out=slot.scores)``)
ALLOC_UNLESS_OUT_FNS = frozenset({
    "stack", "concatenate", "cat", "concat", "vstack", "hstack", "multiply", "divide",
})
_ARRAY_MODULES = frozenset({"np", "numpy", "torch"})


def array_modules(mod: ModuleInfo) -> set[str]:
    """``np``, ``numpy``, ``torch`` and every name ``import numpy as X`` or
    ``import torch as X`` binds in the module."""
    out = set(_ARRAY_MODULES)
    for node in mod.nodes:
        if isinstance(node, ast.Import):
            out.update(alias.asname for alias in node.names
                       if alias.asname and alias.name in ("numpy", "torch"))
    return out


def marked_functions(mod: ModuleInfo) -> set[ast.AST]:
    """The innermost function enclosing each hot-path marker; a marker at
    module level marks nothing (hot paths are functions)."""
    if not mod.hot_path_lines:
        return set()
    funcs = [n for n in mod.nodes if isinstance(n, _FuncDef)]
    marked: set[ast.AST] = set()
    for ln in mod.hot_path_lines:
        inside = [fn for fn in funcs if fn.lineno <= ln <= fn.end_lineno]
        if inside:
            marked.add(max(inside, key=lambda fn: fn.lineno))
    return marked


@register_rule(
    "hot-path-alloc",
    Severity.WARNING,
    "fresh array or tensor (np./torch. zeros, empty, ones, full, their _like "
    "forms; stack, cat, concatenate, multiply, ... without out=) inside a "
    "function marked '# lockcheck: hot-path' — steady-state hot paths reuse "
    "preallocated staging (ops/scorer.StagingPool)",
)
def check_hot_path_alloc(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_hot_path_alloc.rule
    marked = marked_functions(mod)
    modules = array_modules(mod) if marked else set()
    for fn in marked:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or (callee := dotted_name(node.func)) is None:
                continue
            parts = callee.split(".")
            if len(parts) != 2 or parts[0] not in modules:
                continue
            if parts[1] in ALLOC_FNS:
                yield mod.finding(rule, node, f"{callee}(...) allocates a fresh array inside "
                                  f"hot-path region {fn.name!r} — stage into a preallocated "
                                  "buffer (ops/scorer.StagingPool) instead")
            elif parts[1] in ALLOC_UNLESS_OUT_FNS and not any(
                    kw.arg == "out" for kw in node.keywords):
                yield mod.finding(rule, node, f"{callee}(...) without out= allocates a fresh "
                                  f"batch array inside hot-path region {fn.name!r} — pass "
                                  "out=<staging slot> (ops/scorer.StagingPool) instead")


_JSON_CALLS = frozenset({"json.loads", "json.dumps"})
_COMP_NAME = {
    ast.ListComp: "list comprehension",
    ast.DictComp: "dict comprehension",
    ast.SetComp: "set comprehension",
}


@register_rule(
    "hot-path-json",
    Severity.WARNING,
    "json.loads/json.dumps or a per-row list/dict/set comprehension inside a "
    "function marked '# lockcheck: hot-path' — the steady-state ingest and "
    "flush paths decode fixed-layout frames into pooled staging "
    "(service/binlane) and use column math, never per-row Python objects",
)
def check_hot_path_json(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_hot_path_json.rule
    for fn in marked_functions(mod):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and dotted_name(node.func) in _JSON_CALLS:
                yield mod.finding(rule, node, f"{dotted_name(node.func)}(...) inside hot-path "
                                  f"region {fn.name!r} — JSON (de)serialization is per-request "
                                  "interpreter work; use the fixed-layout binary frame decode "
                                  "(service/binlane) instead")
            elif type(node) in _COMP_NAME:
                yield mod.finding(rule, node, f"{_COMP_NAME[type(node)]} inside hot-path region "
                                  f"{fn.name!r} builds one Python object per element — "
                                  "vectorize over the staged columns instead")
