"""The AST engine the port's static rules run on: findings, severities, the
rule registry and the parsed-module model.

The port's own copy of what its rules need from the JAX package's
``analysis/core.py``. Each file is parsed once into a :class:`ModuleInfo` —
the AST plus the facts every rule reads (parent links, the captured bodies,
the comment suppressions) — and handed to each registered :class:`Rule`. A
rule is a function of the module model, registered with
:func:`register_rule`.

Captured bodies take the place of the JAX package's jit-compiled
functions: a function decorated with ``torch.compile`` or
``torch.jit.script`` (or handed to either by name), and a block under
``with torch.cuda.graph(...)``. Such a body is recorded once and replayed,
so host work inside it (a lock, a sync) does not run per call.

Suppression: a finding is dropped when its line, or the line above,
carries ``# lockcheck: ignore[rule-id]`` (or a bare ``# lockcheck:
ignore`` for any rule). The reason stands on the same line or the line
above, so a sanction is a reviewed design point and not a silenced hit.

Hot paths: a ``# lockcheck: hot-path`` comment inside a function marks it
as a steady-state hot region for the perf rules (:mod:`.rules_perf`).
Both comments are read from comment tokens, so a ``#`` inside a string
fakes neither. :func:`Severity.parse` and :func:`get_rule` serve the CLI
(:mod:`.__main__`).
"""

from __future__ import annotations

import ast
import enum
import hashlib
import os
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Callable, Iterable, Iterator


class Severity(enum.IntEnum):
    """ERROR: wrong on the card (a lock a graph replay skips); WARNING: a
    latent operational hazard (a blocking call under a lock); INFO: an
    optimisation opportunity."""

    INFO = 1
    WARNING = 2
    ERROR = 3

    @classmethod
    def parse(cls, s: str) -> "Severity":
        try:
            return cls[s.upper()]
        except KeyError:
            raise ValueError(f"severity must be info|warning|error, got {s!r}") from None


@dataclass(frozen=True)
class Finding:
    rule_id: str
    severity: Severity
    path: str  # relative to the scan's root, forward slashes
    line: int
    col: int
    message: str
    snippet: str  # the source line, stripped

    @property
    def fingerprint(self) -> str:
        """Stable identity: rule + file + the normalised source line. Not
        the line number, so an edit above a finding keeps its identity."""
        norm = re.sub(r"\s+", " ", self.snippet).strip()
        return hashlib.sha1(f"{self.rule_id}|{self.path}|{norm}".encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule_id, "severity": self.severity.name.lower(),
            "path": self.path, "line": self.line, "col": self.col,
            "message": self.message, "snippet": self.snippet,
            "fingerprint": self.fingerprint,
        }


# -- the module model ---------------------------------------------------------

SUPPRESS_RE = re.compile(r"#\s*lockcheck:\s*ignore(?:\[([A-Za-z0-9_,\- ]*)\])?")
#: the marker of a steady-state hot function (the perf rules read it)
HOT_PATH_RE = re.compile(r"#\s*lockcheck:\s*hot-path\b")

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

#: callables whose argument (or decorated function) is captured
CAPTURE_CALLS = frozenset({
    "torch.compile", "torch.jit.script", "jit.script", "torch.jit.trace", "jit.trace",
})
#: context managers whose block is captured
CAPTURE_BLOCKS = frozenset({"torch.cuda.graph", "cuda.graph"})


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains; ``.item`` (a leading dot) when
    the chain's root is a call or a subscript rather than a name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts:
        return "." + ".".join(reversed(parts))
    return None


#: methods that wait for the device when called with no arguments: a
#: tensor's value, its host copy, its list, its array
DEVICE_READS: frozenset[str] = frozenset({"item", "cpu", "tolist", "numpy"})


def device_wait(node: ast.Call) -> str | None:
    """The dotted name of a call that waits for the device, or None: any
    ``.synchronize()`` (``torch.cuda.synchronize``, a stream's, an event's)
    and a :data:`DEVICE_READS` method with no arguments. The lock rule and
    the host-sync rule both read it."""
    dn = dotted_name(node.func)
    if dn is None or "." not in dn:
        return None
    last = dn.rsplit(".", 1)[-1]
    if last == "synchronize" or (last in DEVICE_READS and not node.args and not node.keywords):
        return dn
    return None


def _callee(node: ast.AST) -> str | None:
    return dotted_name(node.func) if isinstance(node, ast.Call) else dotted_name(node)


class ModuleInfo:
    """One parsed module and the facts rules dispatch on."""

    def __init__(self, path: str, rel_path: str, source: str):
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        #: every node, in ``ast.walk`` order: the rules' whole-module walks
        self.nodes: list[ast.AST] = list(ast.walk(self.tree))
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in self.nodes:
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.suppressions, self.hot_path_lines = self._scan_comments()
        self.captured_functions, self.captured_blocks = self._find_captured()

    # -- suppressions and markers -------------------------------------------
    def _scan_comments(self) -> tuple[dict[int, set[str] | None], list[int]]:
        """The suppressions (line → None for every rule, or the rule ids)
        and the lines of the hot-path markers, read from comment tokens,
        so a '#' inside a string cannot fake either."""
        out: dict[int, set[str] | None] = {}
        hot: list[int] = []
        try:
            for tok in tokenize.generate_tokens(StringIO(self.source).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                if HOT_PATH_RE.search(tok.string):
                    hot.append(tok.start[0])
                m = SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                ids = m.group(1)
                out[tok.start[0]] = (None if ids is None or not ids.strip()
                                     else {s.strip() for s in ids.split(",") if s.strip()})
        except tokenize.TokenError:
            pass
        return out, hot

    def suppressed(self, line: int, rule_id: str) -> bool:
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln, "missing")
            if ids is None or (isinstance(ids, set) and rule_id in ids):
                return True
        return False

    # -- captured bodies ----------------------------------------------------
    @staticmethod
    def _decorator_captures(dec: ast.AST) -> bool:
        name = _callee(dec)
        if name in CAPTURE_CALLS:
            return True
        # @partial(torch.compile, ...) / @functools.partial(torch.jit.script, ...)
        return (isinstance(dec, ast.Call) and name in ("partial", "functools.partial")
                and bool(dec.args) and dotted_name(dec.args[0]) in CAPTURE_CALLS)

    def _find_captured(self) -> tuple[set[ast.AST], set[ast.AST]]:
        by_ref: set[str] = set()
        blocks: set[ast.AST] = set()
        for node in self.nodes:
            if isinstance(node, ast.Call) and dotted_name(node.func) in CAPTURE_CALLS:
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    by_ref.update(sub.id for sub in ast.walk(arg) if isinstance(sub, ast.Name))
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and dotted_name(item.context_expr.func) in CAPTURE_BLOCKS
                    for item in node.items):
                blocks.add(node)
        funcs = {node for node in self.nodes if isinstance(node, _FuncDef) and (
            node.name in by_ref or any(self._decorator_captures(d) for d in node.decorator_list))}
        return funcs, blocks

    def in_capture_context(self, node: ast.AST) -> bool:
        """True when ``node`` runs inside a captured body: a captured
        function (or one nested in it), or the block of a
        ``torch.cuda.graph`` context (its items excluded)."""
        cur, prev = self.parents.get(node), node
        while cur is not None:
            if cur in self.captured_functions:
                return True
            if cur in self.captured_blocks and prev in cur.body:
                return True
            prev, cur = cur, self.parents.get(cur)
        return False

    # -- helpers ------------------------------------------------------------
    def line_text(self, line: int) -> str:
        return self.lines[line - 1].strip() if 1 <= line <= len(self.lines) else ""

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule_id=rule.id, severity=rule.severity, path=self.rel_path, line=line,
                       col=getattr(node, "col_offset", 0), message=message,
                       snippet=self.line_text(line))


# -- rules and their registry -------------------------------------------------


@dataclass
class Rule:
    id: str
    severity: Severity
    description: str
    check: Callable[[ModuleInfo], Iterable[Finding]] = field(repr=False)


_REGISTRY: dict[str, Rule] = {}


def register_rule(id: str, severity: Severity, description: str):
    """Decorator: register ``fn(mod) -> Iterable[Finding]`` as a rule; the
    function gets the rule object as ``fn.rule`` to mint findings with
    ``mod.finding(fn.rule, ...)``."""

    def deco(fn):
        if id in _REGISTRY:
            raise ValueError(f"duplicate rule id {id!r}")
        rule = _REGISTRY[id] = Rule(id=id, severity=severity, description=description, check=fn)
        fn.rule = rule
        return fn

    return deco


def iter_rules() -> list[Rule]:
    return list(_REGISTRY.values())


def get_rule(rule_id: str) -> Rule:
    return _REGISTRY[rule_id]


# -- running the rules ---------------------------------------------------------

#: directory names never walked: the git-ignored ``build/`` (kernel
#: libraries, and the whole-repo copies a proof run unpacks there) and
#: bytecode caches. Pruned below the scanned root only, so a tree that
#: itself sits under a ``build/`` directory is still scanned.
DEFAULT_EXCLUDES = ("build", "__pycache__")


def analyze_file(path: str, root: str | None = None,
                 rules: Iterable[Rule] | None = None) -> list[Finding]:
    """Every unsuppressed finding of ``rules`` (default: all registered) in
    one file, its path relative to ``root``."""
    root = root or os.getcwd()
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        mod = ModuleInfo(path, rel, source)
    except SyntaxError as e:
        return [Finding("syntax-error", Severity.ERROR, rel, e.lineno or 1, e.offset or 0,
                        f"file does not parse: {e.msg}", "")]
    return [f_ for rule in (rules if rules is not None else iter_rules())
            for f_ in rule.check(mod) if not mod.suppressed(f_.line, f_.rule_id)]


def iter_python_files(paths: Iterable[str],
                      excludes: Iterable[str] = DEFAULT_EXCLUDES) -> Iterator[str]:
    """The ``.py`` files of ``paths``: a file as given, a directory walked
    in sorted order with the directories named in ``excludes`` pruned."""
    excludes = frozenset(excludes)
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in sorted(dirnames) if d not in excludes]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def analyze_paths(paths: Iterable[str], root: str | None = None,
                  rules: Iterable[Rule] | None = None,
                  excludes: Iterable[str] = DEFAULT_EXCLUDES) -> list[Finding]:
    """:func:`analyze_file` over every file of ``paths``, sorted by place."""
    rules = list(rules) if rules is not None else iter_rules()
    out = [f_ for path in iter_python_files(paths, excludes)
           for f_ in analyze_file(path, root=root, rules=rules)]
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return out
