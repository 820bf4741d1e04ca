"""Artifact durability: every trusted artifact lands atomically.

The port's counterpart of the JAX package's ``analysis/rules_artifacts.py``.
The loaders trust whatever bytes sit at ``model.npz``,
``quant_calibration.npz``, ``ledger_state.npz``, ``wide_params.npz``,
``monitor_profile.npz`` or a rank's ``rank<r>.npz``: a crash in the middle
of an in-place write leaves a torn archive at the trusted name, and the
next start serves garbage or dies in ``np.load``.
:mod:`fraud_detection_tpu_torch.ckpt.atomic` is the one writer (temp file
→ fsync → rename → directory fsync); this rule keeps bare writes from
coming back:

- ``np.savez``/``np.savez_compressed`` outside ``ckpt/atomic.py``
  (``atomic_savez`` is the drop-in; an archive framed in a larger
  container goes through ``savez_bytes`` and ``atomic_write_bytes``);
- ``open(..., "wb")`` (or ``"ab"``) of a path that provably names a
  ``.npz`` (a literal, an f-string's tail, ``os.path.join``'s last part,
  a module-level ``*_FILE`` constant);
- ``torch.save`` to a path that provably names a ``.npz``, ``.pt`` or
  ``.pth`` (the port writes none; a buffer is not a path).

A reviewed exception carries ``# lockcheck: ignore[artifact-nonatomic-write]``.
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

#: the one sanctioned home of a bare np.savez (the helper itself)
_ATOMIC_HELPER = "ckpt/atomic.py"

_SAVEZ_FNS = frozenset({"savez", "savez_compressed"})
_NP_MODULES = frozenset({"np", "numpy"})
_WRITE_MODES = frozenset({"wb", "ab", "wb+", "ab+", "w+b", "a+b"})
_NPZ = (".npz",)
_TORCH_ARTIFACTS = (".npz", ".pt", ".pth")


def _module_str_consts(mod: ModuleInfo) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` bindings (``LEDGER_FILE =
    "ledger_state.npz"``)."""
    return {node.targets[0].id: node.value.value for node in mod.tree.body
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)}


def _names_artifact(node: ast.AST, consts: dict[str, str], suffixes) -> bool:
    """Does this path expression provably end with one of ``suffixes``?
    An expression the rule cannot resolve is not flagged."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.endswith(suffixes)
    if isinstance(node, ast.Name):
        return consts.get(node.id, "").endswith(suffixes)
    if isinstance(node, ast.JoinedStr) and node.values:
        last = node.values[-1]
        return (isinstance(last, ast.Constant) and isinstance(last.value, str)
                and last.value.endswith(suffixes))
    if isinstance(node, ast.Call):
        if dotted_name(node.func) in ("os.path.join", "posixpath.join", "Path") and node.args:
            return _names_artifact(node.args[-1], consts, suffixes)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Div)):
        return _names_artifact(node.right, consts, suffixes)
    return False


@register_rule(
    "artifact-nonatomic-write",
    Severity.ERROR,
    "in-place write of a trusted artifact (np.savez, open('...npz', 'wb'), "
    "torch.save to a .npz/.pt path) — a crash mid-write leaves a torn file at "
    "the name every loader trusts; use ckpt/atomic.atomic_savez (temp file, "
    "fsync, rename, directory fsync)",
)
def check_artifact_nonatomic_write(mod: ModuleInfo) -> Iterator[Finding]:
    rule = check_artifact_nonatomic_write.rule
    if mod.rel_path.replace("\\", "/").endswith(_ATOMIC_HELPER):
        return
    consts = _module_str_consts(mod)
    for node in mod.nodes:
        if not isinstance(node, ast.Call) or (callee := dotted_name(node.func)) is None:
            continue
        parts = callee.split(".")
        if len(parts) == 2 and parts[0] in _NP_MODULES and parts[1] in _SAVEZ_FNS:
            yield mod.finding(rule, node, f"{callee}(...) writes the archive in place — a "
                              "crash mid-write leaves a torn file at the trusted name; use "
                              "ckpt/atomic.atomic_savez (or savez_bytes + atomic_write_bytes "
                              "for framed containers)")
        elif callee == "open" and len(node.args) >= 2:
            mode = node.args[1]
            if (isinstance(mode, ast.Constant) and mode.value in _WRITE_MODES
                    and _names_artifact(node.args[0], consts, _NPZ)):
                yield mod.finding(rule, node, "open(..., 'wb') of a .npz artifact bypasses the "
                                  "atomic write discipline — route the bytes through "
                                  "ckpt/atomic.atomic_write_bytes")
        elif callee == "torch.save" and len(node.args) >= 2:
            if _names_artifact(node.args[1], consts, _TORCH_ARTIFACTS):
                yield mod.finding(rule, node, "torch.save(...) to an artifact path writes it in "
                                  "place — serialize to a buffer and land the bytes through "
                                  "ckpt/atomic.atomic_write_bytes")
