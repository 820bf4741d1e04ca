"""The baseline: accepted findings and violation keys, checked in beside
this module as ``baseline.json``.

The port's counterpart of the JAX package's ``analysis/baseline.py``. The
gate is "nothing beyond the baseline", so a new pass can be adopted on a
tree with accepted debt without fixing all of it in the same change. The
port's baseline is empty in all three sections, and stays so: every
finding is repaired or sanctioned in place with its reason. Lint findings
match by :attr:`~.core.Finding.fingerprint` (rule + file + normalised
source line) as a multiset, so

- an edit above a baselined finding keeps it matched (no line numbers);
- a repaired finding never breaks the gate (its entry is reported stale,
  to be pruned);
- a new instance of a baselined pattern on another source line is caught.

The ``contracts`` and ``lockcheck`` sections hold the stable violation
keys of the program contracts and the lock pass (edited by hand).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from dataclasses import dataclass
from typing import Iterable

from fraud_detection_tpu_torch.analysis.core import Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


@dataclass
class BaselineResult:
    new: list[Finding]  # findings the baseline does not cover
    suppressed: list[Finding]  # findings matched against baseline entries
    stale: list[dict]  # baseline entries matching nothing (prunable)


def _load_doc(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load(path: str) -> list[dict]:
    """The accepted lint findings."""
    return _load_doc(path).get("findings", [])


def load_section(path: str, section: str) -> list[str]:
    """The accepted violation keys of a non-lint pass (``"contracts"`` or
    ``"lockcheck"``): the stable strings each pass makes
    (``entrypoint:diagnostic``, ``lock-cycle:a -> b -> a``)."""
    return [v for v in _load_doc(path).get(section, []) if isinstance(v, str)]


def save(path: str, findings: Iterable[Finding]) -> None:
    """Accept ``findings`` as the lint section; the key sections are kept."""
    prior = _load_doc(path)
    doc = {
        "comment": (
            "the port's static-analysis baseline, a section a pass. `findings` is "
            "the lint pass (regenerate with `python -m "
            "fraud_detection_tpu_torch.analysis --write-baseline` after reviewing "
            "that every entry is an accepted exception); `contracts` and "
            "`lockcheck` hold accepted violation keys of the program contracts and "
            "the lock pass (edit by hand). Empty is the norm."
        ),
        "findings": [f.to_dict() for f in findings],
        "contracts": prior.get("contracts", []),
        "lockcheck": prior.get("lockcheck", []),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def apply_keys(keys: list[str], accepted: list[str]) -> tuple[list[str], list[str]]:
    """Multiset diff of violation keys against a baseline section:
    ``(new, stale)`` — the keys the section does not cover, and its
    entries that match no current violation."""
    budget = Counter(accepted)
    new: list[str] = []
    for k in keys:
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            new.append(k)
    return new, list(budget.elements())


def apply(findings: list[Finding], entries: list[dict]) -> BaselineResult:
    """Multiset diff of lint findings against the baseline's entries, by
    fingerprint."""
    budget = Counter(e.get("fingerprint") for e in entries)
    new: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            suppressed.append(f)
        else:
            new.append(f)
    stale: list[dict] = []
    for e in entries:
        fp = e.get("fingerprint")
        if budget.get(fp, 0) > 0:  # unconsumed: it matched no current finding
            budget[fp] -= 1
            stale.append(e)
    return BaselineResult(new=new, suppressed=suppressed, stale=stale)
