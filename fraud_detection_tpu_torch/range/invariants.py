"""End-to-end invariant checks the fraud range asserts after every scenario.

The port's own copy of the JAX package's ``range/invariants.py`` (numpy
only; a window's tensors are read through their ``.cpu()`` copies, so the
port's drift window compares from any device). Each check returns an
:class:`InvariantOutcome` (never raises) so one scenario run reports ALL
violated invariants, not just the first — chaos failures tend to come in
correlated clusters and the second failure is usually the diagnostic one.
``ScenarioResult.raise_if_failed()`` is the pytest/CI surface.

The named invariants:

- **drift-detected-within-N** — watchtower flags drift within a row budget
  of the campaign's known onset;
- **exactly-once-promotion** — the conductor's CAS machine converged, the
  ``@prod`` alias points at the challenger, exactly one promotion landed,
  and no duplicate model version was registered;
- **p99-holds** — p99 request latency during a hot swap stays within a
  multiple of the undisturbed baseline;
- **no-alert-flaps** — no alert condition fires and clears within one
  evaluation window (sampled each scenario step via
  :class:`AlertFlapDetector`);
- **bitwise-consistent** — two runs of the same seeded scenario leave the
  drift window (and the staging pool's allocation count) bitwise identical.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np


@dataclass
class InvariantOutcome:
    name: str
    ok: bool
    detail: str = ""

    def __bool__(self) -> bool:
        return self.ok


@dataclass
class ScenarioResult:
    name: str
    invariants: list[InvariantOutcome] = field(default_factory=list)
    metrics: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(inv.ok for inv in self.invariants)

    def add(self, outcome: InvariantOutcome) -> None:
        self.invariants.append(outcome)

    def to_dict(self) -> dict:
        def py(v):
            """JSON-native coercion: numpy scalars leak out of invariant
            predicates (``np.isfinite`` returns np.bool_) and json.dumps
            refuses them."""
            if isinstance(v, (bool, np.bool_)):
                return bool(v)
            if isinstance(v, np.integer):
                return int(v)
            if isinstance(v, np.floating):
                return float(v)
            if isinstance(v, dict):
                return {k: py(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [py(x) for x in v]
            return v

        return {
            "scenario": self.name,
            "ok": bool(self.ok),
            "invariants": {
                inv.name: {"ok": bool(inv.ok), "detail": inv.detail}
                for inv in self.invariants
            },
            "metrics": py(self.metrics),
        }

    def raise_if_failed(self) -> None:
        bad = [i for i in self.invariants if not i.ok]
        if bad:
            lines = "\n".join(f"  [{i.name}] {i.detail}" for i in bad)
            raise AssertionError(
                f"scenario {self.name!r} violated "
                f"{len(bad)} invariant(s):\n{lines}"
            )


# -- individual checks ------------------------------------------------------

def drift_detected_within(
    onset_row: int, detected_row: int | None, budget_rows: int
) -> InvariantOutcome:
    name = "drift-detected-within-N"
    if detected_row is None:
        return InvariantOutcome(
            name, False,
            f"drift never detected (onset at row {onset_row}, "
            f"budget {budget_rows} rows)",
        )
    delay = detected_row - onset_row
    ok = 0 <= delay <= budget_rows
    return InvariantOutcome(
        name, ok,
        f"detected at row {detected_row}, onset {onset_row} "
        f"(delay {delay}, budget {budget_rows})",
    )


def exactly_once_promotion(
    registry,
    store,
    model_name: str,
    challenger_version: int,
    versions_before: int,
    promotions_delta: float,
    prod_stage: str = "prod",
    shadow_stage: str = "shadow",
) -> InvariantOutcome:
    """The CAS state machine converged to exactly one applied promotion."""
    name = "exactly-once-promotion"
    problems: list[str] = []
    state = store.get_state(model_name)
    if state["state"] != "done":
        problems.append(f"state machine ended {state['state']!r}, not 'done'")
    prod = registry.get_version_by_alias(model_name, prod_stage)
    if prod != challenger_version:
        problems.append(
            f"@{prod_stage} is v{prod}, expected challenger v{challenger_version}"
        )
    shadow = registry.get_version_by_alias(model_name, shadow_stage)
    if shadow is not None:
        problems.append(f"@{shadow_stage} still set (v{shadow}) after promotion")
    latest = registry.latest_version(model_name)
    if latest != versions_before:
        problems.append(
            f"registry grew to v{latest} (expected v{versions_before}) — "
            "a resumed episode registered a duplicate challenger"
        )
    if promotions_delta != 1:
        problems.append(
            f"lifecycle_promotions_total advanced by {promotions_delta}, "
            "expected exactly 1"
        )
    return InvariantOutcome(
        name, not problems,
        "; ".join(problems) or
        f"one promotion, @{prod_stage}=v{prod}, no duplicate registrations",
    )


def p99_within(
    latencies_s,
    baseline_p99_s: float,
    *,
    factor: float = 5.0,
    absolute_floor_s: float = 0.05,
) -> InvariantOutcome:
    """p99 during the disturbance ≤ max(factor × baseline, floor).

    The floor keeps CI hosts honest: a 0.8 ms baseline p99 on a quiet CPU
    would otherwise fail the swap window on scheduler jitter alone.
    """
    name = "p99-holds"
    lat = np.asarray(list(latencies_s), np.float64)
    if lat.size == 0:
        return InvariantOutcome(name, False, "no latencies recorded")
    p99 = float(np.percentile(lat, 99))
    budget = max(factor * baseline_p99_s, absolute_floor_s)
    return InvariantOutcome(
        name, p99 <= budget,
        f"p99 {p99 * 1e3:.2f}ms vs budget {budget * 1e3:.2f}ms "
        f"(baseline {baseline_p99_s * 1e3:.2f}ms × {factor})",
    )


def _leaf(a) -> np.ndarray:
    """A window leaf as a numpy array: a tensor's host copy (from any
    device), else the array itself."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def windows_bitwise_equal(window_a, window_b) -> InvariantOutcome:
    """Two drift windows (the port's ``DriftWindow`` dataclass of tensors,
    or any named tuple of arrays) must match bit for bit — the determinism
    contract of a seeded scenario."""
    name = "bitwise-consistent"
    fields = getattr(window_a, "_fields", None)
    if fields is None and dataclasses.is_dataclass(window_a):
        fields = tuple(f.name for f in dataclasses.fields(window_a))
    fields = fields or range(len(window_a))
    for i, f in enumerate(fields):
        a = _leaf(window_a[i] if isinstance(f, int) else getattr(window_a, f))
        b = _leaf(window_b[i] if isinstance(f, int) else getattr(window_b, f))
        if a.shape != b.shape or a.dtype != b.dtype:
            return InvariantOutcome(
                name, False, f"field {f}: shape/dtype mismatch {a.shape}/{b.shape}"
            )
        ab, bb = a.tobytes(), b.tobytes()
        if ab != bb:
            diff = int(
                np.sum(
                    np.frombuffer(ab, np.uint8) != np.frombuffer(bb, np.uint8)
                )
            )
            return InvariantOutcome(
                name, False, f"field {f}: {diff} differing bytes"
            )
    return InvariantOutcome(name, True, "drift windows bitwise identical")


class AlertFlapDetector:
    """Samples boolean alert conditions once per scenario step and reports
    flaps: an episode that fires and fully clears within one evaluation
    window (``min_hold_samples``). Prometheus `for:` clauses suppress
    sub-window noise, but a condition that *oscillates* at the window
    boundary pages and un-pages — the operator experience the range
    guards against.
    """

    def __init__(self, min_hold_samples: int = 3):
        self.min_hold = min_hold_samples
        self._series: dict[str, list[bool]] = {}

    def sample(self, **conditions: bool) -> None:
        for k, v in conditions.items():
            self._series.setdefault(k, []).append(bool(v))

    def episodes(self, name: str) -> list[int]:
        """Lengths (in samples) of each firing episode of ``name``."""
        out: list[int] = []
        run = 0
        for v in self._series.get(name, []):
            if v:
                run += 1
            elif run:
                out.append(run)
                run = 0
        if run:
            out.append(run)
        return out

    def check(self) -> InvariantOutcome:
        name = "no-alert-flaps"
        flaps: list[str] = []
        for cond, series in self._series.items():
            eps = self.episodes(cond)
            # the last episode may still be open at scenario end — holding
            # at the end is not a flap
            closed = eps[:-1] if series and series[-1] else eps
            short = [e for e in closed if e < self.min_hold]
            if short:
                flaps.append(
                    f"{cond}: {len(short)} episode(s) shorter than "
                    f"{self.min_hold} samples {short}"
                )
        return InvariantOutcome(
            name, not flaps,
            "; ".join(flaps) or
            f"no condition fired-and-cleared within {self.min_hold} samples",
        )
