"""Control-plane fault injection: the named points the lifecycle fires.

The port's copy of the JAX package's ``range/faults.py``, the part the
lifecycle loop and the lifeboat call: production code carries *named injection points* —
one :func:`fire` (or :func:`patched`) call at each place a drill needs to
break things:

- ``conductor.promoting.pre_alias`` / ``.mid_alias`` / ``.pre_finalize`` —
  kill a replica mid-promotion (lifecycle/conductor.py);
- ``conductor.gated.pre_alias`` — crash between challenger registration and
  the ``@shadow`` write;
- ``conductor.rolling_back.pre_alias`` — crash between the rollback intent
  and the alias restore;
- ``lifecycle.store.add_feedback`` / ``lifecycle.store.get_state`` —
  poison, stall or error the durable lifecycle store (lifecycle/store.py);
- ``lifeboat.recover`` — stall a warm restart (the app's 503 "recovering"
  window), ``lifeboat.journal`` — a journal record written, its flush not
  launched, ``lifeboat.snapshot`` — a generation cut, not yet landed
  (lifeboat/).

Faults are **off by default with no hot-path cost**: every hook is a
module-global ``None`` check. A drill arms a :class:`FaultPlan` via
``with plan.armed(): ...``; arming is process-global (the points fire from
worker, reloader and executor threads) and re-entrant arming is rejected
so two drills cannot blur their blast radius. The scenarios that drive
these points across a fleet (``range/scenarios.py``) are a later slice.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

__all__ = [
    "FaultPlan",
    "ReplicaKilled",
    "fire",
    "patched",
    "active_plan",
]


class ReplicaKilled(BaseException):
    """Raised at a kill point to simulate a replica dying mid-step.

    Deliberately a ``BaseException`` subclass: production ``except
    Exception`` ladders (the worker retry ladder, the conductor's
    fit-failure leg) must NOT absorb a simulated process death — a real
    SIGKILL wouldn't run them either. Scenario code catches it explicitly.
    """

    def __init__(self, point: str):
        super().__init__(f"replica killed at fault point {point!r}")
        self.point = point


@dataclass
class _Rule:
    kind: str  # kill | stall | error | patch | call
    point: str
    times: int  # remaining firings; <0 = unlimited
    seconds: float = 0.0
    value: Any = None
    factory: Callable[[], BaseException] | None = None
    fn: Callable[..., Any] | None = None
    fired: int = 0

    def consume(self) -> bool:
        """One firing if the budget allows; thread-safe under the plan lock."""
        if self.times == 0:
            return False
        if self.times > 0:
            self.times -= 1
        self.fired += 1
        return True


class FaultPlan:
    """A recipe of faults keyed by injection point.

    Builder methods return ``self`` so plans read like the scenario they
    implement::

        plan = (FaultPlan()
                .kill("conductor.promoting.pre_alias")
                .patch("taskq.visibility_timeout", 0.05)
                .stall("netclient.call", seconds=0.5, times=3))
        with plan.armed():
            ...drive the service...
    """

    def __init__(self):
        self._rules: dict[str, list[_Rule]] = {}
        self._lock = threading.Lock()
        self.log: list[tuple[str, str]] = []  # (point, kind) firing history

    # -- plan construction ---------------------------------------------------
    def _add(self, rule: _Rule) -> "FaultPlan":
        self._rules.setdefault(rule.point, []).append(rule)
        return self

    def kill(self, point: str, times: int = 1) -> "FaultPlan":
        """Raise :class:`ReplicaKilled` at ``point`` (default: once)."""
        return self._add(_Rule("kill", point, times))

    def stall(
        self, point: str, seconds: float, times: int = -1
    ) -> "FaultPlan":
        """Sleep ``seconds`` at ``point`` — a stalled peer/store/device."""
        return self._add(_Rule("stall", point, times, seconds=seconds))

    def error(
        self,
        point: str,
        factory: Callable[[], BaseException],
        times: int = -1,
    ) -> "FaultPlan":
        """Raise ``factory()`` at ``point`` — e.g. a ``StoreError`` whose
        retry budget the client has already exhausted."""
        return self._add(_Rule("error", point, times, factory=factory))

    def patch(self, point: str, value: Any, times: int = -1) -> "FaultPlan":
        """Override the value flowing through a ``patched()`` hook (e.g.
        shrink ``taskq.visibility_timeout`` so claims expire immediately)."""
        return self._add(_Rule("patch", point, times, value=value))

    def call(
        self, point: str, fn: Callable[..., Any], times: int = -1
    ) -> "FaultPlan":
        """Invoke ``fn(**ctx)`` at ``point`` (observation/poisoning hook —
        e.g. corrupt a feedback batch in flight)."""
        return self._add(_Rule("call", point, times, fn=fn))

    # -- firing ------------------------------------------------------------
    def _fire(self, point: str, ctx: dict) -> None:
        actions: list[_Rule] = []
        with self._lock:
            for rule in self._rules.get(point, ()):
                if rule.kind != "patch" and rule.consume():
                    self.log.append((point, rule.kind))
                    actions.append(rule)
        # side effects OUTSIDE the lock: a stall must not serialize every
        # other point behind it
        for rule in actions:
            if rule.kind == "stall":
                time.sleep(rule.seconds)
            elif rule.kind == "call" and rule.fn is not None:
                rule.fn(**ctx)
            elif rule.kind == "error" and rule.factory is not None:
                raise rule.factory()
            elif rule.kind == "kill":
                raise ReplicaKilled(point)

    def _patched(self, point: str, value: Any) -> Any:
        with self._lock:
            for rule in self._rules.get(point, ()):
                if rule.kind == "patch" and rule.consume():
                    self.log.append((point, "patch"))
                    return rule.value
        return value

    def fired(self, point: str | None = None) -> int:
        """How many faults fired (optionally at one point) — scenarios
        assert the fault actually landed, so a refactor that silently
        removes an injection point fails the chaos tier."""
        with self._lock:
            return sum(
                1 for p, _ in self.log if point is None or p == point
            )

    # -- arming ------------------------------------------------------------
    def armed(self) -> "_Armed":
        return _Armed(self)


class _Armed:
    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        global _PLAN
        with _ARM_LOCK:
            if _PLAN is not None:
                raise RuntimeError(
                    "a FaultPlan is already armed — scenarios must not overlap"
                )
            _PLAN = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        global _PLAN
        with _ARM_LOCK:
            _PLAN = None


_ARM_LOCK = threading.Lock()
_PLAN: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    return _PLAN


def fire(point: str, **ctx) -> None:
    """Production-side injection point. Disarmed (the default) this is one
    global load and a jump — no allocation."""
    plan = _PLAN
    if plan is None:
        return
    plan._fire(point, ctx)


def patched(point: str, value):
    """Value-override injection point (visibility timeouts, countdowns).
    Disarmed it returns ``value`` after one global load."""
    plan = _PLAN
    if plan is None:
        return value
    return plan._patched(point, value)
