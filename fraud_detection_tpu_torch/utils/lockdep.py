"""Runtime lock-order witness (``LOCKDEP=1``).

The port's copy of the JAX package's ``utils/lockdep.py``. Every named lock
of the lifecycle loop is created through :func:`lock` / :func:`rlock` —
plain ``threading`` primitives when the witness is off (the default: no
overhead, no change of behaviour), instrumented wrappers when
``LOCKDEP=1``:

- each thread keeps a stack of the named locks it currently holds;
- acquiring ``B`` while holding ``A`` records the order edge ``A → B``
  (with the acquiring stack) in a process-global graph;
- if the *reverse* edge ``B → A`` was ever recorded — by any thread, at any
  point in the process lifetime — the acquire **fails fast** with
  :class:`LockOrderInversion` carrying both stacks, instead of leaving a
  latent ABBA deadlock to strike under production timing.

Reentrant holds (``rlock``, or two same-named instances nested by one
thread) are not order evidence and record nothing. Edges are keyed by lock
*name*, not instance: one witnessed ordering per lock class.
"""

from __future__ import annotations

import os
import threading
import traceback


class LockOrderInversion(RuntimeError):
    """Two named locks were acquired in both orders (ABBA hazard)."""


def enabled() -> bool:
    """Witness switch, read at lock-creation time (``LOCKDEP=1``)."""
    return os.environ.get("LOCKDEP", "") == "1"


_graph_lock = threading.Lock()  # guards _edges; never itself witnessed
_edges: dict[tuple[str, str], str] = {}  # (held, acquired) -> acquiring stack
_tls = threading.local()


def _held() -> list[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _stack_summary(limit: int = 12) -> str:
    return "".join(traceback.format_stack(limit=limit)[:-2])


def _note_acquire(name: str) -> None:
    """Record order edges for acquiring ``name``; raises on an inversion.
    The caller pushes ``name`` only after this returns."""
    held = _held()
    if name in held:
        return  # reentrant hold — not order evidence
    here = None
    for h in held:
        key = (h, name)
        rev = (name, h)
        with _graph_lock:
            prior = _edges.get(rev)
            if prior is not None:
                raise LockOrderInversion(
                    f"lock order inversion: acquiring {name!r} while "
                    f"holding {h!r}, but the order {name!r} -> {h!r} was "
                    f"previously witnessed.\n--- prior {name!r} -> {h!r} "
                    f"acquisition ---\n{prior}\n--- this acquisition ---\n"
                    f"{here or _stack_summary()}"
                )
            if key not in _edges:
                if here is None:
                    here = _stack_summary()
                _edges[key] = here


def _push(name: str) -> None:
    _held().append(name)


def _pop(name: str) -> None:
    held = _held()
    # release order need not be LIFO (lock handoffs); drop the last hold
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


def edges() -> dict[tuple[str, str], str]:
    """Snapshot of the witnessed order graph (for tests / status)."""
    with _graph_lock:
        return dict(_edges)


def reset() -> None:
    """Forget all witnessed edges (test isolation only)."""
    with _graph_lock:
        _edges.clear()


class LockdepLock:
    """``threading.Lock`` with named order witnessing."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        self._inner = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                _note_acquire(self.name)
            except BaseException:
                self._inner.release()
                raise
            _push(self.name)
        return ok

    def release(self) -> None:
        _pop(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r} {self._inner!r}>"


class LockdepRLock(LockdepLock):
    """``threading.RLock`` with named order witnessing; reentrant holds
    push/pop symmetrically but record no edges."""

    _factory = staticmethod(threading.RLock)

    def locked(self) -> bool:  # RLock has no .locked() before 3.14
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True


def lock(name: str):
    """A named mutex: plain ``threading.Lock`` unless ``LOCKDEP=1``."""
    return LockdepLock(name) if enabled() else threading.Lock()


def rlock(name: str):
    """A named reentrant mutex: plain ``threading.RLock`` unless
    ``LOCKDEP=1``."""
    return LockdepRLock(name) if enabled() else threading.RLock()
