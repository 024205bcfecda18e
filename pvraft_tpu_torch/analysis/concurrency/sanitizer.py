"""Runtime lock-order sanitizer (port of
``pvraft_tpu/analysis/concurrency/sanitizer.py``).

:class:`OrderedLock` wraps ``threading.Lock`` with a per-thread stack of
held locks and a process-wide order graph. The first time lock B is
taken while A is held, the edge A -> B is recorded with its call site; a
later attempt to take A while B is held is an order inversion, the shape
that deadlocks under the right interleaving, and raises
:class:`LockOrderError` naming both sites *before* it blocks. Taking a
non-reentrant lock the thread already holds (a certain self-deadlock)
raises too.

:func:`ordered_lock` is the adoption point: a plain ``threading.Lock``
unless ``PVRAFT_CHECKS=1`` (:func:`checks_enabled`), read at each call,
so the serving path pays nothing when checks are off and a test that
sets the variable before it builds a service gets every serving lock
instrumented::

    PVRAFT_CHECKS=1 python -m pytest tests/test_torch_sanitizer.py

A non-blocking acquire (``blocking=False``) neither raises on an
inversion nor records an edge: a trylock cannot wait, so it cannot close
a deadlock cycle. A lock won by a trylock is still on the held stack and
constrains later blocking acquires.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

ENV_VAR = "PVRAFT_CHECKS"


def checks_enabled() -> bool:
    """The port's runtime checks are on iff ``PVRAFT_CHECKS=1``."""
    return os.environ.get(ENV_VAR, "") == "1"


class LockOrderError(RuntimeError):
    """Two locks taken in opposite orders by different code paths
    (deadlock-prone), or one non-reentrant lock taken recursively
    (deadlock-certain)."""


# The order graph: (held name, acquired name) -> first call site. Its
# own lock is a leaf (nothing is taken under it), so it cannot invert.
_GRAPH_LOCK = threading.Lock()
_EDGES: Dict[Tuple[str, str], str] = {}

_HELD = threading.local()


def _held_stack() -> List["OrderedLock"]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _call_site() -> str:
    """The acquiring frame outside this module."""
    for frame in reversed(traceback.extract_stack(limit=16)):
        if not frame.filename.endswith("sanitizer.py"):
            return f"{frame.filename}:{frame.lineno} in {frame.name}"
    return "<unknown>"


def order_edges() -> Dict[Tuple[str, str], str]:
    """A copy of the observed order graph, keyed (held, acquired)."""
    with _GRAPH_LOCK:
        return dict(_EDGES)


def reset_order_graph() -> None:
    """Forget every edge (test isolation only: a live process keeps its
    history, or an inversion across phases hides)."""
    with _GRAPH_LOCK:
        _EDGES.clear()


class OrderedLock:
    """``threading.Lock`` that records the order it is taken in.

    Covers the Lock API the port uses: ``with``, ``acquire(blocking=,
    timeout=)``, ``release()``, ``locked()``. Locks are nodes of the
    graph by ``name`` (``"Replica._lock"``): instances of one class share
    a node."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def _check_order(self, blocking: bool) -> None:
        stack = _held_stack()
        if not stack:
            return
        if any(h is self for h in stack):
            raise LockOrderError(
                f"recursive acquisition of non-reentrant lock "
                f"{self.name!r} at {_call_site()}: this thread already "
                f"holds it (guaranteed self-deadlock)")
        if not blocking:
            return
        site = _call_site()
        with _GRAPH_LOCK:
            for held in stack:
                if held.name == self.name:
                    # Two instances of one class nested: the name graph
                    # cannot express their order without a self-loop.
                    continue
                inverse = _EDGES.get((self.name, held.name))
                if inverse is not None:
                    raise LockOrderError(
                        f"lock-order inversion: acquiring {self.name!r} "
                        f"while holding {held.name!r} at {site}, but the "
                        f"opposite order ({self.name!r} -> {held.name!r}) "
                        f"was taken at {inverse}: two threads running "
                        f"these paths concurrently deadlock")
                _EDGES.setdefault((held.name, self.name), site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order(blocking)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _held_stack().append(self)
        return got

    def release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> Optional[bool]:
        self.release()
        return None

    def __repr__(self) -> str:
        return f"OrderedLock({self.name!r})"


def ordered_lock(name: str):
    """A plain ``threading.Lock`` when checks are off, an
    :class:`OrderedLock` named ``name`` under ``PVRAFT_CHECKS=1``."""
    if checks_enabled():
        return OrderedLock(name)
    return threading.Lock()
