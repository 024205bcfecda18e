"""threadcheck of the port, both halves.

* The static half (``model.py``, ``rules.py``, ``check.py``): a
  guarded-by model, from ``# guarded-by: <lock>`` field comments and
  ``with self._lock:`` bodies, feeding rules GC001-GC004 (guarded fields
  accessed outside their lock, lock-order cycles, check-then-act shapes,
  un-joined non-daemon threads), run as ``python -m
  pvraft_tpu_torch.analysis concurrency`` over ``serve/``, ``fleet/``,
  ``obs/`` and ``data/loader.py``. Pure stdlib ``ast``.
* The dynamic half (``sanitizer.py``): the lock-order sanitizer, an
  instrumented :class:`OrderedLock` behind :func:`ordered_lock` when
  ``PVRAFT_CHECKS=1``.
"""

from pvraft_tpu_torch.analysis.concurrency.check import (
    DEFAULT_SCOPE,
    check_paths,
    check_source,
    default_scope,
)
from pvraft_tpu_torch.analysis.concurrency.sanitizer import (
    LockOrderError,
    OrderedLock,
    checks_enabled,
    order_edges,
    ordered_lock,
    reset_order_graph,
)

__all__ = ["DEFAULT_SCOPE", "LockOrderError", "OrderedLock", "check_paths",
           "check_source", "checks_enabled", "default_scope", "order_edges",
           "ordered_lock", "reset_order_graph"]
