"""The lock-order sanitizer of the port's serving tier."""

from pvraft_tpu_torch.analysis.concurrency.sanitizer import (
    LockOrderError,
    OrderedLock,
    checks_enabled,
    order_edges,
    ordered_lock,
    reset_order_graph,
)

__all__ = ["LockOrderError", "OrderedLock", "checks_enabled", "order_edges",
           "ordered_lock", "reset_order_graph"]
