"""Runtime checks of the port (``analysis/concurrency``: the lock-order
sanitizer)."""
