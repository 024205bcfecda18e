"""The port's checks of itself: threadcheck (``analysis/concurrency``:
the GC static rules and the runtime lock-order sanitizer) and detcheck
(``analysis/determinism``: the GD static rules and the bitwise replay
harness), over one engine (``analysis/engine.py``: the diagnostic type
and the shared ``# graftlint: disable=...`` pragma grammar).

    python -m pvraft_tpu_torch.analysis concurrency [paths]
    python -m pvraft_tpu_torch.analysis determinism [paths]
    python -m pvraft_tpu_torch.analysis determinism --replay
"""
