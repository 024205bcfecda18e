"""Runtime checks of the port: the lock-order sanitizer
(``analysis/concurrency``) and the bitwise replay harness
(``analysis/determinism``; ``python -m pvraft_tpu_torch.analysis
determinism --replay``)."""
