"""The bitwise replay harness of the port
(:mod:`~pvraft_tpu_torch.analysis.determinism.replay`; the JAX package's
``analysis/determinism/replay.py``).

    python -m pvraft_tpu_torch.analysis determinism --replay
"""

from pvraft_tpu_torch.analysis.determinism.replay import (  # noqa: F401
    REPLAY_PROGRAMS,
    SCHEMA_VERSION,
    check_report,
    replay_report,
)
