"""The port's checks of itself: graftlint (``analysis/rules.py``, GL006
and GL007, run by ``analysis/lint.py``), threadcheck
(``analysis/concurrency``: the GC static rules and the runtime
lock-order sanitizer), detcheck (``analysis/determinism``: the GD static
rules and the bitwise replay harness) and shardcheck
(``analysis/sharding``: GS004 and the pod planner), over one engine
(``analysis/engine.py``: the diagnostic type and the shared
``# graftlint: disable=...`` pragma grammar).

    python -m pvraft_tpu_torch.analysis lint [paths] [--stats]
    python -m pvraft_tpu_torch.analysis concurrency [paths]
    python -m pvraft_tpu_torch.analysis determinism [paths]
    python -m pvraft_tpu_torch.analysis determinism --replay
    python -m pvraft_tpu_torch.analysis sharding [paths]
    python -m pvraft_tpu_torch.analysis sharding --plan
"""
