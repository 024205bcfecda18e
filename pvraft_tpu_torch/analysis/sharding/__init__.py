"""shardcheck of the port: GS004 (``model.py``, ``rules.py``,
``check.py``: a filesystem write no process-0 test dominates, over
``engine/``, ``obs/`` and ``parallel/``) and the pod planner
(``planner.py``: the ``pvraft_pod_plan/v1`` document for H100 meshes).

    python -m pvraft_tpu_torch.analysis sharding            # GS004
    python -m pvraft_tpu_torch.analysis sharding --plan     # the plan

The static half is pure stdlib ``ast``; the planner reads the program
inventory and the port's model, and is imported only where it is used.
"""

from pvraft_tpu_torch.analysis.sharding.check import (  # noqa: F401
    DEFAULT_SCOPE,
    check_paths,
    check_source,
    default_scope,
)
from pvraft_tpu_torch.analysis.sharding.rules import (  # noqa: F401
    all_sharding_rules,
)
