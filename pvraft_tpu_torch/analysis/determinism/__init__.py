"""detcheck of the port: the GD static rules (``model.py``,
``rules.py``, ``check.py``) and their dynamic twin, the bitwise replay
harness (:mod:`~pvraft_tpu_torch.analysis.determinism.replay`; the JAX
package's ``analysis/determinism/``).

    python -m pvraft_tpu_torch.analysis determinism            # static rules
    python -m pvraft_tpu_torch.analysis determinism --replay   # bitwise replay
"""

from pvraft_tpu_torch.analysis.determinism.check import (  # noqa: F401
    DEFAULT_SCOPE,
    check_paths,
    check_source,
    declared_streams,
    default_scope,
    hazard_spec_records,
)
from pvraft_tpu_torch.analysis.determinism.replay import (  # noqa: F401
    REPLAY_PROGRAMS,
    SCHEMA_VERSION,
    check_report,
    replay_report,
)
from pvraft_tpu_torch.analysis.determinism.rules import (  # noqa: F401
    DetContext,
    HazardSpec,
    all_determinism_rules,
)
