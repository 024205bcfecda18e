"""The port's program registry: what programs exist, at what shapes, and
what each costs (the port's counterpart of ``pvraft_tpu/programs``).

``programs/spec.py`` declares a program (:class:`ProgramSpec`),
``programs/catalog.py`` registers every program the port runs,
``programs/geometries.py`` holds their shapes and ``programs/costs.py``
counts them into the ``pvraft_costs/v1`` inventory and reads it back
(``CostSurface``).

CLI::

    python -m pvraft_tpu_torch.programs list [--tag T] [--only S]
    python -m pvraft_tpu_torch.programs describe NAME [--device cpu]
    python -m pvraft_tpu_torch.programs costs [--out PATH] [--device cpu]
    python -m pvraft_tpu_torch.programs costs --check PATH
    python -m pvraft_tpu_torch.programs params [--out P | --check P]
"""

from pvraft_tpu_torch.programs.spec import (  # noqa: F401
    DuplicateProgramError,
    ProgramSpec,
    by_tag,
    get,
    register,
    register_spec,
    specs,
)


def load_catalog() -> None:
    """Populate the registry (``programs/catalog.py``); idempotent."""
    import pvraft_tpu_torch.programs.catalog  # noqa: F401
