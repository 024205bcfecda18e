"""A fixture for the port's test files that build a ``Trainer`` or an
``Evaluator``: every one built during a test has its telemetry closed
when the test ends, so no handler stays on the process-wide loggers
(``pvraft_tpu_torch.Train_<dataset>``) for a later test in the same
process to find. Import it into a test module to use it there."""

import pytest

from pvraft_tpu_torch.engine.evaluator import Evaluator
from pvraft_tpu_torch.engine.trainer import Trainer


@pytest.fixture(autouse=True)
def close_engines(monkeypatch):
    built = []
    for cls in (Trainer, Evaluator):
        def init(self, *args, _init=cls.__init__, **kwargs):
            built.append(self)
            _init(self, *args, **kwargs)

        monkeypatch.setattr(cls, "__init__", init)
    yield
    for obj in built:
        telemetry = getattr(obj, "telemetry", None)
        if telemetry is not None:
            telemetry.close()
