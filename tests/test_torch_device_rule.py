"""The port's device rule (``pvraft_tpu_torch/device.py``) at the
program registry's entry points: without a device they run on the card,
so on a machine with no CUDA device and none named they raise
``resolve_device``'s error instead of running on the CPU."""

import pytest
import torch

from pvraft_tpu_torch.analysis.determinism.replay import replay_report
from pvraft_tpu_torch.programs import get, load_catalog
from pvraft_tpu_torch.programs.costs import cost_record, run_costs

SPEC = "cuda_corr_lookup_fwd"

ENTRY_POINTS = {
    "ProgramSpec.build": lambda spec: spec.build(size="tiny"),
    "cost_record": lambda spec: cost_record(spec, size="tiny"),
    "run_costs": lambda spec: run_costs([spec], size="tiny"),
    "replay_report": lambda spec: replay_report(size="tiny",
                                                programs=(spec.name,)),
}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_no_device_and_no_cuda_raises(entry, no_cuda):
    load_catalog()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ENTRY_POINTS[entry](get(SPEC))


def test_named_cpu_still_runs():
    load_catalog()
    fn, inputs = get(SPEC).build("cpu", "tiny")
    assert all(torch.isfinite(t).all() for t in fn(*inputs)[:3])
    assert cost_record(get(SPEC), "cpu", "tiny")["ok"]
