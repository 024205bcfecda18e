"""The port's doctor (``python -m pvraft_tpu_torch.doctor``) against the
JAX package's ``scripts/run_doctor.py`` on the CPU: on one snapshot of a
port run poisoned as ``tests/test_obs.py``'s (NaN coordinates in one
scene's ``pc1``), both name the same first non-finite stage (``batch``)
and the same finite flags stage by stage. The JAX doctor replays op by
op, which is most of this file's time.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import doctor as tdoctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The first snapshot of a poisoned port epoch (tiny config)."""
    import pvraft_tpu_torch.engine.trainer as ttrmod

    real = ttrmod.build_datasets

    def poisoned(cfg):
        train, val, test = real(cfg)

        class Poisoned:
            def __getattr__(self, name):
                return getattr(train, name)

            def __len__(self):
                return len(train)

            def __getitem__(self, i):
                s = dict(train[i])
                if i == 2:
                    s["pc1"] = s["pc1"].copy()
                    s["pc1"][0, :] = np.nan
                return s

        return Poisoned(), val, test

    exp = tmp_path_factory.mktemp("doctor")
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(truncate_k=16, corr_knn=8, graph_k=8),
        data=tconfig.DataConfig(dataset="synthetic", max_points=64,
                                synthetic_size=4, num_workers=0),
        train=tconfig.TrainConfig(batch_size=2, num_epochs=1, iters=2,
                                  eval_iters=2, telemetry=True),
        exp_path=str(exp))
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrmod, "build_datasets", poisoned)
    try:
        trainer = ttrmod.Trainer(cfg, device="cpu")
        trainer.training(0)
        trainer.close()
    finally:
        mp.undo()
    snaps = sorted(os.listdir(exp / "snapshots"))
    return str(exp / "snapshots" / snaps[0])


def test_doctors_agree_on_a_port_snapshot(snapshot):
    spec = importlib.util.spec_from_file_location(
        "run_doctor", os.path.join(REPO, "scripts", "run_doctor.py"))
    jdoctor = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdoctor)
    want = jdoctor.diagnose(snapshot)
    torch.set_num_threads(1)
    got = tdoctor.diagnose(snapshot, "cpu")
    assert got["first_nonfinite_stage"] == want[
        "first_nonfinite_stage"] == "batch"
    assert ([(r["stage"], r["finite"]) for r in got["stages"]]
            == [(r["stage"], r["finite"]) for r in want["stages"]])
    assert got["meta"] == want["meta"]
    # The NaN is in pc1 only: pc2's encoding stays finite.
    by_stage = {r["stage"]: r for r in got["stages"]}
    assert not by_stage["encoder(pc1)"]["finite"]
    assert by_stage["encoder(pc2)"]["finite"]


def test_doctor_cli_writes_the_report(snapshot, tmp_path, capsys):
    report = tmp_path / "report.json"
    assert tdoctor.main([snapshot, "--json", str(report), "--device",
                         "cpu"]) == 0
    out = capsys.readouterr().out
    assert "verdict: first non-finite stage is batch" in out
    got = json.load(open(report))
    assert set(got) == {"snapshot", "meta", "device", "stages",
                        "first_nonfinite_stage"}
    assert got["device"] == "cpu"
