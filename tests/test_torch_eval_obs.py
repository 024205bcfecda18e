"""The port's Evaluator observability against the JAX package's, on the
CPU: from one JAX checkpoint, ``run(log_every=2)`` over five synthetic
scenes logs its running means at the same scene counts with the same
values (``logs/TestAlone_synthetic.log``), the ``testalone.events.jsonl``
streams of both packages pass both validators with the same records, and
the TensorBoard scalars carry JAX's tags and values. The test CLI writes
its log and stream too.
"""

import json
import os
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pvraft_tpu.config import Config as JCfg
from pvraft_tpu.config import DataConfig as JDataConfig
from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.config import TrainConfig as JTrainConfig
from pvraft_tpu.engine import checkpoint as jckpt
from pvraft_tpu.engine.evaluator import Evaluator as JEvaluator
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.obs.events import validate_events_file as jvalidate
from pvraft_tpu.parallel.mesh import make_mesh
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import test as tcli
from pvraft_tpu_torch.engine.evaluator import Evaluator
from pvraft_tpu_torch.obs.events import read_events
from pvraft_tpu_torch.obs.events import validate_events_file as tvalidate

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
N, ITERS, SCENES, EVERY = 48, 2, 5, 2
ATOL = 2e-4     # the evaluator means' bar against JAX (test_torch_evaluator)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_obs")
    x = np.random.default_rng(8).uniform(-1, 1, (1, N, 3)).astype(np.float32)
    params = jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                     static_argnums=3)(jax.random.key(8), jnp.asarray(x),
                                       jnp.asarray(x), 1)
    jckpt.save_checkpoint(str(root / "ckpt"), params,
                          optax.adam(1e-3).init(params), 3,
                          checkpoint_interval=0, best=True)
    ckpt = jckpt.find_checkpoint(str(root / "ckpt"), "best_checkpoint")
    jcfg = JCfg(model=JConfig(use_pallas=False, **TINY),
                data=JDataConfig(dataset="synthetic", max_points=N,
                                 synthetic_size=SCENES, num_workers=0),
                train=JTrainConfig(eval_iters=ITERS),
                exp_path=str(root / "jax"))
    jev = JEvaluator(jcfg, mesh=make_mesh(n_data=1))
    jev.load(ckpt)
    jmeans = jev.run(log_every=EVERY)
    jev.close()
    torch.set_num_threads(1)
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=N,
                                synthetic_size=SCENES, num_workers=0),
        train=tconfig.TrainConfig(eval_iters=ITERS),
        exp_path=str(root / "port"))
    ev = Evaluator(cfg, device="cpu")
    ev.load(ckpt)
    means = ev.run(log_every=EVERY)
    ev.close()
    return {"jax": (root / "jax", jmeans, dict(jev.telemetry.tb.history)),
            "port": (root / "port", means, dict(ev.telemetry.tb.history)),
            "ckpt": ckpt}


def _progress(exp):
    """(count, {metric: running mean}) of each ``[count/n]`` line."""
    out = []
    for line in open(os.path.join(exp, "logs", "TestAlone_synthetic.log")):
        m = re.search(r"\[(\d+)/(\d+)\] (.*)$", line)
        if m:
            assert int(m.group(2)) == SCENES
            out.append((int(m.group(1)), {
                k: float(v) for k, v in
                (kv.split("=") for kv in m.group(3).split())}))
    return out


def test_log_every_lines_match_jax(evals):
    got, want = _progress(evals["port"][0]), _progress(evals["jax"][0])
    assert [c for c, _ in got] == [c for c, _ in want] == [2, 4]
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert abs(g[k] - w[k]) <= ATOL, (k, g[k], w[k])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_eval_stream_passes_both_validators(evals, package):
    path = os.path.join(evals[package][0], "testalone.events.jsonl")
    assert tvalidate(path) == [] and jvalidate(path) == []
    records = read_events(path)
    assert [r["type"] for r in records] == ["run_header", "eval"]
    assert records[0]["mode"] == "eval"
    ev = records[1]
    assert (ev["mode"], ev["epoch"], ev["scenes"]) == ("synthetic", -1,
                                                      SCENES)
    for k, v in evals[package][1].items():
        assert abs(ev["metrics"][k] - v) < 1e-6


def test_eval_tensorboard_matches_jax(evals):
    got, want = evals["port"][2], evals["jax"][2]
    assert sorted(got) == sorted(want) == sorted(
        f"Synthetic/{t}" for t in ("Loss", "EPE", "Outlier", "Acc3dRelax",
                                   "Acc3dStrict"))
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == [-1]
        np.testing.assert_allclose([v for _, v in got[tag]],
                                   [v for _, v in want[tag]], atol=ATOL)


def test_test_cli_writes_log_and_stream(evals, tmp_path, capsys):
    exp = str(tmp_path / "cli")
    tcli.main(["--dataset", "synthetic", "--device", "cpu", "--max_points",
               str(N), "--synthetic_size", "3", "--truncate_k", "16",
               "--corr_knn", "8", "--eval_iters", str(ITERS), "--weights",
               evals["ckpt"], "--exp_path", exp])
    means = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    log = open(os.path.join(exp, "logs", "TestAlone_synthetic.log")).read()
    assert "synthetic (3 scenes): " in log and "[" not in log
    records = read_events(os.path.join(exp, "testalone.events.jsonl"))
    assert records[-1]["type"] == "eval"
    assert records[-1]["metrics"] == pytest.approx(means)
