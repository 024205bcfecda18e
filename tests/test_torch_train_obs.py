"""The port's train observability against the JAX package's, on the CPU.

``pvraft_tpu_torch/obs/monitors.py`` on the same arrays as
``pvraft_tpu/obs/monitors.py``; ``obs/divergence.py``'s detector on the
same loss sequences (trips, reasons, z-scores) and its snapshots read by
the other package both ways; the poisoned-dataset run of
``tests/test_obs.py`` ported: the port's Trainer from the JAX Trainer's
initial weights gives the JAX stream's event types in order, its trips
and its TensorBoard history, both streams pass both validators, and the
port's doctor names ``batch`` on the JAX snapshot
(``tests/test_torch_doctor.py`` holds the two doctors against each
other); ``halt_on_divergence`` flushes the step events and writes no
summary. The JAX Trainer's compile dominates (one module fixture, as
``tests/test_obs.py``'s ``nan_run``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pvraft_tpu.obs import divergence as jdiv
from pvraft_tpu.obs import monitors as jmon
from pvraft_tpu.obs.events import validate_events_file as jvalidate
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import doctor as tdoctor
from pvraft_tpu_torch.obs import divergence as tdiv
from pvraft_tpu_torch.obs import monitors as tmon
from pvraft_tpu_torch.obs.events import read_events
from pvraft_tpu_torch.obs.events import validate_events_file as tvalidate
from pvraft_tpu_torch.utils.logging import ExperimentLog, TBWriter
from pvraft_tpu_torch.weights import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_state_dict,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- monitors ----------------------------------------------------------------


def _tree(seed, poison=False):
    """A seeded two-level parameter tree as flax nests it and as the port
    names it (group.leaf)."""
    rng = np.random.default_rng(seed)
    shapes = {"encoder": {"w": (3, 4), "b": (4,)},
              "update_iter": {"w": (4, 5), "b": (5,), "alpha": (1,)},
              "head": {"w": (5, 2)}}
    tree = {g: {k: rng.normal(size=s).astype(np.float32)
                for k, s in leaves.items()} for g, leaves in shapes.items()}
    if poison:
        tree["encoder"]["w"][0, 1] = np.nan
        tree["head"]["w"][1, 0] = np.inf
    flat = {f"{g}.{k}": torch.from_numpy(v.copy())
            for g, leaves in tree.items() for k, v in leaves.items()}
    return tree, flat


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


def test_global_norm_and_nonfinite_match_jax():
    tree, flat = _tree(0)
    _close(float(tmon.global_norm(flat)), float(jmon.global_norm(tree)))
    assert float(tmon.global_norm({})) == float(jmon.global_norm({})) == 0.0
    bad, bad_flat = _tree(1, poison=True)
    ints = np.array([1, 2], np.int32)
    assert (int(tmon.nonfinite_count(bad_flat, torch.from_numpy(ints)))
            == int(jmon.nonfinite_count(bad, jnp.asarray(ints))) == 2)
    assert int(tmon.nonfinite_count(flat)) == 0


def test_delta_flow_norms_match_jax():
    flows = np.random.default_rng(2).normal(size=(4, 2, 16, 3)).astype(
        np.float32)
    _close(tmon.delta_flow_norms(torch.from_numpy(flows)).numpy(),
           jmon.delta_flow_norms(jnp.asarray(flows)))


@pytest.mark.parametrize("with_flows", [True, False])
def test_telemetry_leaves_match_jax(with_flows):
    """The same parameters, gradients (one group without any: the frozen
    backbone's zeros in JAX, None in the port), updates, loss and flows."""
    params, tparams = _tree(3)
    grads, tgrads = _tree(4)
    updates, tupdates = _tree(5)
    grads["head"] = {k: np.zeros_like(v) for k, v in grads["head"].items()}
    tgrads = {k: (None if k.startswith("head.") else v)
              for k, v in tgrads.items()}
    updates["head"] = {k: np.zeros_like(v)
                       for k, v in updates["head"].items()}
    tupdates = [v for k, v in tupdates.items() if not k.startswith("head.")]
    flows = np.random.default_rng(6).normal(size=(3, 1, 8, 3)).astype(
        np.float32)
    want = jmon.telemetry_leaves(
        {"params": params}, {"params": grads}, {"params": updates},
        jnp.float32(1.5), jnp.asarray(flows) if with_flows else None)
    got = tmon.telemetry_leaves(
        tparams, tgrads, tupdates, torch.tensor(1.5),
        torch.from_numpy(flows) if with_flows else None)
    assert list(got) == list(want)
    assert set(got) <= set(tmon.TELEMETRY_LEAVES)
    assert sorted(got["grad_norm_by_group"]) == sorted(
        want["grad_norm_by_group"])
    for key in ("grad_norm", "param_norm", "update_ratio"):
        _close(float(got[key]), float(want[key]))
    for g, v in want["grad_norm_by_group"].items():
        _close(float(got["grad_norm_by_group"][g]), float(v))
    if with_flows:
        _close(got["delta_flow_norm"].numpy(), want["delta_flow_norm"])
    assert int(got["nonfinite"]) == int(want["nonfinite"]) == 0


def test_step_rows_round_trip_the_leaves():
    """An epoch's telemetry crosses to the host as one row a step and
    comes back as the JSON the step events carry."""
    tel = {"grad_norm": torch.tensor([1.0, 2.0]),
           "grad_norm_by_group": {"a": torch.tensor([3.0, 4.0])},
           "delta_flow_norm": torch.tensor([[5.0, 6.0], [7.0, 8.0]]),
           "nonfinite": torch.tensor([0, 3], dtype=torch.int32)}
    rows = tmon.step_rows(tel, 2)
    assert rows.shape == (2, 5)
    assert tmon.host_records(tel, 2, rows.tolist()) == [
        {"grad_norm": 1.0, "grad_norm_by_group": {"a": 3.0},
         "delta_flow_norm": [5.0, 6.0], "nonfinite": 0},
        {"grad_norm": 2.0, "grad_norm_by_group": {"a": 4.0},
         "delta_flow_norm": [7.0, 8.0], "nonfinite": 3}]


# --- the detector ------------------------------------------------------------


def _sequence(case):
    rng = np.random.default_rng(7)
    losses = list(1.0 + 0.05 * rng.normal(size=40))
    nonfinite = [0] * 40
    if case == "spike":
        losses[20] = 4.0
        losses[30] = 2.0
    elif case == "nan_inf":
        losses[5], losses[12] = float("nan"), float("inf")
    elif case == "flat":
        losses = [1.0] * 20 + [1.0 + 1e-4] + [1.0] * 5
    elif case == "sentinel":
        nonfinite[9] = 3
    return losses, nonfinite


@pytest.mark.parametrize("case,kw", [
    ("spike", {}),
    ("spike", {"zscore": 0.0}),
    ("spike", {"window": 3}),
    ("nan_inf", {}),
    ("flat", {}),
    ("sentinel", {"window": 8, "zscore": 2.5}),
])
def test_detector_matches_jax(case, kw):
    """The same trips (step, reason, loss, z-score) on seeded sequences."""
    losses, nonfinite = _sequence(case)
    trips = []
    for det in (jdiv.DivergenceDetector(**kw), tdiv.DivergenceDetector(**kw)):
        got = []
        for i, (loss, bad) in enumerate(zip(losses, nonfinite)):
            trip = det.update(loss, bad)
            if trip is not None:
                got.append((i, trip.reason, repr(trip.loss), trip.zscore))
        trips.append(got)
    assert trips[0] == trips[1]
    assert trips[0] or kw.get("zscore") == 0.0


def test_detector_rejects_a_short_window_as_jax():
    for cls in (jdiv.DivergenceDetector, tdiv.DivergenceDetector):
        with pytest.raises(ValueError, match="window must be >= 2"):
            cls(window=1)
        assert cls(window=3, min_steps=50).min_steps == 3


# --- snapshots both ways -----------------------------------------------------


def _batch(seed=8):
    rng = np.random.default_rng(seed)
    return {"pc1": rng.normal(size=(2, 16, 3)).astype(np.float32),
            "pc2": rng.normal(size=(2, 16, 3)).astype(np.float32),
            "flow": rng.normal(size=(2, 16, 3)).astype(np.float32),
            "mask": np.ones((2, 16), np.float32)}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_snapshot_loads_in_jax(tmp_path):
    from pvraft_tpu_torch.models.raft import PVRaft

    cfg = tconfig.Config(model=tconfig.ModelConfig(**TINY))
    model = PVRaft(cfg.model)
    model.load_state_dict(seeded_state_dict(cfg.model, 3))
    optimizer = torch.optim.Adam(model.parameters())
    params = params_to_jax(model.state_dict())
    opt = opt_state_to_jax(optimizer, model, 7)
    path = tdiv.dump_snapshot(str(tmp_path), _batch(), params, opt, step=12,
                              epoch=1, reason="nonfinite",
                              loss=float("nan"), cfg=cfg,
                              extra_meta={"zscore": None})
    assert os.path.basename(path) == "step_0000012"
    meta, batch, jparams, jopt = jdiv.load_snapshot(path)
    assert meta["schema"] == "pvraft_snapshot/v1" and meta["loss"] == "NaN"
    assert meta["step"] == 12 and meta["reason"] == "nonfinite"
    _equal_trees(batch, _batch())
    _equal_trees(jparams, params)
    _equal_trees(jopt, opt)
    tmeta, tbatch, tparams, topt = tdiv.load_snapshot(path)
    assert tmeta == meta
    _equal_trees(tparams, params)


def test_jax_snapshot_loads_in_port(tmp_path):
    import optax

    state = seeded_state_dict(tconfig.ModelConfig(**TINY), 4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_jax(state))
    opt = optax.adam(1e-3).init(jparams)
    path = jdiv.dump_snapshot(str(tmp_path), _batch(), jparams, opt,
                              step=3, epoch=0, reason="zscore", loss=9.5,
                              cfg={"model": TINY})
    meta, batch, params, opt_state = tdiv.load_snapshot(path)
    assert meta["reason"] == "zscore" and meta["loss"] == 9.5
    _equal_trees(batch, _batch())
    got = params_from_jax(params)
    assert sorted(got) == sorted(state)
    for k in state:
        assert torch.equal(got[k], state[k])
    assert int(np.asarray(opt_state["0"]["count"])) == 0


def test_load_snapshot_rejects_another_schema(tmp_path):
    path = tdiv.dump_snapshot(str(tmp_path), _batch(), {"params": {}}, {},
                              step=1, epoch=0, reason="zscore", loss=1.0)
    meta = json.load(open(os.path.join(path, "meta.json")))
    meta["schema"] = "pvraft_snapshot/v0"
    json.dump(meta, open(os.path.join(path, "meta.json"), "w"))
    for load in (tdiv.load_snapshot, jdiv.load_snapshot):
        with pytest.raises(ValueError, match="schema"):
            load(path)


# --- logs --------------------------------------------------------------------


def test_experiment_log_layout_and_handlers(tmp_path):
    """The JAX layout and file name; one handler per file; the port's
    logger apart from the JAX package's of the same name."""
    from pvraft_tpu.utils.logging import ExperimentLog as JLog

    a = ExperimentLog(str(tmp_path), "Train", "FT3D")
    b = ExperimentLog(str(tmp_path), "Train", "FT3D")
    j = JLog(str(tmp_path / "jax"), "Train", "FT3D")
    assert a.logger is b.logger and a.logger is not j.logger
    assert len(a.logger.handlers) == 1
    a.info("hello")
    assert os.path.isfile(tmp_path / "logs" / "Train_FT3D.log")
    assert os.path.isdir(tmp_path / "checkpoints")
    assert "hello" in open(tmp_path / "logs" / "Train_FT3D.log").read()
    a.close()
    b.close()
    j.close()
    assert not a.logger.handlers
    tb = TBWriter(str(tmp_path / "logs"))
    tb.add_scalar("Train/Loss", 1.5, 3)
    tb.close()
    tb.close()
    assert tb.history["Train/Loss"] == [(3, 1.5)]


# --- the poisoned-dataset run, port against JAX ------------------------------


def _poisoned(build):
    def poisoned_build(c):
        train, val, test = build(c)

        class Poisoned:
            def __getattr__(self, name):
                return getattr(train, name)

            def __len__(self):
                return len(train)

            def __getitem__(self, i):
                s = dict(train[i])
                if i == 2:  # one bad sample: NaN coordinates in pc1
                    s["pc1"] = s["pc1"].copy()
                    s["pc1"][0, :] = np.nan
                return s

        return Poisoned(), val, test

    return poisoned_build


def _port_cfg(exp, **train):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=64,
                                synthetic_size=4, num_workers=0),
        train=tconfig.TrainConfig(batch_size=2, num_epochs=1, iters=2,
                                  eval_iters=2, checkpoint_interval=1,
                                  telemetry=True, **train),
        exp_path=str(exp))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    """One poisoned epoch of each package from the same initial weights:
    the JAX Trainer's (its ``training`` saves; the port's ``save`` is
    called after, as its ``fit`` does)."""
    from conftest import tiny_trainer_cfg

    import pvraft_tpu.engine.trainer as jtrmod
    import pvraft_tpu_torch.engine.trainer as ttrmod
    from pvraft_tpu.parallel.mesh import make_mesh

    root = tmp_path_factory.mktemp("poisoned")
    for mod in (jtrmod, ttrmod):
        monkeypatch_module.setattr(mod, "build_datasets",
                                   _poisoned(mod.build_datasets))
    jcfg = tiny_trainer_cfg(root / "jax")
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, telemetry=True))
    jt = jtrmod.Trainer(jcfg, mesh=make_mesh(n_data=1))
    weights = jax.tree_util.tree_map(np.asarray, jt.params)
    out = {"weights": weights}
    jmetrics = jt.training(0)
    jt.close()
    tt = ttrmod.Trainer(_port_cfg(root / "port"), device="cpu",
                        weights=weights)
    tmetrics = tt.training(0)
    tt.save(0, 1)
    tt.close()
    for name, exp, trainer, metrics in (
            ("jax", jcfg.exp_path, jt, jmetrics),
            ("port", root / "port", tt, tmetrics)):
        snap_root = os.path.join(exp, "snapshots")
        out[name] = {
            "events": os.path.join(exp, "train.events.jsonl"),
            "metrics": metrics, "tb": dict(trainer.tb.history),
            "snaps": [os.path.join(snap_root, s)
                      for s in sorted(os.listdir(snap_root))],
            "taken": trainer.snapshots_taken}
    return out


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_poisoned_run_events_match_jax(runs):
    jax_run, port = runs["jax"], runs["port"]
    assert not np.isfinite(port["metrics"]["loss"])
    assert port["snaps"] and port["taken"] == len(port["snaps"])
    jrec, trec = _records(jax_run["events"]), _records(port["events"])
    assert [r["type"] for r in trec] == [r["type"] for r in jrec]
    trips = [[(r["step"], r["reason"], r["loss"]) for r in recs
              if r["type"] == "divergence"] for recs in (jrec, trec)]
    assert trips[0] == trips[1] and trips[1][0][1:] == ("nonfinite", "NaN")
    steps = [r for r in trec if r["type"] == "step"]
    assert all(set(r["telemetry"]) == set(tmon.TELEMETRY_LEAVES)
               for r in steps)
    assert any(r["telemetry"]["nonfinite"] > 0 for r in steps)
    assert [sorted(r["telemetry"]["grad_norm_by_group"]) for r in steps] == [
        sorted(r["telemetry"]["grad_norm_by_group"])
        for r in jrec if r["type"] == "step"]


def test_snapshots_hold_each_step_s_pre_step_state(runs):
    """The first trip's snapshot holds the initial weights and a fresh
    Adam (the state before step 1); the second's the NaN state step 1
    left: the kept copy is refreshed before every step."""
    first, second = (tdiv.load_snapshot(p) for p in runs["port"]["snaps"])
    _equal_trees(first[2], runs["weights"])
    assert int(np.asarray(first[3]["0"]["count"])) == 0
    assert not any(np.any(leaf) for leaf in
                   jax.tree_util.tree_leaves(first[3]["0"]["mu"]))
    assert int(np.asarray(second[3]["0"]["count"])) == 1
    leaves = jax.tree_util.tree_leaves(second[2])
    assert any(np.isnan(leaf).any() for leaf in leaves)
    assert (first[0]["step"], second[0]["step"]) == (1, 2)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_train_stream_passes_both_validators(runs, package):
    path = runs[package]["events"]
    assert tvalidate(path) == []
    assert jvalidate(path) == []


def test_tensorboard_history_matches_jax(runs):
    jtb, ttb = runs["jax"]["tb"], runs["port"]["tb"]
    assert sorted(ttb) == sorted(jtb)
    for tag in jtb:
        assert [s for s, _ in ttb[tag]] == [s for s, _ in jtb[tag]]
        np.testing.assert_allclose([v for _, v in ttb[tag]],
                                   [v for _, v in jtb[tag]], rtol=1e-4,
                                   equal_nan=True)


def test_port_doctor_reads_a_jax_snapshot(runs, tmp_path, capsys):
    snap = runs["jax"]["snaps"][0]
    report = tmp_path / "report.json"
    assert tdoctor.main([snap, "--json", str(report), "--device",
                         "cpu"]) == 0
    assert "first non-finite stage is batch" in capsys.readouterr().out
    got = json.load(open(report))
    assert got["first_nonfinite_stage"] == "batch"
    by_stage = {r["stage"]: r["finite"] for r in got["stages"]}
    assert not by_stage["encoder(pc1)"] and by_stage["encoder(pc2)"]


def test_halt_on_divergence_flushes_step_events(runs, tmp_path):
    """Rides the module's poisoned datasets: the halt comes after the
    epoch's step events are written, and the halted epoch has no
    summary."""
    import pvraft_tpu_torch.engine.trainer as ttrmod

    trainer = ttrmod.Trainer(_port_cfg(tmp_path, halt_on_divergence=True),
                             device="cpu")
    with pytest.raises(tdiv.DivergenceHalt, match="diverged"):
        trainer.training(0)
    trainer.close()
    kinds = [r["type"] for r in read_events(
        os.path.join(tmp_path, "train.events.jsonl"))]
    assert "divergence" in kinds and "snapshot" in kinds
    assert "step" in kinds and "epoch_summary" not in kinds
    assert kinds.index("step") > kinds.index("divergence")
