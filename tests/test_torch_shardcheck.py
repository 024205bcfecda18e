"""The port's shardcheck (``pvraft_tpu_torch/analysis/sharding``, GS004):
the JAX package's GS004 corpus (``tests/fixtures/shardcheck/gs004_*``)
and its inline cases through both checkers, with the same diagnostics;
the port's own guard spellings and ``torch.save``; the port's scope at
zero findings; the CLI. Then the three writers that GS004 found without
the process-0 rule of their JAX counterparts (``EventLog``,
``dump_snapshot``, ``save_checkpoint``): on a rank other than 0 they
write nothing, as JAX's do, and on rank 0 they write what they wrote
before."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pvraft_tpu.analysis.sharding.check import (
    check_paths as jax_check_paths,
    check_source as jax_check_source,
)
from pvraft_tpu.analysis.sharding.rules import (
    all_sharding_rules as jax_rules,
)
from pvraft_tpu_torch.analysis.engine import collect_suppressions
from pvraft_tpu_torch.analysis.sharding import (
    DEFAULT_SCOPE,
    all_sharding_rules,
    check_paths,
    check_source,
    default_scope,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "shardcheck")
GS004_FIXTURES = ("gs004_unguarded_io_red.py", "gs004_unguarded_io_green.py")
OBS = "/x/pvraft_tpu_torch/obs/foo.py"


def keyed(diags):
    return [(d.line, d.col, d.rule_id) for d in diags]


def ids(src, path=OBS):
    return [d.rule_id for d in check_source(src, path=path)]


# --- the JAX corpus and cases through both checkers ------------------------

@pytest.mark.parametrize("name", GS004_FIXTURES)
def test_fixture_parity_with_the_jax_checker(name):
    path = os.path.join(FIXTURES, name)
    got, n = check_paths([path])
    want, _ = jax_check_paths([path], rule_ids=("GS004",))
    assert n == 1
    assert keyed(got) == keyed(want)
    assert len(got) == (4 if name.endswith("_red.py") else 0)


def test_rule_id_and_title_are_jaxs():
    ours = [(r.id, r.title) for r in all_sharding_rules()]
    assert ours == [(r.id, r.title) for r in jax_rules() if r.id == "GS004"]
    assert all(r.__doc__ for r in all_sharding_rules())


MODULE_LEVEL = ("import numpy as np\n"
                "np.save('warm.npy', [1])\n")
NESTED_DEF = ("import numpy as np\n"
              "if True:\n"
              "    def writer(x):\n"
              "        np.save('x.npy', x)\n")
MUTUAL = ("import numpy as np\n"
          "def a(x):\n"
          "    np.save('a.npy', x)\n"
          "    b(x)\n"
          "def b(x):\n"
          "    np.save('b.npy', x)\n"
          "    a(x)\n")
PLAIN_WRITE = ("import numpy as np\n"
               "def f(x):\n"
               "    np.save('x.npy', x)\n")


@pytest.mark.parametrize("src, want", [
    (MODULE_LEVEL, 1), (NESTED_DEF, 1), (MUTUAL, 2), (PLAIN_WRITE, 1)],
    ids=["module_level", "nested_def", "mutual_recursion", "plain"])
def test_jax_cases_match(src, want):
    """The JAX package's blind-spot cases: an import-time write, a writer
    def'd under a compound statement, a mutually recursive pair with no
    outside caller (a least fixpoint: not proven guarded)."""
    got = check_source(src, path=OBS)
    assert [d.rule_id for d in got] == ["GS004"] * want
    jax = jax_check_source(src, path="/x/pvraft_tpu/obs/foo.py",
                           rule_ids=("GS004",))
    assert keyed(got) == keyed(jax)
    if src is MODULE_LEVEL:
        assert "<module>" in got[0].message


@pytest.mark.parametrize("plane, flagged", [
    ("engine", True), ("obs", True), ("parallel", True), ("serve", False),
    ("data", False), ("fleet", False)])
def test_scope_inside_the_package(plane, flagged):
    """GS004 applies to the every-rank planes inside the package and to
    any source outside it."""
    path = f"/x/pvraft_tpu_torch/{plane}/foo.py"
    assert ids(PLAIN_WRITE, path) == (["GS004"] if flagged else [])
    assert ids(PLAIN_WRITE, "/x/elsewhere/foo.py") == ["GS004"]


def test_pragmas_with_and_without_reason(tmp_path):
    with_reason = PLAIN_WRITE.replace(
        "np.save('x.npy', x)\n",
        "np.save('x.npy', x)  # graftlint: disable=GS004 -- a fixture\n")
    without = PLAIN_WRITE.replace(
        "np.save('x.npy', x)\n",
        "np.save('x.npy', x)  # graftlint: disable=GS004\n")
    assert ids(with_reason) == [] and ids(without) == []
    (tmp_path / "a.py").write_text(with_reason)
    (tmp_path / "b.py").write_text(without)
    reasons = {os.path.basename(p.path): p.reason
               for p in collect_suppressions([str(tmp_path)])}
    assert reasons == {"a.py": "a fixture", "b.py": ""}


def test_syntax_error_is_gs000():
    assert ids("def broken(:\n") == ["GS000"]


# --- the port's guard shapes, red and green --------------------------------

def _fn(body, header="def f(path, x):\n"):
    return ("import os\nimport torch\nimport numpy as np\n"
            "from pvraft_tpu_torch.parallel import process_count, "
            "process_index\n" + header + body)


PORT_CASES = {
    "rank0_if": (
        _fn("    if process_index() == 0:\n        np.save(path, x)\n"),
        _fn("    if process_index() == 1:\n        np.save(path, x)\n")),
    "mesh_field": (
        _fn("    if self.mesh.process_index == 0:\n"
            "        np.save(path, x)\n", "def f(self, path, x):\n"),
        _fn("    if self.mesh.process_count == 0:\n"
            "        np.save(path, x)\n", "def f(self, path, x):\n")),
    "lead_local": (
        _fn("    lead = process_index() == 0\n"
            "    if lead:\n        np.save(path, x)\n"),
        _fn("    lead = process_count() == 2\n"
            "    if lead:\n        np.save(path, x)\n")),
    "guard_clause": (
        _fn("    if process_index() != 0:\n        return\n"
            "    np.save(path, x)\n"),
        _fn("    if process_index() != 0:\n        x = 0\n"
            "    np.save(path, x)\n")),
    "single_process": (
        _fn("    if process_count() > 1:\n        raise ValueError(x)\n"
            "    np.save(path, x)\n"),
        _fn("    if process_count() > 1:\n        x = 0\n"
            "    np.save(path, x)\n")),
    "flag_field": (
        "from pvraft_tpu_torch.parallel import process_index\n"
        "class Log:\n"
        "    def __init__(self, path, enabled=None):\n"
        "        if enabled is None:\n"
        "            enabled = process_index() == 0\n"
        "        self.enabled = enabled\n"
        "        if self.enabled:\n"
        "            self.f = open(path, 'a')\n",
        "class Log:\n"
        "    def __init__(self, path, enabled=True):\n"
        "        self.enabled = enabled\n"
        "        if self.enabled:\n"
        "            self.f = open(path, 'a')\n"),
    "writer_helper": (
        _fn("    if process_index() == 0:\n        _write(path, x)\n")
        + "def _write(path, x):\n    os.replace(path + '.tmp', path)\n",
        _fn("    if process_index() == 0:\n        _write(path, x)\n"
            "    _write(path, x)\n")
        + "def _write(path, x):\n    os.replace(path + '.tmp', path)\n"),
    "torch_save": (
        _fn("    if process_index() == 0:\n        torch.save(x, path)\n"),
        _fn("    torch.save(x, path)\n")),
    "makedirs": (
        _fn("    os.makedirs(path, exist_ok=True)\n"),
        _fn("    os.makedirs(path)\n")),
}


@pytest.mark.parametrize("shape, side", [
    (shape, side) for shape in PORT_CASES for side in ("green", "red")])
def test_port_guard_shapes(shape, side):
    src = PORT_CASES[shape][side == "red"]
    got = check_source(src, path=OBS)
    assert [d.rule_id for d in got] == ([] if side == "green" else ["GS004"])
    if shape != "torch_save":
        # The JAX checker matches the same spellings by name.
        jax = jax_check_source(src, path="/x/pvraft_tpu/obs/foo.py",
                               rule_ids=("GS004",))
        assert keyed(got) == keyed(jax)
    if side == "red":
        assert "process_index() == 0" in got[0].message


# --- the port's own source -------------------------------------------------

def test_default_scope_is_the_every_rank_planes():
    assert DEFAULT_SCOPE == ("pvraft_tpu_torch/engine",
                             "pvraft_tpu_torch/obs",
                             "pvraft_tpu_torch/parallel")
    assert all(os.path.isdir(p) for p in default_scope())


def test_scope_checks_clean():
    diags, nfiles = check_paths(default_scope())
    assert nfiles >= 20
    assert diags == [], "\n".join(d.format() for d in diags)


def test_scope_is_clean_for_the_jax_checker_too():
    """The JAX checker, run read-only over the port's scope, finds
    nothing either (its seven findings in engine/ and obs/ are closed)."""
    diags, _ = jax_check_paths(list(default_scope()), rule_ids=("GS004",))
    assert diags == [], "\n".join(d.format() for d in diags)


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "pvraft_tpu_torch.analysis", "sharding",
         *args], capture_output=True, text=True, cwd=REPO)


def test_cli_default_scope_clean_and_imports_no_torch():
    code = ("import sys\n"
            "from pvraft_tpu_torch.analysis.__main__ import main\n"
            "rc = main(['sharding'])\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "shardcheck: 0 finding(s) in" in proc.stderr


def test_cli_red_fixture_and_rule_list(capsys):
    from pvraft_tpu_torch.analysis.__main__ import main

    assert main(["sharding", "--list-rules"]) == 0
    assert "GS004  unguarded-process0-io" in capsys.readouterr().out
    red = os.path.join(FIXTURES, "gs004_unguarded_io_red.py")
    assert main(["sharding", red, "--select", "GS004"]) == 1
    got = capsys.readouterr()
    assert got.out.count("GS004") == 4
    assert "shardcheck: 4 finding(s) in 1 file(s)" in got.err


# --- F5: the writers take their JAX counterparts' process-0 rule -----------

def _events(path):
    with open(path, encoding="utf-8") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


def test_event_log_is_process_0_only(tmp_path, monkeypatch):
    import jax

    from pvraft_tpu.obs import events as jax_events
    from pvraft_tpu_torch.obs import events

    monkeypatch.setattr(events, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    for module, name in ((events, "port"), (jax_events, "jax")):
        path = str(tmp_path / name / "e.jsonl")
        log = module.EventLog(path)
        assert not log.enabled
        assert log.emit("run_header", run_id="r", mode="train") is None
        log.close()
        assert not os.path.exists(path)
    monkeypatch.undo()
    # Rank 0: the same records as the log enabled by hand (the
    # earlier default).
    paths = [str(tmp_path / n) for n in ("default.jsonl", "enabled.jsonl")]
    for path, log in zip(paths, (events.EventLog(paths[0]),
                                 events.EventLog(paths[1], enabled=True))):
        with log:
            log.emit("run_header", **events.run_metadata({}, mode="train"))
            log.emit("epoch_summary", epoch=0, steps=2, loss=1.5, epe=0.5,
                     step_ms=1.0)
    a, b = _events(paths[0]), _events(paths[1])
    for rec in a + b:
        rec.pop("run_id", None)
    assert a == b and len(a) == 2


def _snapshot_args():
    rng = np.random.default_rng(0)
    batch = {k: rng.standard_normal((1, 4, 3)).astype(np.float32)
             for k in ("pc1", "pc2", "flow")}
    batch["mask"] = np.ones((1, 4), np.float32)
    params = {"params": {"w": rng.standard_normal(3).astype(np.float32)}}
    opt = {"count": np.zeros((), np.int32)}
    return batch, params, opt


def test_dump_snapshot_is_process_0_only(tmp_path, monkeypatch):
    import jax

    from pvraft_tpu.obs import divergence as jax_divergence
    from pvraft_tpu_torch.engine import msgpack
    from pvraft_tpu_torch.obs import divergence

    batch, params, opt = _snapshot_args()
    kw = dict(step=3, epoch=0, reason="nonfinite", loss=float("nan"))
    monkeypatch.setattr(divergence, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    for module, name in ((divergence, "port"), (jax_divergence, "jax")):
        root = tmp_path / name
        assert module.dump_snapshot(str(root), batch, params, opt,
                                    **kw) is None
        assert not root.exists()
    monkeypatch.undo()
    out = divergence.dump_snapshot(str(tmp_path / "rank0"), batch, params,
                                   opt, **kw)
    assert out == str(tmp_path / "rank0" / "step_0000003")
    with open(os.path.join(out, "state.msgpack"), "rb") as f:
        assert f.read() == msgpack.packb({"params": params,
                                          "opt_state": opt})
    with open(os.path.join(out, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["step"] == 3 and meta["reason"] == "nonfinite"
    with np.load(os.path.join(out, "batch.npz")) as got:
        assert all(np.array_equal(got[k], v) for k, v in batch.items())


def test_save_checkpoint_is_process_0_only(tmp_path, monkeypatch):
    import jax

    from pvraft_tpu.engine import checkpoint as jax_checkpoint
    from pvraft_tpu_torch.engine import checkpoint, msgpack

    _, params, opt = _snapshot_args()
    monkeypatch.setattr(checkpoint, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    paths = checkpoint.save_checkpoint(str(port_dir), params, opt, 4,
                                       checkpoint_interval=5, best=True)
    assert [os.path.basename(p) for p in paths] == [
        "last_checkpoint.msgpack", "004.msgpack", "best_checkpoint.msgpack"]
    assert os.listdir(port_dir) == []
    jax_checkpoint.save_checkpoint(str(jax_dir), params, opt, 4,
                                   checkpoint_interval=5, best=True)
    assert os.listdir(jax_dir) == []
    monkeypatch.undo()
    paths = checkpoint.save_checkpoint(str(port_dir), params, opt, 4,
                                       checkpoint_interval=5, best=True)
    want = msgpack.packb(checkpoint._sorted(
        {"epoch": 4, "params": params, "opt_state": opt}))
    for p in paths:
        with open(p, "rb") as f:
            assert f.read() == want
