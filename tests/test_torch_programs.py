"""The port's program registry (``pvraft_tpu_torch/programs``) and its
bitwise replay harness (``analysis/determinism/replay.py``), on the CPU
at the catalog's tiny size: the cases of ``tests/test_programs.py`` over
the port's own programs, the ``list``/``describe``/``params`` CLIs, and
the replay (the train step and the serve dispatch bitwise across two
builds, a deliberately non-deterministic program caught and named).
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from pvraft_tpu.programs.costs import _SERVE_RECORD_RE as JAX_SERVE_RE
from pvraft_tpu_torch.analysis.determinism import replay
from pvraft_tpu_torch.programs import (DuplicateProgramError, by_tag, get,
                                       load_catalog, register, specs)
from pvraft_tpu_torch.programs import spec as spec_mod
from pvraft_tpu_torch.programs.__main__ import build_params_tree
from pvraft_tpu_torch.programs.__main__ import main as programs_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _catalog():
    load_catalog()


@pytest.fixture
def scratch_spec():
    """Names registered by a test, removed after it."""
    names = []
    yield names
    for name in names:
        spec_mod._REGISTRY.pop(name, None)


def test_duplicate_name_raises(scratch_spec):
    scratch_spec.append("test.dup")
    register("test.dup")(lambda device, size: None)
    with pytest.raises(DuplicateProgramError, match="already declared"):
        register("test.dup")(lambda device, size: None)


def test_register_anchors_its_call_site(scratch_spec):
    scratch_spec.append("test.anchor")

    def thunk(device, size):
        """First docstring line."""

    register("test.anchor", tags=("t",))(thunk)
    spec = get("test.anchor")
    assert spec.path == __file__ and spec.description == "First docstring line."
    assert spec in by_tag("t")


def test_unknown_name_and_size_raise():
    with pytest.raises(KeyError, match="programs list"):
        get("no_such_program")
    with pytest.raises(ValueError, match="size"):
        get("flagship_fwd_fp32").build("cpu", "huge")


def test_spec_module_imports_no_torch():
    """spec.py's own imports are light: torch and the model come with
    the thunks."""
    import ast

    tree = ast.parse(open(spec_mod.__file__, encoding="utf-8").read())
    names = {a.name.split(".")[0] for node in tree.body
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in node.names}
    names |= {node.module.split(".")[0] for node in tree.body
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not names & {"torch", "numpy", "pvraft_tpu_torch"}


def test_catalog_imports_without_building_anything():
    """The catalog builds no model and counts nothing at import (a
    subprocess, so nothing else is loaded)."""
    code = (
        "import pvraft_tpu_torch.models.raft as raft\n"
        "def boom(*a, **k): raise AssertionError('built a model')\n"
        "raft.PVRaft.__init__ = boom\n"
        "raft.PVRaftRefine.__init__ = boom\n"
        "from pvraft_tpu_torch.programs import load_catalog, specs\n"
        "load_catalog()\n"
        "from pvraft_tpu_torch.ops import kernel_bounds\n"
        "assert not kernel_bounds._ACTIVE\n"
        "print(len(specs()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == len(specs())


def test_kernel_tag_covers_every_csrc_entry():
    """Every ``csrc/*.cu`` has a forward and a gradient spec."""
    sources = {f[:-3] for f in os.listdir(os.path.join(
        REPO, "pvraft_tpu_torch", "csrc")) if f.endswith(".cu")}
    kernel = by_tag("kernel")
    assert {k for s in kernel for k in s.kernels} == sources
    for source in sources:
        names = {s.name for s in kernel if source in s.kernels}
        assert {n.rsplit("_", 1)[1] for n in names} == {"fwd", "grad"}


def test_profile_specs_mirror_the_ladder():
    from pvraft_tpu_torch.profiling.step_profiler import MEASUREMENTS

    names = [s.name for s in by_tag("profile")]
    assert names == [f"profile.{m}" for m in MEASUREMENTS]
    fn, inputs = get("profile.encoder").build("cpu", "tiny")
    out, = fn(*inputs)
    assert out.dim() == 0 and torch.isfinite(out)


def test_every_serve_geometry_is_registered():
    """One spec per (bucket, batch) of ServeConfig() and per dtype, named
    so the JAX ``_SERVE_RECORD_RE`` parses it, for the function the
    engine captures."""
    from pvraft_tpu_torch.serve import ServeConfig
    from pvraft_tpu_torch.serve.aot import SERVE_DTYPES
    from pvraft_tpu_torch.serve.engine import predict_fn

    cfg = ServeConfig()
    want = {f"serve_predict_{short}_b{b}_bs{bs}"
            for short in SERVE_DTYPES.values()
            for b in cfg.buckets for bs in cfg.batch_sizes}
    got = {s.name for s in by_tag("serve", "aot")}
    assert got == want
    for name in got:
        m = JAX_SERVE_RE.match(name)
        assert m and m.group("variant") in SERVE_DTYPES.values()
    fn, inputs = get("serve_predict_fp32_b2048_bs4").build("cpu", "tiny")
    assert fn.__code__ is predict_fn(None, 1, False).__code__
    assert [tuple(t.shape) for t in inputs] == [(4, 32, 3)] * 2 + [(4, 32)] * 2
    flow, = fn(*inputs)
    assert flow.shape == (4, 32, 3) and torch.isfinite(flow).all()


@pytest.mark.parametrize("module", ["geometries", "catalog"])
def test_no_duplicated_serve_geometry_literals(module):
    """The serve table's buckets, batch sizes and dtype tags are the
    engine's constants, imported: no literal of them in the registry."""
    from pvraft_tpu_torch.programs import geometries as g
    from pvraft_tpu_torch.serve import engine

    path = os.path.join(REPO, "pvraft_tpu_torch", "programs", f"{module}.py")
    text = re.sub(r'"""[\s\S]*?"""', "", open(path, encoding="utf-8").read())
    code = "\n".join(line.split("#")[0] for line in text.splitlines())
    assert not re.search(r"\b(2048|4096)\b|['\"]fp32['\"]\s*[,}]", code)
    assert list(g.serve_program_keys()) == [
        (b, bs) for b in engine.SERVE_DEFAULT_BUCKETS
        for bs in engine.SERVE_DEFAULT_BATCH_SIZES]


def test_list_cli_names_the_slice(capsys):
    """Kernels 1, 2, 2b, 3, 1g, 2g and 3g, the flagship train, eval and
    refine steps, and every serve geometry."""
    assert programs_main(["list"]) == 0
    out = capsys.readouterr().out
    names = set(re.findall(r"^(\S+)\s", out, re.M))
    for kernel in ("corr_lookup", "gru_iter", "gru_iter_bf16", "voxel_corr",
                   "corr_lookup_general", "gru_iter_general",
                   "voxel_corr_general"):
        assert {f"cuda_{kernel}_fwd", f"cuda_{kernel}_grad"} <= names
    assert {"flagship_train_step_fp32", "flagship_train_step_bf16",
            "flagship_eval_step_fp32", "flagship_refine_train_step_fp32",
            "flagship_refine_eval_step_fp32", "flagship_fwd_fp32",
            "flagship_fwd_bf16"} <= names
    assert {s.name for s in by_tag("serve")} <= names
    assert programs_main(["list", "--tag", "kernel", "--only",
                          "bf16"]) == 0
    sel = set(re.findall(r"^(cuda\S+)\s", capsys.readouterr().out, re.M))
    assert sel == {"cuda_gru_iter_bf16_fwd", "cuda_gru_iter_bf16_grad"}


def test_describe_cli(capsys):
    assert programs_main(["describe", "cuda_voxel_corr_fwd", "--device",
                          "cpu", "--size", "tiny"]) == 0
    out = capsys.readouterr().out
    assert "float32[1, 64, 81]" in out and "kernels:     voxel_corr" in out
    assert programs_main(["describe", "nope"]) == 2


def test_params_check_passes_against_the_committed_tree(capsys):
    path = os.path.join(REPO, "artifacts", "params_tree.json")
    assert programs_main(["params", "--check", path]) == 0
    assert "95 leaves, 192034 parameters" in capsys.readouterr().out
    with open(path, encoding="utf-8") as f:
        assert build_params_tree() == json.load(f)


def test_params_check_catches_drift(tmp_path, capsys):
    tree = build_params_tree()
    tree["leaves"] = tree["leaves"][1:]
    path = tmp_path / "tree.json"
    path.write_text(json.dumps(tree))
    assert programs_main(["params", "--check", str(path)]) == 1
    out = tmp_path / "out.json"
    assert programs_main(["params", "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == build_params_tree()


def test_flagship_specs_run_at_tiny_size():
    for name in ("flagship_train_step_bf16", "flagship_refine_eval_step_fp32"):
        fn, inputs = get(name).build("cpu", "tiny")
        out = fn(*inputs)
        assert all(torch.isfinite(t.float()).all() for t in out)


# --- the bitwise replay -----------------------------------------------------


@pytest.fixture(scope="module")
def report():
    return replay.replay_report("cpu", "tiny")


def test_replay_is_bitwise_on_the_cpu(report):
    assert report["schema"] == replay.SCHEMA_VERSION
    assert report["verdict"] == "bitwise"
    assert [e["name"] for e in report["programs"]] == \
        list(replay.REPLAY_PROGRAMS)
    train, serve = report["programs"]
    # loss, epe, then 95 parameters and Adam's three tensors each.
    assert train["n_output_leaves"] == 2 + 95 * 4
    assert serve["n_output_leaves"] == 1 + 95
    assert all(e["digest"] == e["digest_rerun"] for e in report["programs"])


def test_replay_catches_a_nondeterministic_program(scratch_spec):
    """A program whose state moves by a draw from the global generator
    (outside the seed contract) differs across two builds, and the
    report names the tensor."""
    scratch_spec.append("test.nondeterministic")

    @register("test.nondeterministic")
    def thunk(device, size):
        weight = torch.zeros(4, device=device)

        def fn(x):
            weight.add_(torch.rand(4, device=device))
            return (x * 2,)

        fn.state = (weight,)
        return fn, (torch.ones(3, device=device),)

    got = replay.replay_report("cpu", "tiny", ("test.nondeterministic",))
    entry, = got["programs"]
    assert got["verdict"] == "divergent" and not entry["bitwise_identical"]
    assert entry["first_difference"]["tensor"] == "state[0]"


def test_check_report_green_and_red(report, tmp_path):
    path = str(tmp_path / "report.json")
    replay.write_report(path, report)
    assert replay.check_report(path, report) == []
    drift = json.loads(json.dumps(report))
    drift["programs"][0]["digest"] = "0" * 64
    replay.write_report(path, drift)
    problems = replay.check_report(path, report)
    assert any("digest drift" in p for p in problems)
    other = dict(drift, device="another card")
    replay.write_report(path, other)
    assert replay.check_report(path, report) == []
    assert replay.check_report(str(tmp_path / "none.json"), report)


def test_replay_cli(tmp_path, capsys):
    from pvraft_tpu_torch.analysis.__main__ import main

    out = tmp_path / "r.json"
    assert main(["determinism", "--replay", "--device", "cpu", "--out",
                 str(out)]) == 0
    saved = json.loads(out.read_text())
    assert saved["verdict"] == "bitwise" and saved["size"] == "tiny"
    assert main(["determinism", "--replay", "--device", "cpu", "--check",
                 str(out), "--out", str(tmp_path / "again.json")]) == 0
    # Without --replay the static rules run (the port's tree is clean).
    assert main(["determinism"]) == 0
