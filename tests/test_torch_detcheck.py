"""The port's detcheck (``pvraft_tpu_torch/analysis/determinism``): the
JAX package's GD002/GD004/GD005 corpus (``tests/fixtures/detcheck/``)
through both checkers, the shared diagnostics equal and the ones only
JAX gives listed with their reason; red and green sources for each of
torch's shapes; the registry's hazard closure over the port's real
programs, each with its stance; the owner helpers of ``device.py``; the
port's tree at zero findings through the CLI. Pure host-side."""

import ast
import os

import pytest
import torch

from pvraft_tpu.analysis.determinism.check import (
    check_source as jax_check_source,
)
from pvraft_tpu_torch import device as tdevice
from pvraft_tpu_torch import rng
from pvraft_tpu_torch.analysis.__main__ import main as analysis_main
from pvraft_tpu_torch.analysis.determinism import (
    DEFAULT_SCOPE,
    HazardSpec,
    all_determinism_rules,
    check_source,
    declared_streams,
    hazard_spec_records,
)
from pvraft_tpu_torch.analysis.determinism.model import build_module_det_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "detcheck")
STREAMS = ("model.init", "data.shuffle")

# The diagnostics only the JAX checker gives on its corpus, by (file,
# line): the shapes the port has no counterpart of.
JAX_ONLY = {
    # `derive` is the JAX package's key derivation; the port's streams
    # are host_rng / host_entropy / torch_seed (no jax keys).
    ("gd002_entropy_red.py", 18): "jax key derivation (derive)",
    ("gd002_entropy_red.py", 19): "jax key derivation (derive)",
    # XLA_FLAGS and jax.config are JAX's backend flags; torch's are the
    # TF32, cuDNN and deterministic-algorithm switches.
    ("gd004_flags_red.py", 11): "XLA_FLAGS",
    ("gd004_flags_red.py", 13): "jax.config.update",
    ("gd004_flags_red.py", 15): "jax.config attribute",
}

CORPUS = [f"gd00{n}_{kind}_{color}.py" for n, kind in
          ((2, "entropy"), (4, "flags"), (5, "iteration"))
          for color in ("red", "green")]


def _read(name):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        return f.read()


def ids(src, rule=(), path="x.py", specs=()):
    return [d.rule_id for d in check_source(src, path, rule, STREAMS, specs)]


@pytest.fixture(scope="module")
def records():
    return hazard_spec_records()


# --- the JAX corpus through both checkers ---------------------------------

@pytest.mark.parametrize("name", CORPUS)
def test_corpus_parity_with_the_jax_checker(name):
    path = os.path.join(FIXTURES, name)
    src = _read(name)
    ours = {(d.rule_id, d.line, d.col)
            for d in check_source(src, path, (), STREAMS, ())}
    theirs = {(d.rule_id, d.line, d.col)
              for d in jax_check_source(src, path, (), STREAMS, ())
              if d.rule_id != "GD001"}
    assert ours <= theirs
    only_jax = {(name, line) for _, line, _ in theirs - ours}
    assert only_jax == {k for k in JAX_ONLY if k[0] == name}
    if name.endswith("_red.py"):
        assert ours
    else:
        assert ours == set()


def test_corpus_counts():
    red = {n: ids(_read(n)) for n in CORPUS if n.endswith("_red.py")}
    assert red == {"gd002_entropy_red.py": ["GD002"] * 4,
                   "gd004_flags_red.py": ["GD004"],
                   "gd005_iteration_red.py": ["GD005"] * 4}


# --- torch's shapes, red and green ----------------------------------------

GD001_RED = '''
from pvraft_tpu_torch.rng import host_rng

def noises(seed):
    a = host_rng(seed, "data.shuffle").random(4)
    b = host_rng(seed, "data.shuffle").random(4)
    return a, b
'''

GD001_GREEN = '''
from pvraft_tpu_torch.rng import host_rng, torch_seed

def noises(seed, i):
    a = host_rng(seed, "data.shuffle", 0).random(4)
    b = host_rng(seed, "data.shuffle", 1).random(4)
    c = host_rng(seed + 1, "data.shuffle", 0).random(4)
    d = host_rng(seed, "data.shuffle", i).random(4)
    e = host_rng(seed, "data.shuffle", i).random(4)
    return a, b, c, d, e, torch_seed(seed, "data.shuffle", 0)

def again(seed):
    def inner():
        return host_rng(seed, "data.shuffle")
    return host_rng(seed, "data.shuffle"), inner
'''

GD002_RED = '''
import os
import random
import time
import uuid

import numpy as np
import torch

from pvraft_tpu_torch.rng import host_entropy, host_rng, torch_seed


def mint(seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.Generator(device="cuda")
    h.manual_seed(seed)
    torch.manual_seed(0)
    torch.cuda.manual_seed_all(0)
    torch.cuda.manual_seed(1)
    s = torch.seed()
    r = np.random.RandomState(0)
    q = np.random.SeedSequence(seed)
    np.random.seed(0)
    x = random.random()
    t = torch.manual_seed(int(time.time()))
    p = np.random.default_rng(os.getpid())
    u = torch.Generator().manual_seed(uuid.uuid4().int & 0xFFFF)
    a = host_rng(seed)
    b = torch_seed(seed, "not.a.stream")
    c = host_entropy(seed, "model.init", "nope")
    return g, h, s, r, q, x, t, p, u, a, b, c
'''

GD002_GREEN = '''
import numpy as np
import torch

from pvraft_tpu_torch.rng import host_entropy, host_rng, torch_seed


def declared(seed, gen):
    a = host_rng(seed, "data.shuffle", 3)
    b = torch_seed(seed, "model.init")
    c = host_entropy(seed, "model.init", 0)
    x = torch.rand(4, generator=gen)
    y = a.random(4)
    z: np.random.Generator = a
    return a, b, c, x, y, z, torch.randn(2, generator=gen)
'''

GD003_HAZARDS = '''
import torch
import torch.distributed as dist
from torch import distributed


def ops(x, i, v, g):
    x.index_add_(0, i, v)
    torch.index_add(x, 0, i, v)
    x.scatter_add_(-1, i, v)
    torch.scatter_add(x, -1, i, v)
    x.scatter_reduce_(-1, i, v, "sum")
    x.index_put_((i,), v, accumulate=True)
    dist.all_reduce(x, group=g)
    distributed.reduce_scatter_tensor(x, v)
    torch.distributed.reduce(x, 0)
    dist.batch_isend_irecv([])
    dist.isend(x, 1)
'''

GD003_BENIGN = '''
import torch
import torch.distributed as dist


def ops(x, i, v, g):
    x.scatter_(-1, i, v)
    x.index_put_((i,), v)
    x.index_put_((i,), v, accumulate=False)
    torch.gather(x, -1, i)
    dist.all_gather([x], x, group=g)
    dist.broadcast(x, src=0)
    dist.barrier()
'''

GD004_RED = '''
import os

import torch


def flags():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.set_float32_matmul_precision("highest")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.update({"PYTHONHASHSEED": "0"})
'''

GD004_GREEN = '''
import os

import torch

from pvraft_tpu_torch.device import deterministic_algorithms, set_tf32


def flags():
    set_tf32(False)
    was = torch.are_deterministic_algorithms_enabled()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["PVRAFT_CHECKS"] = "1"
    with deterministic_algorithms(True):
        return was, tf32, ws
'''


@pytest.mark.parametrize("rule,red,green,n_red", [
    ("GD001", GD001_RED, GD001_GREEN, 1),
    ("GD002", GD002_RED, GD002_GREEN, 20),
    ("GD004", GD004_RED, GD004_GREEN, 9),
])
def test_rule_red_green(rule, red, green, n_red):
    assert ids(red, (rule,)) == [rule] * n_red
    assert ids(green) == []


def test_gd002_messages():
    got = check_source(GD002_RED, "x.py", ("GD002",), STREAMS, ())
    msgs = "\n".join(d.message for d in got)
    assert sum("raw RNG constructor" in d.message for d in got) == 14
    for callee in ("torch.Generator", "torch.Generator.manual_seed",
                   "torch.manual_seed", "torch.cuda.manual_seed_all",
                   "torch.cuda.manual_seed", "torch.seed",
                   "numpy.random.RandomState", "numpy.random.SeedSequence",
                   "numpy.random.seed", "random.random"):
        assert f"`{callee}`" in msgs
    for via in ("time.time", "os.getpid", "uuid.uuid4"):
        assert f"time/entropy source `{via}`" in msgs
    assert "`host_rng` call carries no stream name literal" in msgs
    assert "undeclared stream 'not.a.stream'" in msgs
    assert "undeclared stream 'nope'" in msgs
    # torch.Generator().manual_seed(seed) is one site, not two.
    line = GD002_RED.splitlines().index(
        "    g = torch.Generator().manual_seed(seed)") + 1
    assert [d.line for d in got].count(line) == 1


def test_gd002_unreadable_vocabulary_is_a_finding():
    got = check_source(GD002_GREEN, "x.py", ("GD002",), None, ())
    assert got and all("unverifiable" in d.message for d in got)


def test_gd001_names_the_first_site():
    d, = check_source(GD001_RED, "x.py", ("GD001",), STREAMS, ())
    assert d.line == 6 and "as at line 5 in `noises`" in d.message


def test_hazard_ops_in_the_model():
    model = build_module_det_model(ast.parse(GD003_HAZARDS))
    kinds = [h.kind for h in model.hazard_ops]
    assert kinds == ["scatter-accumulate"] * 6 + \
        ["collective-reduction"] * 3 + ["ring-fold"] * 2
    assert build_module_det_model(ast.parse(GD003_BENIGN)).hazard_ops == []


def _spec(path, determinism):
    return HazardSpec(name="test.hazard_program", determinism=determinism,
                      path=path, line=3, via="pvraft_tpu_torch/ops/voxel.py",
                      kinds=("scatter-accumulate",))


def test_gd003_red_and_green():
    src = "from x import register\n\nregister('test.hazard_program')\n"
    d, = check_source(src, "/tmp/cat.py", ("GD003",), STREAMS,
                      (_spec("/tmp/cat.py", ""),))
    assert d.line == 3 and "determinism= stance" in d.message
    assert check_source(src, "/tmp/cat.py", ("GD003",), STREAMS,
                        (_spec("/tmp/cat.py", "unique-index-scatter"),)) \
        == []
    # A spec declared in another file leaves this one alone.
    assert check_source(src, "/tmp/other.py", ("GD003",), STREAMS,
                        (_spec("/tmp/cat.py", ""),)) == []


def test_owners_are_exempt_inside_the_package_only():
    rng_path = os.path.join(REPO, "pvraft_tpu_torch", "rng.py")
    device_path = os.path.join(REPO, "pvraft_tpu_torch", "device.py")
    assert ids(GD002_RED, ("GD002",), path=rng_path) == []
    assert ids(GD004_RED, ("GD004",), path=device_path) == []
    assert ids(GD004_RED, ("GD004",), path=rng_path) == ["GD004"] * 9
    with open(device_path, encoding="utf-8") as f:
        source = f.read()
    assert len(build_module_det_model(ast.parse(source)).flag_writes) == 5


def test_suppression_and_syntax_error():
    red = GD004_RED.replace(
        "    torch.backends.cudnn.benchmark = False",
        "    torch.backends.cudnn.benchmark = False  "
        "# graftlint: disable=GD004 -- test-only")
    assert ids(red, ("GD004",)) == ["GD004"] * 8
    assert ids("def broken(:\n") == ["GD000"]


def test_rule_table():
    rules = all_determinism_rules()
    assert [r.id for r in rules] == [
        "GD001", "GD002", "GD003", "GD004", "GD005"]
    for r in rules:
        assert r.title and r.__doc__


# --- the declared context: streams and the registry ------------------------

def test_declared_streams_match_runtime():
    assert declared_streams() == rng.STREAM_NAMES


def test_hazard_closure_covers_the_real_programs(records):
    from pvraft_tpu_torch.programs import specs

    by_name = {r.name: r for r in records}
    catalog = specs()
    assert set(by_name) == set(catalog)
    assert all(r.determinism == catalog[r.name].determinism
               for r in records)
    assert "scatter-accumulate" in by_name["cuda_corr_lookup_grad"].kinds
    assert by_name["cuda_voxel_corr_fwd"].kinds == ("scatter-accumulate",)
    sharded = by_name["dp_sp_2x2_train_step"]
    assert {"collective-reduction", "ring-fold"} <= set(sharded.kinds)
    catalog_path = os.path.join(REPO, "pvraft_tpu_torch", "programs",
                                "catalog.py")
    assert all(os.path.samefile(r.path, catalog_path) for r in records)


def test_every_hazard_program_declares_a_stance(records):
    assert [r.name for r in records if not r.determinism] == []
    stances = {r.name: r.determinism for r in records}
    assert stances["dp_sp_2x2_train_step"].endswith(
        "all_reduce and ring order fixed by the mesh")
    assert stances["flagship_train_step_fp32"].startswith(
        "unique-index-scatter")


def test_gd003_fires_when_a_stance_is_dropped(records):
    """The live records through GD003: clean as declared, one finding per
    spec at its registration line when the stances are taken away."""
    path = records[0].path
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert check_source(src, path, ("GD003",), STREAMS, records) == []
    bare = [HazardSpec(r.name, "", r.path, r.line, r.via, r.kinds)
            for r in records]
    got = check_source(src, path, ("GD003",), STREAMS, bare)
    assert len(got) == len(records)
    assert {d.line for d in got} == {r.line for r in records}


# --- the owner helpers --------------------------------------------------------

def test_set_tf32_sets_both_switches():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        tdevice.set_tf32(True)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        tdevice.set_tf32(False)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]


def test_deterministic_algorithms_restores():
    assert not torch.are_deterministic_algorithms_enabled()
    with tdevice.deterministic_algorithms(True):
        assert torch.are_deterministic_algorithms_enabled()
        with tdevice.deterministic_algorithms(False):
            assert torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()


def test_fix_cublas_workspace_keeps_a_named_one(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    tdevice.fix_cublas_workspace()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    tdevice.fix_cublas_workspace()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


# --- the port's tree ----------------------------------------------------------

def test_default_scope():
    assert DEFAULT_SCOPE == ("pvraft_tpu_torch",)


def test_cli_tree_clean(capsys):
    assert analysis_main(["determinism"]) == 0
    got = capsys.readouterr()
    assert got.out == ""
    assert "detcheck: 0 finding(s) in" in got.err


def test_cli_red_fixture_and_list(capsys):
    red = os.path.join(FIXTURES, "gd005_iteration_red.py")
    assert analysis_main(["determinism", red]) == 1
    got = capsys.readouterr()
    assert got.out.count("GD005") == 4
    assert "detcheck: 4 finding(s) in 1 file(s)" in got.err
    assert analysis_main(["determinism", red, "--select", "GD002"]) == 0
    capsys.readouterr()
    assert analysis_main(["determinism", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(f"GD00{i}" in out for i in range(1, 6))
