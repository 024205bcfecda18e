"""The port's threadcheck (``pvraft_tpu_torch/analysis/concurrency``):
the JAX package's race corpus (``tests/fixtures/threadcheck/``) and its
red/green table through both checkers, with the same diagnostics; the
port's own shapes (``ordered_lock`` fields, the supervisor's module-level
transition, the batcher's bare try-lock); the port's scope at zero
findings, every pragma with a reason, and the CLI. Pure host-side."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from pvraft_tpu.analysis.concurrency.check import (
    check_paths as jax_check_paths,
    check_source as jax_check_source,
)
from pvraft_tpu_torch.analysis.concurrency import (
    DEFAULT_SCOPE,
    check_paths,
    check_source,
    default_scope,
)
from pvraft_tpu_torch.analysis.concurrency.model import build_module_model
from pvraft_tpu_torch.analysis.concurrency.rules import all_concurrency_rules
from pvraft_tpu_torch.analysis.engine import (
    collect_suppressions,
    known_rule_ids,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "threadcheck")
CORPUS = sorted(glob.glob(os.path.join(FIXTURES, "*.py")))


def keyed(diags):
    return [(d.rule_id, d.line, d.col, d.message) for d in diags]


def ids(src, path="x.py"):
    return [d.rule_id for d in check_source(src, path=path)]


# --- the JAX corpus through both checkers ---------------------------------

def test_corpus_is_there():
    # Seven races, each red and green, and the keep-alive case.
    assert len(CORPUS) == 15


@pytest.mark.parametrize("path", CORPUS, ids=os.path.basename)
def test_corpus_parity_with_the_jax_checker(path):
    got, n = check_paths([path])
    want, _ = jax_check_paths([path])
    assert n == 1
    assert keyed(got) == keyed(want)
    if path.endswith("_red.py"):
        assert got, f"{os.path.basename(path)}: the race is not detected"
    else:
        assert got == []


# --- the red/green table of tests/test_threadcheck.py ---------------------

GC001_RED = '''
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0  # guarded-by: _lock
    def bump(self):
        self.n += 1
'''

GC001_GREEN = '''
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0  # guarded-by: _lock
    def bump(self):
        with self._lock:
            self.n += 1
'''

GC002_RED = '''
import threading
class C:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
    def f(self):
        with self.a:
            with self.b:
                pass
    def g(self):
        with self.b:
            with self.a:
                pass
'''

GC002_GREEN = '''
import threading
class C:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
    def f(self):
        with self.a:
            with self.b:
                pass
    def g(self):
        with self.a:
            with self.b:
                pass
'''

GC002_CALL_RED = '''
import threading
class C:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
    def f(self):
        with self.a:
            self.g()
    def g(self):
        with self.b:
            self.h()
    def h(self):
        with self.a:
            pass
'''

GC002_MULTI_ITEM_RED = '''
import threading
class C:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
    def f(self):
        with self.a, self.b:
            pass
    def g(self):
        with self.b:
            with self.a:
                pass
'''

GC003_QUEUE_RED = '''
import queue
import threading
class C:
    def __init__(self):
        self._q = queue.Queue(maxsize=2)
        self._t = threading.Thread(target=self.run, daemon=True)
    def run(self):
        pass
    def submit(self, item):
        if not self._q.full():
            self._q.put_nowait(item)
'''

GC003_QUEUE_GREEN = '''
import queue
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._q = queue.Queue(maxsize=2)
        self._t = threading.Thread(target=self.run, daemon=True)
    def run(self):
        pass
    def submit(self, item):
        with self._lock:
            if not self._q.full():
                self._q.put_nowait(item)
'''

GC004_RED = '''
import threading
class C:
    def __init__(self):
        self._t = threading.Thread(target=self.run)
        self._t.start()
    def run(self):
        pass
'''

GC004_GREEN = '''
import threading
class C:
    def __init__(self):
        self._t = threading.Thread(target=self.run)
        self._t.start()
    def run(self):
        pass
    def close(self):
        self._t.join()
'''

GC004_STRING_JOIN_RED = '''
import os
import threading
class C:
    def __init__(self):
        self._t = threading.Thread(target=self.run)
        self._t.start()
    def run(self):
        return ", ".join(["a", "b"]) + os.path.join("x", "y")
'''

# The port's ordered_lock(...) fields are locks, as the JAX checker's are.
ORDERED_RED = '''
from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
class C:
    def __init__(self):
        self._lock = ordered_lock("C._lock")
        self.n = 0  # guarded-by: _lock
    def read(self):
        return self.n
'''

ORDERED_GREEN = ORDERED_RED.replace(
    "        return self.n", "        with self._lock:\n            return self.n")

# A state mutation inside a helper method is outside any lexical lock
# (the supervisor's `_set` before its module-level `_transition`).
HELPER_RED = '''
import threading
class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = ["healthy"]  # guarded-by: _lock
    def fail(self, i):
        with self._lock:
            self._set(i, "degraded")
    def _set(self, i, new):
        self._state[i] = new
'''

HELPER_GREEN = '''
import threading
def _transition(states, i, new):
    states[i] = new
class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = ["healthy"]  # guarded-by: _lock
    def fail(self, i):
        with self._lock:
            _transition(self._state, i, "degraded")
'''

# A flag set under a try-lock is outside a lexical `with`; the bare
# try-lock (the batcher's finalize) holds no field at all.
TRYLOCK_RED = '''
import threading
class R:
    def __init__(self):
        self._final = threading.Lock()
        self._done = False  # guarded-by: _final
    def finalize(self):
        if not self._final.acquire(blocking=False):
            return False
        try:
            won, self._done = not self._done, True
            return won
        finally:
            self._final.release()
'''

TRYLOCK_GREEN = '''
import threading
class R:
    def __init__(self):
        self._final = threading.Lock()
    def finalize(self):
        return self._final.acquire(blocking=False)
'''

TABLE = [
    ("GC001", GC001_RED, GC001_GREEN),
    ("GC002", GC002_RED, GC002_GREEN),
    ("GC002", GC002_CALL_RED, GC002_GREEN),
    ("GC002", GC002_MULTI_ITEM_RED, GC002_GREEN),
    ("GC003", GC003_QUEUE_RED, GC003_QUEUE_GREEN),
    ("GC004", GC004_RED, GC004_GREEN),
    ("GC004", GC004_STRING_JOIN_RED, GC004_GREEN),
    ("GC001", ORDERED_RED, ORDERED_GREEN),
    ("GC001", HELPER_RED, HELPER_GREEN),
    ("GC001", TRYLOCK_RED, TRYLOCK_GREEN),
]


@pytest.mark.parametrize("rule,red,green", TABLE)
def test_rule_red_green(rule, red, green):
    assert rule in ids(red)
    assert ids(green) == []
    for src in (red, green):
        assert keyed(check_source(src, "x.py")) == \
            keyed(jax_check_source(src, "x.py"))


def test_model_sees_ordered_lock_fields():
    src = ORDERED_RED
    cls = build_module_model(ast.parse(src), src, "x.py").class_named("C")
    assert set(cls.locks) == {"_lock"}
    assert cls.guard_of("n") == "_lock"
    assert cls.concurrent


def test_suppression_needs_the_rule_id():
    red = GC001_RED.replace(
        "        self.n += 1",
        "        self.n += 1  # graftlint: disable=GC001 -- test-only")
    assert ids(red) == []
    other = GC001_RED.replace(
        "        self.n += 1",
        "        self.n += 1  # graftlint: disable=GC002 -- test-only")
    assert ids(other) == ["GC001"]


def test_syntax_error_is_gc000():
    assert ids("def broken(:\n") == ["GC000"]


def test_rule_table_matches_the_jax_checker():
    from pvraft_tpu.analysis.concurrency.rules import (
        all_concurrency_rules as jax_rules,
    )

    ours = [(r.id, r.title) for r in all_concurrency_rules()]
    assert ours == [(r.id, r.title) for r in jax_rules()]
    assert [r.id for r in all_concurrency_rules()] == [
        "GC001", "GC002", "GC003", "GC004"]
    for r in all_concurrency_rules():
        assert r.__doc__


def test_known_rule_ids():
    assert {"GC000", "GC001", "GC002", "GC003", "GC004", "GD000", "GD001",
            "GD002", "GD003", "GD004", "GD005"} == known_rule_ids()


# --- the port's own source -------------------------------------------------

def test_default_scope_is_the_ports_threaded_planes():
    assert DEFAULT_SCOPE == ("pvraft_tpu_torch/serve",
                             "pvraft_tpu_torch/fleet",
                             "pvraft_tpu_torch/obs",
                             "pvraft_tpu_torch/data/loader.py")
    assert all(os.path.exists(p) for p in default_scope())


def test_scope_checks_clean():
    diags, nfiles = check_paths(default_scope())
    assert nfiles >= 30
    assert diags == [], "\n".join(d.format() for d in diags)


def test_scope_is_clean_for_the_jax_checker_too():
    """The JAX checker, run read-only over the port's scope, finds
    nothing either (its six GC001 findings there are closed)."""
    diags, _ = jax_check_paths(default_scope())
    assert diags == [], "\n".join(d.format() for d in diags)


def test_no_reasonless_pragma_in_the_port():
    pragmas = collect_suppressions([os.path.join(REPO, "pvraft_tpu_torch")])
    ours = [p for p in pragmas
            if any(i.startswith(("GC", "GD")) for i in p.ids)]
    assert ours, "the port's GD002 pragmas are missing"
    assert [p for p in ours if not p.reason] == []
    known = known_rule_ids()
    assert all(i in known for p in ours for i in p.ids)


def test_supervisor_transitions_counted_under_the_lock():
    """Every `_transition` call in the supervisor sits in a `with
    self._lock:` block beside its `self._transitions += 1`."""
    from pvraft_tpu_torch.serve import supervisor

    path = supervisor.__file__
    with open(path, encoding="utf-8") as f:
        src = f.read()
    cls = build_module_model(ast.parse(src), src, path).class_named(
        "ReplicaSupervisor")
    counts = [a for a in cls.accesses if a.attr == "_transitions"
              and a.write and a.method != "__init__"]
    assert len(counts) == src.count("_transition(\n") == 8
    assert all("_lock" in a.held for a in counts)


# --- the CLI ------------------------------------------------------------------

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "pvraft_tpu_torch.analysis", "concurrency",
         *args], capture_output=True, text=True, cwd=REPO)


def test_cli_list_rules(capsys):
    from pvraft_tpu_torch.analysis.__main__ import main

    assert main(["concurrency", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "GC001" in out and "GC004" in out


def test_cli_red_fixture_exits_nonzero(capsys):
    from pvraft_tpu_torch.analysis.__main__ import main

    assert main(["concurrency", os.path.join(FIXTURES, "pr8_in_flight_red.py"),
                 "--select", "GC001"]) == 1
    got = capsys.readouterr()
    assert got.out.count("GC001") == 2
    assert "threadcheck: 2 finding(s) in 1 file(s)" in got.err


def test_cli_default_scope_clean():
    proc = _run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "threadcheck: 0 finding(s) in" in proc.stderr


def test_cli_imports_no_torch():
    """The static half is pure stdlib: the CLI runs without torch."""
    code = ("import sys\n"
            "from pvraft_tpu_torch.analysis.__main__ import main\n"
            "rc = main(['concurrency'])\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
