"""The port's graftlint (``pvraft_tpu_torch/analysis/rules.py``, GL006 and
GL007, run by ``analysis/lint.py``): the JAX package's GL006/GL007 corpus
(the red and green fixtures and the suppression cases of
``tests/test_analysis_lint.py``, on sources that trip these two rules)
through both checkers, with the same ``(rule_id, line, col, message)``
lists; the rule table; the suppression-debt report (``lint --stats``)
line for line against JAX's; the port's scope at zero findings; the CLI
in a subprocess that imports neither torch nor jax."""

import os
import subprocess
import sys

import pytest

from pvraft_tpu.analysis.__main__ import main as jax_main
from pvraft_tpu.analysis.engine import all_rules as jax_all_rules
from pvraft_tpu.analysis.engine import lint_paths as jax_lint_paths
from pvraft_tpu.analysis.engine import lint_source as jax_lint_source
from pvraft_tpu_torch.analysis.__main__ import main
from pvraft_tpu_torch.analysis.lint import (
    DEFAULT_SCOPE,
    default_scope,
    lint_paths,
    lint_source,
)
from pvraft_tpu_torch.analysis.rules import all_lint_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GL = ("GL006", "GL007")


def keyed(diags):
    return [(d.rule_id, d.line, d.col, d.message) for d in diags]


def both(src, path="x.py"):
    """The port's findings, after holding them equal to JAX's GL006/GL007
    findings on the same source."""
    got = keyed(lint_source(src, path=path))
    assert got == keyed(jax_lint_source(src, path=path, rule_ids=GL))
    return got


def both_paths(paths):
    got, n = lint_paths(paths)
    want, n_jax = jax_lint_paths(paths, rule_ids=GL)
    assert (keyed(got), n) == (keyed(want), n_jax)
    return [d.rule_id for d in got]


# --- the JAX corpus: red and green fixtures ---------------------------------

RED = {
    "GL006": (
        "def f(x, cache={}):\n"
        "    return cache\n"
    ),
    "GL007": (
        "import jax\n"
        "def f(x):\n"
        "    jax.debug.print(f\"x={x}\")\n"
    ),
}

GREEN = {
    "GL006": (
        "def f(x, cache=None):\n"
        "    cache = {} if cache is None else cache\n"
        "    return cache\n"
    ),
    "GL007": (
        "import jax\n"
        "def f(x):\n"
        "    jax.debug.print(\"x={x}\", x=x)\n"
    ),
}

# Every shape each rule takes or leaves: (source, the ids it gives).
SHAPES = [
    ("def f(a=[]):\n    pass\n", ["GL006"]),
    ("def f(a={}):\n    pass\n", ["GL006"]),
    ("def f(a={1, 2}):\n    pass\n", ["GL006"]),
    ("def f(a=list()):\n    pass\n", ["GL006"]),
    ("def f(a=dict()):\n    pass\n", ["GL006"]),
    ("def f(a=set()):\n    pass\n", ["GL006"]),
    ("def f(*, a=[], b=None):\n    pass\n", ["GL006"]),
    ("def f(a=[], *, b={}):\n    pass\n", ["GL006", "GL006"]),
    ("async def f(a=[]):\n    pass\n", ["GL006"]),
    ("g = lambda a=[]: a\n", ["GL006"]),
    ("g = lambda *, a=set(): a\n", ["GL006"]),
    ("class C:\n    def m(self, a={}):\n        pass\n", ["GL006"]),
    ("def f(a=list((1,))):\n    pass\n", []),
    ("def f(a=dict(x=1)):\n    pass\n", []),
    ("def f(a=(), b=frozenset(), c=None, d=0):\n    pass\n", []),
    ("def f(a=collections.OrderedDict()):\n    pass\n", []),
    ("def f(a=[]):\n    g = lambda b={}: b\n", ["GL006", "GL006"]),
    ("jax.debug.print(f'{x}')\n", ["GL007"]),
    ("debug.print(f'{x}')\n", ["GL007"]),
    ("from jax import debug\ndebug.print(f'{x}', y=1)\n", ["GL007"]),
    ("a.b.debug.print(f'{x}')\n", ["GL007"]),
    ("print(f'{x}')\n", []),
    ("torch.print(f'{x}')\n", []),
    ("jax.debug.print('x={x}', x=x)\n", []),
    ("jax.debug.print(fmt, x=x)\n", []),
    ("jax.debug.print()\n", []),
    ("get().debug.print(f'{x}')\n", []),
    ("jax.debug.print(f'{x}') if d else None\n", ["GL007"]),
    ("def f(a=[]):\n    jax.debug.print(f'{a}')\n", ["GL006", "GL007"]),
]


@pytest.mark.parametrize("rule_id", sorted(RED))
def test_red_fixture_fires_exactly_once(rule_id):
    assert [d[0] for d in both(RED[rule_id])] == [rule_id]


@pytest.mark.parametrize("rule_id", sorted(GREEN))
def test_green_fixture_clean(rule_id):
    assert both(GREEN[rule_id]) == []


@pytest.mark.parametrize("src,want", SHAPES)
def test_shapes_match_jax(src, want):
    assert [d[0] for d in both(src)] == want


def test_anchor_is_the_default_and_the_call():
    """GL006 at the default's line and column, GL007 at the call's."""
    src = ("def f(x,\n"
           "      cache={}):\n"
           "    jax.debug.print(f'{x}')\n")
    assert [d[:3] for d in both(src)] == [("GL006", 2, 12),
                                          ("GL007", 3, 4)]


# --- suppressions: the cases of the JAX suite, on GL006 and GL007 ----------

SUPPRESSIONS = {
    "line_with_reason": (
        "def f(x, cache={}):  # graftlint: disable=GL006 -- test\n"
        "    return cache\n",
        []),
    "line_multiple_ids": (
        "g = lambda x, c=[]: jax.debug.print(f'{x}')"
        "  # graftlint: disable=GL007,GL006\n",
        []),
    "line_wrong_id": (
        "def f(x, cache={}):  # graftlint: disable=GL007\n"
        "    return cache\n",
        ["GL006"]),
    "line_all": (
        "g = lambda x, c=[]: jax.debug.print(f'{x}')"
        "  # graftlint: disable=all\n",
        []),
    "next_line": (
        "# graftlint: disable-next=GL006 -- test\n"
        "def f(x, cache={}):\n"
        "    return cache\n"
        "def g(x, cache={}):\n"          # the next line only
        "    return cache\n",
        ["GL006"]),
    "file_wide": (
        "# graftlint: disable-file=GL007 -- test\n"
        "jax.debug.print(f'{x}')\n"
        "jax.debug.print(f'{y}')\n",
        []),
    "file_wide_other_rule": (
        "# graftlint: disable-file=GL007 -- test\n"
        "def f(x, cache={}):\n"
        "    return cache\n",
        ["GL006"]),
    "per_line": (
        "jax.debug.print(f'{x}')  # graftlint: disable=GL007\n"
        "jax.debug.print(f'{y}')\n",
        ["GL007"]),
    "docstring_inert": (
        '"""Docs.\n'
        "\n"
        "    # graftlint: disable-file=GL006 -- just an example\n"
        '"""\n'
        "def f(x, cache={}):\n"
        "    return cache\n",
        ["GL006"]),
    "string_inert": (
        "S = '# graftlint: disable=GL007'; jax.debug.print(f'{S}')\n",
        ["GL007"]),
    "decorated_disable_next": (
        "def deco(f):\n"
        "    return f\n"
        "# graftlint: disable-next=GL006 -- test\n"
        "@deco\n"
        "def f(x, cache={}):\n"
        "    return cache\n",
        []),
    "decorated_pragma_on_signature": (
        "def deco(f):\n"
        "    return f\n"
        "@deco\n"
        "def f(x,\n"
        "      cache={}):  # graftlint: disable=GL006 -- test\n"
        "    return cache\n",
        []),
    "undecorated_exact": (
        "# graftlint: disable-next=GL006 -- test\n"
        "def f(x, cache={}):\n"
        "    return cache\n"
        "def g(x, cache={}):\n"
        "    return cache\n",
        ["GL006"]),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSIONS))
def test_suppression_matches_jax(case):
    src, want = SUPPRESSIONS[case]
    assert [d[0] for d in both(src)] == want


FILES = {
    "bom": ("\ufeffdef f(x, cache={}):\n    return cache\n"
            .encode("utf-8"), ["GL006"]),
    "crlf_suppression": (
        b"def f(x, cache={}):  # graftlint: disable=GL006 -- test\r\n"
        b"    return cache\r\n", []),
    "crlf_finding_lines": (
        b"import jax\r\n\r\njax.debug.print(f'{x}')\r\n", ["GL007"]),
    "bom_crlf_file_level": (
        "\ufeff# graftlint: disable-file=GL006 -- test\r\n"
        "def f(x, cache={}):\r\n    return cache\r\n".encode("utf-8"), []),
}


@pytest.mark.parametrize("case", sorted(FILES))
def test_file_cases_match_jax(case, tmp_path):
    """BOM and CRLF sources lint (not GL000) and keep their pragmas."""
    data, want = FILES[case]
    f = tmp_path / f"{case}.py"
    f.write_bytes(data)
    assert both_paths([str(f)]) == want


def test_syntax_error_is_gl000():
    got = both("def f(:\n", path="bad.py")
    assert [d[0] for d in got] == ["GL000"]
    assert got[0][3].startswith("syntax error: ")


def test_select_restricts_the_rules():
    src = "def f(a=[]):\n    jax.debug.print(f'{a}')\n"
    for ids in (("GL006",), ("GL007",)):
        got = keyed(lint_source(src, rule_ids=ids))
        assert got == keyed(jax_lint_source(src, rule_ids=ids))
        assert [d[0] for d in got] == list(ids)


# --- the rule table -----------------------------------------------------------

def test_rule_table_is_jaxs():
    jax_rules = {r.id: r for r in jax_all_rules()}
    assert [r.id for r in all_lint_rules()] == list(GL)
    for r in all_lint_rules():
        want = jax_rules[r.id]
        assert (r.title, r.__doc__, r.__name__) == \
            (want.title, want.__doc__, want.__name__)


def test_cli_list_rules(capsys):
    assert main(["lint", "--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in lines] == [
        ["GL006", "mutable-default-arg"], ["GL007", "fstring-debug-print"]]
    jax_rules = {r.id: r for r in jax_all_rules()}
    for line in lines:
        rule = jax_rules[line.split()[0]]
        assert line.endswith(rule.__doc__.strip().splitlines()[0])


# --- the suppression-debt report, line for line against JAX's --------------

STATS = {
    "reasoned": (
        "def f(x, cache={}):  # graftlint: disable=GL006 -- shared on purpose\n"
        "    return cache\n"
        "# graftlint: disable-file=GL007 -- prints through jax\n"
        "# graftlint: disable-next=GD002 -- a fixed stream\n"
        "rng = None\n", 0, []),
    "reasonless": (
        "def f(x, cache={}):  # graftlint: disable=GL006\n"
        "    return cache\n", 1, ["reason-less"]),
    "trailing_text": (
        "def f(x, cache={}):  # graftlint: disable=GL006 see NOTES.md\n"
        "    return cache\n", 1, ["reason-less"]),
    "unknown_id": (
        "x = 1  # graftlint: disable=GL999 -- typo'd id\n", 0,
        ["unknown rule GL999"]),
}


@pytest.mark.parametrize("case", sorted(STATS))
def test_stats_match_jax(case, tmp_path, capsys):
    src, rc, says = STATS[case]
    (tmp_path / "a.py").write_text(src)
    assert main(["lint", "--stats", str(tmp_path)]) == rc
    got = capsys.readouterr()
    assert jax_main(["lint", "--stats", str(tmp_path)]) == rc
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert all(s in got.out for s in says)
    if case == "trailing_text":
        # The engine honours the pragma all the same.
        assert lint_paths([str(tmp_path)])[0] == []


def test_stats_over_the_port_match_jax(capsys):
    """The port's pragmas are its eight GD002s, every one with a reason;
    JAX's report over the same files says the same."""
    assert main(["lint", "--stats"]) == 0
    got = capsys.readouterr()
    assert jax_main(["lint", "--stats", *default_scope()]) == 0
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert got.out.startswith("GD002     8 suppression(s)")
    assert "8 active pragma(s), 0 without reason" in got.err


# --- the port's own source ----------------------------------------------------

def test_default_scope_is_the_ports_python():
    assert DEFAULT_SCOPE == ("pvraft_tpu_torch", "chip_smoke.py",
                             "tests/test_torch_*.py")
    scope = default_scope()
    assert scope[:2] == (os.path.join(REPO, "pvraft_tpu_torch"),
                         os.path.join(REPO, "chip_smoke.py"))
    assert os.path.join(REPO, "tests", "test_torch_graftlint.py") in scope
    assert all(os.path.basename(p).startswith("test_torch_")
               for p in scope[2:])


def test_scope_is_clean_for_both_checkers():
    diags, nfiles = lint_paths(default_scope())
    assert nfiles >= 150
    assert diags == [], "\n".join(d.format() for d in diags)
    assert both_paths(list(default_scope())) == []


# --- the CLI, in a process without torch or jax -----------------------------

def _run(argv):
    code = ("import sys\n"
            "from pvraft_tpu_torch.analysis.__main__ import main\n"
            f"rc = main({argv!r})\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)


def test_cli_default_scope_clean():
    proc = _run(["lint"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    nfiles = lint_paths(default_scope())[1]
    assert f"graftlint: 0 finding(s) in {nfiles} file(s)" in proc.stderr
    assert proc.stdout == ""


def test_cli_red_file_exits_one(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(RED["GL006"] + RED["GL007"])
    proc = _run(["lint", str(bad)])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert [line.split()[1] for line in proc.stdout.splitlines()] == list(GL)
    assert "graftlint: 2 finding(s) in 1 file(s)" in proc.stderr


def test_cli_stats_default_scope():
    proc = _run(["lint", "--stats"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graftlint --stats: 8 active pragma(s), 0 without reason" \
        in proc.stderr
