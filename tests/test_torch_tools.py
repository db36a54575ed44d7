"""The port's tools (``repro_torch.tools``): import integrity, torchlint and
its dead-exports gate, on synthetic repos and fixtures
(``tests/fixtures/torchlint/``), then on this repo, which must be clean.

* Import integrity: a missing module, an attribute import, a directory
  without ``__init__.py``; ``jax`` and ``repro.*`` imports on the port's
  side flagged, a ``repro.*`` import in a ``test_torch_*`` file allowed.
* torchlint: each rule's bad fixture flagged (a count each) and its good
  fixture not; HOSTSYNC followed two calls deep, not three; pragmas (a
  reason suppresses, none is a finding); SARIF with the reference's
  fields.
* The dead-exports gate's semantics, the reference's: a name not listed
  fails, a listed name that gained a use is stale, an entry without a
  reason fails, a re-export is not a use, the JAX package's identifiers
  are not uses.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from repro_torch.tools import import_integrity
from repro_torch.tools.torchlint import (PRAGMA, lint_files, lint_targets,
                                         main)
from repro_torch.tools.torchlint.deadexports import (port_dead_exports,
                                                     port_dead_exports_gate)
from repro_torch.tools.torchlint.sarif import sarif_log

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "torchlint"
ALLOWLIST = ROOT / "scripts" / "torch_dead_exports_allowlist.txt"

#: rule -> (the path each fixture is linted as, the bad fixture's count)
RULE_CASES = {
    "HOSTSYNC": ("src/repro_torch/serve/decode.py", 11),
    "TF32": ("scripts/tf32_case.py", 5),
    "GLOBALRNG": ("src/repro_torch/models/case.py", 9),
    "FALLBACK": ("src/repro_torch/serve/case.py", 4),
    "CPUDEFAULT": ("src/repro_torch/models/case.py", 3),
}


def _write(root: pathlib.Path, files: dict) -> pathlib.Path:
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return root


# -- import integrity --------------------------------------------------------

_BASE = {"src/repro_torch/__init__.py": "",
         "src/repro_torch/a.py": "VALUE = 1\n",
         "src/repro_torch/pkg/__init__.py": "",
         "src/repro_torch/bare/x.py": ""}

_IMPORT_CASES = [
    ("missing module", "src/repro_torch/m.py",
     "import repro_torch.nothere\n", "import target 'repro_torch.nothere'"),
    ("missing from-module", "scripts/s.py",
     "from repro_torch.pkg.gone import f\n", "'repro_torch.pkg.gone'"),
    ("attribute import", "src/repro_torch/m.py",
     "from repro_torch.a import VALUE\nfrom repro_torch import pkg\n", None),
    ("directory without __init__", "tests/test_x.py",
     "from repro_torch import bare\n", "directory without __init__.py"),
    ("jax on the port's side", "src/repro_torch/m.py",
     "import jax.numpy as jnp\n", "imports 'jax.numpy'"),
    ("jaxlib in chip_smoke", "chip_smoke.py", "import jaxlib\n",
     "imports 'jaxlib'"),
    ("the JAX package in an example", "examples/torch_demo.py",
     "from repro.core import qat\n", "imports 'repro.core'"),
    ("the JAX package in an experiment", "experiments/torch_x.py",
     "import repro\n", "imports 'repro'"),
    ("the JAX package in a torch test", "tests/test_torch_x.py",
     "from repro.core import qat\nimport jax\n", None),
    ("a JAX example", "examples/jax_demo.py", "import jax\n", None),
    ("a fixture", "tests/fixtures/x/m.py", "import repro_torch.gone\n",
     None),
]


@pytest.mark.parametrize("name,rel,text,want", _IMPORT_CASES,
                         ids=[c[0] for c in _IMPORT_CASES])
def test_import_integrity_on_a_synthetic_repo(tmp_path, name, rel, text,
                                              want):
    root = _write(tmp_path, {**_BASE, rel: text})
    problems = import_integrity.import_problems(root)
    if want is None:
        assert problems == []
    else:
        assert len(problems) == 1 and want in problems[0], problems
        assert problems[0].startswith(f"{rel}:1: ")


def test_import_integrity_of_this_repo():
    assert import_integrity.import_problems(ROOT) == []
    proc = subprocess.run([sys.executable, "scripts/check_torch_imports.py"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- torchlint rules ---------------------------------------------------------

def _fixture(rule: str, kind: str) -> str:
    return (FIXTURES / f"{rule.lower()}_{kind}.py").read_text()


def _lint(source: str, path: str) -> list:
    """The findings of one file linted alone as ``path``."""
    return lint_files({path: source})


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_rule_flags_its_bad_fixture(rule):
    path, count = RULE_CASES[rule]
    found = _lint(_fixture(rule, "bad"), path)
    assert {f.rule for f in found} == {rule}, found
    assert len(found) == count, found


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_rule_passes_its_good_fixture(rule):
    path, _ = RULE_CASES[rule]
    if rule == "HOSTSYNC":  # the sanctioned point is the runner's
        path = "src/repro_torch/ft/runner.py"
    assert _lint(_fixture(rule, "good"), path) == []


@pytest.mark.parametrize("rule,path", [
    ("HOSTSYNC", "src/repro_torch/models/lm.py"),
    ("GLOBALRNG", "scripts/timing.py"),
    ("CPUDEFAULT", "chip_smoke.py")])
def test_scoped_rules_stay_in_their_scope(rule, path):
    """HOSTSYNC lints the hot-loop modules only; GLOBALRNG and CPUDEFAULT
    the port's own modules."""
    assert _lint(_fixture(rule, "bad"), path) == []


def _chain(depth: int) -> dict:
    """A hot-loop call reaching ``.item()`` through ``depth`` helpers."""
    files = {"src/repro_torch/train/step.py":
             "from repro_torch.util.h1 import h1\n\n\n"
             "def train_step(x):\n    return h1(x)\n"}
    for i in range(1, depth + 1):
        body = "x.item()" if i == depth else f"h{i + 1}(x)"
        head = "" if i == depth else \
            f"from repro_torch.util.h{i + 1} import h{i + 1}\n\n\n"
        files[f"src/repro_torch/util/h{i}.py"] = \
            f"{head}def h{i}(x):\n    return {body}\n"
    return files


def test_hostsync_follows_helpers_two_calls_deep():
    found = lint_files(_chain(2))
    assert [(f.path, f.line, f.rule) for f in found] == [
        ("src/repro_torch/train/step.py", 5, "HOSTSYNC")]
    assert "src/repro_torch/util/h2.py:2" in found[0].message
    assert lint_files(_chain(3)) == []
    # a reasoned pragma on the helper's sync quiets the call site too
    files = _chain(2)
    files["src/repro_torch/util/h2.py"] = files[
        "src/repro_torch/util/h2.py"].replace(
        "x.item()", "x.item()  # torchlint: disable=HOSTSYNC -- once")
    assert lint_files(files) == []


def test_pragmas_need_a_reason_and_a_known_rule():
    path = "src/repro_torch/serve/decode.py"
    src = "def f(t):\n    return t.item()  # torchlint: disable=HOSTSYNC\n"
    found = _lint(src, path)
    assert sorted(f.rule for f in found) == ["HOSTSYNC", PRAGMA]
    ok = src.replace("HOSTSYNC\n", "HOSTSYNC -- read once a request\n")
    assert _lint(ok, path) == []
    bad = src.replace("HOSTSYNC\n", "HOSTSYNC,NOSUCH -- a reason\n")
    found = _lint(bad, path)
    assert [f.rule for f in found] == [PRAGMA]
    assert "NOSUCH" in found[0].message


def _keys(obj):
    """The nested key structure of a JSON value (lists by their first)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return type(obj).__name__


def test_sarif_has_the_reference_s_fields():
    from repro.tools.jaxlint.core import Finding as JaxFinding
    from repro.tools.jaxlint.sarif import sarif_report
    found = _lint(_fixture("CPUDEFAULT", "bad"),
                        RULE_CASES["CPUDEFAULT"][0])
    log = sarif_log(found)
    want = sarif_report([JaxFinding(f.path, f.line, f.rule, f.message)
                         for f in found])
    assert _keys(log) == _keys(want)
    assert log["version"] == "2.1.0" and log["$schema"] == want["$schema"]
    run = log["runs"][0]
    assert run["tool"]["driver"]["name"] == "torchlint"
    ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert ids == sorted(ids) and {"PRAGMA", "SYNTAX", "CPUDEFAULT"} <= \
        set(ids)
    assert len(run["results"]) == 3
    for res, f in zip(run["results"], found):
        assert ids[res["ruleIndex"]] == res["ruleId"] == f.rule
        loc = res["locations"][0]["physicalLocation"]
        assert loc == {"artifactLocation": {"uri": f.path},
                       "region": {"startLine": f.line}}
    json.dumps(log)


def test_the_port_lints_clean(capsys):
    assert lint_files(lint_targets(ROOT)) == []
    assert main([], repo_root=ROOT) == 0
    assert main(["--format", "sarif"], repo_root=ROOT) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["runs"][0]["results"] == []
    assert main(["--list-rules"], repo_root=ROOT) == 0
    listed = capsys.readouterr().out.split()
    assert {"HOSTSYNC", "TF32", "GLOBALRNG", "FALLBACK",
            "CPUDEFAULT"} <= set(listed)


# -- dead exports ------------------------------------------------------------

_DEAD_REPO = {
    "src/repro_torch/__init__.py": "from repro_torch.m import exported\n",
    "src/repro_torch/m.py": "def live_fn():\n    pass\n\n\n"
                            "def dead_fn():\n    pass\n\n\n"
                            "def exported():\n    pass\n\n\n"
                            "def _private():\n    pass\n\n\n"
                            "LIMIT = 3\n",
    "src/repro_torch/orphan.py": "def alone():\n    pass\n",
    "src/repro/ref.py": "def f():\n    return dead_fn\n",
    "tests/test_m.py": "from repro_torch.m import live_fn\n\n\n"
                       "def test_it():\n    live_fn()\n",
    "chip_smoke.py": "from repro_torch import m\nprint(m.LIMIT)\n",
}


def test_dead_exports_report_on_a_synthetic_repo(tmp_path):
    dead = port_dead_exports(_write(tmp_path, _DEAD_REPO))
    assert sorted(n for _, n, _ in dead["symbols"]) == [
        "alone", "dead_fn", "exported"]
    assert dead["modules"] == ["repro_torch.orphan"]


@pytest.mark.parametrize("entries,code,want", [
    (["repro_torch.m.dead_fn -- held", "repro_torch.m.exported -- API",
      "repro_torch.orphan.alone -- held", "module:repro_torch.orphan -- held"],
     0, "clean (4 allowlisted, 0 stale)"),
    (["repro_torch.m.exported -- API", "repro_torch.orphan.alone -- held",
      "module:repro_torch.orphan -- held"],
     1, "dead export not in the allowlist: repro_torch.m.dead_fn"),
    (["repro_torch.m.dead_fn -- held", "repro_torch.m.exported -- API",
      "repro_torch.orphan.alone -- held", "module:repro_torch.orphan -- held",
      "repro_torch.m.live_fn -- it was dead once"],
     1, "stale allowlist entry: repro_torch.m.live_fn"),
    (["repro_torch.m.dead_fn", "repro_torch.m.exported -- API",
      "repro_torch.orphan.alone -- held", "module:repro_torch.orphan -- held"],
     1, "carries no reason"),
], ids=["clean", "unlisted", "stale", "no reason"])
def test_dead_exports_gate_semantics(tmp_path, entries, code, want):
    root = _write(tmp_path, _DEAD_REPO)
    allow = root / "allow.txt"
    allow.write_text("# comment\n" + "\n".join(entries) + "\n")
    lines, rc = port_dead_exports_gate(root, allow)
    assert rc == code and any(want in line for line in lines), lines


def test_dead_exports_gate_is_clean_on_this_repo(capsys):
    lines, rc = port_dead_exports_gate(ROOT, ALLOWLIST)
    assert rc == 0, lines
    argv = ["--report", "dead-exports", "--allowlist", str(ALLOWLIST)]
    assert main(argv, repo_root=ROOT) == 0
    assert "dead-exports gate: clean" in capsys.readouterr().out
