"""torchlint core: findings, the rule registry, pragmas and the runner.

A rule is a generator ``check(src) -> Iterable[Finding]`` over one parsed
file (a :class:`SourceFile`), registered under an UPPERCASE name with
:func:`register`.  A rule may add a project pass (:func:`register_project`),
``project_check(project, paths)``, run once a lint over every file with
the port's intra-package imports resolved (:class:`~.graph.PortGraph`);
it reports into the files in ``paths`` only (the caller's file, never the
callee's).

The runner parses each file once, runs every rule and every project pass,
then applies the pragmas of each file's lines::

    torch.cuda.synchronize(dev)  # torchlint: disable=HOSTSYNC -- why

A pragma suppresses the named rules on its own line only when it carries
a ``-- reason``; a pragma without one, or naming an unknown rule, is inert
and itself a ``PRAGMA`` finding, which nothing suppresses.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import pathlib
import re
from typing import Callable

from repro_torch.tools.import_integrity import on_port_side

#: the port's hot-loop modules (the reference's four): HOSTSYNC applies
#: only there
HOT_MODULES = (
    "repro_torch/ft/runner.py",
    "repro_torch/serve/executor.py",
    "repro_torch/serve/decode.py",
    "repro_torch/train/step.py",
)

#: sanctioned sync points of a hot-loop module, by function qualname
#: prefix: the chunked loop's one host copy a chunk, the executor's one
#: wait a wave and its tile-by-tile baseline (the reference's)
SYNC_POINTS = {
    "repro_torch/ft/runner.py": ("_chunked_loop.retire",),
    "repro_torch/serve/executor.py": ("InflightWave.wait",
                                      "InflightWave.wait_tiles"),
}

#: the package prefix of the rules scoped to the port's own modules
PORT_PREFIX = "repro_torch/"

#: the name of pragma findings (not a rule: nothing suppresses them)
PRAGMA = "PRAGMA"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def github(self) -> str:
        """A GitHub workflow annotation."""
        return (f"::error file={self.path},line={self.line},"
                f"title=torchlint {self.rule}::{self.message}")


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    name: str
    summary: str
    check: Callable
    project_check: Callable | None = None


#: name -> RuleSpec, filled as :mod:`.rules` is imported
REGISTRY: dict = {}


def register(name: str, summary: str):
    """Decorator adding ``check(src)`` to the registry under ``name``."""
    if name != name.upper() or name == PRAGMA:
        raise ValueError(f"rule names are UPPERCASE and not {PRAGMA}: "
                         f"{name!r}")

    def deco(fn):
        if name in REGISTRY:
            raise ValueError(f"duplicate rule {name}")
        REGISTRY[name] = RuleSpec(name, summary, fn)
        return fn
    return deco


def register_project(name: str):
    """Decorator attaching a project pass to the registered rule ``name``."""
    def deco(fn):
        if name not in REGISTRY:
            raise ValueError(f"project pass for unregistered rule {name}")
        REGISTRY[name] = dataclasses.replace(REGISTRY[name],
                                             project_check=fn)
        return fn
    return deco


def rule_summaries() -> dict:
    """{rule name: one-line summary} of every registered rule."""
    _load_rules()
    return {r.name: r.summary for r in REGISTRY.values()}


def _load_rules() -> None:
    from repro_torch.tools.torchlint import rules  # noqa: F401 (registers)


class SourceFile:
    """One parsed file and the maps the rules share."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        #: the path rules match against (``src/`` stripped)
        self.module_path = path[4:] if path.startswith("src/") else path
        self.source = source
        self.tree = tree
        self._parents = None
        self._qualnames = None

    @property
    def parents(self) -> dict:
        if self._parents is None:
            self._parents = {child: node for node in ast.walk(self.tree)
                             for child in ast.iter_child_nodes(node)}
        return self._parents

    @property
    def qualnames(self) -> dict:
        """FunctionDef / ClassDef -> ``Outer.inner`` qualname."""
        if self._qualnames is None:
            out = {}

            def visit(node, prefix):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        qual = f"{prefix}.{child.name}" if prefix \
                            else child.name
                        out[child] = qual
                        visit(child, qual)
                    else:
                        visit(child, prefix)
            visit(self.tree, "")
            self._qualnames = out
        return self._qualnames

    @property
    def in_port(self) -> bool:
        """True for the port's own modules (``src/repro_torch/``)."""
        return self.module_path.startswith(PORT_PREFIX)

    def qualname_of(self, node: ast.AST) -> str:
        """The qualname of the function around ``node`` ('' at module
        level)."""
        cur = node
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cur = self.parents.get(cur)
        return self.qualnames.get(cur, "") if cur is not None else ""

    def finding(self, node, rule: str, message: str) -> Finding:
        line = node if isinstance(node, int) else node.lineno
        return Finding(self.path, line, rule, message)


_PRAGMA_RE = re.compile(
    r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s*--\s*([^#]*\S))?\s*"
    r"(?=#|$)")


def parse_pragmas(source: str, path: str) -> tuple:
    """({line: suppressed rule names}, PRAGMA findings)."""
    _load_rules()
    suppress: dict = {}
    problems = []
    for i, text in enumerate(source.splitlines(), start=1):
        for m in _PRAGMA_RE.finditer(text):
            names = {n.strip().upper() for n in m.group(1).split(",")
                     if n.strip()}
            unknown = sorted(n for n in names if n not in REGISTRY)
            if unknown:
                problems.append(Finding(
                    path, i, PRAGMA, f"pragma names unknown rule(s) "
                    f"{', '.join(unknown)} (known: "
                    f"{', '.join(sorted(REGISTRY))})"))
            if not m.group(2):
                problems.append(Finding(
                    path, i, PRAGMA, "pragma carries no reason: write `# "
                    "torchlint: disable=RULE -- why this line is exempt`"))
                continue
            suppress.setdefault(i, set()).update(names - set(unknown))
    return suppress, problems


def lint_files(files: dict) -> list:
    """Unsuppressed findings of ``{repo-relative path: source}``: every
    rule per file, every project pass over all of them, then the
    pragmas."""
    from repro_torch.tools.torchlint.graph import PortGraph
    _load_rules()
    parsed = {}
    raw = []
    for path, source in files.items():
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            raw.append(Finding(path, e.lineno or 1, "SYNTAX",
                               f"syntax error prevents linting ({e.msg})"))
            continue
        parsed[path] = SourceFile(path, source, tree)
    for src in parsed.values():
        for rule in REGISTRY.values():
            raw.extend(rule.check(src))
    graph = PortGraph(parsed)
    for rule in REGISTRY.values():
        if rule.project_check is not None:
            raw.extend(f for f in rule.project_check(graph, list(parsed))
                       if f.path in parsed)
    by_path: dict = {}
    for f in raw:
        by_path.setdefault(f.path, set()).add(f)
    out = []
    for path, source in files.items():
        suppress, problems = parse_pragmas(source, path)
        out += [f for f in by_path.get(path, ())
                if f.rule not in suppress.get(f.line, set())] + problems
    return sorted(out)


def _imports_port(source: str) -> bool:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return True  # linted, so that the syntax error is reported
    for node in ast.walk(tree):
        mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
            else [node.module or ""] if isinstance(node, ast.ImportFrom) \
            else []
        if any(m.split(".")[0] == "repro_torch" for m in mods):
            return True
    return False


def lint_targets(repo_root) -> dict:
    """``{repo-relative path: source}`` a repo scan lints: the port's side
    (``import_integrity.PORT_SIDE``) and the scripts that import the
    port."""
    repo_root = pathlib.Path(repo_root)
    found = sorted((repo_root / "src" / "repro_torch").rglob("*.py"))
    for top in ("examples", "experiments", "scripts"):
        found += sorted((repo_root / top).glob("*.py"))
    found += [repo_root / "chip_smoke.py"]
    files = {}
    for py in found:
        if not py.is_file():
            continue
        rel = py.relative_to(repo_root).as_posix()
        source = py.read_text()
        if on_port_side(rel) or (rel.startswith("scripts/")
                                 and _imports_port(source)):
            files[rel] = source
    return files


def main(argv=None, repo_root=None) -> int:
    if repo_root is None:
        repo_root = pathlib.Path(__file__).resolve().parents[4]
    ap = argparse.ArgumentParser(
        prog="torchlint", description="static checks of the PyTorch port's "
        "contracts (host syncs, TF32, global RNG, fallbacks, CPU defaults)")
    ap.add_argument("--report", choices=("dead-exports",),
                    help="print a report instead of linting (with "
                    "--allowlist: the dead-exports gate)")
    ap.add_argument("--allowlist", metavar="FILE",
                    help="the dead-exports gate: exit 1 on dead exports "
                    "not in FILE and on entries of FILE no longer dead")
    ap.add_argument("--format", choices=("text", "github", "sarif"),
                    default="text", dest="fmt")
    ap.add_argument("--github", action="store_true",
                    help="the same as --format github")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for name, summary in sorted(rule_summaries().items()):
            print(f"{name:11s} {summary}")
        return 0
    if args.report == "dead-exports":
        from repro_torch.tools.torchlint.deadexports import (
            port_dead_exports_gate, port_dead_exports_lines)
        if args.allowlist:
            lines, code = port_dead_exports_gate(repo_root, args.allowlist)
        else:
            lines, code = port_dead_exports_lines(repo_root), 0
        for line in lines:
            print(line)
        return code
    files = lint_targets(repo_root)
    findings = lint_files(files)
    fmt = "github" if args.github else args.fmt
    if fmt == "sarif":
        import json

        from repro_torch.tools.torchlint.sarif import sarif_log
        print(json.dumps(sarif_log(findings), indent=2))
        return 1 if findings else 0
    if findings:
        print(f"torchlint: {len(findings)} unsuppressed finding(s):")
        for f in findings:
            print(f.github() if fmt == "github" else f"  {f.key}")
        return 1
    print(f"torchlint: clean ({len(files)} files, {len(REGISTRY)} rules)")
    return 0

