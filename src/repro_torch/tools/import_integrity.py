"""Static import integrity of the port (counterpart of
``repro.tools.import_integrity``), in two checks over the repo's python
files, parsed with ``ast`` (nothing is imported or run):

* **Resolution.**  Every ``import repro_torch.x.y`` / ``from
  repro_torch.x.y import z`` names a module under ``src/``; for ``from A
  import z`` a ``z`` that is a directory without ``__init__.py`` is
  flagged too (``z`` may otherwise be an attribute).  The scan covers
  :data:`SCAN_ROOTS` and the root ``chip_smoke.py``, less
  :data:`_SKIPPED_PREFIXES`.
* **The boundary.**  No file on the port's side (:data:`PORT_SIDE`:
  ``src/repro_torch/**``, ``chip_smoke.py``, ``examples/torch_*.py``,
  ``experiments/torch_*.py``) imports ``jax``, ``jaxlib`` or the JAX
  package (``repro`` / ``repro.*``).  ``tests/test_torch_*.py`` import
  both packages by design and are not on that side.

Run it as ``python scripts/check_torch_imports.py``.
"""

from __future__ import annotations

import ast
import pathlib

#: repo-relative directories scanned for python files (the reference's)
SCAN_ROOTS = ("src", "tests", "scripts", "benchmarks", "examples",
              "experiments")

#: repo-relative files scanned besides :data:`SCAN_ROOTS`
SCAN_FILES = ("chip_smoke.py",)

#: repo-relative prefixes left out: lint fixtures are synthetic
_SKIPPED_PREFIXES = ("tests/fixtures/",)

#: repo-relative globs of the port's side (``**`` spans directories)
PORT_SIDE = ("src/repro_torch/**", "chip_smoke.py", "examples/torch_*.py",
             "experiments/torch_*.py")

#: import roots the port's side may not name
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "repro")

_PACKAGE = "repro_torch"


def on_port_side(rel: str) -> bool:
    """True for a repo-relative posix path on the port's side."""
    for pattern in PORT_SIDE:
        if pattern.endswith("/**"):
            if rel.startswith(pattern[:-2]):
                return True
            continue
        head, _, tail = pattern.partition("*")
        if rel.startswith(head) and rel.endswith(tail) and \
                "/" not in rel[len(head):]:
            return True
    return False


def _scanned_files(repo_root: pathlib.Path) -> list:
    """(repo-relative posix path, file) of every python file scanned."""
    repo_root = pathlib.Path(repo_root)
    out = []
    for top in SCAN_ROOTS:
        base = repo_root / top
        if base.is_dir():
            out += sorted(base.rglob("*.py"))
    out += [repo_root / f for f in SCAN_FILES if (repo_root / f).is_file()]
    files = []
    for py in out:
        rel = py.relative_to(repo_root).as_posix()
        if not any(rel.startswith(p) for p in _SKIPPED_PREFIXES):
            files.append((rel, py))
    return files


def _imports(tree: ast.AST):
    """(line, module, from-names) of every absolute import statement."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name, []
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or "", [a.name for a in node.names]


def _in_package(module: str, package: str) -> bool:
    return module == package or module.startswith(package + ".")


def _resolves(src_root: pathlib.Path, module: str) -> bool:
    path = src_root.joinpath(*module.split("."))
    return path.with_suffix(".py").is_file() or \
        (path / "__init__.py").is_file()


def import_problems(repo_root) -> list:
    """``file:line: ...`` records of every unresolved ``repro_torch``
    import and every import across the boundary; empty when clean."""
    repo_root = pathlib.Path(repo_root)
    src_root = repo_root / "src"
    problems = []
    for rel, py in _scanned_files(repo_root):
        try:
            tree = ast.parse(py.read_text(), filename=str(py))
        except SyntaxError as e:
            problems.append(f"{rel}: syntax error prevents checking "
                            f"({e.msg}, line {e.lineno})")
            continue
        port_side = on_port_side(rel)
        for line, module, names in _imports(tree):
            where = f"{rel}:{line}"
            root = module.split(".")[0]
            if port_side and root in _FORBIDDEN_ROOTS:
                problems.append(f"{where}: the port's side imports "
                                f"'{module}' (JAX or the JAX package)")
                continue
            if not _in_package(module, _PACKAGE):
                continue
            if not _resolves(src_root, module):
                problems.append(f"{where}: import target '{module}' has no "
                                f"module under src/")
                continue
            for name in names:
                sub = src_root.joinpath(*module.split("."), name)
                if sub.is_dir() and not (sub / "__init__.py").is_file():
                    problems.append(f"{where}: '{module}.{name}' is a "
                                    f"directory without __init__.py")
    return problems


def main(repo_root=None) -> int:
    """Print the problems; 1 if there are any, else 0."""
    if repo_root is None:
        repo_root = pathlib.Path(__file__).resolve().parents[3]
    problems = import_problems(repo_root)
    if problems:
        print(f"torch import integrity: {len(problems)} problem(s):")
        for p in problems:
            print(f"  {p}")
        return 1
    print("torch import integrity: every repro_torch import resolves; the "
          "port's side imports nothing of JAX")
    return 0
