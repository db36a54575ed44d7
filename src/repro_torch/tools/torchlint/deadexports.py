"""Dead exports of the port: public top-level names of ``src/repro_torch``
that no other file uses, and port modules nothing imports (the reference's
``repro.tools.jaxlint.deadexports`` over the port).

A use is an identifier (a name, an attribute, a ``from X import name``) in
any file of ``import_integrity.SCAN_ROOTS`` or ``chip_smoke.py`` other than
the defining one, the JAX package (``src/repro``) excepted: it imports
nothing of the port.  A re-export in an ``__init__.py`` is not a use.  So
the report under-counts (a same-named identifier elsewhere keeps a name
alive) and never over-counts.

With an allowlist the report is a gate: every dead export must be listed
with a reason, and every entry must still be dead (a name that gained a
use, or was deleted, makes its entry stale).  Entries, one a line::

    repro_torch.launch.mesh.production_shape -- why it stays
    module:repro_torch.launch.dryrun -- run with -m, imported by no one

``#`` starts a comment.
"""

from __future__ import annotations

import ast
import pathlib

from repro_torch.tools.import_integrity import SCAN_FILES, SCAN_ROOTS

_PORT_ROOT = "src/repro_torch"
#: the JAX package: scanned by nobody for uses of the port's names
_NOT_A_USER = "src/repro/"


def _public_names(repo_root: pathlib.Path):
    """(module, name, line, file) of the port's public top-level names."""
    src_root = repo_root / "src"
    for py in sorted((repo_root / _PORT_ROOT).rglob("*.py")):
        if py.name == "__init__.py":
            continue
        module = ".".join(py.relative_to(src_root).with_suffix("").parts)
        try:
            tree = ast.parse(py.read_text())
        except SyntaxError:
            continue
        for stmt in tree.body:
            names = []
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [stmt.name]
            elif isinstance(stmt, ast.Assign):
                names = [t.id for t in stmt.targets
                         if isinstance(t, ast.Name)]
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                names = [stmt.target.id]
            for name in names:
                if not name.startswith("_"):
                    yield module, name, stmt.lineno, py


def _uses(repo_root: pathlib.Path) -> tuple:
    """({file: identifiers it uses}, every module imported anywhere)."""
    files = []
    for top in SCAN_ROOTS:
        if (repo_root / top).is_dir():
            files += sorted((repo_root / top).rglob("*.py"))
    files += [repo_root / f for f in SCAN_FILES if (repo_root / f).is_file()]
    used_by, imported = {}, set()
    for py in files:
        if py.relative_to(repo_root).as_posix().startswith(_NOT_A_USER):
            continue
        try:
            tree = ast.parse(py.read_text())
        except SyntaxError:
            continue
        used = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                used.add(node.attr)
            elif isinstance(node, ast.Import):
                imported |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mod = node.module or ""
                imported.add(mod)
                for a in node.names:
                    imported.add(f"{mod}.{a.name}")
                    if py.name != "__init__.py":
                        used.add(a.asname or a.name)
        used_by[py] = used
    return used_by, imported


def port_dead_exports(repo_root) -> dict:
    """{"symbols": [(module, name, line)], "modules": [module]}."""
    repo_root = pathlib.Path(repo_root)
    used_by, imported = _uses(repo_root)
    symbols, modules = [], set()
    for module, name, line, py in _public_names(repo_root):
        modules.add(module)
        if not any(name in used for f, used in used_by.items() if f != py):
            symbols.append((module, name, line))
    dead_modules = sorted(m for m in modules if m not in imported and not
                          any(i.startswith(m + ".") for i in imported))
    return {"symbols": symbols, "modules": dead_modules}


def _keyed(repo_root) -> dict:
    """{allowlist key: where} of every dead export."""
    dead = port_dead_exports(repo_root)
    keys = {f"{m}.{n}": f"src/{m.replace('.', '/')}.py:{line}"
            for m, n, line in dead["symbols"]}
    keys.update({f"module:{m}": f"src/{m.replace('.', '/')}.py"
                 for m in dead["modules"]})
    return keys


def port_dead_exports_lines(repo_root) -> list:
    """The report (informational)."""
    keys = _keyed(repo_root)
    lines = ["torchlint dead-exports report (identifier-based: a hit "
             "means no use found in the repo)", ""]
    lines += [f"  {k}  ({where})" for k, where in sorted(keys.items())]
    return lines if keys else lines + ["no dead exports found"]


def _read_allowlist(path) -> tuple:
    """({entry: reason}, problem lines for entries without a reason)."""
    path = pathlib.Path(path)
    entries, problems = {}, []
    for i, raw in enumerate(path.read_text().splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        key, sep, reason = line.partition(" -- ")
        key, reason = key.strip(), reason.strip()
        if not sep or not reason:
            problems.append(f"{path}:{i}: entry `{key}` carries no reason: "
                            f"write `<name> -- why it stays`")
        entries[key] = reason
    return entries, problems


def port_dead_exports_gate(repo_root, allowlist) -> tuple:
    """(lines, exit code): 1 on a dead export not listed, a stale entry,
    or an entry without a reason."""
    allowlist = pathlib.Path(allowlist)
    if not allowlist.is_file():
        return [f"dead-exports gate: allowlist {allowlist} not found"], 1
    keys = _keyed(repo_root)
    entries, lines = _read_allowlist(allowlist)
    lines += [f"dead export not in the allowlist: {k} ({keys[k]}): use it, "
              f"delete it, or list it in {allowlist.name} with a reason"
              for k in sorted(set(keys) - set(entries))]
    lines += [f"stale allowlist entry: {k} is no longer a dead export: "
              f"remove it from {allowlist.name}"
              for k in sorted(set(entries) - set(keys))]
    if lines:
        return lines, 1
    return [f"dead-exports gate: clean ({len(keys)} allowlisted, 0 "
            f"stale)"], 0
