"""The project pass's view of the port: its modules, the intra-package
imports of every linted file, and call resolution.

* modules: ``src/repro_torch/a/b.py`` <-> ``repro_torch.a.b`` (files
  outside ``src/`` import the port but nothing imports them);
* imports: per file, local name -> (module, symbol or None for a module
  binding), for every absolute ``repro_torch`` import;
* :meth:`PortGraph.resolve_call`: the top-level functions (and a class's
  methods through ``self``) a call may reach, by name, through those
  imports.  What does not resolve contributes nothing.
"""

from __future__ import annotations

import ast


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` of a chain of names and attributes, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _module_name(path: str) -> str | None:
    """The dotted module of a file under ``src/``, else None."""
    if not path.startswith("src/") or not path.endswith(".py"):
        return None
    mod = path[len("src/"):-len(".py")]
    if mod.endswith("/__init__"):
        mod = mod[:-len("/__init__")]
    return mod.replace("/", ".")


class PortGraph:
    """Parsed files (``{path: SourceFile}``) and their cross-module maps."""

    def __init__(self, files: dict):
        self.files = files
        self.module_path = {}
        for path in files:
            mod = _module_name(path)
            if mod is not None:
                self.module_path[mod] = path
        self.imports = {p: self._imports(f.tree) for p, f in files.items()}
        self.defs = {p: self._defs(f.tree) for p, f in files.items()}

    def _imports(self, tree) -> dict:
        out = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in self.module_path:
                        out[a.asname or a.name] = (a.name, None)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mod = node.module or ""
                for a in node.names:
                    sub = f"{mod}.{a.name}"
                    if sub in self.module_path:
                        out[a.asname or a.name] = (sub, None)
                    elif mod in self.module_path:
                        out[a.asname or a.name] = (mod, a.name)
        return out

    @staticmethod
    def _defs(tree) -> dict:
        """{"fns": name -> FunctionDef, "classes": name -> {method ->
        FunctionDef}} of the module's top level."""
        fns, classes = {}, {}
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns[stmt.name] = stmt
            elif isinstance(stmt, ast.ClassDef):
                classes[stmt.name] = {
                    s.name: s for s in stmt.body
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        return {"fns": fns, "classes": classes}

    def _symbol(self, module: str, symbol: str) -> list:
        parts = symbol.split(".")
        while len(parts) > 1 and f"{module}.{parts[0]}" in self.module_path:
            module, parts = f"{module}.{parts[0]}", parts[1:]
        path = self.module_path.get(module)
        if path is None or len(parts) != 1:
            return []
        fn = self.defs[path]["fns"].get(parts[0])
        return [(path, fn)] if fn is not None else []

    def resolve_call(self, path: str, call: ast.Call) -> list:
        """Candidate ``(path, FunctionDef)`` of a call expression."""
        name = dotted(call.func)
        if name is None:
            return []
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2:
            return self._method(path, call, parts[1])
        if len(parts) == 1:
            fn = self.defs.get(path, {}).get("fns", {}).get(name)
            if fn is not None:
                return [(path, fn)]
        imp = self.imports.get(path, {}).get(parts[0])
        if imp is None:
            return []
        module, symbol = imp
        if symbol is None:
            return self._symbol(module, ".".join(parts[1:])) \
                if len(parts) > 1 else []
        return self._symbol(module, symbol) if len(parts) == 1 else []

    def _method(self, path: str, node: ast.AST, meth: str) -> list:
        src = self.files.get(path)
        cur = src.parents.get(node) if src is not None else None
        while cur is not None and not isinstance(cur, ast.ClassDef):
            cur = src.parents.get(cur)
        if cur is None:
            return []
        fn = self.defs[path]["classes"].get(cur.name, {}).get(meth)
        return [(path, fn)] if fn is not None else []
