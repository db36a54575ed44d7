"""The port's contracts as rules (``ROADMAP.md``, "Port conventions").

* ``HOSTSYNC``: no host sync on the hot loop (the reference's rule in
  torch's terms).  In :data:`~.core.HOT_MODULES`, outside the sanctioned
  sync points: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``np.asarray``, ``torch.cuda.synchronize``, an event's or a stream's
  ``.synchronize()``, and ``float()`` / ``int()`` / ``bool()`` of a value
  that may be a tensor (a literal, ``len()``, a shape, ``.size()``,
  ``.numel()`` or ``.dim()`` is not).  The project pass follows a hot
  loop's calls into the port's other modules, two calls deep, and reports
  a reached sync at the hot loop's call site.
* ``TF32``: TF32 stays off — ``allow_tf32 = True``,
  ``torch.set_float32_matmul_precision`` with anything but ``"highest"``,
  and Triton's ``tl.dot`` without ``input_precision="ieee"``.
* ``GLOBALRNG``: in the port's modules every random draw takes an explicit
  ``generator=``: no ``torch.manual_seed`` / ``torch.cuda.manual_seed*``,
  no ``rand``, ``randn``, ``randint``, ``randperm``, ``normal``,
  ``bernoulli``, ``multinomial`` or in-place ``uniform_``, ``normal_``,
  ``random_``, ``exponential_`` without one.
* ``FALLBACK``: nothing falls back — no ``except`` handler calls a plain
  version (a name of a ``ref`` module, or one ending ``_plain``), and none
  swallows, without re-raising, the error of a kernel wrapper (a
  ``*_call``, a name imported from ``repro_torch.kernels``) or of
  ``kernels/build.py``.
* ``CPUDEFAULT``: no public function of the port defaults ``device`` to
  ``"cpu"`` or ``torch.device("cpu")`` (devices are explicit, default
  ``"cuda"``).
"""

from __future__ import annotations

import ast

from repro_torch.tools.torchlint.core import (HOT_MODULES, SYNC_POINTS,
                                              register, register_project)
from repro_torch.tools.torchlint.graph import dotted

# -- HOSTSYNC ---------------------------------------------------------------

_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_CASTS = ("float", "int", "bool")
_PYTHON_VALUED = ("shape", "ndim")
_PYTHON_CALLS = ("size", "numel", "dim", "element_size")

#: hops the project pass follows from a hot loop's call site
_HELPER_DEPTH = 2


def _walk_calls(tree: ast.AST):
    """Every call expression under ``tree``."""
    return (n for n in ast.walk(tree) if isinstance(n, ast.Call))


def _python_valued(node: ast.AST) -> bool:
    """True where ``node`` is a Python number, never a tensor."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Subscript):
        return _python_valued(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr in _PYTHON_VALUED
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        return name == "len" or name.split(".")[-1] in _PYTHON_CALLS
    if isinstance(node, ast.UnaryOp):
        return _python_valued(node.operand)
    if isinstance(node, ast.BinOp):
        return _python_valued(node.left) and _python_valued(node.right)
    if isinstance(node, ast.IfExp):
        return _python_valued(node.body) and _python_valued(node.orelse)
    return False


def _sync_pattern(call: ast.Call, casts: bool = True) -> str | None:
    """The host sync a call makes, or None; ``casts=False`` leaves out
    ``float()`` / ``int()`` / ``bool()``, whose argument's type a helper's
    own code says nothing of."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr == "asarray" and dotted(f.value) in ("np", "numpy"):
            return f"{dotted(f.value)}.asarray"
        if f.attr in _SYNC_METHODS and not call.args and not call.keywords:
            return f".{f.attr}()"
        if f.attr == "synchronize":
            return "torch.cuda.synchronize" \
                if dotted(f) == "torch.cuda.synchronize" \
                else ".synchronize()"
    elif casts and isinstance(f, ast.Name) and f.id in _CASTS and \
            call.args and not _python_valued(call.args[0]):
        return f"{f.id}()"
    return None


def _hot_module(src) -> str | None:
    return next((m for m in HOT_MODULES if src.module_path == m
                 or src.module_path.endswith("/" + m)), None)


def _sanctioned(src, module: str, node: ast.AST) -> bool:
    qual = src.qualname_of(node)
    return any(qual == a or qual.startswith(a + ".")
               for a in SYNC_POINTS.get(module, ()))


@register("HOSTSYNC", "host sync (.item/.tolist/.cpu/.numpy/np.asarray/"
                      "synchronize/float/int/bool of a tensor) on a hot "
                      "loop")
def _hostsync(src):
    module = _hot_module(src)
    if module is None:
        return
    for call in _walk_calls(src.tree):
        pat = _sync_pattern(call)
        if pat is None or _sanctioned(src, module, call):
            continue
        qual = src.qualname_of(call)
        where = f"in `{qual}`" if qual else "at module level"
        yield src.finding(call, "HOSTSYNC",
                          f"host sync `{pat}` {where}: a hot-loop module "
                          f"syncs only at its sanctioned points")


def _first_sync(graph, path, fn, depth, seen, hot, quiet):
    """(path, line, pattern, function) of the first unsuppressed sync
    inside ``fn`` within :data:`_HELPER_DEPTH` calls, else None (casts
    left out: :func:`_sync_pattern`)."""
    if id(fn) in seen:
        return None
    seen.add(id(fn))
    for call in _walk_calls(fn):
        pat = _sync_pattern(call, casts=False)
        if pat is not None and call.lineno not in quiet(path):
            return path, call.lineno, pat, fn.name
    if depth >= _HELPER_DEPTH:
        return None
    for call in _walk_calls(fn):
        for cpath, cfn in graph.resolve_call(path, call):
            if cpath not in hot:
                found = _first_sync(graph, cpath, cfn, depth + 1, seen, hot,
                                    quiet)
                if found is not None:
                    return found
    return None


@register_project("HOSTSYNC")
def _hostsync_project(graph, paths):
    from repro_torch.tools.torchlint.core import parse_pragmas
    hot = {p for p, s in graph.files.items() if _hot_module(s) is not None}
    quiet_lines: dict = {}

    def quiet(path):  # lines whose HOSTSYNC a reasoned pragma suppresses
        if path not in quiet_lines:
            sup, _ = parse_pragmas(graph.files[path].source, path)
            quiet_lines[path] = {n for n, r in sup.items()
                                 if "HOSTSYNC" in r}
        return quiet_lines[path]

    for path in paths:
        src = graph.files[path]
        module = _hot_module(src)
        if module is None:
            continue
        seen_sites = set()
        for call in _walk_calls(src.tree):
            if _sanctioned(src, module, call):
                continue
            for cpath, cfn in graph.resolve_call(path, call):
                if cpath in hot:
                    continue  # its own per-file run covers it
                sync = _first_sync(graph, cpath, cfn, 1, set(), hot, quiet)
                if sync is None or (call.lineno, sync[:2]) in seen_sites:
                    continue
                seen_sites.add((call.lineno, sync[:2]))
                spath, sline, pat, sfn = sync
                yield src.finding(
                    call, "HOSTSYNC",
                    f"call in `{src.qualname_of(call) or '<module>'}` "
                    f"reaches host sync `{pat}` in `{sfn}` "
                    f"({spath}:{sline}): a helper's sync stalls the hot "
                    f"loop as an inline one does")


# -- TF32 -------------------------------------------------------------------

def _kw(call: ast.Call, name: str):
    return next((k.value for k in call.keywords if k.arg == name), None)


def _splats(call: ast.Call) -> bool:
    """True where ``**kwargs`` may carry any keyword."""
    return any(k.arg is None for k in call.keywords)


def _is_const(node, value) -> bool:
    return isinstance(node, ast.Constant) and node.value == value


@register("TF32", "TF32 turned on (allow_tf32 = True, a float32 matmul "
                  "precision below highest, tl.dot without "
                  "input_precision='ieee')")
def _tf32(src):
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Attribute) and t.attr == "allow_tf32"
                   for t in targets) and _is_const(node.value, True):
                yield src.finding(node, "TF32", "`allow_tf32 = True`: "
                                  "TF32 stays off (fp32 products in fp32)")
        elif isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            if name.endswith("set_float32_matmul_precision") and not (
                    node.args and _is_const(node.args[0], "highest")):
                yield src.finding(node, "TF32", "float32 matmul precision "
                                  "other than \"highest\" turns TF32 on")
            elif name in ("tl.dot", "triton.language.dot") and not \
                    _is_const(_kw(node, "input_precision"), "ieee"):
                yield src.finding(node, "TF32", "`tl.dot` without "
                                  "`input_precision=\"ieee\"` runs fp32 "
                                  "inputs in TF32")


# -- GLOBALRNG --------------------------------------------------------------

_SEEDS = ("torch.manual_seed", "torch.cuda.manual_seed",
          "torch.cuda.manual_seed_all", "torch.random.manual_seed")
_DRAWS = ("rand", "randn", "randint", "randperm", "normal", "bernoulli",
          "multinomial")
_IN_PLACE_DRAWS = ("uniform_", "normal_", "random_", "exponential_")


@register("GLOBALRNG", "the global RNG in the port (manual_seed, a random "
                       "draw without generator=)")
def _globalrng(src):
    if not src.in_port:
        return
    for call in _walk_calls(src.tree):
        name = dotted(call.func) or ""
        if name in _SEEDS:
            yield src.finding(call, "GLOBALRNG", f"`{name}` seeds the "
                              f"process-global RNG: pass a "
                              f"torch.Generator instead")
            continue
        draw = name in (f"torch.{d}" for d in _DRAWS) or (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _IN_PLACE_DRAWS)
        if draw and _kw(call, "generator") is None and not _splats(call):
            yield src.finding(call, "GLOBALRNG", f"`{name or '.draw'}` "
                              f"without `generator=` draws from the "
                              f"global RNG")


# -- FALLBACK ---------------------------------------------------------------

def _ref_modules(tree) -> set:
    """Local names bound to a module named ``ref``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names
                    if a.name == "ref"}
        elif isinstance(node, ast.Import):
            out |= {a.asname for a in node.names
                    if a.asname and a.name.split(".")[-1] == "ref"}
    return out


def _kernel_names(tree) -> set:
    """Local names imported from ``repro_torch.kernels`` modules."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                node.module or "").startswith("repro_torch.kernels"):
            out |= {a.asname or a.name for a in node.names}
    return out


def _plain_call(call, refs) -> str | None:
    name = dotted(call.func) or ""
    parts = name.split(".")
    if (len(parts) > 1 and parts[0] in refs) or \
            parts[-1].endswith("_plain"):
        return name
    return None


def _kernel_call(call, kernels) -> str | None:
    name = dotted(call.func) or ""
    parts = name.split(".")
    if parts[0] in kernels or parts[-1].endswith("_call") or \
            parts[0] == "build":
        return name
    return None


@register("FALLBACK", "an except handler that falls back to a plain "
                      "version or swallows a kernel's or the build's error")
def _fallback(src):
    refs, kernels = _ref_modules(src.tree), _kernel_names(src.tree)
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Try):
            continue
        tried = [n for stmt in node.body for n in _walk_calls(stmt)]
        wrapped = next((k for k in (_kernel_call(c, kernels) for c in tried)
                        if k), None)
        for handler in node.handlers:
            plain = next((p for p in (_plain_call(c, refs)
                                      for c in _walk_calls(handler)) if p),
                         None)
            if plain:
                yield src.finding(handler, "FALLBACK", f"the handler calls "
                                  f"the plain version `{plain}`: a kernel "
                                  f"that fails raises, nothing falls back")
            elif wrapped and not any(isinstance(n, ast.Raise)
                                     for n in ast.walk(handler)):
                yield src.finding(handler, "FALLBACK", f"the handler "
                                  f"swallows the error of `{wrapped}` "
                                  f"without re-raising it")


# -- CPUDEFAULT -------------------------------------------------------------

def _cpu_default(node) -> bool:
    if _is_const(node, "cpu"):
        return True
    return isinstance(node, ast.Call) and \
        (dotted(node.func) or "") in ("torch.device", "device") and \
        len(node.args) == 1 and _is_const(node.args[0], "cpu")


def _defaults(fn) -> dict:
    a = fn.args
    pos = [*a.posonlyargs, *a.args]
    out = dict(zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                   a.defaults))
    out.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                if d is not None})
    return out


@register("CPUDEFAULT", "a public function of the port whose device "
                        "defaults to the CPU")
def _cpudefault(src):
    if not src.in_port:
        return
    for fn, qual in src.qualnames.items():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if any(part.startswith("_") for part in qual.split(".")):
            continue
        default = _defaults(fn).get("device")
        if default is not None and _cpu_default(default):
            yield src.finding(fn, "CPUDEFAULT", f"`{qual}` defaults "
                              f"`device` to the CPU: entry points default "
                              f"to \"cuda\" and raise without a card")
