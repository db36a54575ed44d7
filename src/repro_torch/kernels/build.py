"""Build and load the port's CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled on first use by its
own ``nvcc`` process into a shared library with a plain C interface, and
loaded with ``ctypes``.  Libraries go into ``build/repro_torch_kernels/``
at the checkout root (listed in ``.gitignore``), in a directory keyed by a
hash of the flags, the source and every header it includes from
``csrc/`` (``#include "..."``, followed through headers), so an edited
source or header rebuilds and an unchanged one is reused.

``--use_fast_math`` is never passed: it makes ``/`` approximate and
flushes denormals, which breaks bit-exactness against the integer oracle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

#: kernel name -> source file under ``csrc/``
SOURCES = {"qat_dense": "qat_dense.cu", "fused_forward": "fused_forward.cu",
           "fused_train": "fused_train.cu", "flash_attn": "flash_attn.cu",
           "flash_attn_sm90": "flash_attn_sm90.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu"}

#: bytes of shared memory a block may use on sm_90
SMEM_MAX = 232_448

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def cuda_tool(name: str = "nvcc") -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on
    PATH, else under /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin") / name
    if default.is_file():
        return str(default)
    raise RuntimeError(f"{name} not found (PATH or /usr/local/cuda/bin): the "
                       f"CUDA kernels cannot be built or read")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(source: str) -> list:
    """The headers under ``csrc/`` that ``source`` includes with
    ``#include "..."``, directly or through another such header, sorted."""
    found, todo = set(), [CSRC / source]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_bytes()):
            path = CSRC / inc.decode()
            if path.is_file() and path not in found:
                found.add(path)
                todo.append(path)
    return sorted(found)


def library_path(name: str) -> pathlib.Path:
    """Where kernel ``name``'s library lives: keyed by the flags, its
    source and the headers it includes, so an edit to any of them builds
    anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (CSRC / SOURCES[name], *included_headers(SOURCES[name])):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all), one ``nvcc`` each, started
    together.  Returns ``{name: ptxas report}``; raises on any failure.

    Up-to-date libraries are not rebuilt (their report is read back from
    the log kept beside them).
    """
    names = tuple(SOURCES) if names is None else tuple(names)
    unknown = set(names) - set(SOURCES)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; "
                         f"known: {sorted(SOURCES)}")
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def check_device(device: torch.device) -> None:
    """Raise unless ``device`` is a Hopper (sm_90) card: the libraries hold
    ``sm_90a`` code only."""
    _check_index(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _check_index(index: int) -> None:
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{cap}; the port's kernels are built for sm_90a (H100/H200)")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
