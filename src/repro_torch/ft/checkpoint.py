"""Checkpoints of a training state on one device (counterpart of
``repro.ft.checkpoint``; sharded leaves arrive with the sharding slice).

Layout:
    <dir>/step_<N>/
        manifest.json            leaf count, shapes and dtypes
        leaf_<i>.npy             one file per tensor
    <dir>/LATEST                 atomic pointer (tmp + rename)

The state is any tree of tensors (``repro_torch.tree``: NamedTuples,
lists, dicts, ``None``).  Saving copies every leaf to the host at once (a
sync point for a CUDA state); the files are written on a worker thread so
the train loop is not held up.  ``restore_state`` rebuilds the structure of
a ``like`` tree on the device asked for, the values bit for bit.
``CheckpointManager`` keeps the last K checkpoints and resumes from the
latest.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.tree import leaves, rebuild


def save_state(state, directory, step: int, *, async_io: bool = True):
    """Save a tree of tensors as checkpoint ``step``.  Returns ``wait()``,
    which blocks until the files and ``LATEST`` are written and re-raises
    the worker's error, if any."""
    directory = pathlib.Path(directory)
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    hosts = [t.detach().cpu().numpy() for t in leaves(state)]
    manifest = {"step": step, "n_leaves": len(hosts),
                "leaves": [{"file": f"leaf_{i}.npy", "shape": list(h.shape),
                            "dtype": str(h.dtype)}
                           for i, h in enumerate(hosts)]}

    def flush():
        for info, host in zip(manifest["leaves"], hosts):
            np.save(tmp / info["file"], host)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = directory / ".LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, directory / "LATEST")

    if not async_io:
        flush()
        return lambda: None
    failure = []

    def work():
        try:
            flush()
        except Exception as e:  # handed to wait(), which re-raises it
            failure.append(e)

    worker = threading.Thread(target=work, name=f"checkpoint-{step}")
    worker.start()

    def wait():
        worker.join()
        if failure:
            raise failure[0]
    return wait


def latest_step(directory) -> int | None:
    p = pathlib.Path(directory) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore_state(like, directory, step: int | None = None, *,
                  device="cuda"):
    """Checkpoint ``step`` (default: the latest) in the structure of
    ``like``, its tensors on ``device``."""
    dev = resolve_device(device)
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    n = len(leaves(like))
    if n != manifest["n_leaves"]:
        raise ValueError(f"checkpoint {d} holds {manifest['n_leaves']} "
                         f"tensors; the state has {n}")
    return rebuild(like, [torch.from_numpy(np.load(d / info["file"])).to(dev)
                          for info in manifest["leaves"]])


class CheckpointManager:
    """Keep-last-K manager with asynchronous saves and resume."""

    def __init__(self, directory, *, keep: int = 3, every: int = 100):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self.every = every
        self._pending = None
        self._lock = threading.Lock()

    def maybe_save(self, state, step: int, *, force: bool = False) -> bool:
        """Save if ``step`` is on the period, or always with ``force``
        (eviction snapshots land wherever the straggler monitor fired)."""
        if not force and step % self.every:
            return False
        self.wait()
        inner = save_state(state, self.dir, step, async_io=True)

        def finish():  # collect old checkpoints only after the rename landed
            inner()
            self._gc()

        self._pending = finish
        return True

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                pending, self._pending = self._pending, None
                pending()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def restore_latest(self, like, *, device="cuda"):
        """``(state, step)`` of the latest checkpoint, or ``(None, 0)``."""
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        return restore_state(like, self.dir, step, device=device), step
