"""Checkpoints of a training state, its DTensor leaves saved shard by
shard (counterpart of ``repro.ft.checkpoint``).

Layout:
    <dir>/step_<N>/
        manifest.json            leaf count, shapes, dtypes, the world
        leaf_<i>.npy             a plain tensor (written by rank 0)
        leaf_<i>/shard_<r>.npy   a DTensor's piece held by rank r
        shards_<r>.json          the global index of each of r's pieces
    <dir>/LATEST                 atomic pointer (tmp + rename)

The state is any tree of tensors (``repro_torch.tree``: NamedTuples,
lists, dicts, ``None``).  Each rank writes the pieces of the DTensor leaves
it owns with their *global index* (slices into the whole tensor; of
replicated copies only the first owner's), as the reference does, so
:func:`restore_state` builds each rank's block of every leaf from the
pieces that overlap it, on **any** mesh given by ``placements`` (a tree
of ``dist.sharding.Layout``): the elastic property, a checkpoint of 4
ranks restored on 2 or on one process.  Saving copies every leaf to the host at once (a sync point for a
CUDA state).  On one rank the files are written on a worker thread; on
several, each rank writes its own, then a barrier, rank 0's rename and a
second barrier, in the caller's thread.  ``CheckpointManager`` keeps the
last K checkpoints and resumes from the latest.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import obs
from repro_torch.kernels.common import resolve_device
from repro_torch.tree import leaves, leaves_like, rebuild


def _world() -> tuple:
    """(rank, world size) of the default process group, (0, 1) without."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def _piece(t: DTensor):
    """(global index [[start, stop], ...], this rank's piece as numpy), or
    None when another rank owns an identical replica of the piece."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:  # this rank is not on the leaf's mesh
        return None
    if any(isinstance(p, Replicate) and c for p, c in
           zip(t.placements, coord)):
        return None
    if not all(p.is_shard() or isinstance(p, Replicate)
               for p in t.placements):
        raise ValueError(f"cannot save a DTensor with pending sums "
                         f"{tuple(t.placements)}: reduce it first")
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, t.placements)
    index = [[int(o), int(o) + int(n)] for o, n in zip(offset, shape)]
    return index, t.to_local().detach().cpu().numpy()


def save_state(state, directory, step: int, *, async_io: bool = True):
    """Save a tree of tensors as checkpoint ``step``.  Returns ``wait()``,
    which blocks until the files and ``LATEST`` are written and re-raises
    the worker's error, if any."""
    directory = pathlib.Path(directory)
    rank, world = _world()
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    if rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    if world > 1:
        _barrier()

    infos, work, mine = [], [], {}
    with obs.span("repro_torch.ckpt.copy", wait=True):
        for i, t in enumerate(leaves(state)):
            info = {"shape": list(t.shape), "dtype": str(t.dtype)}
            if isinstance(t, DTensor):
                info["sharded"] = True
                piece = _piece(t)
                if piece is not None:
                    index, host = piece
                    fn = f"leaf_{i}/shard_{rank}.npy"
                    mine[str(i)] = {"file": fn, "index": index}
                    work.append((tmp / fn, host))
            else:
                info["file"] = f"leaf_{i}.npy"
                if rank == 0:
                    work.append((tmp / info["file"],
                                 t.detach().cpu().numpy()))
            infos.append(info)
    manifest = {"step": step, "n_leaves": len(infos), "world": world,
                "leaves": infos}

    def write_own():
        for path, host in work:
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, host)
        (tmp / f"shards_{rank}.json").write_text(json.dumps(mine))

    def publish():
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = directory / ".LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, directory / "LATEST")

    if world > 1:  # every rank's pieces land before rank 0 publishes
        write_own()
        _barrier()
        if rank == 0:
            publish()
        _barrier()
        return lambda: None
    if not async_io:
        write_own()
        publish()
        return lambda: None
    failure = []

    def work_fn():
        try:
            write_own()
            publish()
        except Exception as e:  # handed to wait(), which re-raises it
            failure.append(e)

    worker = threading.Thread(target=work_fn, name=f"checkpoint-{step}")
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


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.removeprefix("torch."))


def _region(shape, lay) -> tuple:
    """This rank's block of a leaf of ``shape`` placed by ``lay``: (local
    shape, global offset); the whole leaf where ``lay`` is ``None``."""
    if lay is None:
        return tuple(shape), (0,) * len(shape)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, offset = compute_local_shape_and_global_offset(
        torch.Size(shape), lay.mesh, lay.placements)
    return tuple(local), tuple(offset)


def _read_block(path: pathlib.Path, index, start, stop):
    """Elements [start, stop) of the array in ``path`` whose global index
    is ``index`` ([[begin, end], ...]), read through a memory map: only the
    block's pages are read."""
    arr = np.load(path, mmap_mode="r")
    return torch.from_numpy(np.array(arr[tuple(
        slice(a - b0, z - b0) for a, z, (b0, _) in zip(start, stop, index))]))


def _assemble(d: pathlib.Path, i: int, info: dict, pieces: list, lay):
    """This rank's block of leaf ``i`` (:func:`_region`), as a CPU tensor,
    from its file or from the pieces that overlap the block."""
    shape, offset = _region(info["shape"], lay)
    end = tuple(o + n for o, n in zip(offset, shape))
    out = torch.empty(shape, dtype=_dtype(info["dtype"]))
    if out.numel() == 0:
        return out
    if "file" in info:
        whole = [[0, n] for n in info["shape"]]
        return _read_block(d / info["file"], whole, offset, end)
    covered = 0
    for piece in pieces:
        entry = piece.get(str(i))
        if entry is None:
            continue
        lo = tuple(max(o, b) for o, (b, _) in zip(offset, entry["index"]))
        hi = tuple(min(e, z) for e, (_, z) in zip(end, entry["index"]))
        if any(a >= z for a, z in zip(lo, hi)):
            continue
        block = _read_block(d / entry["file"], entry["index"], lo, hi)
        out[tuple(slice(a - o, z - o) for a, z, o in zip(lo, hi, offset))] \
            = block
        covered += block.numel()
    if covered != out.numel():
        raise ValueError(f"checkpoint {d}: leaf {i} has {covered} of the "
                         f"{out.numel()} elements of this rank's block")
    return out


def restore_state(like, directory, step: int | None = None, *,
                  device="cuda", placements=None):
    """Checkpoint ``step`` (default: the latest) in the structure of
    ``like``, its tensors on ``device``: plain where ``placements`` (a tree
    mirroring ``like`` of ``dist.sharding.Layout`` or ``None``) has no
    layout, else DTensors placed by it on its mesh, whatever the mesh the
    checkpoint was saved from.  Each rank reads only the pieces that
    overlap its own block of each leaf."""
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
    pieces = [json.loads(p.read_text()) for p in sorted(d.glob("shards_*"))]
    layouts = ([None] * n if placements is None
               else leaves_like(like, placements))
    out = []
    for i, (info, lay) in enumerate(zip(manifest["leaves"], layouts)):
        block = _assemble(d, i, info, pieces, lay).to(dev)
        out.append(block if lay is None else DTensor.from_local(
            block, lay.mesh, lay.placements, run_check=False,
            shape=torch.Size(info["shape"]),
            stride=torch.empty(info["shape"], device="meta").stride()))
    return rebuild(like, out)


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
        with obs.span("repro_torch.ckpt.save"):
            self.wait()
            inner = save_state(state, self.dir, step, async_io=True)
        obs.count("ckpt_saves")

        def finish():  # collect old checkpoints only after the rename landed
            inner()
            self._gc()

        self._pending = finish
        return True

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                pending, self._pending = self._pending, None
                with obs.span("repro_torch.ckpt.wait", wait=True):
                    pending()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def restore_latest(self, like, *, device="cuda", placements=None):
        """``(state, step)`` of the latest checkpoint, or ``(None, 0)``."""
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        with obs.span("repro_torch.ckpt.restore"):
            return restore_state(like, self.dir, step, device=device,
                                 placements=placements), step
