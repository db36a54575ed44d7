"""Execution layer of the recon serving stack: the double-buffered
asynchronous wave executor (counterpart of ``repro.serve.executor``).

:meth:`WaveExecutor.dispatch` stages one wave's voxel pool on the device
(one concatenate that also pads the ragged tail up to its bucket), enqueues
every bucket tile's forward and its copy into pinned host memory on the
current CUDA stream, records one event per tile, and returns an
:class:`InflightWave` **without blocking** — so the engine can stage and
dispatch wave N+1 while the card still computes wave N.

:meth:`InflightWave.wait` synchronizes once, on the event recorded after
the wave's last tile, and reads the host copies; :meth:`InflightWave
.wait_tiles` is the synchronous baseline that synchronizes tile by tile.

Tiles come from :func:`plan_tiles` over a fixed bucket set, so every
forward sees one of ``len(buckets)`` shapes.  Backends: ``float``
(``mrf_net.forward`` in fp32, TF32 off) and ``int8`` with ``int8_impl``
``fused`` (the whole-network CUDA kernel, denormalization fused into its
epilogue), ``layered`` (the per-layer CUDA kernel chain) or ``lax`` (plain
PyTorch).  All int8 implementations serve bit-identical maps.  On the CPU
the kernels' plain versions run.  Under ambient mesh rules
(``dist.sharding.use_rules``) each tile's voxel rows are placed on
``"batch"`` and every implementation runs per rank on its own rows
(:func:`on_mesh`); no kernel sees a DTensor.

Graceful degradation
--------------------
The executor carries the reference's **circuit breaker** with the port's
own target.  When the fused forward raises (at tile enqueue here, or at the
wave's event wait — the engine reports those through
:meth:`WaveExecutor.note_kernel_failure`), ``breaker_threshold`` failures
trip it and the executor rebuilds its forward on the ``layered`` chain:
the whole-network kernel B4 (``csrc/fused_forward.cu``) gives way to the
per-layer kernel B5 (``csrc/qat_dense.cu``).  The reference trips to its
plain ``lax`` forward; the port's ``lax`` is the plain PyTorch version,
and a kernel never falls back to its plain version here, so the port
trips to the other hand-written kernel that is bit-exact against the same
oracle and shares no code with B4.  Degraded waves serve identical maps;
``degraded`` / ``degraded_reason`` / ``n_degraded_waves`` record the trip.
The float backend and an explicit ``layered`` or ``lax`` have nothing to
trip to: their failures raise into the engine's retry path.  Fault
schedules (``serve.faults``) fire a ``kernel_fail`` here deterministically.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import mrf_net
from repro_torch.dist.sharding import (axes_to_placements, current_rules,
                                       mesh_size)
from repro_torch.data.pipeline import (T1_RANGE_MS, T2_RANGE_MS,
                                       denormalize_targets)
from repro_torch.kernels.common import (disable_tf32, resolve_device,
                                        resolve_int8_impl)
from repro_torch.kernels.qat_dense.ops import (int_forward_fused,
                                               int_forward_lax,
                                               int_forward_layered,
                                               prepad_int_layers)

BACKENDS = ("float", "int8")

# Four shapes cover any request mix: full tiles at 1024, the tail padded to
# the smallest fit.
DEFAULT_BUCKETS = (128, 256, 512, 1024)


def plan_tiles(n: int, buckets: Sequence[int]) -> list:
    """Tile ``n`` voxels into (offset, count, bucket) micro-batches.

    Full tiles use the largest bucket; the remainder uses the smallest
    bucket that fits (padded by the executor).  Covers [0, n) exactly.
    """
    buckets = sorted(int(b) for b in buckets)  # torchlint: disable=HOSTSYNC -- bucket sizes are Python ints from the configuration
    if not buckets or buckets[0] <= 0:
        raise ValueError(f"buckets must be positive: {buckets}")
    bmax = buckets[-1]
    tiles = []
    off = 0
    while n - off >= bmax:
        tiles.append((off, bmax, bmax))
        off += bmax
    rem = n - off
    if rem:
        fit = next(b for b in buckets if b >= rem)
        tiles.append((off, rem, fit))
    return tiles


@dataclasses.dataclass(eq=False)
class InflightWave:
    """Handle to one dispatched wave.

    ``host[i]`` is the (bucket, 2) host tensor that receives tile ``i``'s
    denormalized (T1 ms, T2 ms) predictions once ``events[i]`` has
    completed (on the CPU the events are ``None`` and the values final);
    only the first ``count`` rows of each are real voxels.
    """

    tiles: list          # (offset, count, bucket) in pool coordinates
    host: list           # per-tile host tensors (pinned on CUDA)
    events: list         # per-tile torch.cuda.Event, or None on the CPU
    total: int           # real (unpadded) voxel count of the wave

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    def wait(self) -> np.ndarray:
        """Block once for the whole wave; return the (total, 2) predictions.

        One synchronization — on the event recorded after the last tile —
        whatever the tile count: the pipelined path's contract.
        """
        if self.events and self.events[-1] is not None:
            self.events[-1].synchronize()
        pred = np.empty((self.total, 2), np.float32)
        for (off, count, _), out in zip(self.tiles, self.host):
            pred[off:off + count] = out.numpy()[:count]
        return pred

    def wait_tiles(self):
        """Per-tile sync generator: yields (offset, count, block) as each
        tile lands.  The synchronous baseline — one sync per tile."""
        for (off, count, _), out, ev in zip(self.tiles, self.host,
                                            self.events):
            if ev is not None:
                ev.synchronize()
            yield off, count, out.numpy()[:count]


def on_mesh(fwd):
    """``fwd`` over a tile's voxel rows, run per rank under the ambient
    mesh rules (the reference's ``shard(x, "batch", None)``): the tile is
    placed on ``"batch"`` (each rank keeps its own rows), B4, B5 or the
    float net runs in ``local_map`` on the rank's rows, and the maps are
    gathered whole on every rank.  Without a mesh, ``fwd`` itself."""
    def placed(x):
        rules = current_rules()
        if rules is None or rules.mesh is None:
            return fwd(x)
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import local_map
        pl = list(axes_to_placements(("batch", None), rules))
        rows = local_map(fwd, out_placements=pl, in_placements=(pl,),
                         device_mesh=rules.mesh)
        out = rows(distribute_tensor(x, rules.mesh, pl, src_data_rank=None))
        return out.full_tensor() if mesh_size(rules.mesh) > 1 \
            else out.to_local()
    return placed


class WaveExecutor:
    """Dispatches voxel waves through the per-bucket forward on ``device``.

    ``backend="float"`` needs ``params`` (the mrf_net list);
    ``backend="int8"`` needs ``int_layers`` (a ``qat.export_int8`` /
    ``qat.load_int8_artifact`` list), which are moved to ``device`` and
    padded once here.  ``int8_impl`` picks the full-integer implementation
    (``None`` = ``"fused"``).  ``device`` defaults to ``"cuda"`` and raises
    without a card.  ``injector`` (a ``serve.faults.FaultInjector``) fires
    ``kernel_fail`` at tile enqueue; ``breaker_threshold`` forward failures
    trip the fused -> layered circuit breaker (see the module doc).
    ``tiles_by_impl`` counts the tiles each implementation served.
    """

    def __init__(self, *, backend: str = "float", params=None, int_layers=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 int8_impl: str | None = None, injector=None,
                 breaker_threshold: int = 1, device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if backend == "float" and params is None:
            raise ValueError("float backend needs params")
        if backend == "int8" and int_layers is None:
            raise ValueError("int8 backend needs int_layers "
                             "(qat.export_int8 or qat.load_int8_artifact)")
        self.device = resolve_device(device)
        disable_tf32()
        self.backend = backend
        self.params = None if params is None else [
            {k: v.to(self.device) for k, v in layer.items()}
            for layer in params]
        self.int_layers = None if int_layers is None else [
            dataclasses.replace(layer, **{
                f: (None if getattr(layer, f) is None
                    else getattr(layer, f).to(self.device))
                for f in ("w_q", "b_q", "s_in", "s_w", "s_out")})
            for layer in int_layers]
        self.buckets = tuple(sorted(int(b) for b in buckets))  # torchlint: disable=HOSTSYNC -- bucket sizes are Python ints from the configuration
        self.int8_impl = (resolve_int8_impl(int8_impl)
                          if backend == "int8" else None)
        # weights are static: pad K/N and pack the fused image exactly once
        self._prepadded = (prepad_int_layers(self.int_layers)  # torchlint: disable=HOSTSYNC -- the weights are padded once, at construction
                           if backend == "int8" else None)
        self.in_dim = int(self.params[0]["w"].shape[0] if backend == "float"
                          else self.int_layers[0].w_q.shape[0])
        self._fwd = self._make_forward()
        self.bucket_shapes_run: set = set()
        # voxel counts of every request dispatched, in order: the recorded
        # size distribution that bucket autotuning reads
        self.request_sizes: list = []
        self.tiles_by_impl: collections.Counter = collections.Counter()
        # fault injection + the fused -> layered circuit breaker
        if breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, "
                             f"got {breaker_threshold}")
        self._injector = injector
        self.breaker_threshold = breaker_threshold
        self.degraded = False
        self.degraded_reason: str | None = None
        self.n_kernel_failures = 0
        self.n_degraded_waves = 0
        self._wave_seq = 0  # wave numbering for direct callers

    def _make_forward(self):
        # denormalization runs on the device inside the forward (or the
        # fused kernel's epilogue), so tile outputs are already (T1, T2) in
        # ms and each tile crosses to the host exactly once
        if self.backend == "float":
            params = self.params

            def fwd(x):
                return denormalize_targets(mrf_net.forward(params, x))
        elif self.int8_impl == "fused":
            pre = self._prepadded
            # the (T1_max, T2_max) row denormalize_targets applies,
            # multiplied after the head scale inside the kernel — bit-exact
            # vs composing denormalize_targets outside (tested)
            dscale = torch.tensor([T1_RANGE_MS[1], T2_RANGE_MS[1]],
                                  dtype=torch.float32, device=self.device)

            def fwd(x):
                return int_forward_fused(pre, x, denorm_scale=dscale)  # torchlint: disable=HOSTSYNC -- pre is prepadded in __init__: the helper's prepad branch is not reached
        elif self.int8_impl == "lax":
            ints = self.int_layers
            for layer in ints:
                _ = layer.b_absmax  # read once here, not per tile

            def fwd(x):
                return denormalize_targets(int_forward_lax(ints, x))
        else:  # "layered": per-layer kernel chain on the prepadded net
            pre = self._prepadded

            def fwd(x):
                return denormalize_targets(int_forward_layered(pre, x))  # torchlint: disable=HOSTSYNC -- pre is prepadded in __init__: the helper's prepad branch is not reached
        return on_mesh(fwd)

    def cache_size(self) -> int:
        """Distinct bucket shapes run so far; bounded by ``len(buckets)``."""
        return len(self.bucket_shapes_run)

    # -- staging + dispatch ------------------------------------------------

    def stage(self, features_list: Sequence) -> tuple:
        """Host->device staging of one wave: returns (pool, tiles, total).

        One concatenate builds the whole pool on the device: the per-request
        feature blocks *and* the zero rows that pad the ragged tail to its
        bucket, so every tile is then a contiguous static-shape slice.
        """
        counts = [int(f.shape[0]) for f in features_list]
        self.request_sizes.extend(counts)
        total = sum(counts)
        tiles = plan_tiles(total, self.buckets)
        padded_total = (tiles[-1][0] + tiles[-1][2]) if tiles else 0
        parts = [torch.as_tensor(f, dtype=torch.float32, device=self.device)
                 for f in features_list]
        if padded_total > total:
            parts.append(torch.zeros((padded_total - total, self.in_dim),
                                     dtype=torch.float32, device=self.device))
        if parts:
            pool = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        else:
            pool = torch.zeros((0, self.in_dim), dtype=torch.float32,
                               device=self.device)
        return pool.contiguous(), tiles, total

    # -- degradation (the circuit breaker) ---------------------------------

    def can_degrade(self) -> bool:
        """True while a fallback exists for this executor's forward: the
        fused int8 kernel B4 degrades to the layered chain B5."""
        return (self.backend == "int8" and self.int8_impl == "fused"
                and not self.degraded)

    def note_kernel_failure(self) -> bool:
        """Record one forward failure; trips the breaker onto the layered
        chain once ``breaker_threshold`` failures accumulate and a fallback
        exists.  Returns True iff the executor is (now) degraded.

        Called internally when a tile enqueue raises, and by the engine
        when a wave's wait raises (a kernel's failure can surface at the
        launch or at the event that follows the wave).
        """
        self.n_kernel_failures += 1
        if (self.can_degrade()
                and self.n_kernel_failures >= self.breaker_threshold):
            self.degraded = True
            self.degraded_reason = (
                f"int8 fused kernel B4 (fused_forward.cu) failed "
                f"{self.n_kernel_failures}x; circuit breaker tripped to the "
                f"layered kernel chain B5 (qat_dense.cu), bit-exact against "
                f"qat.int_forward like B4")
            self.int8_impl = "layered"
            self._fwd = self._make_forward()
        return self.degraded

    def dispatch(self, features_list: Sequence, *,
                 wave_index: int | None = None) -> InflightWave:
        """Stage one wave and enqueue all its tiles; never blocks.

        Each tile's output is copied into pinned host memory on the same
        stream and followed by an event, so ``wait()`` needs one
        synchronization and ``wait_tiles()`` one per tile.  ``wave_index``
        labels the wave for fault schedules (the engine passes its dispatch
        sequence number; direct callers get an internal counter).  A
        forward that raises at enqueue feeds the circuit breaker: if it
        trips, the failing tile is enqueued again on the layered chain and
        the wave still completes.
        """
        pool, tiles, total = self.stage(features_list)
        widx = self._wave_seq if wave_index is None else wave_index
        self._wave_seq = widx + 1
        on_cuda = self.device.type == "cuda"
        host, events = [], []
        for off, _count, bucket in tiles:
            # only the trailing tile is padded, so pool offsets == voxel
            # offsets and every slice is a contiguous (bucket, in_dim) view
            tile = pool[off:off + bucket]
            with torch.no_grad():
                try:
                    if self._injector is not None:
                        self._injector.fire_kernel(widx)
                    out = self._fwd(tile)
                except Exception:
                    if not self.note_kernel_failure():
                        raise  # nothing to trip to: the engine retries
                    out = self._fwd(tile)  # degraded: B5, bit-exact maps
            self.tiles_by_impl[self.int8_impl or self.backend] += 1
            if on_cuda:
                buf = torch.empty(out.shape, dtype=torch.float32,
                                  pin_memory=True)
                buf.copy_(out, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
            else:
                buf, ev = out, None
            host.append(buf)
            events.append(ev)
            self.bucket_shapes_run.add(bucket)
        if self.degraded:
            self.n_degraded_waves += 1
        return InflightWave(tiles=tiles, host=host, events=events, total=total)
