"""Per-device cost of one torch step: FLOP, int8 FLOP, an HBM-traffic
proxy, collective bytes by kind and memory (counterpart of
``repro.analysis.hlo_cost``, which reads XLA's compiled HLO; torch has
none, so this counter watches the ops a step runs).

Scope.  :class:`StepCounter` is a ``TorchDispatchMode``: it sees every op
the step dispatches below autograd — the forward, the backward, and a
checkpointed block's forward again where the backward recomputes it (the
HLO's remat blocks, counted as often as they run).  Loops are Python
loops, so each trip dispatches its ops again and is counted (the HLO's
trip counts).  It runs on real tensors and on fake ones
(``FakeTensorMode``, the dry-run), where nothing is computed.

* **Per device.**  For an op on a DTensor the counter steps aside
  (returns ``NotImplemented``, as torch's ``CommDebugMode`` does), DTensor
  runs its own dispatch, and the counter sees the ops it runs on this
  rank's shards and the collectives its redistributions issue: every
  number is one rank's.  Blocks in ``local_map`` are counted as they run
  on the local shards.  DTensor's sharding propagation runs each new op
  once more on global-shape fake tensors to learn its output's metadata;
  those runs are not counted.
* ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, SDPA) and the port's registered ones: B6 and B6-bwd
  (``kernels.flash_attn.ops``: 4 and 10 x BH x dh a kept pair) and
  ``aten._int_mm`` (2 M K N, registered here).  A custom operator counts
  by its formula; the ops inside it are not seen.  Element-wise work
  (norms, softmax outside B6, the optimizer) counts no FLOP, as in the
  HLO counter's dots-only rule.
* ``flops_int8``: the part of ``flops`` on ``aten._int_mm``.
* ``hbm_bytes``: the eager HBM proxy — for every op that is not a view
  (its output aliases an input) or a bare allocation, the bytes of its
  tensor operands and results; a kernel operator's are its own reads and
  writes.  Eager PyTorch fuses nothing, so this is what it moves, an upper
  bound on a fused program's traffic; ``hbm_by_op`` the largest entries.
* ``collectives``: the bytes of each collective's local input by kind
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``:
  the c10d functional ops DTensor issues and ``torch.distributed``'s
  all-reduce), and their ``total``.  DTensor on a CPU mesh does an
  all-to-all as an all-gather and a chunk, so the dry-run counts it so.
* ``memory``: ``argument_bytes``, the storages of the tensors handed in
  (a DTensor's local shard); ``peak_per_device_bytes``, those plus the
  most bytes the step's own storages held at once (a storage counts from
  the op that made it until it is freed); ``live_end_bytes``, what the
  step's storages still hold when it ends (its outputs, and the
  activations a forward keeps for its backward).
"""

from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.tree import leaves

#: the collectives a step issues: DTensor's (``_c10d_functional``) and
#: ``torch.distributed.all_reduce``'s (``c10d.allreduce_``, the split
#: vocab's cross entropy)
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "wait_tensor", "detach", "lift_fresh",
               "set_", "resize_", "record_stream", "_unsafe_view"}
_META = {"size", "stride", "sym_size", "sym_stride", "numel", "sym_numel",
         "dim", "storage_offset", "sym_storage_offset", "is_contiguous",
         "sym_is_contiguous", "is_strides_like_format",
         "is_non_overlapping_and_dense", "layout", "device"}
TOP_OPS = 12


if torch.ops.aten._int_mm not in flop_registry:
    @register_flop_formula(torch.ops.aten._int_mm)
    def _int_mm_flop(a_shape, b_shape, *args, out_shape=None,
                     **kwargs) -> int:
        """(M, K) int8 @ (K, N) int8: 2 M K N integer operations."""
        m, k = a_shape
        return 2 * m * k * b_shape[1]


_UNCOUNTED = [0]  # > 0: ops that compute metadata, not the step's work


@contextlib.contextmanager
def uncounted():
    """Ops run within are not counted by any :class:`StepCounter` (a
    caller's metadata arithmetic, such as DTensor's shard offsets)."""
    _UNCOUNTED[0] += 1
    try:
        yield
    finally:
        _UNCOUNTED[0] -= 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what the ops run inside ``with StepCounter(args):`` cost on
    this device (module docstring); ``args``, the tensors the step is
    handed (a tree: its train state and batch), whose storages count as
    arguments.  :meth:`result` returns the record."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.flops_int8 = 0
        self.hbm_bytes = 0
        self.by_op = defaultdict(int)
        self.flops_by_op = defaultdict(int)
        self.collectives = defaultdict(int)
        self.n_ops = 0
        self._args = {}
        for t in leaves(args):
            st = (t.to_local() if isinstance(t, DTensor) else t
                  ).untyped_storage()
            self._args[st._cdata] = st.nbytes()
        self.argument_bytes = sum(self._args.values())
        self._live = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- DTensor's metadata runs are not the step's ----------------------
    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        meta = type(prop)._propagate_tensor_meta_non_cached

        def metadata_only(op_schema):
            with uncounted():
                return meta(prop, op_schema)

        prop._propagate_tensor_meta_non_cached = metadata_only
        return super().__enter__()

    def __exit__(self, *exc):
        prop = DTensor._op_dispatcher.sharding_propagator
        del prop._propagate_tensor_meta_non_cached
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        if _UNCOUNTED[0]:
            return out
        name = func._overloadpacket.__name__
        if name in _META:
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[f"{func.namespace}.{packet.__name__}"] += n
            if packet is torch.ops.aten._int_mm:
                self.flops_int8 += n
        ins = [a for a in _flat(args, kwargs) if isinstance(a, torch.Tensor)]
        outs = [o for o in _flat(out) if isinstance(o, torch.Tensor)]
        ns = func.namespace
        if ns in _COLLECTIVE_NS and name in COLLECTIVE_KINDS:
            self.collectives[COLLECTIVE_KINDS[name]] += sum(map(_nbytes,
                                                                ins))
        elif not func.is_view and name not in _NO_TRAFFIC:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.hbm_bytes += moved
            self.by_op[f"{ns}.{name}"] += moved
        for o in outs:
            self._track(o)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._args:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def result(self) -> dict:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        top = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        return {
            "flops": self.flops, "flops_int8": self.flops_int8,
            "flops_by_op": dict(self.flops_by_op),
            "hbm_bytes": self.hbm_bytes, "hbm_by_op": dict(top),
            "collectives": coll, "ops": self.n_ops,
            "memory": {"argument_bytes": self.argument_bytes,
                       "peak_per_device_bytes": self.argument_bytes
                       + self.peak_bytes,
                       "live_end_bytes": self.live_bytes}}


def _flat(*trees):
    out = []
    for tree in trees:
        if isinstance(tree, dict):
            out += _flat(*tree.values())
        elif isinstance(tree, (list, tuple)):
            out += _flat(*tree)
        else:
            out.append(tree)
    return out


def count_step(fn, *args, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` under a :class:`StepCounter` whose arguments
    are ``args``: (its result, the counter's record)."""
    counter = StepCounter(args)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.result()
