"""An MRF training cell: set-up, the measured window and the check.

The system under test is ``repro_torch.train.engine.train`` with the
``fused`` backend: the chunked runner (``ft.runner``) stages each chunk's
batches on the device (``data.pipeline.batch_at``) and trains them in one
launch of the training kernel, with checkpoints (``ft.checkpoint``) every
``ckpt_every`` steps.  One training job runs through its calls, each
resuming from the checkpoint the calls before left in the job's directory
(under the run's ``TMPDIR``):

1. set-up, the compared steps (:func:`segments`), one call a segment, each
   ending on a checkpoint: step 1; one whole launch of ``chunk_steps``
   (the window's launch); then single steps, ``single_steps`` in all with
   step 1 (``limits/<cell>.json``);
2. warm-up: resumed from there, one chunk and then three at the window's
   cadence, the difference timing two chunks to size the window;
3. the window: resumed from the same checkpoint, as many steps as fill
   ``--seconds`` at the warm-up's rate, in whole chunks.

After the window, once the peak memory has been read, the compared
numbers (``yardstick.compare``) hold the set-up calls (each step's loss,
the state after each call, the step counters the runner hands back)
against the reference (``yardstick.reference``), which rebuilds the
initial weights and the batches from the seed with its frozen copy
(``yardstick.mrf_data``) and trains them itself.  It follows the program
segment by segment: segment 1 from the initial weights it draws itself,
each later one from the parameters the program handed back after the
segment before.  In float32 a ReLU decision that round-off flips early in
a step moves the rest of that step's thousands of sequential updates, so
one step from a common start is as far as a float64 reference and a
sound float32 run stay comparable; the start (segment 1, from the
reference's own weights) and the hand-over between calls (each call
starts from its checkpoint, the reference from the state the call before
returned) are checked by the same numbers.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time

import numpy as np
import torch

from torch_bench.harness import spec as spec_mod
from torch_bench.yardstick import compare, mrf_data, reference


@dataclasses.dataclass
class ReadContext:
    """What a per-layer reader (``metrics/<name>.py``) gets."""
    trace: object          # harness.trace.Trace, or None
    samples: int           # samples trained in the window
    launches: int          # training-kernel launches the program counted
    window_s: float        # the window on the host clock
    widths: tuple
    tile: int
    optimizer: str


def seeds_of(seed: int) -> tuple:
    """(data seed in [0, 2**31), init seed) drawn from ``--seed``, any
    whole number >= 0."""
    s = np.random.SeedSequence(int(seed)).generate_state(2, dtype=np.uint32)
    return int(s[0]) % 2 ** 31, int(s[1])


def _leaves(params) -> list:
    return [t.detach().to("cpu", torch.float64).numpy()
            for layer in params for t in (layer["w"], layer["b"])]


def _launches() -> int:
    from repro_torch.kernels.fused_train import multistep
    return (multistep.fused_train_multistep_call.launches
            + multistep.fused_train_adam_call.launches)


class Job:
    """The program's training job of one cell and seed (module
    docstring)."""

    def __init__(self, cell, seed: int, device, ckpt_dir: str):
        from repro_torch.configs import get_config
        from repro_torch.core.mrf_net import layer_sizes
        from repro_torch.data.epg import MRFSequence
        from repro_torch.data.pipeline import MRFSampleStream
        from repro_torch.models import registry
        from repro_torch.train import engine

        c, t = cell.config, cell.traffic
        if t["optimizer"] != "sgd":
            # the check starts each call's reference from the program's
            # state, and SGD's is the parameters alone
            raise ValueError(f"{cell.name}: the check follows SGD only, "
                             f"not {t['optimizer']!r}")
        self.widths = tuple(c["widths"])
        cfg = get_config(c["program_arch"])
        got = tuple(layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden))
        if got != self.widths:
            raise ValueError(f"the program's {c['program_arch']} has widths "
                             f"{got}; {c['name']} states {self.widths}")
        self.engine = engine
        self.fns = registry.build(cfg)
        self.traffic = t
        self.per_step = int(t["samples_per_step"])
        ref_stream = mrf_data.stream_of(c, self.per_step)
        self.ref_stream = ref_stream
        self.stream = MRFSampleStream(
            seq=MRFSequence(flip_angles=ref_stream.flip_angles,
                            trs=ref_stream.trs,
                            inv_delay=ref_stream.inv_delay),
            batch_size=self.per_step, snr_range=ref_stream.snr_range,
            t1_range=ref_stream.t1_range, t2_range=ref_stream.t2_range)
        self.ecfg = engine.EngineConfig(
            backend=t["backend"], lr=float(t["lr"]),
            optimizer=t["optimizer"], tile_batch=int(t["tile"]),
            chunk_steps=int(t["chunk_steps"]))
        self.data_seed, self.init_seed = seeds_of(seed)
        self.device = device
        self.ckpt_dir = ckpt_dir

    def train(self, total_steps: int, ckpt_every: int, on_metrics=None):
        from repro_torch.ft.runner import RunnerConfig
        rcfg = RunnerConfig(total_steps=total_steps, ckpt_dir=self.ckpt_dir,
                            ckpt_every=ckpt_every)
        return self.engine.train(
            self.fns, self.ecfg, rcfg, stream=self.stream,
            seed=self.data_seed, init_seed=self.init_seed,
            on_metrics=on_metrics, device=self.device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def segments(cell) -> list:
    """The compared steps, as the steps of each set-up call: step 1, one
    whole launch of ``chunk_steps``, then single steps up to
    ``single_steps`` (``limits/<cell>.json``) single-step calls."""
    singles = int(cell.limits["single_steps"])
    return [1, int(cell.traffic["chunk_steps"])] + [1] * (singles - 1)


def checked_steps(job: Job, segs) -> dict:
    """The set-up calls of ``segs`` (:func:`segments`): the program's side
    of the comparison.  Each call resumes from the checkpoint the one
    before ended on and makes one launch of its steps."""
    losses = {}

    def keep(step, metrics, dt):
        losses[step] = float(metrics["loss"])

    out, start = [], 0
    for n in segs:
        # the next boundary after ``start`` is ``start + n``: one launch
        # of ``n`` steps, ending on a checkpoint
        state, step, _ = job.train(start + n, start + n, keep)
        out.append({"losses": [losses.get(start + k + 1, float("nan"))
                               for k in range(n)],
                    "params": _leaves(state.params)})
        start += n
    count_gap = abs(int(state.step) - start) + abs(step - start) + abs(
        int(state.opt_state.step) - start)
    del state
    return {"segments": out, "count_gap": count_gap}


def reference_inputs(job: Job, steps: int, device) -> tuple:
    """(initial ``[(w, b)]``, x, y) as NumPy arrays: the frozen init and
    the batches of the first ``steps`` steps drawn on ``device`` (the
    program's draws, bit for bit)."""
    p0 = [(w.cpu().numpy(), b.cpu().numpy()) for w, b in
          mrf_data.init_params(job.widths, job.init_seed, device)]
    xs, ys = zip(*(mrf_data.batch(job.ref_stream, job.data_seed, s, device)
                   for s in range(steps)))
    return p0, torch.cat(xs).cpu().numpy(), torch.cat(ys).cpu().numpy()


def _pairs(leaves) -> list:
    return [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]


def follow(job: Job, segs, inputs, side=None, **how) -> dict:
    """The reference over the segments ``segs``, each from where ``side``
    (a program's side, as :func:`checked_steps` gives it) stood at its
    start: segment 1 from the initial weights, segment ``k`` from
    ``side``'s parameters after segment ``k - 1``; segments of one length
    train as stacked chains (``reference.train_chains``).  Without
    ``side`` the reference follows itself, one segment after another.
    ``how``: its precision or fault (``yardstick.reference``)."""
    t = job.traffic
    p0, x, y = inputs
    rows = job.per_step
    kw = dict(tile=int(t["tile"]), optimizer=t["optimizer"],
              lr=float(t["lr"]), **how)
    bounds = np.cumsum([0] + list(segs))
    out = [None] * len(segs)
    if side is None:  # one after another, each from the last one's end
        start = p0
        for k, n in enumerate(segs):
            r0, r1 = bounds[k] * rows, bounds[k + 1] * rows
            got = reference.train(start, x[r0:r1], y[r0:r1], steps=n, **kw)
            out[k] = {"losses": got["losses"], "params": got["params"],
                      "start": flat(start)}
            start = _pairs(got["params"])
        return {"segments": out}
    starts = [p0] + [_pairs(s["params"]) for s in side["segments"][:-1]]
    for n in sorted(set(segs)):
        ks = [k for k, m in enumerate(segs) if m == n]
        xs = np.stack([x[bounds[k] * rows:bounds[k + 1] * rows] for k in ks])
        ys = np.stack([y[bounds[k] * rows:bounds[k + 1] * rows] for k in ks])
        got = reference.train_chains([starts[k] for k in ks], xs, ys,
                                     steps=n, **kw)
        for c, k in enumerate(ks):
            out[k] = {"losses": got["losses"][c],
                      "params": got["params"][c], "start": flat(starts[k])}
    return {"segments": out}


def judge_side(job: Job, side, segs, inputs) -> dict:
    """The compared numbers of ``side`` against the float64 reference
    following it."""
    ref = follow(job, segs, inputs, side)
    return compare.numbers(side, ref, lr=job.ecfg.lr)


def readings_of(cell, seed: int, device, controls: bool) -> dict:
    """{side: compared numbers} of one seed (``readings.py``): the
    program's set-up calls against the reference and, with ``controls``,
    the reference in TF32 (``tf32``) and with half of each batch
    (``half_batch``) in the program's place, and the program's side with
    each step's loss altered by 1% where it is reported
    (``altered_loss``)."""
    tmp = tempfile.mkdtemp(prefix="torch_bench_readings_")
    try:
        job = Job(cell, seed, device, f"{tmp}/ckpt")
        segs = segments(cell)
        sides = {"program": checked_steps(job, segs)}
        inputs = reference_inputs(job, sum(segs), device)
        if controls:
            sides["altered_loss"] = {**sides["program"], "segments": [
                {**seg, "losses": [x * 1.01 for x in seg["losses"]]}
                for seg in sides["program"]["segments"]]}
            sides["tf32"] = follow(job, segs, inputs, precision="tf32")
            sides["half_batch"] = follow(job, segs, inputs,
                                         fault="half_batch")
        return {name: judge_side(job, side, segs, inputs)
                for name, side in sides.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def flat(p0) -> list:
    return [np.asarray(a, np.float64) for wb in p0 for a in wb]


def run(cell, seed: int, seconds: float, trace: bool, device, log,
        started: float) -> dict:
    """One run of ``cell``: the result's fields (``run.py`` prints them).
    ``started``: the process's start on ``time.perf_counter``'s clock, from
    which set-up counts."""
    from torch_bench.harness import trace as trace_mod

    tmp = tempfile.mkdtemp(prefix="torch_bench_")
    try:
        job = Job(cell, seed, device, f"{tmp}/ckpt")
        segs = segments(cell)
        n = sum(segs)
        every = int(job.traffic["ckpt_every"])
        chunk = job.ecfg.chunk_steps
        prog = checked_steps(job, segs)
        log("checked steps done")

        def timed(k):
            t0 = time.perf_counter()
            job.train(n + k, every)
            _sync(device)
            return time.perf_counter() - t0

        # a call of one chunk and one of three: their difference is two
        # chunks at the steady rate, without the restore, the first
        # staging and the last drain that every call pays
        one, three = timed(chunk), timed(3 * chunk)
        per_step = (three - one) / (2 * chunk)
        if per_step <= 0:  # a clock too coarse for the difference
            per_step = three / (3 * chunk)
        steps = max(chunk, int(round(seconds / per_step / chunk)) * chunk)
        log(f"warm-up: {per_step * 1e3:.3f} ms a step; window: {steps} "
            f"steps of {job.per_step} samples")

        launches0 = _launches()

        def window():
            start = time.perf_counter()
            _, last, _ = job.train(n + steps, every)
            _sync(device)
            return last, time.perf_counter() - start

        setup_s = time.perf_counter() - started
        if trace:
            (last, window_s), tr = trace_mod.traced(window, device)
        else:
            (last, window_s), tr = window(), None
        launches = _launches() - launches0
        samples = (last - n) * job.per_step
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        log(f"window: {last - n} steps, {samples} samples in "
            f"{window_s:.6f} s, {launches} launches")

        t_check = time.perf_counter()
        inputs = reference_inputs(job, n, device)
        nums = judge_side(job, prog, segs, inputs)
        correct, rows = compare.judge(nums, cell.limits)
        log(f"check: {time.perf_counter() - t_check:.3f} s; leaves counted: "
            f"{nums['leaves_counted']} of {nums['leaves']}; single steps' "
            f"median-leaf gaps {nums['single_steps']}")

        metrics = {}
        if trace:
            ctx = ReadContext(trace=tr, samples=samples, launches=launches,
                              window_s=window_s, widths=job.widths,
                              tile=job.ecfg.tile_batch,
                              optimizer=job.ecfg.optimizer)
            for m in cell.per_layer:
                value = spec_mod.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = {"train_samples_per_s": samples / window_s,
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        out = {"correct": bool(correct), "attempted": last - n, "failed": 0,
               "metrics": metrics, "peak": peak, "checks": rows}
        if tr is not None:
            out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
            out["breakdown"] = {"device_ops": tr.top_ops(),
                                "idle_gaps": tr.idle_gaps()}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
