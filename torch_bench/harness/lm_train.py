"""An LM training cell: set-up, the measured window and the check.

The system under test is the port's LM training job,
``repro_torch.launch.train.lm_job``, the one the training launcher's LM
branch runs: the configuration's model (``configs/<config>.json``, its
``program_arch`` cut to its ``n_layers``) with f32 masters and bf16
activations, byte-level batches, Adam with clipping at a global norm of
1.0, the fault-tolerant runner (``ft.runner``, one step a call of the
step function) and its checkpoints (``ft.checkpoint``), under
deterministic algorithms, on one card with no mesh.  One training job
runs through its calls, each resuming from the checkpoint the calls
before left in the job's directory (under the run's ``TMPDIR``):

1. set-up, the compared steps: ``compared_steps`` calls of one step each
   (``limits/<cell>.json``), each ending on a checkpoint; step 1 starts
   from the program's initial weights.  Each call hands back its state,
   and the first call of the SSD scan is taken as the program made it
   (:func:`scan_taken`);
2. the window's call: resumed from there, one step to warm up, then as
   many steps as fill ``--seconds`` at the compared steps' pace, with the
   traffic's checkpoint period.  The window runs from the end of the
   warm-up step to the end of the last step, on the host clock.

After the window, once the peak memory has been read, the compared numbers
(``yardstick.lm_compare``) hold each compared step's loss, its gradient
norm, its update of every parameter and its scan against the plain
reference (``yardstick.mamba2_ref``, float32, TF32 off), on the tokens
the reference draws itself (``yardstick.lm_data``).  The reference starts
step 1 from the initial weights it draws itself (``yardstick.lm_init``)
and each later step from the parameters and Adam moments the program
handed back from the step before; it computes one sequence at a time,
each layer recomputed in its backward.

With ``--trace 1`` the window's call runs under the profiler and an
``obs`` recording; the readers get the device time of the kernels the SSD
scan launched (``harness.lm_trace``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import statistics
import tempfile
import time

import torch

from torch_bench.harness import spec as spec_mod
from torch_bench.harness.mrf_train import seeds_of
from torch_bench.yardstick import lm_compare, lm_data, lm_init
from torch_bench.yardstick import mamba2_ref as ref

#: what the launcher sets before CUDA starts: deterministic cuBLAS
#: products, and an allocator that does not fragment under a full-width
#: step's activations
ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8",
       "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
#: the configuration file's widths, each with the port's field
WIDTHS = {"d_model": "d_model", "d_inner": "d_inner",
          "n_heads": "n_ssm_heads", "head_dim": "ssm_head_dim",
          "d_state": "ssm_state", "chunk_size": "ssm_chunk",
          "vocab_rows": "vocab_size", "tie_embeddings": "tie_embeddings"}
#: the planted faults of ``readings.py`` (:func:`planted`)
FAULTS = ("scan_bf16", "no_inter_chunk", "no_D", "half_batch", "wrong_init",
          "frozen_after_first", "moments_lost")


@dataclasses.dataclass
class ReadContext:
    """What a per-layer reader (``metrics/<name>.py``) gets."""
    trace: object          # harness.lm_trace.LaunchTrace, or None
    rec: object            # the window call's obs recording, or None
    samples: int           # sequences trained in the window
    window_s: float        # the window on the host clock
    model: dict            # the configuration file (its widths)
    batch: int
    seq: int


def model_config(c: dict):
    """The program's configuration of ``c``: its ``program_arch`` cut to
    ``n_layers``, every width checked against ``c``.  ``"smoke": true``
    takes the arch's smoke model (the CPU tests), whose head is tied as
    ``c`` states."""
    from repro_torch.configs import get_config, get_smoke

    cfg = dataclasses.replace(
        (get_smoke if c.get("smoke") else get_config)(c["program_arch"]),
        n_layers=int(c["n_layers"]))
    if c.get("smoke"):
        cfg = dataclasses.replace(cfg, tie_embeddings=c["tie_embeddings"])
    got = {k: getattr(cfg, f) for k, f in WIDTHS.items()}
    want = {k: c[k] for k in WIDTHS}
    if got != want:
        raise ValueError(f"the program's {c['program_arch']} has {got}; "
                         f"{c['name']} states {want}")
    return cfg


class Job:
    """The program's training job of one cell and seed (module
    docstring)."""

    def __init__(self, cell, seed: int, device, ckpt_dir: str):
        from repro_torch.launch import train as launcher

        t = cell.traffic
        if t["optimizer"] != "adam" or float(t["max_grad_norm"]) != 1.0 \
                or int(t["microbatches"]) != 1:
            raise ValueError(f"{cell.name}: the job trains with Adam, "
                             f"clipping at 1.0 and one microbatch")
        self.config = cell.config
        self.cfg = model_config(cell.config)
        self.launcher = launcher
        self.traffic = t
        self.batch, self.seq = int(t["batch"]), int(t["seq"])
        self.data_seed, self.init_seed = seeds_of(seed)
        self.device = device
        self.ckpt_dir = ckpt_dir

    def train(self, total_steps: int, ckpt_every: int, on_step=None):
        return self.launcher.lm_job(
            self.cfg, batch=self.batch, seq=self.seq, steps=total_steps,
            ckpt_dir=self.ckpt_dir, ckpt_every=ckpt_every,
            lr=float(self.traffic["lr"]), device=self.device,
            seed=self.init_seed, data_seed=self.data_seed, on_step=on_step)


def _keep_latest(ckpt_dir: str) -> None:
    """The job's directory down to its latest checkpoint, which the next
    call resumes from: a state of ~9 GB a checkpoint, the runner's three
    kept would fill the run's disk for nothing."""
    import pathlib

    from repro_torch.ft.checkpoint import latest_step
    latest = latest_step(ckpt_dir)
    for d in pathlib.Path(ckpt_dir).glob("step_*"):
        if d.name != f"step_{latest}":
            shutil.rmtree(d, ignore_errors=True)


def _host(params):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), params)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checked_steps(job: Job, n: int) -> dict:
    """The set-up calls: ``n`` calls of one step, each resuming from the
    checkpoint the one before ended on.  The program's side of the
    comparison, on the host: each step's loss, gradient norm and seconds;
    the parameters each step ended on (``ends``) and, for each step but
    the last, the Adam moments it handed back with them (``moments``,
    ``(mu, nu)``); the first scan of each step (:func:`scan_taken`); and
    the step counters' gap."""
    losses, norms, secs, ends, moments, scans = [], [], [], [], [], []
    for k in range(1, n + 1):
        with scan_taken() as scan:
            out = job.train(k, k)
        _keep_latest(job.ckpt_dir)
        losses.append(out.losses[k])
        norms.append(out.grad_norms[k])
        secs.append(out.times[k])
        ends.append(_host(out.state.params))
        if k < n:
            opt = out.state.opt_state
            moments.append((_host(opt.mu), _host(opt.nu)))
        scans.append(scan)
    state, step = out.state, out.step
    count_gap = abs(int(state.step) - n) + abs(step - n) + abs(
        int(state.opt_state.step) - n)
    del out, state
    return {"losses": losses, "grad_norms": norms, "step_s": secs,
            "ends": ends, "moments": moments, "scans": scans,
            "count_gap": count_gap}


@contextlib.contextmanager
def scan_taken():
    """``with scan_taken() as got:`` the first call of the program's SSD
    scan (``models.ssm.ssd_chunked``, as ``_mixer_core`` calls it) inside
    the block, on its first sequence, copied to the host: ``got["inputs"]``
    (x (L, H, P), dt (L, H), A (H,), B, C (L, N)) and ``got["y"]`` (L, H,
    P)."""
    from repro_torch.models import ssm

    real = ssm.ssd_chunked
    got = {}

    def host(t):
        return t.detach().to("cpu", copy=True)

    def taking(x, dt, A, Bmat, Cmat, chunk):
        y, state = real(x, dt, A, Bmat, Cmat, chunk)
        if not got:
            got["inputs"] = [host(t if t is A else t[0])
                             for t in (x, dt, A, Bmat, Cmat)]
            got["y"] = host(y[0])
        return y, state

    ssm.ssd_chunked = taking
    try:
        yield got
    finally:
        ssm.ssd_chunked = real


def _plain(params, device) -> dict:
    """The port's parameters (or a tree shaped as them, such as Adam's
    moments) in the reference's layout, on ``device``."""
    out = {"embed": params["embed"].to(device),
           "final_norm": params["final_norm"].to(device),
           "layers": [{"norm": lp["ln1"].to(device),
                       **{k: v.to(device) for k, v in
                          lp["ssm"]._asdict().items()}}
                      for lp in params["layers"]]}
    if "head" in params:
        out["head"] = params["head"].to(device)
    return out


def _leaves(plain) -> list:
    """``[(kind, tensor)]``: the embedding, the final norm, the head (if
    untied), then each layer's leaves by name."""
    return [(k, plain[k]) for k in ("embed", "final_norm", "head")
            if k in plain] \
        + [kt for lp in plain["layers"] for kt in sorted(lp.items())]


@contextlib.contextmanager
def _float32_products():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    ref.no_tf32()
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def _pool(counts) -> dict:
    """``[(kind, part, whole, entries)]`` summed by kind."""
    kinds = {}
    for kind, part, whole, n in counts:
        p0, w0, n0 = kinds.get(kind, (0.0, 0.0, 0))
        kinds[kind] = (p0 + part, w0 + whole, n0 + n)
    return kinds


def judge_side(job: Job, side: dict) -> dict:
    """The compared numbers of ``side`` (:func:`checked_steps`) against
    the reference following it step by step (``yardstick.lm_compare``):
    step 1 from the reference's own initial weights (``yardstick.lm_init``)
    and zero moments, each later step from the parameters and moments the
    program handed back."""
    dev, lr = job.device, float(job.traffic["lr"])
    losses, norms, updates, scan_gaps = [], [], [], []
    with _float32_products():
        for k, end in enumerate(side["ends"]):
            tokens, labels = lm_data.batch(
                job.data_seed, k, job.batch, job.seq,
                min(job.cfg.vocab_size, 256), device=dev)
            p = (lm_init.init_params(job.config, job.init_seed, dev)
                 if k == 0 else _plain(side["ends"][k - 1], dev))
            loss, grads = ref.loss_and_grads(p, tokens, labels)
            g = _leaves(grads)
            losses.append(float(loss))
            norms.append(lm_compare.global_norm([t for _, t in g]))
            scale = lm_compare.clip_scale(norms[-1])
            moved = [(kind, a - b) for (kind, a), (_, b) in zip(
                _leaves(_plain(end, dev)), _leaves(p), strict=True)]
            if k == 0:
                signs = [(kind, *lm_compare.sign_counts(d, w), w.numel())
                         for (kind, d), (_, w) in zip(moved, g, strict=True)]
                init_move = max(float(d.abs().max()) for _, d in moved) / lr
            else:
                mu, nu = (_leaves(_plain(t, dev))
                          for t in side["moments"][k - 1])
                counts = []
                for (kind, d), (_, w), (_, m), (_, v) in zip(
                        moved, g, mu, nu, strict=True):
                    want, m_new = lm_compare.adam_update(w * scale, m, v,
                                                         k + 1, lr)
                    counts.append((kind, *lm_compare.update_counts(
                        d, want, m_new), d.numel()))
                    del want, m_new
                updates.append(_pool(counts))
                del mu, nu
            scan = side["scans"][k]
            want = ref.ssm(*(t.to(dev) for t in scan["inputs"]))
            scan_gaps.append(lm_compare.scan_gap(scan["y"].to(dev), want))
            del p, grads, g, moved, want
    nums = lm_compare.numbers(
        {**side, "sign_kinds": _pool(signs), "update_kinds": updates,
         "init_move": init_move, "scan_gaps": scan_gaps},
        {"losses": losses, "grad_norms": norms})
    # what the numbers are read from, for the readings of the limits: each
    # step's (loss, reference loss, norm, reference norm, scan gap) and
    # each later step's pooled update gap by kind
    nums["steps"] = [list(x) for x in zip(side["losses"], losses,
                                          side["grad_norms"], norms,
                                          scan_gaps)]
    nums["update_kinds"] = [{kind: part / whole for kind, (part, whole, _)
                             in u.items() if whole > 0} for u in updates]
    return nums


def readings_of(cell, seed: int, device, controls: bool) -> dict:
    """{side: compared numbers} of one seed (``readings.py``): the
    program's set-up calls against the reference and, with ``controls``,
    the program with each step's loss altered by 1% (``altered_loss``)
    and with each of :data:`FAULTS` planted (:func:`planted`)."""
    for k, v in ENV.items():
        os.environ.setdefault(k, v)
    n = int(cell.limits["compared_steps"])
    out = {}
    for name in ("program",) + (FAULTS if controls else ()):
        tmp = tempfile.mkdtemp(prefix="torch_bench_readings_")
        try:
            job = Job(cell, seed, device, f"{tmp}/ckpt")
            with planted(name):
                side = checked_steps(job, n)
            out[name] = judge_side(job, side)
            if name == "program" and controls:
                out["altered_loss"] = judge_side(job, {
                    **side, "losses": [x * 1.01 for x in side["losses"]]})
            del side
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, for the readings of the limits
    (``"program"``: none).  ``scan_bf16``: the SSD scan's inputs and
    products in bf16 (the configuration states a float32 scan);
    ``no_inter_chunk``: each chunk scanned as a sequence of its own, no
    state carried between chunks; ``no_D``: the skip ``D x`` left out;
    ``half_batch``: each step trains on the first half of its batch;
    ``wrong_init``: ``A_log`` drawn over log 1..8, not 1..16;
    ``frozen_after_first``: Adam leaves the parameters as they are after
    its first step; ``moments_lost``: each call's first step starts from
    zero moments, the step count kept (a resume that restores no
    moments)."""
    from repro_torch import optim
    from repro_torch.launch import train as launcher
    from repro_torch.models import ssm

    real_ssd, real_core = ssm.ssd_chunked, ssm._mixer_core
    real_batches, real_init, real_adam = (launcher.lm_batches, ssm.init_ssm,
                                          optim.adam)

    def scan_bf16(x, dt, A, B, C, chunk):
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16):
            y, s = real_ssd(*(t.to(torch.bfloat16) for t in (x, dt, A, B, C)),
                            chunk)
        return y.float(), s.float()

    def no_inter_chunk(x, dt, A, B, C, chunk):
        b, length, h, p = x.shape
        n, nc = B.shape[-1], max(length // chunk, 1)
        q = length // nc
        y, s = real_ssd(x.reshape(b * nc, q, h, p), dt.reshape(b * nc, q, h),
                        A, B.reshape(b * nc, q, n), C.reshape(b * nc, q, n),
                        chunk)
        return y.reshape(b, length, h, p), s.reshape(b, nc, h, p, n)[:, -1]

    def no_D(*args, **kw):
        args = list(args)
        args[9] = args[9] * 0.0
        return real_core(*args, **kw)

    def half_batch(cfg, pipe, device):
        at = real_batches(cfg, pipe, device)
        return lambda step: {k: v[:v.shape[0] // 2]
                             for k, v in at(step).items()}

    def wrong_init(*args, **kw):
        p = real_init(*args, **kw)
        return p._replace(A_log=torch.log(torch.linspace(
            1.0, 8.0, p.A_log.shape[0], dtype=torch.float32,
            device=p.A_log.device)))

    def frozen_after_first(*args, **kw):
        opt = real_adam(*args, **kw)

        def update(grads, state, params):
            new, after = opt.update(grads, state, params)
            return (params if int(state.step) >= 1 else new), after
        return dataclasses.replace(opt, update=update)

    def moments_lost(*args, **kw):
        from repro_torch.tree import tree_map
        opt, first = real_adam(*args, **kw), [True]

        def update(grads, state, params):
            if first[0]:
                first[0] = False
                state = state._replace(mu=tree_map(torch.zeros_like, state.mu),
                                       nu=tree_map(torch.zeros_like, state.nu))
            return opt.update(grads, state, params)
        return dataclasses.replace(opt, update=update)

    patch = {"program": {}, "scan_bf16": {(ssm, "ssd_chunked"): scan_bf16},
             "no_inter_chunk": {(ssm, "ssd_chunked"): no_inter_chunk},
             "no_D": {(ssm, "_mixer_core"): no_D},
             "half_batch": {(launcher, "lm_batches"): half_batch},
             "wrong_init": {(ssm, "init_ssm"): wrong_init},
             "frozen_after_first": {(optim, "adam"): frozen_after_first},
             "moments_lost": {(optim, "adam"): moments_lost}}[fault]
    for (mod, name), fn in patch.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        ssm.ssd_chunked, ssm._mixer_core = real_ssd, real_core
        launcher.lm_batches, ssm.init_ssm, optim.adam = (
            real_batches, real_init, real_adam)


def run(cell, seed: int, seconds: float, trace: bool, device, log,
        started: float) -> dict:
    """One run of ``cell``: the result's fields (``run.py`` prints them).
    ``started``: the process's start on ``time.perf_counter``'s clock, from
    which set-up counts."""
    from repro_torch import obs
    from torch_bench.harness import lm_trace

    for k, v in ENV.items():
        os.environ.setdefault(k, v)
    tmp = tempfile.mkdtemp(prefix="torch_bench_")
    try:
        job = Job(cell, seed, device, f"{tmp}/ckpt")
        n = int(cell.limits["compared_steps"])
        prog = checked_steps(job, n)
        per_step = statistics.median(prog["step_s"][1:] or prog["step_s"])
        steps = max(2, int(round(seconds / per_step)))
        log(f"checked steps done: {[round(s, 3) for s in prog['step_s']]} "
            f"s; window: {steps} steps of {job.batch} x {job.seq} tokens")

        ends = {}

        def stamp(step, loss, gnorm, dt):
            ends[step] = time.perf_counter()

        def window():
            out = job.train(n + 1 + steps, int(job.traffic["ckpt_every"]),
                            on_step=stamp)
            _sync(device)
            return out.step

        rec = None
        if trace:
            def recorded():
                nonlocal rec
                with obs.recording() as rec:
                    return window()
            last, tr = lm_trace.traced(recorded, device)
        else:
            last, tr = window(), None
        first = n + 1  # the warm-up step
        window_s = ends[last] - ends[first]
        samples = (last - first) * job.batch
        setup_s = ends[first] - started
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        log(f"window: {last - first} steps, {samples} sequences in "
            f"{window_s:.6f} s; peak {peak / 2 ** 30:.2f} GiB")

        t_check = time.perf_counter()
        nums = judge_side(job, prog)
        correct, rows = lm_compare.judge(nums, cell.limits)
        log(f"check: {time.perf_counter() - t_check:.3f} s")

        metrics = {}
        if trace:
            ctx = ReadContext(trace=tr, rec=rec, samples=samples,
                              window_s=window_s, model=cell.config,
                              batch=job.batch, seq=job.seq)
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
        out = {"correct": bool(correct), "attempted": last - first,
               "failed": 0, "metrics": metrics, "peak": peak, "checks": rows}
        if tr is not None:
            out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
            out["breakdown"] = {"device_ops": tr.top_ops(),
                                "idle_gaps": tr.idle_gaps(),
                                "scan": lm_trace.breakdown(tr, rec)}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
