"""Training entry points of the MRF net (counterpart of
``repro.core.train_loop``).

``train()`` is a thin wrapper over the engine (``repro_torch.train.engine``):
the float baseline (Adam, the paper's software setup), QAT (fake-quant +
observers) and the fused CUDA kernel are the same ``ft.runner`` run with
another backend.  The net is initialised from a generator seeded with
``cfg.seed`` and the batches are ``batch_at(stream, cfg.seed, step)``.

``evaluate()`` is the paper's test: held-out synthetic signals -> Table 1
metrics.
"""

from __future__ import annotations

import dataclasses
import tempfile

import torch

from repro_torch.core import mrf_net, qat
from repro_torch.core.metrics import table1_metrics_normalized
from repro_torch.data.pipeline import MRFSampleStream, make_eval_set
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class TrainConfig:
    n_frames: int = 32
    hidden: tuple = mrf_net.ADAPTED_HIDDEN
    lr: float = 1e-4            # paper's learning rate
    batch_size: int = 256
    steps: int = 500
    qat: bool = False
    optimizer: str = "adam"     # paper: Adam for software, SGD on FPGA
    seed: int = 0
    log_every: int = 100
    backend: str = ""           # "" -> float, or qat-int8 when qat=True;
                                # may name any train.engine backend
    ckpt_dir: str | None = None  # None -> throwaway temp dir
    ckpt_every: int = 0         # 0 -> no periodic checkpoints
    tile_batch: int = 128       # fused only
    chunk_steps: int = 1        # > 1: n steps per call (bit-identical)


def train(cfg: TrainConfig, stream: MRFSampleStream | None = None,
          verbose: bool = True, *, device="cuda"):
    """Train an MRF net through the engine on ``device``; returns
    ``(params, qstate, history)``."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data.epg import default_sequence
    from repro_torch.ft.checkpoint import latest_step
    from repro_torch.ft.runner import RunnerConfig
    from repro_torch.models.mrf import build_mrf
    from repro_torch.train import engine

    dev = resolve_device(device)
    if stream is None:
        stream = MRFSampleStream(seq=default_sequence(cfg.n_frames),
                                 batch_size=cfg.batch_size)
    n_frames = stream.seq.n_frames
    sizes = mrf_net.layer_sizes(n_frames, cfg.hidden)
    backend = cfg.backend or ("qat-int8" if cfg.qat else "float")
    model_cfg = ModelConfig(
        name=f"mrf-{n_frames}f", family="mrf", n_layers=len(cfg.hidden) + 1,
        mrf_n_frames=n_frames, mrf_hidden=tuple(cfg.hidden)).validate()
    fns = build_mrf(model_cfg)
    ecfg = engine.EngineConfig(backend=backend, lr=cfg.lr,
                               optimizer=cfg.optimizer, max_grad_norm=None,
                               tile_batch=cfg.tile_batch,
                               chunk_steps=cfg.chunk_steps)

    history = []

    def on_metrics(step, metrics, dt):
        i = step - 1
        if i % cfg.log_every == 0 or i == cfg.steps - 1:
            history.append((i, float(metrics["loss"])))
            if verbose:
                print(f"step {i:5d}  loss {history[-1][1]:.6f}")

    tmp = None
    ckpt_dir = cfg.ckpt_dir
    if ckpt_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="mrf_engine_")
        ckpt_dir = tmp.name
    else:
        resume = latest_step(ckpt_dir)
        if resume:
            # history and wall_seconds then cover only the resumed tail
            print(f"resuming from checkpoint step {resume} in {ckpt_dir}")
    try:
        rcfg = RunnerConfig(total_steps=cfg.steps, ckpt_dir=ckpt_dir,
                            ckpt_every=cfg.ckpt_every or cfg.steps + 1)
        state, _, info = engine.train(
            fns, ecfg, rcfg, stream=stream, seed=cfg.seed,
            init_seed=cfg.seed, batch_size=stream.batch_size,
            on_metrics=on_metrics, device=dev)
    finally:
        if tmp is not None:
            tmp.cleanup()

    qstate = state.aux if state.aux is not None else qat.init_qat_state(
        len(state.params), device=dev)
    return state.params, qstate, {"history": history,
                                  "wall_seconds": info["wall_seconds"],
                                  "samples_per_s": info["samples_per_s"],
                                  "sizes": sizes}


def evaluate(params, seq, *, qstate=None, int_layers=None, n: int = 5000,
             seed: int = 123, device="cuda") -> dict:
    """The paper's test: ``n`` held-out synthetic signals at SNR 20 ->
    Table 1 metrics (ms).  ``int_layers`` runs the integer oracle (on a CPU
    copy), ``qstate`` the fake-quantized net, else the float net."""
    dev = resolve_device(device)
    x, y = make_eval_set(seq, n=n, seed=seed, device=dev)
    with torch.no_grad():
        if int_layers is not None:
            cpu = [dataclasses.replace(
                layer, **{f: (None if getattr(layer, f) is None
                              else getattr(layer, f).cpu())
                          for f in ("w_q", "b_q", "s_in", "s_w", "s_out")})
                   for layer in int_layers]
            pred = qat.int_forward(cpu, x.cpu())
            y = y.cpu()
        elif qstate is not None:
            pred, _ = qat.forward_qat(params, qstate, x, train=False)
        else:
            pred = mrf_net.forward(params, x)
    return table1_metrics_normalized(pred, y)
