"""Serving launcher of the port (counterpart of ``repro.launch.serve``): the
LM families' token serving (dense, MoE, SSM, hybrid, encoder-decoder and
VLM) and the MRF reconstruction family.

Token serving: ``python -m repro_torch.launch.serve --arch tinyllama-1.1b
--requests 8 --prompt-len 2048 --gen-len 32`` initialises the model from a
seed (fp32 masters, served from their bf16 copy), draws random prompts from
a seeded ``torch.Generator``, runs one warm-up prefill and decode step, then
a timed batched prefill (attention on the flash-attention kernel B6) and a
timed lockstep greedy decode loop with no host sync per token.  The last
line printed is ``token_report {json}``: prefill ms, decode ms per token
per batch, generated tokens/s, B6's launches and the sampled tokens.  An
MoE arch (``--arch deepseek-moe-16b``, ``phi3.5-moe-42b-a6.6b``) routes its
tokens in groups of 256 (one group of the batch at decode); a batch whose
``requests x prompt-len`` (or ``requests``) is not a whole number of groups
is refused before the weights are made, as the reference's assert refuses
it: nothing is padded.  ``--arch mamba2-1.3b`` (SSM: no attention, so no
B6 launch) and ``--arch hymba-1.5b`` (hybrid: B6 and the mamba2 mixer side
by side, windows of 1,024 on all but three layers) keep an SSM state and
conv tails per layer; their prompts need at least 3 tokens.
``--arch seamless-m4t-large-v2`` (encoder-decoder) takes a request's
``enc_len_for(prompt-len)`` frames beside its prompt, and
``--arch llava-next-34b`` (VLM) its ``n_prefix_embeds`` patch embeddings
in place of the prompt's first tokens (a shorter prompt is refused before
the weights are made); both are ``0.02 * N(0, 1)`` in bf16 from the
launcher's seeded generator, as the reference's launcher makes them (the
speech and vision frontends are stubs there too).  B6 runs the encoder's
attention, the decoder's self- and cross-attention and llava's.

``python -m repro_torch.launch.serve --arch mrf-fpga --backend int8`` QAT-
trains a net through the port's engine (600 steps, 60 with ``--smoke``, or
``--train-steps``), exports it to a full-integer int8 artifact, round-trips
the artifact through disk and serves it; ``--artifact net.npz`` serves a
kept artifact instead (the ``.npz`` format of
``repro.core.qat.save_int8_artifact``, written by either package).  A
request wave of phantom slices goes through the queued engine on
``--device`` (default ``cuda``), and every served map is checked against
the plain integer oracle ``qat.int_forward`` — computed on a CPU copy, so
the check does not run through the kernel it checks — bit for bit.
``--backend float`` trains a float net and serves it through the
executor's float backend, checked against ``mrf_net.forward`` on a CPU
copy within rtol 1e-5 of the map's scale.  ``--serve-mode pipelined``
serves the same trace through the double-buffered executor and also
asserts that its maps are bit-identical to sync serving.

Chaos run: ``--fault-schedule`` (a ``serve.faults`` JSON schedule) and/or
the admission knobs (``--max-pending-voxels``, ``--shed-deadline-ms``)
switch the MRF family onto the overload/fault accounting path — no warm-up
wave, enqueue everything, drain through the injected faults, then audit:
every ticket landed in exactly one terminal state (done/failed/shed),
something was served, and every served map equals fault-free serving on
the implementation the engine ended on (bit for bit for int8) and the
oracle above.  ``--adaptive`` tunes the in-flight depth and the wave cap
live (pipelined only), ``--wave-timeout-ms`` counts slow waves.
``--expect-shed`` / ``--expect-degraded`` fail the run unless load
shedding / the circuit breaker (the fused kernel B4 giving way to the
layered chain B5) actually engaged.

For the MRF family the last line printed is ``serve_report {json}``:
throughput, latency percentiles, the tiles each implementation served and
the engine's health counters (``degraded``, ``n_kernel_failures``,
``n_shed_total``, ``n_slow_waves``); a chaos run adds the tickets' states,
retries, the fired faults and the final depth and wave cap.
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import mrf_net, qat
from repro_torch.data.epg import default_sequence
from repro_torch.data.phantom import acquire_slice, make_phantom, tissue_errors
from repro_torch.data.pipeline import denormalize_targets
from repro_torch.kernels.common import disable_tf32, resolve_device
from repro_torch.models.moe import group_of
from repro_torch.serve.admission import AdmissionPolicy
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.queue import RequestState
from repro_torch.serve.recon import (ReconEngine, ReconRequest,
                                     latency_percentiles)

#: health() counters every serve_report carries
HEALTH_KEYS = ("degraded", "n_kernel_failures", "n_shed_total",
               "n_slow_waves")


def _maps_equal(a, b) -> bool:
    return np.array_equal(a.t1_ms, b.t1_ms) and np.array_equal(a.t2_ms, b.t2_ms)


def _float_err(got, want) -> float:
    """Largest difference of two (n, 2) float map sets, over each map's
    scale."""
    worst = 0.0
    for j in range(want.shape[1]):
        scale = max(float(np.abs(want[:, j]).max()), 1e-30)
        worst = max(worst, float(np.abs(got[:, j] - want[:, j]).max())
                    / scale)
    return worst


def _maps_close(a, b) -> bool:
    """Float maps within 1e-5 of each map's scale."""
    def stack(r):
        return np.stack([r.t1_ms.ravel(), r.t2_ms.ravel()], 1)
    return _float_err(stack(a), stack(b)) <= 1e-5


def _train_mrf(args, cfg, device, *, qat_mode: bool):
    """One training recipe for both serving backends; the topology comes
    from the arch config, so mrf-original serves its own (deeper) net."""
    from repro_torch.core.train_loop import TrainConfig, train

    steps = (args.train_steps if args.train_steps is not None
             else (60 if args.smoke else 600))
    tcfg = TrainConfig(n_frames=cfg.mrf_n_frames, hidden=cfg.mrf_hidden,
                       steps=steps, qat=qat_mode, lr=1e-3, batch_size=256,
                       log_every=max(steps // 3, 1))
    params, qstate, info = train(tcfg, verbose=not args.smoke, device=device)
    print(f"trained {'qat-int8' if qat_mode else 'float'} {cfg.name}: "
          f"{steps} steps, {info['samples_per_s']:.0f} samples/s, loss "
          f"{info['history'][0][1]:.6f} -> {info['history'][-1][1]:.6f}")
    return params, qstate


def _int8_artifact(args, cfg, device) -> tuple:
    """``(layers on device, layers on the CPU)``: ``--artifact``, or a
    QAT-trained export round-tripped through disk (the deployment unit)."""
    if args.artifact:
        return (qat.load_int8_artifact(args.artifact, device=device),
                qat.load_int8_artifact(args.artifact, device="cpu"))
    params, qstate = _train_mrf(args, cfg, device, qat_mode=True)
    ints = qat.export_int8(params, qstate)
    with tempfile.TemporaryDirectory(prefix="mrf_artifact_") as tmp:
        path = qat.save_int8_artifact(f"{tmp}/{cfg.name}_int8", ints)
        loaded = (qat.load_int8_artifact(path, device=device),
                  qat.load_int8_artifact(path, device="cpu"))
        print(f"int8 artifact round-tripped via {path.name}")
    return loaded


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def token_batch(cfg, b: int, s: int, generator, device) -> dict:
    """A prefill batch of ``b`` random prompts of ``s`` tokens from
    ``generator``, with an encoder-decoder's frames (B, enc_len_for(s), d)
    or a VLM's prefix embeddings (B, n_prefix_embeds, d): ``0.02 * N(0,
    1)`` in bf16, as the reference's launcher makes them."""
    from repro_torch.models.common import COMPUTE
    from repro_torch.models.encdec import enc_len_for

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=generator, device=device,
                                     dtype=torch.int32)}
    extra = {"encdec": ("frames", enc_len_for(s)),
             "vlm": ("prefix_embeds", cfg.n_prefix_embeds)}.get(cfg.family)
    if extra:
        name, n = extra
        batch[name] = 0.02 * torch.randn((b, n, cfg.d_model),
                                         generator=generator, device=device,
                                         dtype=COMPUTE)
    return batch


def serve_tokens(args, cfg) -> int:
    """Batched prefill + lockstep greedy decode for the LM families."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.models import registry
    from repro_torch.models.common import COMPUTE
    from repro_torch.models.lm import check_prefix_len
    from repro_torch.models.ssm import check_prompt_len
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    if min(args.requests, args.prompt_len, args.gen_len) < 1:
        raise SystemExit("--requests, --prompt-len and --gen-len must be >= 1")
    if cfg.family == "moe":  # prefill's and decode's tokens route in groups
        group_of(args.requests * args.prompt_len)
        group_of(args.requests)
    if cfg.family in ("ssm", "hybrid"):  # decode extends the conv tails
        check_prompt_len(args.prompt_len)
    if cfg.family == "vlm":  # the prefix overwrites the first positions
        check_prefix_len(cfg.n_prefix_embeds, args.prompt_len)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = flash_attention_call.launches
    fns = registry.build(cfg)
    params = fns.init(0, device=device, dtype=COMPUTE)
    prefill = make_prefill_step(fns)
    serve = make_serve_step(fns)

    b, s = args.requests, args.prompt_len
    gen = torch.Generator(device=device).manual_seed(1)
    batch = token_batch(cfg, b, s, gen, device)
    with torch.no_grad():
        # warm-up: first launches (and kernel builds) outside the timed part
        w_cache, w_tok, _ = prefill(params, batch)
        w_tok, w_cache = serve(params, w_cache, w_tok, s)
        _sync(device)
        del w_cache, w_tok

        t0 = time.perf_counter()
        cache, tok, _ = prefill(params, batch)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        # tokens stay on the device: no host sync per token
        toks = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen_len - 1):
            tok, cache = serve(params, cache, tok, s + i)
            toks.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0

    tokens = torch.stack(toks, dim=1).cpu()
    n_dec = max(args.gen_len - 1, 1)
    print(f"arch={cfg.name} requests={b} prompt={s} gen={args.gen_len} "
          f"device={device}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms  decode: "
          f"{t_decode / n_dec * 1e3:.2f} ms/token/batch")
    print("sample token ids:", tokens[0][:12].tolist())
    report = {"arch": cfg.name, "device": str(device), "requests": b,
              "prompt": s, "gen": args.gen_len,
              "prefill_ms": t_prefill * 1e3,
              "decode_ms_per_token": t_decode / n_dec * 1e3,
              "generated_tokens_per_s": b * args.gen_len
              / (t_prefill + t_decode),
              "flash_attn_launches": flash_attention_call.launches - launches0,
              "sample_ids": tokens[0][:12].tolist(),
              "peak_device_gib": torch.cuda.max_memory_allocated(device)
              / 2**30 if device.type == "cuda" else None,
              "tokens": tokens.tolist()}
    print("token_report " + json.dumps(report))
    return 0


def _check_oracle(backend, requests, results, vox, ints_cpu, params) -> bool:
    """Every served map against the plain oracle on a CPU copy, so the
    check does not run through the kernel it checks: the integer oracle
    ``qat.int_forward`` bit for bit (the paper's FPGA-vs-Python
    criterion), or ``mrf_net.forward`` within 1e-5 of the map's scale
    (fp32 sums run in another order on the card)."""
    if backend == "int8":
        for r, got in zip(requests, results):
            want = denormalize_targets(
                qat.int_forward(ints_cpu, r.features.cpu())).numpy()
            if not (np.array_equal(got.t1_ms[vox], want[:, 0])
                    and np.array_equal(got.t2_ms[vox], want[:, 1])):
                print(f"FAIL: int8 engine diverges from qat.int_forward "
                      f"oracle ({r.request_id})")
                return False
        print(f"int8 engine == qat.int_forward oracle: bit-exact "
              f"({len(requests)} requests)")
        return True
    p_cpu = [{k: v.detach().cpu() for k, v in layer.items()}
             for layer in params]
    worst = 0.0
    for r, got in zip(requests, results):
        with torch.no_grad():
            want = denormalize_targets(
                mrf_net.forward(p_cpu, r.features.cpu())).numpy()
        worst = max(worst, _float_err(
            np.stack([got.t1_ms[vox], got.t2_ms[vox]], 1), want))
    if worst > 1e-5:
        print(f"FAIL: float engine diverges from mrf_net.forward: "
              f"max error {worst:.3g} of the map's scale > 1e-5")
        return False
    print(f"float engine == mrf_net.forward oracle: max error "
          f"{worst:.3g} of the map's scale ({len(requests)} requests)")
    return True


def _report(args, cfg, engine, engines, requests, results, device) -> dict:
    wave = engine.last_wave
    pct = latency_percentiles(results)
    tiles = collections.Counter()
    for e in engines:
        tiles.update(e.executor.tiles_by_impl)
    health = engine.health()
    return {"arch": cfg.name, "backend": args.backend,
            "impl": engine.int8_impl, "mode": args.serve_mode,
            "device": str(device), "requests": len(requests),
            "voxels": wave["total_voxels"],
            "voxels_per_s": wave["voxels_per_s"], "wall_s": wave["wall_s"],
            "p50_ms": pct["p50_ms"], "p99_ms": pct["p99_ms"],
            "tiles": sum(tiles.values()), "tiles_by_impl": dict(tiles),
            **{k: health[k] for k in HEALTH_KEYS}}


def _chaos_serve(args, cfg, engine, net_kw, requests, oracle, injector,
                 device) -> int:
    """Overload/fault accounting path: enqueue everything, drain through
    the injected schedule, then audit the lifecycle ledger.

    Enqueue-all-then-drain (not enqueue/poll interleaved) on purpose: the
    pending backlog builds before any wave retires, so admission-policy
    shedding is deterministic — the same requests shed every run.
    """
    tickets = [engine.enqueue(r) for r in requests]
    engine.drain()
    stats, health = engine.last_wave, engine.health()
    states = collections.Counter(t.state for t in tickets)
    print(f"chaos drain: done={states['done']} failed={states['failed']} "
          f"shed={states['shed']} waves={stats['n_waves']} "
          f"retries={stats['n_retries']} slow={health['n_slow_waves']} "
          f"degraded={health['degraded']}")
    for t in tickets:
        if t.state == RequestState.SHED:
            print(f"  shed   {t.request.request_id}: {t.shed_reason}")
        elif t.state == RequestState.FAILED:
            print(f"  failed {t.request.request_id}: {t.error}")
    bad = [t for t in tickets if t.state not in RequestState.TERMINAL]
    if bad:
        print(f"FAIL: {len(bad)} ticket(s) stranded non-terminal: "
              f"{[t.state for t in bad]}")
        return 1
    done = [t for t in tickets if t.state == RequestState.DONE]
    if not done:
        print("FAIL: chaos schedule starved the drain — nothing served")
        return 1
    # every served map against fault-free serving on the implementation
    # the engine ended on: bit for bit for int8 (integer arithmetic does
    # not depend on which wave or tile row a voxel rode in); float within
    # 1e-5 of the map's scale, since a voxel's fp32 sums may run in
    # another order in a tile of another shape
    ref_kw = dict(net_kw)
    if ref_kw["backend"] == "int8":
        ref_kw["int8_impl"] = engine.int8_impl
    ref = ReconEngine(**ref_kw)
    for t in done:
        want, = ref.reconstruct([t.request])
        same = (_maps_equal if args.backend == "int8" else _maps_close)
        if not same(t.result, want):
            print(f"FAIL: served maps diverge from healthy serving "
                  f"({t.request.request_id})")
            return 1
    print(f"served maps == healthy serving on {ref.int8_impl or 'float'}: "
          f"{'bit-exact' if args.backend == 'int8' else 'within 1e-5'} "
          f"({len(done)} requests)")
    if not oracle([t.request for t in done], [t.result for t in done]):
        return 1
    if args.expect_shed and states["shed"] == 0:
        print("FAIL: --expect-shed but the admission policy shed nothing")
        return 1
    if args.expect_degraded and not health["degraded"]:
        print("FAIL: --expect-degraded but the circuit breaker never "
              "tripped")
        return 1
    print("chaos smoke: clean drain, every ticket terminal")
    report = _report(args, cfg, engine, [engine, ref], requests,
                     [t.result for t in done], device)
    report.update(
        n_done=states["done"], n_failed=states["failed"],
        n_shed=states["shed"], waves=stats["n_waves"],
        retries=stats["n_retries"], inflight_depth=health["inflight_depth"],
        max_wave_voxels=health["max_wave_voxels"],
        chaos_tiles_by_impl=dict(engine.executor.tiles_by_impl),
        fired=injector.fired if injector is not None else [],
        failed_ids=[t.request.request_id for t in tickets
                    if t.state == RequestState.FAILED])
    print("serve_report " + json.dumps(report))
    return 0


def serve_mrf(args, cfg) -> int:
    """The MRF reconstruction family through the batched serving engine."""
    if args.backend not in ("float", "int8"):
        raise SystemExit(f"--backend {args.backend} is not an MRF serving "
                         f"backend (float | int8)")
    if args.artifact and args.backend != "int8":
        raise SystemExit("--artifact is an int8 deployment unit; it requires "
                         "--backend int8 (float would silently retrain)")
    if args.backend == "float" and args.int8_impl != "auto":
        raise SystemExit("--int8-impl selects the full-integer "
                         "implementation; it requires --backend int8")
    if args.requests < 1:
        raise SystemExit("--requests must be >= 1")
    device = resolve_device(args.device)

    ints_cpu = params = None
    if args.backend == "int8":
        ints, ints_cpu = _int8_artifact(args, cfg, device)
        in_dim = int(ints[0].w_q.shape[0])
        if in_dim != 2 * cfg.mrf_n_frames:
            raise SystemExit(f"artifact takes {in_dim} features; {cfg.name} "
                             f"has {cfg.mrf_n_frames} frames "
                             f"({2 * cfg.mrf_n_frames})")
        impl = None if args.int8_impl == "auto" else args.int8_impl
        net_kw = dict(backend="int8", int_layers=ints, int8_impl=impl,
                      device=device)
    else:
        params, _ = _train_mrf(args, cfg, device, qat_mode=False)
        net_kw = dict(backend="float", params=params, device=device)
    injector = admission = None
    if args.fault_schedule:
        injector = FaultInjector(json.loads(args.fault_schedule))
    if args.max_pending_voxels is not None or \
            args.shed_deadline_ms is not None:
        admission = AdmissionPolicy(max_pending_voxels=args.max_pending_voxels,
                                    deadline_ms=args.shed_deadline_ms)
    engine = ReconEngine(mode=args.serve_mode,
                         max_wave_voxels=args.max_wave_voxels,
                         max_wait_ms=args.max_wait_ms, admission=admission,
                         injector=injector, adaptive=args.adaptive,
                         wave_timeout_s=(args.wave_timeout_ms * 1e-3
                                         if args.wave_timeout_ms is not None
                                         else None), **net_kw)
    if args.backend == "int8":
        print(f"int8 impl: {engine.int8_impl} (requested {args.int8_impl}) "
              f"on {device}")

    # request pool: one phantom slice per request, distinct noise draws
    seq = default_sequence(cfg.mrf_n_frames)
    t1_map, t2_map, mask = make_phantom(args.phantom_n)
    requests = []
    for i in range(args.requests):
        gen = torch.Generator(device=device).manual_seed(i)
        feats, msk = acquire_slice(seq, t1_map, t2_map, mask, generator=gen,
                                   device=device)
        requests.append(ReconRequest(features=feats, mask=msk,
                                     request_id=f"slice-{i}"))
    vox = np.asarray(mask, bool)

    def oracle(reqs, results):
        return _check_oracle(args.backend, reqs, results, vox, ints_cpu,
                             params)

    if injector is not None or admission is not None:
        # no warm-up wave: it would consume fault-schedule wave indices and
        # pre-feed the admission service rate
        return _chaos_serve(args, cfg, engine, net_kw, requests, oracle,
                            injector, device)

    engines = [engine]

    engine.reconstruct(requests)  # warmup wave (builds and loads kernels)
    if args.serve_mode == "pipelined":
        # streaming admission: enqueue as slices "arrive", poll dispatches
        # due waves mid-stream, drain flushes the rest double-buffered
        tickets = []
        for r in requests:
            tickets.append(engine.enqueue(r))
            engine.poll()
        engine.drain()
        bad = [t for t in tickets if t.result is None]
        if bad:
            for t in bad:
                print(f"FAIL: request {t.request.request_id!r} "
                      f"{t.state}: {t.error}")
            return 1
        results = [t.result for t in tickets]
    else:
        results = engine.reconstruct(requests)
    wave = engine.last_wave
    pct = latency_percentiles(results)
    print(f"arch={cfg.name} backend={args.backend} mode={args.serve_mode} "
          f"requests={len(requests)} voxels={wave['total_voxels']} "
          f"waves={wave['n_waves']}")
    print(f"throughput: {wave['voxels_per_s']:.0f} voxels/s")
    print(f"latency: p50 {pct['p50_ms']:.3f} ms  p99 {pct['p99_ms']:.3f} ms")

    if args.serve_mode == "pipelined":
        # pipelining must be a pure scheduling change: same maps, bit-for-bit
        sync_engine = ReconEngine(**net_kw)
        engines.append(sync_engine)
        for got, want in zip(results, sync_engine.reconstruct(requests)):
            if not _maps_equal(got, want):
                print(f"FAIL: pipelined maps diverge from sync serving "
                      f"({got.request_id})")
                return 1
        print("pipelined == sync serving: bit-exact")
    for name, e in tissue_errors(results[0].t1_ms, results[0].t2_ms,
                                 t1_map, mask).items():
        print(f"  {name:6s}: T1 err {e['T1_err_%']:5.1f}%   "
              f"T2 err {e['T2_err_%']:5.1f}%")

    if not oracle(requests, results):
        return 1
    report = _report(args, cfg, engine, engines, requests, results, device)
    print("serve_report " + json.dumps(report))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True,
                    help="a dense LM (tinyllama-1.1b, granite-8b, "
                         "qwen2.5-14b, minitron-8b), an MoE LM "
                         "(deepseek-moe-16b, phi3.5-moe-42b-a6.6b), the SSM "
                         "LM mamba2-1.3b, the hybrid LM hymba-1.5b, the "
                         "encoder-decoder seamless-m4t-large-v2, the VLM "
                         "llava-next-34b or mrf-fpga | mrf-original")
    ap.add_argument("--backend", default="int8",
                    help="int8 (full-integer CUDA kernels, the default) or "
                         "float (a float net through the executor)")
    ap.add_argument("--int8-impl", default="auto",
                    choices=["auto", "fused", "layered", "lax"],
                    help="fused = whole-network CUDA kernel (auto), layered "
                         "= per-layer CUDA kernel chain, lax = plain "
                         "PyTorch; all bit-exact vs the qat.int_forward "
                         "oracle (checked)")
    ap.add_argument("--serve-mode", default="sync",
                    choices=["sync", "pipelined"],
                    help="sync = per-tile retirement baseline; pipelined = "
                         "double-buffered waves, one sync per wave "
                         "(bit-identical maps, checked)")
    ap.add_argument("--max-wave-voxels", type=int, default=None,
                    help="close a wave at this many voxels (default: one "
                         "wave per drain)")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="admission deadline from enqueue before a wave is "
                         "due (default: no deadline trigger)")
    ap.add_argument("--fault-schedule", default=None,
                    help="chaos: JSON list of serve.faults FaultSpec "
                         'dicts, e.g. \'[{"kind": "kernel_fail", '
                         '"wave": 0}]\' — switches to the chaos '
                         "accounting path")
    ap.add_argument("--max-pending-voxels", type=int, default=None,
                    help="chaos: admission budget — shed arrivals that "
                         "would push the pending backlog past this")
    ap.add_argument("--shed-deadline-ms", type=float, default=None,
                    help="chaos: shed arrivals whose estimated queue wait "
                         "exceeds this deadline")
    ap.add_argument("--adaptive", action="store_true",
                    help="tune the in-flight depth and the wave cap from "
                         "observed staging/compute (pipelined only)")
    ap.add_argument("--wave-timeout-ms", type=float, default=None,
                    help="count waves whose completion wait exceeds this "
                         "as stalls (health accounting)")
    ap.add_argument("--expect-shed", action="store_true",
                    help="chaos: fail unless load shedding engaged")
    ap.add_argument("--expect-degraded", action="store_true",
                    help="chaos: fail unless the int8 circuit breaker "
                         "tripped (fused B4 -> layered B5)")
    ap.add_argument("--artifact", default=None,
                    help="int8: serve this .npz artifact instead of "
                         "QAT-training one")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="steps of the in-process training (default 60 "
                         "with --smoke, else 600)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (16 frames; LM: 2 "
                         "layers, d_model 64)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM: prompt tokens a request")
    ap.add_argument("--gen-len", type=int, default=16,
                    help="LM: tokens generated a request")
    ap.add_argument("--phantom-n", type=int, default=32,
                    help="phantom slice side length")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "mrf":
        return serve_mrf(args, cfg)
    return serve_tokens(args, cfg)


if __name__ == "__main__":
    raise SystemExit(main())
