#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the CUDA kernels,
holds each against its plain PyTorch version, trains and serves MRF nets end
to end through ``repro_torch.launch.train`` / ``repro_torch.launch.serve``,
runs the paper's experiment through the port's examples, serves tokens from
tinyllama-1.1b, deepseek-moe-16b, phi3.5-moe, mamba2-1.3b, hymba-1.5b,
seamless-m4t-large-v2 and llava-next-34b at full width through
``repro_torch.launch.serve``, trains tinyllama-1.1b whole through
``repro_torch.launch.train``, then mamba2-1.3b, hymba-1.5b,
deepseek-moe-16b (4 layers), seamless-m4t-large-v2 and tinyllama-1.1b
under int8 QAT at full width, tinyllama-1.1b and the MoE, SSM, hybrid and
encoder-decoder models again on the sharded path (``torchrun ... --mesh
single``), and times the kernels.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (any failure raises, and the script exits non-zero without the
final result line):

1. device facts (name, capability, ``nvidia-smi`` name and power limit);
2. build the kernels from ``src/repro_torch/csrc`` with ``nvcc``, one
   process per source, started together;
2b. ``cuobjdump -sass``: the bf16 flash-attention kernel and both B6-bwd
   kernels (``flash_attn_bwd_dq_kernel``, ``flash_attn_bwd_dkdv_kernel``)
   must hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA) instructions, and
   B6-bwd no atomic (``ATOM*``, ``RED*``), the int8 kernels (B4, B5)
   ``IMMA`` (int8 tensor cores) and no ``IDP.4A`` (``__dp4a``);
3. the serving kernels (B4, B5) against their plain versions on identical
   tensors on the card (bit-exact: integer arithmetic): B4 at every bucket
   and at a whole wave (281,600 voxels) for mrf-fpga, mrf-original and a
   (256, 256, 32) net, with and without the denorm row; B5 at every layer
   shape of those nets at M=1,024 and at a whole wave, and at ragged
   shapes (K, N not multiples of 32 and 8) with every epilogue;
3a. the training data the card makes against the CPU's, on the same
   (T1, T2) arrays: fingerprints, features and targets within
   ``DATA_ATOL`` (``check_training_data``);
3b. the training kernel, one thread-block cluster (B1 one step, B2 K SGD
   steps, B3 K Adam steps), against its plain version at mrf-fpga and
   mrf-original full width, with and without QAT, at the cluster the
   wrapper picks and at every cluster size whose plan fits a block (losses
   and params atol 1e-5, Adam moments atol 1e-6 / rtol 1e-5; B1 also over
   the per-sample stream's 1,024 rows at tile 1, where with QAT the two
   runs part at the first int8 level flip, see ``held_stream``; B2 at the
   stream's own shape in phase 4e, 3 steps of 512 rows at tile 1 on one
   block, held the same way), a
   K=4 launch against 4 single-step launches, one launch over the stream
   against one launch per row and a launch against its repeat (bit for
   bit), a ragged tile of 127 rows and tiles of 4 rows on 8 blocks; the
   wrapper's launches at tile 128 ran on more than one block; B1 and B2 at
   tile 1 for mrf-fpga without QAT run on the per-sample kernel (tile 1,
   SGD, no QAT), which ``check_per_sample_path`` also holds at the stream
   cell's shape, 4 x 4,096 samples, row by row against the plain version,
   bit for bit across launch splits, every launch counted in
   ``per_sample_launches`` (``train_counters()["per_sample"]``);
3c. B6 (flash attention) against its plain version: bf16 on the Hopper
   kernel at its tiles, at the launcher's serving shape, granite-8b's dh
   128, deepseek-moe-16b's (16 query heads over 16 kv heads: group 1, dh
   128), hymba-1.5b's (25 query heads over 5 kv heads: group 5, dh 64)
   with its window of 1,024 and fully causal, seamless-m4t-large-v2's
   encoder (unmasked, S 512) and cross-attention (2,048 queries unmasked
   over 512 keys), a ragged cross case (200 queries over 50 keys, padded
   keys masked by ``kv_len``), llava-next-34b's (56 query heads over 8:
   group 7, dh 128, S 3,072), and small masked cases (``hold_b6_bf16``),
   f32 on the scalar kernel within atol 2e-5;
4. the serving path: a calibrated mrf-fpga int8 artifact (random He-uniform
   weights, QAT observer calibration on simulated fingerprints) served
   through the launcher — sync and pipelined via the fused kernel, sync via
   the layered kernel chain, and mrf-original via the fused kernel — each
   run checked bit for bit against the CPU integer oracle, with the kernels'
   launch counts read just before and after; a run whose report says
   ``degraded`` or counts a kernel failure fails (a circuit-breaker trip
   outside the chaos phase is a fault, never a quiet pass);
4a. the serving robustness layer through the launcher's chaos path
   (``chaos_phase``): mrf-fpga int8, fused, pipelined, adaptive, 16
   requests of one 256x256 slice (35,200 tissue voxels) under a pending-
   voxel budget of 8 slices and a wave cap of 2, with a fault schedule
   that fires every kind (``CHAOS_SCHEDULE``): every ticket ends in one
   terminal state, 8 are shed ``queue_full``, exactly the poisoned request
   fails, the breaker trips from B4 to B5, B4's launches equal the tiles
   served before the trip and B5's 7 x the tiles after it (the launcher's
   fault-free reference on B5 included), and every served map equals
   fault-free serving and the CPU integer oracle bit for bit; then a float
   run with one ``kernel_fail`` that has nothing to trip to and serves
   through the retry path;
4b. the training path through the launcher at full width, batch 256, tile
   128 — fused SGD and Adam chunked (50 steps per launch), fused SGD
   stepwise (B2 at K = 1, one launch a step), float, qat-int8 and fused
   mrf-original — each with its launch counts and a falling loss; chunked == stepwise and crash + restart ==
   uninterrupted (``engine.train``), bit for bit; and the paper's
   per-sample stream (``fused_train_step`` at tile 1);
4c. train, then serve: the serve launcher QAT-trains mrf-fpga
   (``SERVE_TRAIN_STEPS`` steps),
   exports and serves it through B4 bit-exact against the CPU oracle, and
   trains and serves a float net;
4d. token serving through the launcher at full width: tinyllama-1.1b (all
   22 layers, random weights from seed 0), 8 requests of 2,048-token
   prompts, 32 generated tokens, twice: 22 B6 launches per prefill (warm-up
   included), the same greedy tokens both times; then the kernel inside the
   model: one request's 256-token prompt (cut from 2,048 to keep the CPU
   side short) on the card and on a CPU copy of the same params (B6's
   plain version), each layer one step within ``LM_LAYER_ULPS`` bf16 ulps,
   the prefill's last-token logits within ``LM_LOGIT_ULPS``, greedy tokens
   equal wherever the margin exceeds twice that (``model_vs_cpu``); and
   where a prefill's and a decode step's device time goes, by kernel
   class, with the device's idle share (``lm_breakdown``, also for
   deepseek-moe-16b);
4e. the paper's experiment through the port's examples (``paper_phase``):
   ``examples/torch_quickstart.py`` (B4 and B5 bit-exact against the
   integer oracle), ``examples/torch_mrf_fpga_train.py`` — the per-sample
   stream chunked (B2 at tile 1), the minibatch at tile 128 stepwise (B2
   at K = 1), and the stream once more on the host CPU with the card's
   loop — and
   ``examples/torch_phantom_recon.py`` (every slice done, B4's launches
   equal to its tiles); each run with its exact launch counts;
4f. the MoE family: deepseek-moe-16b at full width through the launcher,
   twice (8 x 2,048-token prompts, 32 tokens; 56 B6 launches a run, the
   same tokens), phi3.5-moe at full width with 16 of its 32 layers once
   (32 B6 launches; ``moe_phase``); then deepseek's first two layers on
   the card against a CPU copy, routing compared first
   (``moe_vs_cpu``), and the MoE block's two forms timed at the prefill
   shape (``moe_forms``);
4g. the SSM and hybrid families (``ssm_phase``): mamba2-1.3b (48 layers,
   no attention: 0 B6 launches a run) and hymba-1.5b (32 layers, windows
   of 1,024 on all but layers 0, 16 and 31: 64 B6 launches a run) at full
   width through the launcher, twice each (8 x 2,048-token prompts, 32
   tokens, the same tokens both times, peak device memory in the
   report); then their first two layers on the card against a CPU copy
   (``layers_vs_cpu``: mamba2 on 600 tokens, padded to 768 by the scan,
   hymba on 1,152, its layer 1's window biting and its ring rotated):
   block outputs, the mixer's state and conv tails, the ring-aligned K
   and V and B6 on the layer's own q, k, v, then 4 decode steps of those
   layers; the SSD scan alone at the prefill shape (``ssd_time``);
   ``examples/torch_serve_batch.py`` at its defaults;
4h. the encoder-decoder and VLM families (``encdec_vlm_phase``), after
   phase 5's breakdowns of the earlier models, with no other model's
   params alive: seamless-m4t-large-v2 (24 encoder and 24 decoder layers)
   at full width through the launcher twice (8 x 2,048-token prompts
   beside 512 frames, 32 tokens: 144 B6 launches a run — encoder, decoder
   self- and cross-attention —, the same tokens), its first two encoder
   and decoder layers against a CPU copy (``encdec_vs_cpu``: block
   outputs, the self and cross K/V, B6 on each attention's own q, k, v, 4
   decode steps) and its breakdown; llava-next-34b (60 layers, 64.05 GiB
   of bf16 weights) at full width through the launcher once (4 x 3,072
   tokens, the first 2,880 positions its prefix embeddings, 32 tokens: 120
   B6 launches), its first two layers against a CPU copy on 1 x 3,072
   tokens (``layers_vs_cpu``, the prefix overwrite on the path) and its
   breakdown;
4i. LM training (``lm_train_phase``), with nothing else on the
   card: B6 with its per-row log-sum-exp (the output bit-equal to the
   launch without it, the lse within ``LSE_ATOL`` of the plain version's)
   and B6-bwd (``csrc/flash_attn_bwd.cu``) against its plain backward
   within ``ref.bwd_bounds`` at 9 cases (``bwd_cases``: tinyllama's
   training shape, group 1 and group 7 at dh 128, window 1,024 at group
   5, 2,048 queries unmasked over 512 keys, S 512 unmasked (seamless's
   encoder), ragged 200 over 50, a length
   of 300, dh 16), a launch equal to its repeat, the plain backward within
   ``PLAIN_BWD_RTOL`` of autograd through the plain forward, the bounds
   breaking on two planted faults (the causal mask dropped, dK not summed
   over the group), a float32 CUDA input under grad refused
   (``check_flash_attention_bwd``); tinyllama's first two layers at full
   width on 1 x 512 tokens, loss and every gradient leaf against a CPU
   copy (``lm_train_vs_cpu``); then tinyllama-1.1b whole through the
   launcher at 8 x 2,048 tokens a step, ``TRAIN_STEPS`` steps, twice —
   uninterrupted, and with a crash at step 3 restarted from the step-0
   checkpoint: the loss falls, 44 B6 and 22 B6-bwd launches a step, the
   steps before the crash repeat the first run's losses bit for bit and
   the restarted run ends on its losses and params bit for bit; then one
   step profiled by kernel class in a process of its own
   (``lm_train_breakdown``: B6, B6-bwd, the matrix products, everything
   else, and the idle share); ms a step,
   tokens/s, peak memory, the step's bound (``lm_step_work``) and the
   breakdown in an ``lm_train_run {json}`` line;
4j. the other families' training and LM QAT (``family_train_phase``),
   after 4i and its timings: each entry of ``FAMILY_TRAIN`` — mamba2-1.3b
   at 12 of 48 layers (a depth cut for the time limit) at 8 x 2,048 tokens,
   hymba-1.5b whole at 2 x 2,048 (no remat),
   deepseek-moe-16b at 4 of 28 layers at 8 x 2,048, seamless-m4t-large-v2
   whole at 5 x 2,048 beside 512 frames a sequence, tinyllama-1.1b with
   ``--quant qat-int8`` at 8 x 2,048 — through the launcher,
   ``FAMILY_STEPS`` steps, twice: the loss falls; B6 and B6-bwd counted
   from 0 just before each run, ``train_launches`` a step (0 and 0, 32 and
   32, 8 and 4, 144 and 72, 44 and 22); the second run repeats the first's
   losses and params digest bit for bit — for mamba2 with its step-0
   checkpoint (~5 GB at 12 layers) and a crash at step 2, restarted;
   the first runs write no checkpoint (``--ckpt-every 0``); each cut
   printed beside the run, with
   the memory a batch one larger would take; the first 2 layers of the
   MoE, SSM, hybrid and encoder-decoder models (2 + 2) against a CPU copy
   on 1 x 512 tokens (``lm_train_vs_cpu``: MoE routing flips counted, the
   card's recompute repeating its routing, the CPU then on the card's
   routing); one step of mamba2 and of deepseek profiled by kernel class
   (``lm_train_breakdown``, each in a process of its own); B6-bwd timed at
   the training shapes (``FAMILY_BWD_SHAPES``) beside its bound and SDPA's
   backward; an ``lm_train_run {json}`` line per entry;
4k. the sharded path (``mesh_phase``), after 4j: tinyllama-1.1b through
   ``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
   repro_torch.launch.train --mesh single`` (a process of its own, its
   counts from 0), ``TRAIN_STEPS`` steps at 8 x 2,048 tokens, twice: every
   state leaf a DTensor on the (1, 1) mesh, B6 and B6-bwd in
   ``local_map``; the losses and params digest equal 4i's run A bit for
   bit, 44 and 22 launches a step, the rerun bit for bit; ms a step and
   peak memory beside 4i's; B6, and B6 + B6-bwd under grad, at each dense
   arch's tp-2 and tp-4 local heads (``padded_heads``), the ranks' slices
   concatenated equal to one launch bit for bit; in a one-rank NCCL group
   made here, ``mrf-fpga`` fused (B2) and float through ``--mesh single``
   equal to their mesh-less runs bit for bit, and the executor's B4 and
   B5 maps under the mesh equal to the integer oracle; a ``mesh_run
   {json}`` line;
4l. the other families on the sharded path (``mesh_family_phase``), last:
   phase 4j's four non-QAT entries — mamba2-1.3b, hymba-1.5b,
   deepseek-moe-16b at its 4j depth (``--layers``), seamless-m4t-large-v2
   — each through ``torchrun --standalone --nproc-per-node 1 -m
   repro_torch.launch.train --mesh single`` with 4j's run A's arguments
   (its batch, ``FAMILY_STEPS`` steps, ``--ckpt-every 0``): every state
   leaf a DTensor on the (1, 1) mesh (the experts and SSM heads placed
   over ``model``, the MoE block and the SSM scan per rank in
   ``local_map``), every loss and the params digest equal to 4j's run A
   bit for bit, B6 and B6-bwd ``train_launches`` a step; ms a step,
   tokens/s and peak memory beside 4j's; then B6 and B6 + B6-bwd at
   hymba's (window and global), deepseek's and seamless's (self and
   cross) tp-2 and tp-4 local heads (``MESH_FAMILY_CASES``), the ranks'
   slices concatenated equal to one launch bit for bit; a
   ``mesh_family_run {json}`` line per family;
5. kernel times on the device (profiler, median of the launches it
   recorded, at least half of them) beside their bounds, their
   plain versions' device times and the wall time of one wrapper call
   between CUDA events; B4 and B5 at M=1,024 and at a whole wave, beside
   the device time of a one-element ``fill_`` (the launch floor); B1-B3
   also at each cluster size 1, 2, 4, 8, 16; B6 at the five prefill
   shapes, seamless's cross-attention and llava's group 7 beside SDPA (at
   hymba's window the band goes to SDPA as a boolean mask), and the float32
   B6 (scalar, on no main path) at the serving shape with B 1 beside SDPA
   in float32; then the breakdowns of phase 4d for tinyllama, deepseek,
   mamba2 and hymba (those of seamless and llava run in phase 4h); B6-bwd
   at tinyllama's training shape beside its bound, the two-kernel design's
   floor and SDPA's backward, and B6 with its log-sum-exp beside SDPA's
   forward under grad, after phase 4i.

Before them, ``chaos_run {json}`` records the chaos phase: states, waves,
retries, slow waves, the final depth and wave cap, voxels/s, p50/p99 and
both kernels' launches; ``eq3_run {json}`` the paper's Eq. 3 comparison
(``eq3_summary``); ``lm_train_run {json}`` phase 4i; ``mesh_run {json}``
phase 4k; ``mesh_family_run {json}`` phase 4l.  The last two lines
are ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.  Bounds use the card's published peaks
(``repro_torch.analysis.roofline.H100``; training's through
``repro_torch.core.fpga_cost_model``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# before CUDA starts: phase 4i trains with cuBLAS's deterministic workspace
# setting (``repro_torch.launch.train.CUBLAS_DETERMINISTIC``; on an H100 it
# is also cuBLAS's default size, so the other phases run as without it)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# and in expandable segments (``repro_torch.launch.train.ALLOC_CONF``):
# phase 4j's full-width steps do not fit in fixed ones
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = pathlib.Path(__file__).resolve().parent
# a Python that writes no bytecode (PYTHONDONTWRITEBYTECODE, a site-packages
# without __pycache__) compiles torch's sources again in every process:
# ~8 s of each child's start on the H100 host.  In a checkout, this process
# and the ones it starts keep their bytecode under build/ instead
if (ROOT / "src" / "repro_torch").is_dir():
    PYCACHE = str(ROOT / "build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.dont_write_bytecode, sys.pycache_prefix = False, PYCACHE

import torch  # noqa: E402

sys.path.insert(0, str(ROOT / "src"))

# the card's peaks (bytes/s, FLOP/s, SMs): ``repro_torch.analysis.roofline.H100``
REPS = 30
MARKER = "FillFunctor<short>"  # device_ms's marker, a one-element int16 fill_
DEVICE_EVENT_TRIES = 5      # profiler sessions before device_ms takes events
LEAD_S = 0.025              # device_events' lead: 25 ms of host time, x4 a retry
EVENT_TIMED = []            # device_ms's labels timed between CUDA events
TRAIN_REPS = 20             # training kernels: ms-long launches
BUCKETS = (128, 256, 512, 1024)
WAVE_VOXELS = 281_600       # a wave of 8 phantom slices of 256 x 256
DATA_ATOL = 1e-5            # training data, card vs CPU (phase 3d)
LM_ARCH = "tinyllama-1.1b"
MOE_ARCH = "deepseek-moe-16b"
MOE_WIDE = "phi3.5-moe-42b-a6.6b"
MOE_WIDE_LAYERS = 16        # of 32: full width, depth cut to fit one card
SSM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "hymba-1.5b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "llava-next-34b"
VLM_PROMPT = 3072           # 2,880 prefix embeddings + 192 text tokens
# card vs CPU, the mixer's f32 state: within this share of its largest
# magnitude (it is linear in the mixer's bf16 inputs, whose GEMMs round
# ~1 ulp apart on the two sides)
SSM_STATE_RTOL = 5e-2
# card vs CPU, deepseek-moe-16b: at most this share of a layer's (token,
# choice) pairs routed differently (a near-tie in the router meets the ~1
# bf16 ulp the two sides' attention outputs differ by); outputs are held
# only at tokens routed and dispatched alike
MOE_FLIP_SHARE = 0.05
MOE_INDEX_ULPS = 2          # index dispatch vs the dense one-hot, on the card
LM_LAYER_ULPS = 4           # card vs CPU, one layer on the same input
LM_LOGIT_ULPS = 8           # card vs CPU prefill logits after 22 layers
# B6 in bf16 against its plain version, element by element (``ref.bf16_ulps``):
# every element within one bf16 ulp of its own magnitude, and at most this
# share of the elements not bit-equal (a CPU emulation of the kernel's
# order reads ~5e-6; a planted fault 1.4e-2 or more: test_torch_flash_attn)
B6_MAX_ULPS = 1
B6_DIFFER_SHARE = 1e-3
# B6's log-sum-exp against its plain version's: the row's scores and its
# exp sums in other f32 orders move it by a few f32 ulps of ~10 (the
# largest |lse| at these lengths); a dropped kv tile moves it by log(1 +
# the tile's share of the row's sum)
LSE_ATOL = 1e-4
# B6-bwd's plain version against autograd through B6's plain forward, both
# float32: the same gradient, sums over up to ~14,000 rows in other orders
PLAIN_BWD_RTOL = 1e-4
# phase 4i, training through launch.train: steps of tinyllama-1.1b whole
TRAIN_STEPS = 5             # phase 4k repeats run A's steps on the mesh
# card vs CPU, tinyllama's first two layers at full width on 512 tokens:
# the loss (an f32 mean over 512 tokens of bf16 logits that differ by ~1
# ulp a layer; read 5.1e-5) and each gradient leaf within this many bf16
# ulps of its largest magnitude (each passes through the whole bf16
# backward, cuBLAS's and B6-bwd's sums in other orders than the CPU's;
# read 1.25; the CPU tests hold the port against JAX at 8,
# tests/test_torch_lm_train.py)
TRAIN_LOSS_RTOL = 5e-4
TRAIN_GRAD_ULPS = 4
# phase 4j, the other families' first two layers card vs CPU: each leaf
# within the tolerance the CPU tests hold the port to against the reference
# (``GRAD_ULPS`` of tests/test_torch_lm_train.py, two implementations' bf16
# sums in other orders): hymba's conv taps, sums over every token of small
# bf16 products without a recompute, read 4.5 where tinyllama reads 1.25
FAMILY_GRAD_ULPS = 8
# phase 4j: the MoE, SSM, hybrid and encoder-decoder families and LM QAT
# trained at full width through launch.train, 2,048 tokens a sequence,
# FAMILY_STEPS steps a run, twice: arch, layers (0: all), batch, --quant,
# the cut and why (the batch cut first, never the width).  A batch under
# 8 is where the search for the largest that fits starts (``fit_batch``)
FAMILY_STEPS = 3
FAMILY_SEQ = 2048
FAMILY_TRAIN = (
    (SSM_ARCH, 12, 8, None,
     "12 of 48 layers: the script's time limit, which phase 4l (this "
     "entry's run again under torchrun, at this depth) would pass with "
     "all 48"),
    (HYBRID_ARCH, 0, 2, None,
     "no remat, as the reference's unrolled stack: every layer's "
     "activations (the SSD scan's chunk tensors among them) are alive at "
     "once"),
    (MOE_ARCH, 4, 8, None,
     "4 of 28 layers: 16 bytes a parameter (f32 masters, grads, Adam's "
     "moments) are 270 GB for 28"),
    (ENCDEC_ARCH, 0, 5, None,
     "the 256,206-column logits (bf16, f32 and their gradients) grow with "
     "the batch"),
    (LM_ARCH, 0, 8, "qat-int8", "none"),
)
# B6-bwd timed at phase 4j's training shapes — key, the arch whose
# training batch B takes, (label, S or (Sq, Sk), Hq, Hkv, dh, causal,
# window), launches a step
FAMILY_BWD_SHAPES = (
    ("hymba_train", HYBRID_ARCH, ("hymba-1.5b: group 5, window 1,024", 2048,
                                  25, 5, 64, True, 1024), 32),
    ("deepseek_train", MOE_ARCH, ("deepseek-moe-16b: group 1 at dh 128",
                                  2048, 16, 16, 128, True, 0), 4),
    ("seamless_self_train", ENCDEC_ARCH,
     ("seamless-m4t-large-v2: decoder self-attention", 2048, 16, 16, 64,
      True, 0), 24),
    ("seamless_cross_train", ENCDEC_ARCH,
     ("seamless-m4t-large-v2: cross-attention", (2048, 512), 16, 16, 64,
      False, 0), 24),
    ("seamless_encoder_train", ENCDEC_ARCH,
     ("seamless-m4t-large-v2: encoder", 512, 16, 16, 64, False, 0), 24),
)
# the model shapes B6 is timed at beside the serving shape (phase 5)
B6_SHAPES = ("dh128", "deepseek", "hymba_window", "hymba_global",
             "seamless_cross", "llava", "f32")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


@contextlib.contextmanager
def took(what: str):
    """Log the host seconds the block took, as ``took: <what> <s> s``: the
    script's time limit is spent by part."""
    t0 = time.perf_counter()
    yield
    log(f"took: {what} {time.perf_counter() - t0:.1f} s")


def device_facts() -> tuple:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}  capability {cap[0]}.{cap[1]}  "
        f"count {torch.cuda.device_count()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(smi)
    return name, smi


def sass_functions(build, kernel: str, func: str) -> list:
    """``cuobjdump -sass`` of kernel library ``kernel``: the name and the
    machine code of each compiled function whose name holds ``func``."""
    lib = build.library_path(kernel)
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if func in f.splitlines()[0]]
    if not funcs:
        fail(f"cuobjdump finds no {func} in {lib}")
    return [(f.splitlines()[0][:90], f) for f in funcs]


def sass_counts(build, kernel: str, func: str, ops) -> list:
    """For each function of :func:`sass_functions`, its name and the count
    of each mnemonic in ``ops``."""
    return [(name, {op: text.count(op) for op in ops})
            for name, text in sass_functions(build, kernel, func)]


# an instruction's mnemonic: after its address and an optional predicate
SASS_OP = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9]*)")


def mnemonics(text: str) -> set:
    """The mnemonics of a function's instructions (``HGMMA`` of
    ``HGMMA.64x64x16.F32.BF16``)."""
    return set(SASS_OP.findall(text))


def atomic_ops(ops: set) -> set:
    """The atomic or reduction mnemonics (``ATOM*``, ``RED*`` but the warp
    reduction ``REDUX``) among ``ops``."""
    return {m for m in ops
            if m.startswith("ATOM") or (m.startswith("RED") and m != "REDUX")}


def check_sass(build) -> None:
    """Phase 2b: the machine code, through ``cuobjdump -sass``.  The bf16 B6
    kernel and both B6-bwd kernels must hold tensor-core products
    (``HGMMA``, from wgmma) and TMA loads (``UTMALDG``), and B6-bwd no
    atomic or reduction instruction (``ATOM*``, ``RED*``: its sums have one
    fixed order); B4 and B5 int8 tensor-core products (``IMMA``, from
    mma.sync m16n8k32 s8) and no ``IDP.4A`` (``__dp4a``) — or they are not
    the Hopper designs."""
    for name, n in sass_counts(build, "flash_attn_sm90",
                               "flash_attn_kernel_sm90",
                               ("HGMMA", "UTMALDG")):
        if not all(n.values()):
            fail(f"{name}: {n} (wgmma and TMA expected)")
    log(f"cuobjdump: flash_attn_kernel_sm90 holds HGMMA and UTMALDG ({n})")
    for func in ("flash_attn_bwd_dq_kernel", "flash_attn_bwd_dkdv_kernel"):
        found = sass_functions(build, "flash_attn_bwd", func)
        for name, text in found:
            # HGMMA and UTMALDG among the parsed mnemonics: the parse that
            # finds no atomic is shown to have read the instructions
            ops = mnemonics(text)
            n = {op: text.count(op) for op in ("HGMMA", "UTMALDG")}
            atomics = atomic_ops(ops)
            if not {"HGMMA", "UTMALDG"} <= ops or atomics:
                fail(f"{name}: {n}, {len(ops)} mnemonics parsed, atomics "
                     f"{sorted(atomics)} (wgmma and TMA, and no atomics, "
                     f"expected)")
        log(f"cuobjdump: {len(found)} {func} instances, each with HGMMA and "
            f"UTMALDG and no ATOM or RED ({n})")
    for kernel in ("qat_dense", "fused_forward"):
        found = sass_counts(build, kernel, f"{kernel}_kernel",
                            ("IMMA.16832.S8.S8", "IDP.4A"))
        for name, n in found:
            if not n["IMMA.16832.S8.S8"] or n["IDP.4A"]:
                fail(f"{name}: {n} (int8 tensor-core IMMA and no IDP.4A "
                     f"expected)")
        log(f"cuobjdump: {len(found)} {kernel}_kernel instances, each with "
            f"IMMA.16832.S8.S8 and no IDP.4A "
            f"({[n['IMMA.16832.S8.S8'] for _, n in found]} IMMA)")


def calibrated_net(hidden, seed: int, device):
    """Random He-uniform weights, observers calibrated on simulated
    fingerprints, exported to int8 — serving needs no trained net."""
    from repro_torch.core import mrf_net, qat
    from repro_torch.data.epg import default_sequence
    from repro_torch.data.pipeline import MRFSampleStream, sample_batch

    gen = torch.Generator(device=device).manual_seed(seed)
    params = mrf_net.init_params(gen, mrf_net.layer_sizes(32, hidden))
    qs = qat.init_qat_state(len(params), device=device)
    stream = MRFSampleStream(seq=default_sequence(32), batch_size=1024)
    for _ in range(5):
        x, _ = sample_batch(stream, gen)
        _, qs = qat.forward_qat(params, qs, x)
    return qat.export_int8(params, qs)


def exact(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
             f"{want.dtype}{tuple(want.shape)}")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"{what}: differs from its plain version (max abs err {err})")
    return err


def check_kernels(nets, device) -> dict:
    """Phase 3: B4 and B5 against their plain versions, bit-exact: B4 at
    every bucket and at a whole wave, with and without the denorm row; B5
    at every layer shape of each net at the largest bucket and at a whole
    wave, and at ragged shapes with every epilogue."""
    from repro_torch.kernels.qat_dense import fused, kernel, ops, ref

    errs = {"fused_forward": 0.0, "qat_dense": 0.0}
    drow = torch.tensor([4000.0, 600.0], device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    for arch, net in nets.items():
        for m in (*BUCKETS, WAVE_VOXELS):
            x = torch.randn((m, net.in_dim), generator=gen, device=device)
            for d in (drow, None):
                before = fused.fused_forward_call.launches
                got = fused.fused_forward_call(x, net, drow=d)
                want = ref.ref_fused_forward(x, net.s_in, net.packed,
                                             net.out_dim, drow=d)
                torch.cuda.synchronize()
                if fused.fused_forward_call.launches != before + 1:
                    fail("fused_forward launch counter did not advance")
                errs["fused_forward"] = max(errs["fused_forward"], exact(
                    got, want, f"fused_forward {arch} M={m} "
                               f"denorm={d is not None}"))
        # every layer shape of the net at the largest bucket, as served,
        # and at a whole wave
        for i in range(net.n_layers):
            w, b, s = net.packed[3 * i:3 * i + 3]
            last = i == net.n_layers - 1
            for m in (BUCKETS[-1], WAVE_VOXELS):
                xq = torch.randint(-128, 128, (m, w.shape[0]), generator=gen,
                                   device=device, dtype=torch.int8)
                before = kernel.qat_dense_call.launches
                got = kernel.qat_dense_call(xq, w, b, s, relu=not last,
                                            float_out=last)
                want = ref.ref_qat_dense(xq, w, b, s, relu=not last,
                                         float_out=last)
                torch.cuda.synchronize()
                if kernel.qat_dense_call.launches != before + 1:
                    fail("qat_dense launch counter did not advance")
                errs["qat_dense"] = max(errs["qat_dense"], exact(
                    got, want, f"qat_dense {arch} layer {i} "
                               f"{tuple(w.shape)} M={m}"))
    # ragged M/N/K edges (K, N not multiples of 32 and 8), every epilogue
    for m, k, n in ((130, 200, 300), (1, 4, 4), (33, 72, 20), (5, 37, 13)):
        xq = torch.randint(-128, 128, (m, k), generator=gen, device=device,
                           dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=device,
                          dtype=torch.int8)
        b = torch.randint(-2048, 2048, (n,), generator=gen, device=device,
                          dtype=torch.int32)
        s = torch.rand((n,), generator=gen, device=device) * 1e-2 + 1e-4
        for relu, float_out in ((True, False), (False, False), (False, True)):
            got = ops.qat_dense(xq, w, b, s, relu=relu, float_out=float_out)
            want = ref.ref_qat_dense(xq, w, b, s, relu=relu,
                                     float_out=float_out)
            torch.cuda.synchronize()
            errs["qat_dense"] = max(errs["qat_dense"], exact(
                got, want, f"qat_dense ragged {(m, k, n)} relu={relu} "
                           f"float_out={float_out}"))
    log(f"kernels == plain versions: bit-exact ({errs}; nets "
        f"{sorted(nets)}, M {(*BUCKETS, WAVE_VOXELS)})")
    return errs


def check_training_data(device) -> float:
    """Phase 3a: the training data the card makes, against the CPU's.
    ``simulate_fingerprints`` on 4,096 log-uniform (T1, T2) draws over the
    stream's ranges with T2 <= T1 (numpy, seed 0) plus the phantom's tissue
    values, ``to_features`` of the same signal and the targets ``t / hi``
    (``pipeline.targets``), on both devices from the same arrays: each
    within ``DATA_ATOL`` (the fingerprints are L2-normalised, so 1e-5 of
    their scale).  ``augment`` is left out: its noise comes from a device
    generator, which cannot agree across devices.  Returns the largest
    difference."""
    import numpy as np

    from repro_torch.data.epg import (default_sequence, simulate_fingerprints,
                                      to_features)
    from repro_torch.data.phantom import PHANTOM_T1T2_MS
    from repro_torch.data.pipeline import MRFSampleStream, targets

    stream = MRFSampleStream(seq=default_sequence(32), batch_size=4096)
    rng = np.random.default_rng(0)
    (lo1, hi1), (lo2, hi2) = stream.t1_range, stream.t2_range
    t1 = np.exp(rng.uniform(np.log(lo1), np.log(hi1), 4096))
    t2 = np.minimum(np.exp(rng.uniform(np.log(lo2), np.log(hi2), 4096)), t1)
    tissues = np.array(list(PHANTOM_T1T2_MS.values()))
    t1 = np.concatenate([t1, tissues[:, 0]]).astype(np.float32)
    t2 = np.concatenate([t2, tissues[:, 1]]).astype(np.float32)
    got, want = {}, {}
    for dev, into in ((device, got), (torch.device("cpu"), want)):
        a, b = torch.from_numpy(t1).to(dev), torch.from_numpy(t2).to(dev)
        sig = simulate_fingerprints(stream.seq, a, b, device=dev)
        into["fingerprints"] = torch.view_as_real(sig)
        into["features"] = to_features(sig)
        into["targets"] = targets(stream, a, b)
    errs = {}
    for key in want:
        g = got[key].cpu()
        if g.shape != want[key].shape or g.dtype != want[key].dtype:
            fail(f"training data {key}: card {g.dtype}{tuple(g.shape)} vs "
                 f"CPU {want[key].dtype}{tuple(want[key].shape)}")
        errs[key] = float((g.double() - want[key].double()).abs().max())
        if not math.isfinite(errs[key]) or errs[key] > DATA_ATOL:
            fail(f"training data {key}: card vs CPU max abs err "
                 f"{errs[key]} (limit {DATA_ATOL})")
    log(f"training data, card vs CPU ({t1.size} (T1, T2) pairs, "
        f"{stream.seq.n_frames} frames): max abs err {errs} "
        f"(limit {DATA_ATOL}; augment's noise left out)")
    return max(errs.values())


def serve(argv, expect: str = "oracle: bit-exact",
          chaos: bool = False) -> dict:
    """One launcher run with the kernels' counts reset just before it;
    returns its report plus the counts read just after.  ``expect``: the
    launcher's line that says its maps passed their check.  Outside the
    chaos phase a run that reports a kernel failure or a breaker trip
    fails."""
    from repro_torch.kernels.qat_dense import fused, kernel
    from repro_torch.launch import serve as launcher

    fused.fused_forward_call.launches = 0
    kernel.qat_dense_call.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(argv)
    counts = {"fused_forward": fused.fused_forward_call.launches,
              "qat_dense": kernel.qat_dense_call.launches}
    out = buf.getvalue()
    log(out.rstrip())
    if rc != 0:
        fail(f"launcher {' '.join(argv)} returned {rc}")
    lines = [ln for ln in out.splitlines() if ln.startswith("serve_report ")]
    if not lines or expect not in out:
        fail(f"launcher {' '.join(argv)}: no oracle check / report")
    report = json.loads(lines[-1].split(" ", 1)[1])
    report["launches"] = counts
    if not chaos and (report["degraded"] or report["n_kernel_failures"]):
        fail(f"launcher {' '.join(argv)}: degraded "
             f"{report['degraded']}, {report['n_kernel_failures']} kernel "
             f"failures outside the chaos phase")
    return report


def int8_launches(report, n_layers: int) -> dict:
    """The launches a run's tiles ask for: one B4 launch a fused tile, one
    B5 launch a layer of a layered tile."""
    tiles = report["tiles_by_impl"]
    return {"fused_forward": tiles.get("fused", 0),
            "qat_dense": tiles.get("layered", 0) * n_layers}


def serve_phase(tmp: pathlib.Path, device) -> dict:
    """Phase 4: the port's main path through the launcher; returns each
    kernel's launches summed over the runs."""
    from repro_torch.core import mrf_net, qat

    paths = {}
    for arch, hidden in (("mrf-fpga", mrf_net.ADAPTED_HIDDEN),
                         ("mrf-original", mrf_net.ORIGINAL_HIDDEN)):
        paths[arch] = qat.save_int8_artifact(
            tmp / f"{arch}_int8", calibrated_net(hidden, 0, device))
    base = ["--backend", "int8", "--device", "cuda", "--phantom-n", "256"]
    runs = [
        ("mrf-fpga", "fused", "sync", 8),
        ("mrf-fpga", "fused", "pipelined", 8),
        ("mrf-fpga", "layered", "sync", 8),
        ("mrf-original", "fused", "sync", 2),
    ]
    launches = {"fused_forward": 0, "qat_dense": 0}
    for arch, impl, mode, n_req in runs:
        rep = serve(["--arch", arch, *base, "--artifact", str(paths[arch]),
                     "--int8-impl", impl, "--serve-mode", mode,
                     "--requests", str(n_req)])
        want = int8_launches(rep, 7 if arch == "mrf-fpga" else 9)
        if rep["launches"] != want or set(rep["tiles_by_impl"]) != {impl}:
            fail(f"{arch} {impl} {mode}: launches {rep['launches']}, "
                 f"expected {want} for {rep['tiles']} tiles")
        for k, v in rep["launches"].items():
            launches[k] += v
        log(f"serve {arch} {impl} {mode}: {rep['voxels']} voxels, "
            f"{rep['voxels_per_s']} voxels/s, p50 {rep['p50_ms']} ms, "
            f"p99 {rep['p99_ms']} ms, {rep['tiles']} tiles, launches "
            f"{rep['launches']}")
    return launches


# every fault kind once: the transient dispatch fault sends wave 0's two
# slices to solo retries (waves 1 and 2), the kernel failure trips the
# breaker on wave 2 after wave 1 ran on B4, the timeout hits wave 3, whose
# slices are all fresh and retry alone, and slice-7 is poisoned at assembly
# (no retry there), so it alone fails
CHAOS_SCHEDULE = [{"kind": "dispatch_raise", "wave": 0},
                  {"kind": "kernel_fail", "wave": 2},
                  {"kind": "tile_timeout", "wave": 3},
                  {"kind": "slow_wave", "wave": 4},
                  {"kind": "assembly_corrupt", "request_id": "slice-7"}]
SLICE_VOXELS = 35_200       # tissue voxels of a 256 x 256 phantom slice


def chaos_phase(tmp: pathlib.Path, device) -> dict:
    """Phase 4a: the serving robustness layer through the launcher's chaos
    path at full mrf-fpga width; returns its record for ``chaos_run``."""
    from repro_torch.core import mrf_net, qat
    from repro_torch.serve.faults import FAULT_KINDS

    path = qat.save_int8_artifact(
        tmp / "chaos_int8", calibrated_net(mrf_net.ADAPTED_HIDDEN, 0, device))
    n_req, admitted = 16, 8
    rep = serve(["--arch", "mrf-fpga", "--backend", "int8", "--device",
                 "cuda", "--phantom-n", "256", "--artifact", str(path),
                 "--int8-impl", "fused", "--serve-mode", "pipelined",
                 "--requests", str(n_req),
                 "--max-wave-voxels", str(2 * SLICE_VOXELS),
                 "--max-pending-voxels", str(admitted * SLICE_VOXELS),
                 "--fault-schedule", json.dumps(CHAOS_SCHEDULE),
                 "--adaptive", "--wave-timeout-ms", "1000",
                 "--expect-shed", "--expect-degraded"], chaos=True)
    states = (rep["n_done"], rep["n_failed"], rep["n_shed"])
    if sum(states) != n_req or states != (admitted - 1, 1, n_req - admitted):
        fail(f"chaos: done/failed/shed {states}, expected "
             f"{(admitted - 1, 1, n_req - admitted)} of {n_req}")
    if rep["failed_ids"] != ["slice-7"]:
        fail(f"chaos: failed {rep['failed_ids']}, expected the poisoned "
             f"slice-7 alone")
    fired = {kind for _, kind in rep["fired"]}
    if fired != set(FAULT_KINDS):
        fail(f"chaos: fired {sorted(fired)}, expected every kind")
    if not rep["degraded"] or rep["n_kernel_failures"] != 1:
        fail(f"chaos: degraded {rep['degraded']}, "
             f"{rep['n_kernel_failures']} kernel failures; expected one trip")
    if rep["launches"] != int8_launches(rep, 7):
        fail(f"chaos: launches {rep['launches']} for tiles "
             f"{rep['tiles_by_impl']}")
    ours = rep["chaos_tiles_by_impl"]
    if min(ours.get("fused", 0), ours.get("layered", 0)) <= 0:
        fail(f"chaos: the engine's tiles by implementation {ours}: B4 must "
             f"serve before the trip and B5 after it")
    log(f"chaos: done/failed/shed {states}, {rep['waves']} waves, "
        f"{rep['retries']} retries, {rep['n_slow_waves']} slow, depth "
        f"{rep['inflight_depth']}, cap {rep['max_wave_voxels']}, "
        f"{rep['voxels_per_s']} voxels/s, p50 {rep['p50_ms']} ms, p99 "
        f"{rep['p99_ms']} ms, tiles {rep['tiles_by_impl']} (chaos engine "
        f"{ours}), launches {rep['launches']}")

    rep_f = serve(["--arch", "mrf-fpga", "--backend", "float", "--device",
                   "cuda", "--phantom-n", "64", "--requests", "4",
                   "--train-steps", "30", "--fault-schedule",
                   json.dumps([{"kind": "kernel_fail", "wave": 0}])],
                  expect="float engine == mrf_net.forward oracle", chaos=True)
    if (rep_f["degraded"] or rep_f["n_kernel_failures"] != 1
            or rep_f["retries"] < 1 or rep_f["n_done"] != 4
            or any(rep_f["launches"].values())):
        fail(f"chaos float: degraded {rep_f['degraded']}, "
             f"{rep_f['n_kernel_failures']} kernel failures, "
             f"{rep_f['retries']} retries, {rep_f['n_done']} done, launches "
             f"{rep_f['launches']}; expected the retry path, no trip")
    log(f"chaos float: kernel_fail took the retry path ({rep_f['retries']} "
        f"retries, {rep_f['n_done']} served, not degraded)")
    keep = ("n_done", "n_failed", "n_shed", "waves", "retries",
            "n_slow_waves", "inflight_depth", "max_wave_voxels",
            "voxels_per_s", "p50_ms", "p99_ms", "launches", "tiles_by_impl",
            "chaos_tiles_by_impl", "degraded", "n_kernel_failures", "fired")
    return {**{k: rep[k] for k in keep},
            "float_run": {k: rep_f[k] for k in (
                "n_done", "retries", "degraded", "n_kernel_failures")}}


class PerSampleCount:
    """``run_fused_train.per_sample_launches`` (the launches of the
    per-sample kernel: tile 1, SGD, no QAT, whichever wrapper made them)
    under the wrappers' ``launches`` name, to read and to reset."""

    @property
    def launches(self) -> int:
        from repro_torch.kernels.fused_train import kernel
        return kernel.run_fused_train.per_sample_launches

    @launches.setter
    def launches(self, n: int) -> None:
        from repro_torch.kernels.fused_train import kernel
        kernel.run_fused_train.per_sample_launches = n


def train_counters() -> dict:
    """The training kernel's wrappers (B1, B2, B3), each with its count,
    and ``per_sample``: how many of their launches took the per-sample
    kernel."""
    from repro_torch.kernels.fused_train import kernel, multistep

    return {"fused_train": kernel.fused_train_call,
            "fused_train_multistep": multistep.fused_train_multistep_call,
            "fused_train_adam": multistep.fused_train_adam_call,
            "per_sample": PerSampleCount()}


def max_err(got, want) -> float:
    from repro_torch.tree import leaves

    pairs = list(zip(leaves(got), leaves(want)))
    if len(pairs) != len(leaves(want)):
        fail("kernel and plain version return different structures")
    return max((float((a.double() - b.double()).abs().max())
                for a, b in pairs if b.numel()), default=0.0)


def bitequal(a, b, what: str) -> None:
    from repro_torch.tree import leaves

    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb) or not all(torch.equal(x, y)
                                     for x, y in zip(la, lb)):
        fail(f"{what}: not bit-identical (max abs err {max_err(a, b)})")


def training_data(device, steps: int, seed: int = 5):
    """``steps`` batches of 256 simulated mrf-fpga fingerprints, back to
    back: x (steps*256, 64), y (steps*256, 2)."""
    from repro_torch.data.epg import default_sequence
    from repro_torch.data.pipeline import MRFSampleStream, batch_at

    stream = MRFSampleStream(seq=default_sequence(32), batch_size=256)
    batches = [batch_at(stream, seed, s, device=device) for s in range(steps)]
    return (torch.cat([b["x"] for b in batches]),
            torch.cat([b["y"] for b in batches]))


def held_stream(train, x, y, flat, widths, lr: float, qat: bool,
                what: str) -> dict:
    """``train`` — one SGD update a row at tile 1, ``(x_row, y_row, params)
    -> (params, losses)`` — held row by row against the plain version
    (``ref.stream_divergence``): every update, taken from ``train``'s own
    net, within atol 1e-5, and the two runs side by side within atol 1e-5
    up to the first update whose int8 weight levels differ (without QAT:
    over the whole stream).  Returns the divergence record with ``err``,
    the largest error held against the limit."""
    from repro_torch.kernels.fused_train import ref

    div = ref.stream_divergence(train, x, y, flat, widths, lr=lr, qat=qat)
    if not qat and div["first_flip"] is not None:
        fail(f"{what}: int8 levels compared without QAT")
    div["err"] = max(div["local_err"], div["free_err"])
    if div["err"] > 1e-5:
        fail(f"{what}: max abs err vs plain {div['err']} > 1e-5 (one update "
             f"from the kernel's nets {div['local_err']}, side by side "
             f"before the first level flip {div['free_err']})")
    span = ("the whole stream" if div["first_flip"] is None else
            f"update {div['first_flip']}, the first int8 level flip")
    log(f"{what}, {x.shape[0]} samples: one update from each of the "
        f"kernel's nets within {div['local_err']:.3g} of the plain version; "
        f"side by side within {div['free_err']:.3g} up to {span}; at the "
        f"end {div['flipped']} levels differ, max abs err "
        f"{div['end_err']:.3g}")
    return div


def check_sample_stream(x, y, flat, widths, qat: bool, what: str) -> float:
    """B1 at the per-sample stream's shape (all rows of x, tile 1) held row
    by row against the plain version (``held_stream``); the run as one
    launch bit-equals its repeat and one launch per row.  Returns the
    largest error held against the limit."""
    from repro_torch.kernels.fused_train import kernel

    counter = train_counters()["fused_train"]
    before = counter.launches

    def b1(xr, yr, p):
        return kernel.fused_train_call(xr, yr, p, widths=widths, lr=1e-2,
                                       tile_batch=1, qat=qat)

    got, again = b1(x, y, flat), b1(x, y, flat)
    div = held_stream(b1, x, y, flat, widths, 1e-2, qat, what)
    torch.cuda.synchronize()
    if counter.launches != before + 2 + x.shape[0]:
        fail(f"{what}: launch counter did not advance per launch")
    bitequal(again, got, f"{what}, two identical launches")
    bitequal((div["params"], div["losses"]), got,
             f"{what}: one launch vs {x.shape[0]} one-row launches")
    return div["err"]


def hold_multistep(what, params, x, y, per_step, optimizer, qat, cluster,
                   tile_batch=128) -> float:
    """B2 (SGD) or B3 (Adam) over ``x``/``y`` as K steps of ``per_step``
    rows in one launch against the plain version (params and losses atol
    1e-5, Adam's moments atol 1e-6 / rtol 1e-5), then bit for bit against K
    single-step launches and against its repeat.  At tile 1 (SGD, the
    per-sample stream) the launch is held row by row as B1 is
    (``held_stream``, one one-row launch a row: with QAT the two runs part
    at the first int8 level flip) and bit for bit against those one-row
    launches.  Returns the max abs error."""
    from repro_torch.kernels.fused_train import kernel, multistep, ops, ref
    from repro_torch.optim import adam

    name = "fused_train_adam" if optimizer == "adam" else \
        "fused_train_multistep"
    counter = train_counters()[name]
    k_steps = x.shape[0] // per_step
    tile = ops.effective_tile(per_step, tile_batch)

    def fresh():
        return adam(1e-3).init(params) if optimizer == "adam" else None

    def run(p, s, xs, ys, n):
        return ops.fused_train_multistep(
            p, s, xs, ys, n_steps=n, lr=1e-3, optimizer=optimizer,
            tile_batch=tile_batch, qat=qat, cluster=cluster)

    def one_row(xr, yr, p):
        return multistep.fused_train_multistep_call(
            xr, yr, p, widths=widths, lr=1e-3, tile_batch=1, qat=qat,
            cluster=cluster)

    before = counter.launches
    got_p, got_s, got_l = run(params, fresh(), x, y, k_steps)
    flat, widths = ops.pack_params(params)
    row_launches = 0
    if tile == 1:
        if optimizer != "sgd":
            fail(f"{what}: tile 1 is held for SGD only")
        div = held_stream(one_row, x, y, flat, widths, 1e-3, qat, what)
        bitequal((div["params"], div["losses"]),
                 (ops.pack_params(got_p)[0], got_l.reshape(-1)),
                 f"{what}: one launch vs {x.shape[0]} one-row launches")
        err, row_launches = div["err"], x.shape[0]
    else:
        moments = step0 = None
        if optimizer == "adam":
            moments = (torch.zeros_like(flat), torch.zeros_like(flat))
            step0 = torch.zeros((1,), dtype=torch.int32, device=x.device)
        want_p, want_mu, want_nu, want_l = ref.fused_train_plain(
            x, y, flat, widths, lr=1e-3, tile_batch=tile, qat=qat,
            moments=moments, step0=step0)
        err = max_err((ops.pack_params(got_p)[0], got_l.reshape(-1)),
                      (want_p, want_l))
        if err > 1e-5:
            fail(f"{what}: params/losses max abs err {err} > 1e-5")
        if optimizer == "adam":
            for got_m, want_m in ((got_s.mu, want_mu), (got_s.nu, want_nu)):
                packed = ops.pack_params(got_m)[0]
                if not torch.allclose(packed, want_m, atol=1e-6, rtol=1e-5):
                    fail(f"{what}: moments beyond atol 1e-6, rtol 1e-5 "
                         f"(max abs err {max_err(packed, want_m)})")
                err = max(err, max_err(packed, want_m))
            if int(got_s.step) != k_steps * (per_step // tile):
                fail(f"{what}: Adam step {int(got_s.step)}")
    seq_p, seq_s, rows = params, fresh(), []
    for k in range(k_steps):
        sl = slice(per_step * k, per_step * (k + 1))
        seq_p, seq_s, tl = run(seq_p, seq_s, x[sl], y[sl], 1)
        rows.append(tl[0])
    again = run(params, fresh(), x, y, k_steps)
    torch.cuda.synchronize()
    if counter.launches != before + 2 + k_steps + row_launches:
        fail(f"{what}: launch counter did not advance per launch")
    want_c = kernel.cluster_size(tile, widths) if cluster is None else cluster
    if kernel.run_fused_train.last_cluster != want_c:
        fail(f"{what}: launched cluster {kernel.run_fused_train.last_cluster}"
             f", expected {want_c}")
    bitequal((seq_p, seq_s, torch.stack(rows)), (got_p, got_s, got_l),
             f"{what} vs {k_steps} single steps")
    bitequal(again, (got_p, got_s, got_l), f"{what}, two identical launches")
    return err


def check_training_kernels(device) -> dict:
    """Phase 3b: B1, B2 and B3 against the plain version at full width, at
    the cluster the wrapper picks and at every cluster size whose plan fits
    a block (1, 2, 4, 8 and the non-portable 16), with and without QAT;
    K=4 in one launch bit-equals 4 single-step launches, and a launch
    bit-equals its repeat; a ragged tile of 127 rows and a tile of 4 rows
    on 8 blocks; the launches at tile 128 ran on more than one block.
    Returns each kernel's max abs error."""
    from repro_torch.core import mrf_net
    from repro_torch.kernels.fused_train import kernel, ops, ref

    counters = train_counters()
    errs = {name: 0.0 for name in counters if name != "per_sample"}
    x, y = training_data(device, 4)
    clusters_held = {}
    for arch, hidden in (("mrf-fpga", mrf_net.ADAPTED_HIDDEN),
                         ("mrf-original", mrf_net.ORIGINAL_HIDDEN)):
        gen = torch.Generator(device=device).manual_seed(3)
        params = mrf_net.init_params(gen, mrf_net.layer_sizes(32, hidden))
        flat, widths = ops.pack_params(params)
        sizes = kernel.cluster_sizes(128, widths)
        clusters_held[arch] = sizes
        for qat in (False, True):
            want_p, _, _, want_l = ref.fused_train_plain(
                x[:256], y[:256], flat, widths, lr=1e-2, tile_batch=128,
                qat=qat)
            for cluster in (None, *sizes):
                # B1 at tile 128, two tiles of 128 against the plain version
                what = f"B1 {arch} tile 128 qat={qat} cluster={cluster}"
                before = counters["fused_train"].launches
                got = kernel.fused_train_call(x[:256], y[:256], flat,
                                              widths=widths, lr=1e-2,
                                              tile_batch=128, qat=qat,
                                              cluster=cluster)
                launched = kernel.run_fused_train.last_cluster
                again = kernel.fused_train_call(x[:256], y[:256], flat,
                                                widths=widths, lr=1e-2,
                                                tile_batch=128, qat=qat,
                                                cluster=cluster)
                torch.cuda.synchronize()
                if counters["fused_train"].launches != before + 2:
                    fail(f"{what}: launch counter did not advance")
                if cluster is None and launched <= 1:
                    fail(f"{what}: the wrapper launched one block")
                err = max_err(got, (want_p, want_l))
                if err > 1e-5:
                    fail(f"{what}: max abs err {err} vs plain > 1e-5")
                bitequal(again, got, f"{what}, two identical launches")
                errs["fused_train"] = max(errs["fused_train"], err)
            err = check_sample_stream(x, y, flat, widths, qat,
                                      f"B1 {arch} tile 1 qat={qat}")
            errs["fused_train"] = max(errs["fused_train"], err)
            # B2 / B3: K=4 steps of 256 at tile 128 in one launch
            for cluster in (None, *sizes):
                for optimizer, name in (("sgd", "fused_train_multistep"),
                                        ("adam", "fused_train_adam")):
                    what = (f"{name} {arch} K=4 qat={qat} cluster={cluster}")
                    err = hold_multistep(what, params, x, y, 256, optimizer,
                                         qat, cluster)
                    if cluster is None and \
                            kernel.run_fused_train.last_cluster <= 1:
                        fail(f"{what}: the wrapper launched one block")
                    errs[name] = max(errs[name], err)
    # a ragged tile (254 rows a step: tile 127, the last block 15 rows) and
    # tiles of 4 rows on 8 blocks (4 take none), mrf-fpga
    gen = torch.Generator(device=device).manual_seed(3)
    params = mrf_net.init_params(gen, mrf_net.layer_sizes(32))
    for optimizer, name in (("sgd", "fused_train_multistep"),
                            ("adam", "fused_train_adam")):
        for what, per_step, tile_batch, cluster in (
                ("ragged tile 127", 254, 128, None),
                ("tile 4 on 8 blocks", 8, 4, 8)):
            rows = 3 * per_step
            err = hold_multistep(f"{name} mrf-fpga K=3 {what}", params,
                                 x[:rows], y[:rows], per_step, optimizer,
                                 False, cluster, tile_batch=tile_batch)
            errs[name] = max(errs[name], err)
    # B2 at the per-sample stream's own shape (phase 4e runs it chunked):
    # steps of 512 rows at tile 1 on one block, with and without QAT
    xs, ys = training_data(device, 6, seed=8)
    for qat in (False, True):
        err = hold_multistep(
            f"fused_train_multistep mrf-fpga K=3 x 512 tile 1 qat={qat}",
            params, xs, ys, 512, "sgd", qat, None, tile_batch=1)
        errs["fused_train_multistep"] = max(errs["fused_train_multistep"],
                                            err)
    errs["fused_train_multistep"] = max(errs["fused_train_multistep"],
                                        check_per_sample_path(device))
    log(f"training kernels == plain versions within atol 1e-5 at clusters "
        f"{clusters_held} and the wrapper's own; K-step == K single-step "
        f"launches and repeats bit-exact ({errs})")
    return errs


def check_per_sample_path(device) -> float:
    """Phase 3b: the per-sample kernel at the stream cell's shape, mrf-fpga
    at tile 1 (SGD, no QAT): 4 steps of 4,096 samples in one launch (B2),
    bit for bit against 4 single-step launches, against its repeat and
    against one launch a row; every update, taken from the kernel's own
    net, and the two runs side by side held against the plain version
    (``held_stream``, params and losses atol 1e-5; the plain version on a
    CPU copy, for its pace); ``per_sample_launches`` equal to the launches
    made.  Returns the largest error held against the limit."""
    from repro_torch.core import mrf_net
    from repro_torch.kernels.fused_train import kernel, multistep, ops

    widths = mrf_net.layer_sizes(32)
    if not kernel.takes_per_sample_path(widths, 1, qat=False, adam=False,
                                        cluster=None):
        fail(f"mrf-fpga at tile 1 does not take the per-sample kernel: "
             f"{kernel.per_sample_schedule(tuple(widths)).why}")
    gen = torch.Generator(device=device).manual_seed(11)
    flat, _ = ops.pack_params(mrf_net.init_params(gen, widths))
    x, y = training_data(device, 64, seed=12)  # 16,384 samples
    per_step, lr = 4096, 1e-4  # the stream cell's step and rate
    counter = train_counters()["per_sample"]
    before = counter.launches

    def launch(xs, ys, p):
        return multistep.fused_train_multistep_call(
            xs, ys, p, widths=widths, lr=lr, tile_batch=1)

    got = launch(x, y, flat)
    again = launch(x, y, flat)
    p, losses = flat, []
    for k in range(x.shape[0] // per_step):
        sl = slice(per_step * k, per_step * (k + 1))
        p, tile_losses = launch(x[sl], y[sl], p)
        losses.append(tile_losses)
    torch.cuda.synchronize()
    bitequal(again, got, "per-sample kernel, two identical launches")
    bitequal((p, torch.cat(losses)), got,
             "per-sample kernel, a 4-step launch vs 4 single-step launches")

    def one_row(xr, yr, p_cpu):
        new, loss = launch(xr.to(device), yr.to(device), p_cpu.to(device))
        return new.cpu(), loss.cpu()

    div = held_stream(one_row, x.cpu(), y.cpu(), flat.cpu(), widths, lr,
                      False, "per-sample kernel mrf-fpga 4 x 4,096 tile 1")
    bitequal((div["params"], div["losses"]),
             (got[0].cpu(), got[1].cpu()),
             f"per-sample kernel: one launch vs {x.shape[0]} one-row "
             f"launches")
    made = 2 + x.shape[0] // per_step + x.shape[0]
    if counter.launches != before + made:
        fail(f"per_sample_launches advanced by {counter.launches - before}"
             f", {made} launches made")
    if kernel.run_fused_train.last_cluster != 1:
        fail(f"per-sample kernel: last_cluster "
             f"{kernel.run_fused_train.last_cluster}")
    log(f"per-sample kernel (mrf-fpga, tile 1, 4 x 4,096 samples): max abs "
        f"err {div['err']:.3g} vs plain, bit-equal across launch splits, "
        f"{made} launches counted")
    return div["err"]


def train(argv) -> dict:
    """One training-launcher run with the training kernel's counts reset
    just before it; returns its report plus the counts read just after.
    Fails unless the run ends with a finite loss below its first logged
    loss."""
    from repro_torch.launch import train as launcher

    counters = train_counters()
    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(argv)
    counts = {name: c.launches for name, c in counters.items()}
    out = buf.getvalue()
    lines = out.splitlines()
    log("\n".join(lines[:1] + lines[-3:]))
    if rc != 0:
        fail(f"train launcher {' '.join(argv)} returned {rc}")
    if not lines or not lines[-1].startswith("train_report "):
        fail(f"train launcher {' '.join(argv)}: no report")
    report = json.loads(lines[-1].split(" ", 1)[1])
    first, last = report["first_loss"], report["last_loss"]
    if not (last is not None and math.isfinite(last) and last < first):
        fail(f"train launcher {' '.join(argv)}: loss {first} -> {last} did "
             f"not fall to a finite value")
    report["launches"] = counts
    return report


def train_phase(tmp: pathlib.Path, device) -> tuple:
    """Phase 4b: the training path at full width; returns (each kernel's
    launches summed over the runs, the runs' reports)."""
    from repro_torch.configs import get_config
    from repro_torch.core import mrf_net
    from repro_torch.ft.runner import RunnerConfig
    from repro_torch.kernels.fused_train import ops
    from repro_torch.models.mrf import build_mrf
    from repro_torch.train import engine

    base = ["--device", "cuda", "--batch", "256", "--lr", "1e-3"]
    fused = ["--backend", "fused", "--tile-batch", "128"]
    runs = [
        ("mrf-fpga fused sgd chunked", ["--arch", "mrf-fpga", *fused,
         "--optimizer", "sgd", "--steps", "200", "--chunk-steps", "50"],
         {"fused_train_multistep": 4}),
        ("mrf-fpga fused adam chunked", ["--arch", "mrf-fpga", *fused,
         "--optimizer", "adam", "--steps", "200", "--chunk-steps", "50"],
         {"fused_train_adam": 4}),
        ("mrf-fpga fused sgd stepwise", ["--arch", "mrf-fpga", *fused,
         "--optimizer", "sgd", "--steps", "20"],
         {"fused_train_multistep": 20}),  # B2 at K = 1, one a step
        ("mrf-fpga float adam", ["--arch", "mrf-fpga", "--backend", "float",
         "--steps", "100"], {}),
        ("mrf-fpga qat-int8 adam", ["--arch", "mrf-fpga", "--backend",
         "qat-int8", "--steps", "100"], {}),
        ("mrf-original fused sgd chunked", ["--arch", "mrf-original", *fused,
         "--optimizer", "sgd", "--steps", "50", "--chunk-steps", "50"],
         {"fused_train_multistep": 1}),
    ]
    launches = {name: 0 for name in train_counters()}
    reports = []
    for i, (label, argv, want) in enumerate(runs):
        rep = train([*argv, *base, "--ckpt-dir", str(tmp / f"train_{i}")])
        want = {name: want.get(name, 0) for name in launches}
        if rep["launches"] != want:
            fail(f"{label}: launches {rep['launches']}, expected {want}")
        for name, n in rep["launches"].items():
            launches[name] += n
        rep["run"] = label
        reports.append(rep)
        log(f"train {label}: {rep['samples_per_s']:.1f} samples/s, loss "
            f"{rep['first_loss']:.6f} -> {rep['last_loss']:.6f}, launches "
            f"{rep['launches']}")

    # the paper's per-sample stream: one B1 launch over 1,024 samples
    counters = train_counters()
    for c in counters.values():
        c.launches = 0
    gen = torch.Generator(device=device).manual_seed(4)
    params = mrf_net.init_params(gen, mrf_net.layer_sizes(32))
    x, y = training_data(device, 4, seed=6)
    t0 = time.perf_counter()
    _, losses = ops.fused_train_step(params, x, y, lr=1e-2, tile_batch=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    head, tail = float(losses[:256].mean()), float(losses[-256:].mean())
    if counters["fused_train"].launches != 1 or \
            counters["per_sample"].launches != 1 or not tail < head:
        fail(f"per-sample stream: {counters['fused_train'].launches} B1 "
             f"launches ({counters['per_sample'].launches} per-sample), "
             f"mean loss {head} -> {tail}")
    launches["fused_train"] += 1
    launches["per_sample"] += 1
    log(f"train per-sample stream (fused_train_step, tile 1): 1024 samples "
        f"in {wall * 1e3:.3f} ms, mean loss {head:.6f} -> {tail:.6f}")

    # chunked == stepwise and crash + restart == uninterrupted, on the card
    fns = build_mrf(get_config("mrf-fpga"))
    for optimizer in ("sgd", "adam"):
        finals = {}
        for mode, chunk, inject in (("stepwise", 1, None),
                                    ("chunked", 5, None),
                                    ("crash+restart", 5, 13)):
            cfg = engine.EngineConfig(backend="fused", lr=1e-3,
                                      optimizer=optimizer, tile_batch=128,
                                      chunk_steps=chunk)
            rcfg = RunnerConfig(total_steps=20, ckpt_dir=str(
                tmp / f"pair_{optimizer}_{mode}"), ckpt_every=10,
                inject_fault_at=inject)
            state, step, _ = engine.train(fns, cfg, rcfg, seed=7,
                                          batch_size=256, device=device)
            if step != 20:
                fail(f"fused {optimizer} {mode}: stopped at step {step}")
            finals[mode] = state
        bitequal(finals["chunked"], finals["stepwise"],
                 f"fused {optimizer}: chunked vs stepwise, 20 steps")
        bitequal(finals["crash+restart"], finals["chunked"],
                 f"fused {optimizer}: crash at 13 + restart vs uninterrupted")
        log(f"train fused {optimizer}: chunked == stepwise and crash + "
            f"restart == uninterrupted, bit for bit (20 steps)")
    return launches, reports


# phase 4c's training before it serves (the launcher's default is 600): the
# served maps are held against the oracle of whatever net was trained
SERVE_TRAIN_STEPS = 200


def train_then_serve(device) -> int:
    """Phase 4c: the serve launcher trains its own nets and serves them;
    returns B4's launches."""
    base = ["--arch", "mrf-fpga", "--device", "cuda", "--phantom-n", "256",
            "--requests", "8", "--train-steps", str(SERVE_TRAIN_STEPS)]
    rep = serve([*base, "--backend", "int8"])
    if rep["launches"] != {"fused_forward": rep["tiles"], "qat_dense": 0}:
        fail(f"train+serve int8: launches {rep['launches']} for "
             f"{rep['tiles']} tiles")
    log(f"train+serve int8 ({SERVE_TRAIN_STEPS} QAT steps): "
        f"{rep['voxels_per_s']} voxels/s, "
        f"p50 {rep['p50_ms']} ms, launches {rep['launches']}")
    rep_f = serve([*base, "--backend", "float"],
                  expect="float engine == mrf_net.forward oracle")
    if rep_f["launches"] != {"fused_forward": 0, "qat_dense": 0}:
        fail(f"train+serve float launched int8 kernels: {rep_f['launches']}")
    log(f"train+serve float ({SERVE_TRAIN_STEPS} steps): "
        f"{rep_f['voxels_per_s']} voxels/s, "
        f"p50 {rep_f['p50_ms']} ms")
    return rep["launches"]["fused_forward"]


EQ3_SAMPLES = 250_000_000  # the paper's training run (Eq. 3)


def example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mrf_counters() -> dict:
    """Every kernel wrapper of the MRF path (B1-B5), each with its count."""
    from repro_torch.kernels.qat_dense import fused, kernel

    return {**train_counters(), "fused_forward": fused.fused_forward_call,
            "qat_dense": kernel.qat_dense_call}


def run_example(name: str, argv, want: dict | None) -> tuple:
    """One example's ``main(argv)`` with the MRF kernels' counts reset just
    before it; fails on a non-zero exit or unless the counts read just
    after are ``want`` (0 for a kernel not named; ``None``: not checked
    here).  Returns (its lines, the counts)."""
    counters = mrf_counters()
    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = example(name).main(argv)
    counts = {k: c.launches for k, c in counters.items()}
    lines = buf.getvalue().splitlines()
    what = f"examples/{name}.py {' '.join(argv)}"
    if rc != 0:
        log("\n".join(lines[-20:]))
        fail(f"{what} exited {rc}")
    if want is not None and counts != {k: want.get(k, 0) for k in counters}:
        fail(f"{what}: launches {counts}, expected {want}")
    log(f"{what}: {time.perf_counter() - t0:.1f} s, launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    return lines, counts


def report_of(lines, tag: str, what: str) -> dict:
    found = [ln for ln in lines if ln.startswith(tag + " ")]
    if not found:
        fail(f"{what}: no {tag} line")
    return json.loads(found[-1].split(" ", 1)[1])


def paper_phase() -> tuple:
    """Phase 4e: the paper's experiment through the port's examples.

    * ``torch_quickstart``: QAT training, export, Table 1, and the int8 net
      through B4 (one launch) and B5 (one a layer, 7) — both lines must
      read bit-exact against the integer oracle;
    * ``torch_mrf_fpga_train``: the per-sample stream (tile 1) chunked, 60
      steps of 512 in chunks of 20 (3 B2 launches: the runner's
      checkpoints every 20 steps end the chunks), and the minibatch at tile
      128 stepwise, 300 steps of 512 (300 B2 launches at K = 1); each loss
      must fall; then the stream again on the host CPU (``--device cpu``,
      the kernel's plain version) with the card's loop — the same steps,
      chunks and checkpoints — for the CPU's rate;
    * ``torch_phantom_recon``: 200 QAT steps, 4 slices streamed through the
      pipelined engine on B4, every slice ``done``.

    Returns (each kernel's launches over the runs, the training runs'
    ``eq3_report`` by run)."""
    launches = {k: 0 for k in mrf_counters()}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    lines, counts = run_example("torch_quickstart", ["--device", "cuda"],
                                {"fused_forward": 1, "qat_dense": 7})
    exact = [ln.strip() for ln in lines if "qat.int_forward == " in ln]
    if exact != ["qat.int_forward == B4 (fused kernel): True",
                 "qat.int_forward == B5 (layered kernel chain): True"]:
        fail(f"quickstart: {exact}")
    log("\n".join(ln for ln in lines
                   if "MAPE" in ln or "qat.int_forward ==" in ln))
    add(counts)

    runs = {}
    stream = ["--mode", "stream", "--steps", "60", "--chunk-steps", "20"]
    for key, argv, want in (
            ("stream", [*stream, "--device", "cuda"],
             {"fused_train_multistep": 3, "per_sample": 3}),
            ("minibatch", ["--mode", "minibatch", "--steps", "300",
                           "--device", "cuda"], {"fused_train_multistep": 300}),
            ("stream on the host CPU", [*stream, "--device", "cpu"], {})):
        lines, counts = run_example("torch_mrf_fpga_train", argv, want)
        rep = report_of(lines, "eq3_report", f"mrf_fpga_train {key}")
        first, last = rep["first_loss"], rep["last_loss"]
        if not (math.isfinite(last) and last < first):
            fail(f"mrf_fpga_train {key}: loss {first} -> {last}")
        log("\n".join(lines[-6:-1]))
        rep["launches"] = {k: n for k, n in counts.items() if n}
        runs[key] = rep
        add(counts)

    lines, counts = run_example(
        "torch_phantom_recon", ["--device", "cuda", "--train-steps", "200"],
        None)
    rep = report_of(lines, "phantom_report", "phantom_recon")
    want = {"fused_forward": rep["tiles_by_impl"].get("fused", 0)}
    if rep["n_done"] != rep["slices"] or rep["states"] != ["done"] * 4:
        fail(f"phantom_recon: states {rep['states']}")
    if counts != {k: want.get(k, 0) for k in counts} or not want[
            "fused_forward"]:
        fail(f"phantom_recon: launches {counts} for tiles "
             f"{rep['tiles_by_impl']}")
    log("\n".join(lines[-30:]))
    add(counts)
    return launches, runs


def eq3_summary(runs: dict, rows: list, name: str, smi: str) -> dict:
    """The ``eq3_run`` record: the paper's Eq. 3 comparison for 250 M
    samples, each figure under its algorithm's name — this program's wall
    time on the card and on the host CPU (phase 4e), the kernel alone
    (phase 5's device time a sample: B1 at tile 1, B2 at tile 128), the
    H100 roofline of each algorithm (``core.fpga_cost_model``), the FPGA's
    200 s and the paper's 16 h CPU; ``card_over_cpu`` is how many times
    faster the card ran the per-sample stream than the host CPU did."""
    from repro_torch.core import fpga_cost_model as fcm

    per_sample_ms = {r["name"]: r["ms"] / r["samples"] for r in rows
                     if "samples" in r}
    kernel_only = {fcm.train_algorithm(1): (
                       "B1 at tile 1", per_sample_ms["fused_train"]),
                   fcm.train_algorithm(128): (
                       "B2 at tile 128", per_sample_ms["fused_train_multistep"])}
    out = {"runs": {key: {k: rep[k] for k in (
        "algorithm", "device", "tile", "chunk_steps", "steps", "batch",
        "samples", "wall_s", "s_per_250m", "launches", "h100_roofline_s",
        "cluster", "first_loss", "last_loss")} for key, rep in runs.items()},
        "kernel_only_s_per_250m": {
            alg: {"kernel": k, "s": ms * EQ3_SAMPLES / 1e3}
            for alg, (k, ms) in kernel_only.items()},
        "paper_fpga_s": fcm.paper_eq3_seconds(),
        "cycle_model_s": runs["stream"]["cycle_model_s"],
        "paper_cpu_s": fcm.PAPER["cpu_train_seconds"],
        "paper_cpu_over_fpga": fcm.PAPER["cpu_train_seconds"]
        / fcm.paper_eq3_seconds(),
        "card_over_cpu": runs["stream on the host CPU"]["s_per_250m"]
        / runs["stream"]["s_per_250m"],
        "device": name, "nvidia_smi": smi}
    for key, r in out["runs"].items():
        log(f"eq3 {key} ({r['algorithm']}) on {r['device']}: {r['samples']} "
            f"samples in {r['wall_s']:.3f} s of wall time -> "
            f"{r['s_per_250m']:.1f} s per 250 M samples (measured, this "
            f"program); H100 roofline {r['h100_roofline_s']:.2f} s")
    for alg, r in out["kernel_only_s_per_250m"].items():
        log(f"eq3 kernel only, {alg}: {r['kernel']} {r['s']:.1f} s per 250 M "
            f"samples (phase 5 device time a sample x 250 M: a projection)")
    log(f"eq3: the FPGA's {out['paper_fpga_s']:.0f} s, the paper's CPU "
        f"{out['paper_cpu_s']:.0f} s ({out['paper_cpu_over_fpga']:.0f}x); the "
        f"card ran the per-sample stream {out['card_over_cpu']:.1f}x faster "
        f"than this host's CPU  [{smi}]")
    return out


def training_timing(launches: dict, errs: dict, device) -> list:
    """Phase 5 for the training kernel at mrf-fpga full width: B1 over 1,024
    samples at tile 1, B2 and B3 over K=50 steps of 256 at tile 128.  The
    device time is the profiler's median over the launches it records of
    20 back-to-back ones (:func:`device_ms`).  The bounds are the cost
    model's (``core.fpga_cost_model.h100_train_seconds``): x and y read
    once, the net (and Adam's moments) read and written once, the losses
    written; the forward, dW and dh products (59,584 FLOP a sample) plus the
    update (2 FLOP a parameter a tile for SGD, 16 for Adam) at the card's
    fp32 rate, at one SM's (1/132 of it) and at the launch's C SMs' (one
    cluster of C blocks walks the tiles in order).  Each kernel is also
    timed at every cluster size 1, 2, 4, 8, 16 (``by_cluster``; a size
    whose rows do not fit a block is refused, one the card cannot place
    fails to launch)."""
    from repro_torch.analysis.roofline import H100
    from repro_torch.core import mrf_net
    from repro_torch.core.fpga_cost_model import h100_train_seconds
    from repro_torch.kernels.fused_train import kernel, multistep, ops, ref

    gen = torch.Generator(device=device).manual_seed(9)
    widths = mrf_net.layer_sizes(32)
    flat, _ = ops.pack_params(mrf_net.init_params(gen, widths))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y = training_data(device, 50, seed=8)
    torch.cuda.synchronize()
    log(f"  staging 50 batches of 256 (batch_at): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms of host wall time")
    zeros = torch.zeros_like(flat)
    step0 = torch.zeros((1,), dtype=torch.int32, device=device)
    cases = [
        ("fused_train", "src/repro/kernels/fused_train/kernel.py:145",
         "1024 samples, tile 1, mrf-fpga", 1024, 1, None),
        ("fused_train_multistep",
         "src/repro/kernels/fused_train/multistep.py:58",
         "K=50 x 256 samples, tile 128, mrf-fpga", 12_800, 128, None),
        ("fused_train_adam", "src/repro/kernels/fused_train/multistep.py:172",
         "K=50 x 256 samples, tile 128, mrf-fpga", 12_800, 128, "adam"),
    ]
    algorithms = {
        "fused_train": "per-sample stream (SGD at tile 1, the paper's "
                       "algorithm)",
        "fused_train_multistep": "minibatch 256 at tile 128, SGD (a "
                                 "reformulation beyond the paper)",
        "fused_train_adam": "minibatch 256 at tile 128, Adam (a "
                            "reformulation beyond the paper)"}
    counters = train_counters()
    rows = []
    for name, replaces, shape, n_rows, tile, opt in cases:
        xs, ys = x[:n_rows], y[:n_rows]
        kw = dict(widths=widths, lr=1e-3, tile_batch=tile)
        if name == "fused_train":
            call = lambda: kernel.fused_train_call(xs, ys, flat, **kw)  # noqa: E731
        elif name == "fused_train_multistep":
            call = lambda: multistep.fused_train_multistep_call(  # noqa: E731
                xs, ys, flat, **kw)
        else:
            call = lambda: multistep.fused_train_adam_call(  # noqa: E731
                step0, xs, ys, flat, zeros, zeros, **kw)
        plain = lambda: ref.fused_train_plain(  # noqa: E731
            xs, ys, flat, widths, lr=1e-3, tile_batch=tile,
            moments=(zeros, zeros) if opt else None,
            step0=step0 if opt else None)

        def bound(c):
            return h100_train_seconds(widths, n_rows, tile=tile, cluster=c,
                                      optimizer=opt or "sgd")

        card = bound(H100["n_sms"])
        saved = {k: c.launches for k, c in counters.items()}
        t = {"ms": device_ms(call, "fused_train_kernel", reps=TRAIN_REPS,
                             warmup=1, label=name),
             "wall_ms": event_ms(call, reps=TRAIN_REPS),
             "plain_ms": device_ms(plain, None, reps=2, warmup=1,
                                   label=f"{name} plain")}
        cluster = kernel.run_fused_train.last_cluster
        by_cluster = []
        for c in (1, 2, 4, 8, 16):
            kw["cluster"] = c
            try:
                ms = device_ms(call, "fused_train_kernel", reps=TRAIN_REPS,
                               warmup=1, label=f"{name} cluster {c}")
                by_cluster.append({"cluster": c, "ms": ms, "bound_c_sms_ms":
                                   bound(c)["t_compute_s"] * 1e3})
            except (ValueError, RuntimeError) as e:
                by_cluster.append({"cluster": c, "refused": str(e)})
        del kw["cluster"]
        for k, c in counters.items():
            c.launches = saved[k]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/fused_train.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"],
                     "bound_ms": card["t_total_s"] * 1e3,
                     "bound_by": ("bytes" if card["bound"] == "memory"
                                  else "operations"),
                     "library_ms": None, "wall_ms": t["wall_ms"],
                     "cluster": cluster,
                     "bound_one_sm_ms": bound(1)["t_compute_s"] * 1e3,
                     "bound_c_sms_ms": bound(cluster)["t_compute_s"] * 1e3,
                     "by_cluster": by_cluster, "shape": shape,
                     "bytes": card["bytes"], "ops": card["ops"],
                     "samples": n_rows, "algorithm": algorithms[name]})
    return rows


def event_ms(fn, reps: int = REPS) -> float:
    """Median wall time of one call between CUDA events: the device time
    plus whatever host launch overhead keeps the card waiting."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(run, lead=None, label: str = "device_events",
                  must: bool = True) -> tuple:
    """One profiler session of ``run()``: the device activity it recorded,
    sorted by start, and what ``run`` returned.

    The profiler drops the first device activity of some sessions: the
    first 1-4 of 10 back-to-back launches of the ms-long training kernel,
    the only launch of a one-launch session, 1 of 30 launches of B5 —
    whatever idle time or lead-in kernel opened the session, in this
    process or a new one — later in a long process up to 11 of 20 launches
    of the training kernel (~180 ms of device time), and once every record
    of a session (the per-sample plain version's ~150,000 small kernels).
    So with ``lead`` the session first calls ``lead()``, whose records
    absorb that loss, then a one-element int16 ``fill_`` as a marker, and
    keeps only the activity after the marker.  A session that kept nothing
    is taken again, up to ``DEVICE_EVENT_TRIES`` sessions in all (``label``
    names it in the log).  ``lead()`` is repeated for at least ``LEAD_S``
    s x 4 ** (session - 1) of host time: a lead of five 0.08 ms launches
    did not outlast the loss, three sessions running.  When none kept
    anything, fails, or (``must`` False) returns an empty list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros((1,), dtype=torch.int16, device="cuda")
    for attempt in range(DEVICE_EVENT_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if lead is not None:
                lead()
                torch.cuda.synchronize()
                until = time.perf_counter() + LEAD_S * 4 ** attempt
                while time.perf_counter() < until:
                    lead()
                    torch.cuda.synchronize()
                marker.fill_(1)
                torch.cuda.synchronize()
            ret = run()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if lead is not None:
            marks = [i for i, e in enumerate(evs) if MARKER in e.name]
            evs = evs[marks[-1] + 1:] if marks else []
        if evs:
            return evs, ret
        log(f"  {label}: the profiler recorded no device activity"
            f"{' after the marker' if lead else ''} (session "
            f"{attempt + 1} of {DEVICE_EVENT_TRIES})")
    if must:
        fail(f"{label}: the profiler recorded no device activity: no device "
             f"time")
    return [], ret


def sum_by_class(evs) -> tuple:
    """Device ms of profiler events summed by ``kernel_class`` and by
    kernel name."""
    by_class, by_name = {}, {}
    for e in evs:
        ms = e.time_range.elapsed_us() / 1e3
        by_class[kernel_class(e.name)] = \
            by_class.get(kernel_class(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    return by_class, by_name


def host_wall(fn):
    """``fn()`` on the host clock, up to a synchronisation, in ms, and what
    it returned."""
    t0 = time.perf_counter()
    ret = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, ret


def device_ms(fn, kernel: str | None, reps: int = REPS, warmup: int = 3,
              label: str = "", lead: int = 0) -> float:
    """Device time per call from the profiler's CUDA activity
    (:func:`device_events`): the median duration of the launches of
    ``kernel`` it recorded, or (``kernel=None``) the summed duration of
    every device activity over ``reps`` calls, per call.

    A session timing ``kernel`` makes ``2 * reps`` launches, the first
    ``reps`` to absorb the records the profiler drops, and keeps the last
    ``reps`` records of ``kernel``; a short count is logged (``label``
    names the call), not fatal.  A sum over ``kernel=None`` may read low,
    unless ``lead`` calls open the session before its marker (and its
    retries: :func:`device_events`).  Fails when the profiler records more
    launches of ``kernel`` than were made.  When every session kept no
    activity, or fewer than half the launches of ``kernel``, the time is
    taken between CUDA events instead (:func:`event_span_ms`: ``reps``
    calls back to back, per call), logged, and its label listed in
    ``EVENT_TIMED``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    label = label or "device_ms"

    def calls(n):
        for _ in range(n):
            fn()

    if kernel is not None:
        evs, _ = device_events(lambda: calls(2 * reps), label=label,
                               must=False)
    else:
        evs, _ = device_events(lambda: calls(reps),
                               (lambda: calls(lead)) if lead else None,
                               label=label, must=False)
    if kernel is None:
        if evs:
            return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3
        return events_instead(fn, reps, label, "no device activity")
    recorded = [e.time_range.elapsed_us() for e in evs if kernel in e.name]
    if len(recorded) > 2 * reps:
        fail(f"{label}: profiler saw {len(recorded)} launches of {kernel} "
             f"in {2 * reps} calls")
    durs = recorded[-reps:]
    if len(durs) < reps // 2:
        return events_instead(fn, reps, label, f"{len(durs)} launches of "
                              f"{kernel} in {reps}")
    if len(durs) < reps:
        log(f"  {label}: the profiler recorded {len(durs)} of {reps} "
            f"launches of {kernel}; median of those")
    return statistics.median(durs) / 1e3


def event_span_ms(fn, reps: int) -> float:
    """``reps`` calls of ``fn`` back to back between two CUDA events, per
    call: the device time when the host launches faster than the card
    runs, with any gap the host leaves between launches counted in it."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def events_instead(fn, reps: int, label: str, why: str) -> float:
    """:func:`event_span_ms` where the profiler kept too little (``why``):
    logged, and ``label`` listed in ``EVENT_TIMED``."""
    ms = event_span_ms(fn, reps)
    EVENT_TIMED.append(label)
    log(f"  {label}: the profiler kept {why}; timed between CUDA events "
        f"instead: {ms:.6f} ms a call over {reps} calls back to back")
    return ms


def launch_floor_ms() -> float:
    """The device time of the smallest kernel PyTorch launches, a
    one-element ``fill_``: the floor under any launch's device time."""
    buf = torch.empty((1,), device="cuda")
    return device_ms(lambda: buf.fill_(1.0), None, label="fill_ (floor)")


def int8_times(net, int_layers, m: int, gen, device) -> dict:
    """B4 (``net``, with the denorm row, as served) and B5 (the first
    hidden layer, (64, 64), ReLU) at M voxels: device ms (profiler median),
    wall ms of one call, the plain version's device ms, the bound, and the
    bytes and operations it counts.  B4's bound counts the net at its true
    widths (``int_layers``): int8 weights, int32 bias and fp32 scale per
    output, never the kernel's padded shared-memory image."""
    from repro_torch.analysis.roofline import H100
    from repro_torch.kernels.qat_dense import fused, kernel, ref

    x = torch.randn((m, net.in_dim), generator=gen, device=device)
    drow = torch.tensor([4000.0, 600.0], device=device)
    shapes = [tuple(int(d) for d in layer.w_q.shape) for layer in int_layers]
    w, b, s = net.packed[3:6]  # layer 1: (64, 64), ReLU epilogue
    xq = torch.randint(-128, 128, (m, w.shape[0]), generator=gen,
                       device=device, dtype=torch.int8)
    k, n = w.shape
    cases = {
        "fused_forward": (
            lambda: fused.fused_forward_call(x, net, drow=drow),
            lambda: ref.ref_fused_forward(x, net.s_in, net.packed,
                                          net.out_dim, drow=drow),
            x.numel() * 4 + sum(kk * nn + 8 * nn for kk, nn in shapes)
            + drow.numel() * 4 + m * net.out_dim * 4,
            2 * m * sum(kk * nn for kk, nn in shapes),
            f"M={m}, mrf-fpga, denorm"),
        "qat_dense": (
            lambda: kernel.qat_dense_call(xq, w, b, s),
            lambda: ref.ref_qat_dense(xq, w, b, s),
            m * k + k * n + 4 * n + 4 * n + m * n, 2 * m * k * n,
            f"M={m}, K={k}, N={n}, relu")}
    out = {}
    for name, (call, plain, nbytes, nops, shape) in cases.items():
        counter = (fused.fused_forward_call if name == "fused_forward"
                   else kernel.qat_dense_call)
        saved = counter.launches
        t_bytes = nbytes / H100["hbm_bytes_per_s"] * 1e3
        t_ops = nops / H100["peak_int8_ops"] * 1e3
        out[name] = {"ms": device_ms(call, f"{name}_kernel",
                                     label=f"{name} M={m}"),
                     "wall_ms": event_ms(call),
                     "plain_ms": device_ms(plain, None, reps=5),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "shape": shape, "bytes": nbytes, "ops": nops}
        counter.launches = saved
    return out


def timing_phase(net, int_layers, launches: dict, errs: dict,
                 device) -> list:
    """Phase 5 for the serving kernels: B4 and B5 at the served bucket
    (M=1024) and at a whole wave (M=281,600, the launcher's wave of 8
    slices, in ``wave``), beside the launch floor (``launch_floor_ms``)."""
    gen = torch.Generator(device=device).manual_seed(11)
    floor = launch_floor_ms()
    tile = int8_times(net, int_layers, BUCKETS[-1], gen, device)
    wave = int8_times(net, int_layers, WAVE_VOXELS, gen, device)
    rows = []
    for name, src, replaces in (
            ("fused_forward", "src/repro_torch/csrc/fused_forward.cu",
             "src/repro/kernels/qat_dense/fused.py:68"),
            ("qat_dense", "src/repro_torch/csrc/qat_dense.cu",
             "src/repro/kernels/qat_dense/kernel.py:64")):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], **tile[name],
                     "library_ms": None, "launch_floor_ms": floor,
                     "wave": wave[name]})
    return rows


def bf16_ulp(x: torch.Tensor) -> float:
    """The spacing of bf16 numbers at ``max |x|``: one bf16 ulp of the
    tensor's largest magnitude."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def hold_bf16(what: str, got: torch.Tensor, want: torch.Tensor) -> tuple:
    """B6's bf16 output against its plain version's, element by element:
    fails beyond ``B6_MAX_ULPS`` or ``B6_DIFFER_SHARE``.  Returns (max ulps,
    share of elements not bit-equal)."""
    from repro_torch.kernels.flash_attn.ref import bf16_ulps

    ulps = float(bf16_ulps(got, want).max())
    share = float((got != want).float().mean())
    if ulps > B6_MAX_ULPS or share > B6_DIFFER_SHARE:
        fail(f"{what}: {ulps:g} bf16 ulps off at worst (limit {B6_MAX_ULPS}),"
             f" {share:.3g} of the elements differ (limit {B6_DIFFER_SHARE})")
    return ulps, share


def hold_b6_bf16(what: str, got, qf, kf, vf, kw) -> dict:
    """B6's bf16 kernel output ``got`` (kernel layout) against its plain
    version, on the card.  The tensor cores sum q k^T in another order than
    the plain version's f32 product, and a score one f32 ulp off can round
    its p to the neighbouring bf16 value: at S 2,048 that moves a few
    small-magnitude outputs by up to ~40 of their own ulps, as it does
    between the plain version and an f64 emulation of it (``ref.py``).  So:

    * a launch with ``scores=`` must repeat ``got`` bit for bit, and its
      scores lie within ``ref.scores_bound`` (two f32 orders' rounding
      bound) of the plain version's own;
    * ``got`` is held element by element (``hold_bf16``, limits unchanged)
      against the plain version run on those scores, which repeats every
      other operation of the kernel's arithmetic.

    The direct comparison is read and logged, not held.  Returns the
    readings."""
    from repro_torch.kernels.flash_attn import kernel, ref

    counter = kernel.flash_attention_call
    saved = counter.launches
    scores = torch.full((qf.shape[0], qf.shape[1], kf.shape[1]), math.nan,
                        device=qf.device)
    again = counter(qf, kf, vf, **kw, scores=scores)
    counter.launches = saved
    if not torch.equal(got, again):
        fail(f"{what}: a launch and its repeat (with scores) differ")
    ran = ~torch.isnan(scores)
    worst = 0.0
    for i in range(0, qf.shape[0], kw["group"]):  # one kv head at a time
        sl, kl = slice(i, i + kw["group"]), slice(i // kw["group"],
                                                   i // kw["group"] + 1)
        gap = (scores[sl] - ref.plain_scores(qf[sl], kf[kl],
                                             group=kw["group"])).abs()
        bound = ref.scores_bound(qf[sl], kf[kl], group=kw["group"])
        # a padded row or key has a bound of 0, and its score must be
        # exactly the plain version's (0/0 would read NaN, which max skips)
        ratio = torch.where(bound > 0, gap / bound,
                            torch.where(gap > 0, math.inf, 0.0))
        worst = max(worst, float(ratio[ran[sl]].max()))
    if not worst <= 1:
        fail(f"{what}: scores {worst:.3g}x the bound of two f32 summation "
             f"orders away from the plain version's")
    ulps, share = hold_bf16(what, got, ref.flash_attention_plain(
        qf, kf, vf, **kw, scores=scores))
    direct = ref.flash_attention_plain(qf, kf, vf, **kw)
    return {"ulps": ulps, "share": share, "scores_vs_bound": worst,
            "direct_ulps": float(ref.bf16_ulps(got, direct).max()),
            "direct_share": float((got != direct).float().mean())}


def check_flash_attention(device) -> float:
    """Phase 3c: B6 against its plain version on the card, on the same
    padded inputs and blocks (``ops.kernel_layout``; bf16 at the Hopper
    kernel's tiles, f32 at the blocks named), the first case at the serving
    path's shape (the launcher's batch of 8), then the models' own shapes
    and small masked ones, cross-attention with its own kv length (Sk):
    f32 within atol 2e-5, bf16 as ``hold_b6_bf16`` says; each launch
    bit-equals its repeat.  Returns the largest absolute error."""
    from repro_torch.kernels.flash_attn import kernel, ref
    from repro_torch.kernels.flash_attn.ops import flash_attention, \
        kernel_layout

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # label, B, S or (Sq, Sk), Hq, Hkv, dh, causal, window, dtype,
        #   block
        ("prefill shape", 8, 2048, 32, 4, 64, True, 0, bf16, None),
        ("sliding window 24", 1, 320, 8, 2, 64, True, 24, bf16, None),
        ("sliding window 8", 1, 320, 8, 2, 64, True, 8, bf16, None),
        ("non-causal", 2, 256, 8, 2, 64, False, 0, bf16, None),
        ("ragged 200 (kv_len padding)", 1, 200, 8, 2, 64, True, 0, bf16,
         None),
        ("prompt shorter than a tile", 1, 50, 8, 2, 64, True, 0, bf16, None),
        ("group 1", 2, 256, 4, 4, 64, True, 0, bf16, None),
        ("dh 128 window 24", 1, 320, 8, 2, 128, True, 24, bf16, None),
        ("dh 128, granite-8b prefill shape", 8, 2048, 32, 8, 128, True, 0,
         bf16, None),
        ("group 1 at dh 128, deepseek-moe-16b prefill shape", 8, 2048, 16, 16,
         128, True, 0, bf16, None),
        ("window 1024, group 5, hymba-1.5b prefill shape", 8, 2048, 25, 5, 64,
         True, 1024, bf16, None),
        ("global causal, group 5, hymba-1.5b prefill shape", 8, 2048, 25, 5,
         64, True, 0, bf16, None),
        ("non-causal, seamless-m4t-large-v2 encoder shape", 8, 512, 16, 16,
         64, False, 0, bf16, None),
        ("cross, seamless-m4t-large-v2 decoder over its encoder", 8,
         (2048, 512), 16, 16, 64, False, 0, bf16, None),
        ("ragged cross (kv_len padding)", 2, (200, 50), 8, 2, 64, False, 0,
         bf16, None),
        ("group 7 at dh 128, llava-next-34b prefill shape", 4, 3072, 56, 8,
         128, True, 0, bf16, None),
        ("f32", 1, 256, 8, 2, 64, True, 0, f32, 64),
        ("f32 window 8, ragged 50, blocks 16", 1, 50, 6, 2, 16, True, 8, f32,
         16),
    ]
    gen = torch.Generator(device=device).manual_seed(13)
    counter = kernel.flash_attention_call
    worst = 0.0
    for label, b, s, hq, hkv, dh, causal, window, dtype, blk in cases:
        s, sk = s if isinstance(s, tuple) else (s, s)  # queries, keys
        q, k, v = (torch.randn((b, n, h, dh), generator=gen,
                               device=device).to(dtype)
                   for n, h in ((s, hq), (sk, hkv), (sk, hkv)))
        qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window,
                                       block_q=blk, block_k=blk)
        before = counter.launches
        got = counter(qf, kf, vf, **kw)
        again = counter(qf, kf, vf, **kw)
        want = ref.flash_attention_plain(qf, kf, vf, **kw)
        through_ops = flash_attention(q, k, v, causal=causal, window=window,
                                      block_q=blk, block_k=blk)
        torch.cuda.synchronize()
        keys = f", Sk {sk}" if sk != s else ""
        what = f"B6 {label} (B {b}, S {s}{keys}, Hq {hq}, Hkv {hkv}, dh " \
               f"{dh}, causal {causal}, window {window}, {dtype})"
        if counter.launches != before + 3:
            fail(f"{what}: launch counter did not advance per launch")
        if got.dtype != dtype or not torch.isfinite(got).all():
            fail(f"{what}: output {got.dtype}, not all finite or wrong type")
        if not torch.equal(got, again):
            fail(f"{what}: a launch and its repeat differ")
        if not torch.equal(through_ops, got.reshape(b, hq, -1, dh)
                           .transpose(1, 2)[:, :s]):
            fail(f"{what}: ops.flash_attention differs from the kernel call")
        if dtype == f32:
            err = float((got.double() - want.double()).abs().max())
            if err > 2e-5:
                fail(f"{what}: max abs err vs plain {err} > 2e-05")
            held = "limit 2e-05"
        else:
            del want
            r = hold_b6_bf16(what, got, qf, kf, vf, kw)
            err = float((got.double() - ref.flash_attention_plain(
                qf, kf, vf, **kw).double()).abs().max())
            held = (f"scores within {r['scores_vs_bound']:.3g} of the f32 "
                    f"orders' bound; on them {r['ulps']:g} bf16 ulps at "
                    f"worst, {r['share']:.3g} of the elements differ; "
                    f"direct, not held: {r['direct_ulps']:g} ulps, "
                    f"{r['direct_share']:.3g}")
        worst = max(worst, err)
        log(f"{what} blocks ({kw['block_q']}, {kw['block_k']}): max abs err "
            f"vs plain {err:.3g} ({held}), repeat bit-identical")
    return worst


def b6_time(b: int, s: int, hq: int, hkv: int, dh: int, device,
            window: int = 0, *, sk: int | None = None,
            causal: bool = True, dtype=torch.bfloat16) -> dict:
    """B6 (bf16, or float32 on the scalar kernel; causal, within
    ``window`` if not 0, or unmasked over ``sk`` keys) at one shape: the
    profiler's device time, the wall time of one wrapper call (tensor maps
    encoded on the host included), the plain version's and SDPA's device
    time, and the bound: the products of the pairs the masks keep,
    4*B*Hq*dh*pairs FLOP — sum_q min(q+1, W) pairs causal (S(S+1)/2
    without a window), S*Sk unmasked — at the bf16 tensor-core peak (the
    float32 peak outside the tensor cores for float32), against q, k, v
    read once and the output written once at 3.35 TB/s.  SDPA:
    ``scaled_dot_product_attention(enable_gqa=True)`` on the same inputs in its (B, H, S, dh) layout, ``is_causal``
    as B6's, or with a window the band as a boolean ``attn_mask`` (which
    takes SDPA off its flash path): a yardstick the port never calls."""
    import torch.nn.functional as F

    from repro_torch.analysis.roofline import H100
    from repro_torch.kernels.flash_attn import kernel, ref
    from repro_torch.kernels.flash_attn.ops import kernel_layout

    sk = s if sk is None else sk
    gen = torch.Generator(device=device).manual_seed(17)
    q, k, v = (torch.randn((b, n, h, dh), generator=gen,
                           device=device).to(dtype)
               for n, h in ((s, hq), (sk, hkv), (sk, hkv)))
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window)
    ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    counter = kernel.flash_attention_call
    saved = counter.launches
    call = lambda: counter(qf, kf, vf, **kw)  # noqa: E731
    if window:
        pos = torch.arange(s, device=device)
        band = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            ql, kl, vl, attn_mask=band, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            ql, kl, vl, is_causal=causal, enable_gqa=True)
    what = f"dh {dh}, group {hq // hkv}" + \
        (f", window {window}" if window else "") + \
        ("" if causal else f", Sq {s} over Sk {sk} unmasked") + \
        (", float32" if dtype == torch.float32 else "")
    t = {"ms": device_ms(call, "flash_attn_kernel", reps=20, warmup=2,
                         label=f"flash_attn {what}"),
         "wall_ms": event_ms(call, reps=20),
         "plain_ms": device_ms(lambda: ref.flash_attention_plain(
             qf, kf, vf, **kw), None, reps=2, warmup=1),
         "library_ms": device_ms(lib, None, reps=20, lead=20,
                                 label=f"SDPA {what}")}
    lib_err = float((lib().transpose(1, 2).double() - call().reshape(
        b, hq, s, dh).transpose(1, 2).double()).abs().max())
    counter.launches = saved
    pairs = sum(min(i + 1, window or s) for i in range(s)) if causal \
        else s * sk
    nops = 4 * b * hq * dh * pairs
    f32 = dtype == torch.float32
    nbytes = q.element_size() * (2 * b * s * hq * dh + 2 * b * sk * hkv * dh)
    t_ops = nops / H100["peak_fp32_flops" if f32 else "peak_bf16_flops"] \
        * 1e3
    t_bytes = nbytes / H100["hbm_bytes_per_s"] * 1e3
    log(f"  B6 vs scaled_dot_product_attention at {what}: max abs diff "
        f"{lib_err:.3g} (not held: another algorithm)")
    masks = (", causal" + (f", window {window}" if window else "")
             if causal else f", Sk {sk}, unmasked")
    t.update({"bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "shape": f"B {b}, Hq {hq}, Hkv {hkv}, dh {dh}, S {s}{masks}, "
                       f"{'float32' if f32 else 'bf16'}", "bytes": nbytes,
              "ops": nops})
    return t


def flash_attention_timing(err: float, device) -> dict:
    """Phase 5 for B6, right after its checks: the serving shape (B 8, Hq
    32, Hkv 4, dh 64, S 2,048) makes the kernel row; granite-8b's (Hkv 8,
    dh 128) rides in it as ``dh128``, deepseek-moe-16b's (Hq 16, Hkv 16,
    group 1, dh 128) as ``deepseek``, hymba-1.5b's (Hq 25, Hkv 5, group 5,
    dh 64) with its window of 1,024 as ``hymba_window`` and fully causal
    (its global layers) as ``hymba_global``, seamless-m4t-large-v2's
    cross-attention (Hq 16, Hkv 16, dh 64, 2,048 decoder queries unmasked
    over 512 encoder keys) as ``seamless_cross``, llava-next-34b's (B 4,
    Hq 56, Hkv 8: group 7, dh 128, S 3,072) as ``llava``, and the float32
    kernel (``csrc/flash_attn.cu``, scalar; on no main path: phase 3c's
    checks launch it) at the serving shape with B 1 as ``f32``."""
    row = b6_time(8, 2048, 32, 4, 64, device)
    row["dh128"] = b6_time(8, 2048, 32, 8, 128, device)
    row["deepseek"] = b6_time(8, 2048, 16, 16, 128, device)
    row["hymba_window"] = b6_time(8, 2048, 25, 5, 64, device, window=1024)
    row["hymba_global"] = b6_time(8, 2048, 25, 5, 64, device)
    row["seamless_cross"] = b6_time(8, 2048, 16, 16, 64, device, sk=512,
                                    causal=False)
    row["llava"] = b6_time(4, 3072, 56, 8, 128, device)
    row["f32"] = b6_time(1, 2048, 32, 4, 64, device, dtype=torch.float32)
    row.update({"name": "flash_attn", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attn_sm90.cu",
                "replaces": "src/repro/kernels/flash_attn/kernel.py:86",
                "launches": None, "max_abs_err": err})
    return row


def b6_per_prefill(cfg) -> int:
    """B6's launches in one prefill: one an attention (an SSM layer has
    none; an encoder-decoder's decoder layer two, self and cross)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def token_runs(label: str, cfg, run, n_runs: int,
               requests: int = 8) -> tuple:
    """``n_runs`` token-serving runs of ``cfg`` at ``requests`` prompts and
    32 tokens (``run()`` serves and returns the exit code), B6's count
    reset just before each run and read just after: each run makes exactly
    ``b6_per_prefill`` B6 launches a prefill (warm-up and timed), its
    tokens lie in the vocab, and every run gives the same tokens.  The
    report's peak device memory counts what was alive before the run
    (``base_device_gib``, logged beside it).  Returns (B6's launches over
    the runs, the reports)."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call

    counter = flash_attention_call
    reports, total = [], 0
    for _ in range(n_runs):
        base = torch.cuda.memory_allocated() / 2**30
        counter.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run()
        launches = counter.launches
        out = buf.getvalue().splitlines()
        if rc != 0 or not out or not out[-1].startswith("token_report "):
            fail(f"token serving {label}: rc {rc}, no report")
        log("\n".join(out[:-1]))
        rep = json.loads(out[-1].split(" ", 1)[1])
        rep["layers"] = cfg.n_layers
        rep["base_device_gib"] = base
        toks = torch.tensor(rep["tokens"])
        want = 2 * b6_per_prefill(cfg)  # warm-up + timed prefill
        if launches != want or rep["flash_attn_launches"] != want:
            fail(f"token serving {label}: {launches} B6 launches (report "
                 f"{rep['flash_attn_launches']}), expected {want}")
        if toks.shape != (requests, 32) or not (0 <= int(toks.min())
                                         and int(toks.max()) < cfg.vocab_size):
            fail(f"token serving {label}: tokens {tuple(toks.shape)} outside "
                 f"the vocab")
        total += launches
        reports.append(rep)
        log("token_report " + json.dumps(
            {k: v for k, v in rep.items() if k != "tokens"}))
    if any(r["tokens"] != reports[0]["tokens"] for r in reports):
        fail(f"token serving {label}: greedy tokens differ between runs")
    log(f"token serving {label}: {total} B6 launches in {n_runs} run(s) "
        f"({want // 2} a prefill), greedy tokens identical across runs")
    return total, reports


def launcher_argv(arch: str, requests: int = 8,
                  prompt_len: int = 2048) -> list:
    return ["--arch", arch, "--device", "cuda", "--requests", str(requests),
            "--prompt-len", str(prompt_len), "--gen-len", "32"]


def token_phase() -> tuple:
    """Phase 4d: token serving through the launcher at full width, twice.
    Returns (B6's launches over both runs, the reports)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    return token_runs(LM_ARCH, get_config(LM_ARCH),
                      lambda: launcher.main(launcher_argv(LM_ARCH)), 2)


def free_device() -> None:
    """Return the cached blocks of freed tensors to the card, so a model of
    other shapes can take their memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def moe_phase() -> tuple:
    """Phase 4f, serving: deepseek-moe-16b, all 28 layers at full width,
    through the launcher twice (56 B6 launches a run); phi3.5-moe at full
    width with ``MOE_WIDE_LAYERS`` of its 32 layers (its 78 GiB of bf16
    weights do not fit beside the cache and activations), once, through the
    launcher's ``serve_tokens`` on a config cut in depth only (32 B6
    launches).  Returns (B6's launches, the reports)."""
    import argparse
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    n_ds, reports = token_runs(MOE_ARCH, get_config(MOE_ARCH),
                               lambda: launcher.main(launcher_argv(MOE_ARCH)),
                               2)
    free_device()
    wide = dataclasses.replace(get_config(MOE_WIDE),
                               n_layers=MOE_WIDE_LAYERS)
    args = argparse.Namespace(requests=8, prompt_len=2048, gen_len=32,
                              device="cuda")
    n_wide, wide_reports = token_runs(
        f"{MOE_WIDE} ({MOE_WIDE_LAYERS} of 32 layers)", wide,
        lambda: launcher.serve_tokens(args, wide), 1)
    free_device()
    return n_ds + n_wide, reports + wide_reports


def lm_model(device, arch: str = LM_ARCH) -> tuple:
    """An LM's model functions and bf16 params at full width, random weights
    from seed 0 (as the launcher makes them)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.common import COMPUTE

    fns = registry.build(get_config(arch))
    return fns, fns.init(0, device=device, dtype=COMPUTE)


def kernel_class(name: str) -> str:
    """B6-bwd (``flash_attn_bwd_dq_kernel<``, ``..._dkdv_kernel<``; also
    the names of a tree from before they were named so), B6, the matrix
    products or everything else."""
    if "dq_kernel<" in name or "dkdv_kernel<" in name:
        return "B6-bwd"
    if "flash_attn_kernel" in name:
        return "B6"
    if any(t in name for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def serving_work(cfg, b: int, s: int) -> dict:
    """The least work of serving b requests of s tokens, for the bounds:
    bf16 product FLOP and bytes of a prefill and of one decode step.

    * Products: 2 x the params a token passes through, less the embedding
      (a gather), with the head on one token a request; an
      encoder-decoder's encoder layers and cross K/V projections over its
      ``enc_len_for(s)`` frames; and 4 x Hq x dh FLOP a (query, key) pair
      each attention keeps (causal, within a hybrid's window, unmasked over
      the frames; a decode token over the cache's slots).
    * Bytes: the bf16 weights a step uses (a prefill all of them, a decode
      step all but the encoder and the embedding), the K/V cache written
      (prefill) or read (decode), an SSM's f32 state read and written a
      decode step.
    An SSM's scan products are ``analysis.roofline.ssd_flops`` (f32)."""
    import dataclasses

    from repro_torch.configs.base import active_param_count, param_count
    from repro_torch.models.encdec import enc_len_for
    from repro_torch.models.lm import global_flags

    d, vp, n_layers = cfg.d_model, cfg.padded_vocab(1), cfg.n_layers
    hq, hkv = cfg.padded_heads(1)
    dh = cfg.head_dim
    body = active_param_count(cfg) - 2 * d * vp  # less embedding and head
    se = enc_len_for(s) if cfg.family == "encdec" else 0
    frames = 0  # params that run over the frames
    if se:
        frames = param_count(cfg) - param_count(dataclasses.replace(
            cfg, n_enc_layers=0)) + n_layers * 2 * d * hkv * dh

    def causal(n, w):  # pairs q >= k > q - w, w = 0 for no window
        w = min(w or n, n)
        return w * (w + 1) // 2 + (n - w) * w

    window = cfg.swa_window
    flags = global_flags(cfg)
    if cfg.family == "ssm":
        pre_pairs = dec_pairs = kv_layers = 0
    elif cfg.family == "encdec":
        pre_pairs = cfg.n_enc_layers * se * se + n_layers * (
            causal(s, 0) + s * se)
        dec_pairs = n_layers * (s + se)
        kv_layers = n_layers * (s + se)  # slots of self and cross K/V
    else:
        wins = [0 if g else window for g in flags]
        pre_pairs = sum(causal(s, w) for w in wins)
        dec_pairs = sum(min(w or s, s) for w in wins)
        kv_layers = dec_pairs
    pair = 4 * hq * dh
    kv_bytes = 2 * 2 * b * kv_layers * hkv * dh  # K and V, bf16
    state = 0
    if cfg.family in ("ssm", "hybrid"):
        state = 2 * 4 * n_layers * b * cfg.n_ssm_heads * cfg.ssm_head_dim \
            * cfg.ssm_state
    blocks = 2 * (frames * b * se + (body - frames) * b * s)
    return {
        "prefill_ops": blocks + 2 * d * vp * b + pair * b * pre_pairs,
        "block_ops": blocks, "attention_ops": pair * b * pre_pairs,
        "prefill_bytes": 2 * param_count(cfg) + kv_bytes,
        "decode_ops": 2 * (body - frames + d * vp) * b + pair * b * dec_pairs,
        "decode_bytes": 2 * (body - frames + d * vp) + kv_bytes + state}


def lm_breakdown(fns, params, device, b: int = 8, s: int = 2048) -> dict:
    """Where the device time of token serving goes at a serving shape: one
    prefill of b x s tokens (the launcher's batch: with an encoder-decoder's
    frames or a VLM's prefix embeddings), then 8 decode steps, each under
    the profiler after a warm-up and a run in which any host
    synchronisation raises.  Device time is summed by kernel class (B6,
    the matrix products, everything else); the idle share is 1 - busy /
    wall, wall on the host clock between synchronisations (kernels of one
    stream do not overlap).  Beside each, a lower bound from
    ``analysis.roofline``'s peaks: the products of ``serving_work`` at the
    bf16 peak plus an SSM's scan products (``ssd_flops``) at the f32 peak,
    against its bytes over HBM (a prefill reads every weight: an MoE
    prefill's 16,384 tokens reach every expert; a decode step one token's
    active weights)."""
    from repro_torch.analysis.roofline import H100, ssd_flops
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.launch.serve import token_batch
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = fns.cfg

    def bound(products, scan, nbytes) -> dict:
        t_scan = scan / H100["peak_fp32_flops"]
        t_ops = products / H100["peak_bf16_flops"] + t_scan
        t_bytes = nbytes / H100["hbm_bytes_per_s"]
        return {"t_bound_s": max(t_ops, t_bytes), "t_scan_s": t_scan,
                "dominant": "compute" if t_ops >= t_bytes else "memory"}

    pre = f"prefill {b} x {s}"
    work = serving_work(cfg, b, s)
    bounds = {pre: bound(work["prefill_ops"], ssd_flops(cfg, b, s),
                         work["prefill_bytes"]),
              "decode, 8 steps": bound(8 * work["decode_ops"],
                                       8 * ssd_flops(cfg, b, 1),
                                       8 * work["decode_bytes"])}
    counter = flash_attention_call
    saved = counter.launches
    gen = torch.Generator(device=device).manual_seed(3)
    batch = token_batch(cfg, b, s, gen, device)
    prefill, serve = make_prefill_step(fns), make_serve_step(fns)
    state = {}

    def run_prefill():
        state.clear()  # the last cache goes before the next is made
        state["cache"], state["tok"], _ = prefill(params, batch)

    def run_decode():
        tok, cache = state["tok"], state["cache"]
        for i in range(8):
            tok, cache = serve(params, cache, tok, s + i)

    out = {}
    with torch.no_grad():
        run_prefill()
        run_decode()  # warm-up of both
        torch.cuda.synchronize()
        # the serving loop must never wait on the device: any op that
        # synchronises raises in this mode
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_prefill()
            run_decode()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log(f"{cfg.name} prefill and 8 decode steps: no host "
            f"synchronisation (sync debug mode 'error')")
        for what, fn in ((pre, run_prefill),
                         ("decode, 8 steps", run_decode)):
            torch.cuda.synchronize()
            evs, (wall, _) = device_events(lambda fn=fn: host_wall(fn),
                                           label=f"{cfg.name} {what}")
            by_class, by_name = sum_by_class(evs)
            busy = sum(by_class.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            bound = bounds[what]
            out[what] = {"wall_ms": wall, "busy_ms": busy,
                         "idle_share": 1 - busy / wall,
                         "by_class_ms": by_class,
                         "bound_ms": bound["t_bound_s"] * 1e3,
                         "bound_by": bound["dominant"]}
            scan = (f", of it the SSD scan {bound['t_scan_s'] * 1e3:.3f} ms "
                    f"at the f32 peak" if bound["t_scan_s"] else "")
            log(f"breakdown {cfg.name} {what}: wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms (idle share {1 - busy / wall:.3f}), bound "
                f"{bound['t_bound_s'] * 1e3:.3f} ms ({bound['dominant']}"
                f"{scan}); by "
                f"class {json.dumps({k: round(v, 3) for k, v in by_class.items()})}"
                f"; top {[(n[:60], round(v, 3)) for n, v in top]}")
    counter.launches = saved
    return out


def ulps(got, want) -> float:
    """``|got - want|`` at worst (got on any device, want on the CPU), in
    bf16 ulps of ``want``'s largest magnitude."""
    return float((got.float().cpu() - want.float()).abs().max()) \
        / bf16_ulp(want)


@contextlib.contextmanager
def recording_b6():
    """Record every call a model makes to B6 through ``models.attention``
    while the block runs: a list of (q, k, v, kwargs, output)."""
    from repro_torch.models import attention as attn_mod

    original, seen = attn_mod.flash_attention, []

    def recording(q, k, v, **kw):
        out = original(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    attn_mod.flash_attention = recording
    try:
        yield seen
    finally:
        attn_mod.flash_attention = original


def hold_recorded_b6(call, what: str) -> dict:
    """B6 on a model's own q, k, v (one ``recording_b6`` call): a launch on
    the same inputs, not counted, must repeat the model's output bit for
    bit, and is held against the plain version (``hold_b6_bf16``)."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.kernels.flash_attn.ops import kernel_layout

    q, k, v, kw, out = call
    qf, kf, vf, lkw = kernel_layout(q, k, v, **kw)
    saved = flash_attention_call.launches
    got = flash_attention_call(qf, kf, vf, **lkw)
    flash_attention_call.launches = saved
    b, sq, hq, dh = q.shape
    if not torch.equal(out, got.reshape(b, hq, -1, dh).transpose(
            1, 2)[:, :sq]):
        fail(f"{what}: the model's call and a repeat differ")
    return hold_b6_bf16(what, got, qf, kf, vf, lkw)


def model_vs_cpu(fns, params, device) -> dict:
    """Phase 4d, the kernel inside the model: one request's 256-token prompt
    at full width on the card (B6) and on a CPU copy of the same bf16
    params (B6's plain version).

    * Each layer, one step: the card's block on the CPU chain's input,
      within ``LM_LAYER_ULPS`` bf16 ulps of the CPU block's output (the
      largest magnitude's ulp).  cuBLAS and the CPU's GEMMs round some
      values to the neighbouring bf16 number; a block has ~10 roundings in
      series before its residual add.
    * B6 in each of those steps, on the model's own q, k and v: held
      against its plain version on the card (``hold_b6_bf16``).  This is the check that holds the kernel; the two
      above and below hold the model around it.
    * End to end, the prefill entry point on the card against the CPU
      chain's last row: last-token logits within ``LM_LOGIT_ULPS`` bf16
      ulps of their largest magnitude.  The one-step GEMM differences
      accumulate along the residual stream over the 22 layers (about 1 ulp
      a layer, as a random walk).
    * Greedy tokens of the chained forwards equal at every position whose
      top-2 margin on the CPU exceeds twice the logit limit."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.models import lm
    from repro_torch.models.common import rms_norm
    from repro_torch.tree import tree_map

    cfg = fns.cfg
    cpu_params = tree_map(lambda t: t.cpu(), params)
    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                           device=device, dtype=torch.int32)
    counter = flash_attention_call
    seen = []
    with torch.no_grad():
        before = counter.launches
        _, logits = fns.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        launches = counter.launches - before
        # the prefill's blocks one layer at a time
        t0 = time.perf_counter()
        h_c = lm._embed(cpu_params, tokens.cpu())
        h_g = lm._embed(params, tokens)
        layer_ulps = []
        for lp_g, lp_c in zip(params["layers"], cpu_params["layers"]):
            with recording_b6() as calls:
                one, _, _ = lm._block(cfg, 1, h_c.to(device), lp_g,
                                   return_kv=False)
            seen += calls
            h_c, _, _ = lm._block(cfg, 1, h_c, lp_c, return_kv=False)
            h_g, _, _ = lm._block(cfg, 1, h_g, lp_g, return_kv=False)
            layer_ulps.append(ulps(one, h_c))
        all_g = lm._logits(params, rms_norm(h_g, params["final_norm"],
                                            cfg.norm_eps))[0].float().cpu()
        all_c = lm._logits(cpu_params, rms_norm(
            h_c, cpu_params["final_norm"], cfg.norm_eps))[0].float()
        t_cpu = time.perf_counter() - t0
        attn_held = [hold_recorded_b6(call, f"B6 in layer {i}")
                     for i, call in enumerate(seen)]
    if launches != cfg.n_layers or len(seen) != cfg.n_layers:
        fail(f"card prefill: {launches} B6 launches, {len(seen)} attention "
             f"calls layer by layer, expected {cfg.n_layers}")
    got, want = logits[0].float().cpu(), all_c[-1]
    if not torch.isfinite(got).all():
        fail("card prefill: logits not finite")
    err = float((got - want).abs().max())
    tol = LM_LOGIT_ULPS * bf16_ulp(want)
    rel_rms = float((got - want).norm() / want.norm())
    top2 = torch.topk(all_c, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = int((all_g.argmax(-1) == all_c.argmax(-1))[sure].sum())
    log(f"{LM_ARCH} prefill, 1 x 256 tokens, card vs CPU copy: B6 on each "
        f"layer's own q, k, v: scores within "
        f"{max(r['scores_vs_bound'] for r in attn_held):.3g} of the f32 "
        f"orders' bound, on them within "
        f"{max(r['ulps'] for r in attn_held):g} bf16 ulps of its plain "
        f"version, at most {max(r['share'] for r in attn_held):.3g} of the "
        f"elements differing (direct, not held: "
        f"{max(r['direct_ulps'] for r in attn_held):g} ulps, "
        f"{max(r['direct_share'] for r in attn_held):.3g}); "
        f"each layer one step within {max(layer_ulps):g} bf16 ulps (limit "
        f"{LM_LAYER_ULPS}; per layer {layer_ulps}); last-token logits max "
        f"abs err {err:.6g} = {err / bf16_ulp(want):g} ulps of max |logit| "
        f"{float(want.abs().max()):.6g} (limit {LM_LOGIT_ULPS} ulps = "
        f"{tol:.6g}), relative rms {rel_rms:.4g}; greedy equal at {same} of "
        f"{int(sure.sum())} positions whose margin exceeds {2 * tol:.6g} "
        f"(of 256); layer-by-layer chains {t_cpu:.1f} s")
    if max(layer_ulps) > LM_LAYER_ULPS:
        fail(f"card vs CPU: a layer's one-step output is "
             f"{max(layer_ulps)} bf16 ulps off (limit {LM_LAYER_ULPS})")
    if err > tol or same != int(sure.sum()):
        fail(f"card vs CPU prefill: logits max abs err {err} (limit {tol}), "
             f"greedy equal at {same} of {int(sure.sum())} sure positions")
    return {"logit_err": err, "logit_tol": tol, "layer_ulps": layer_ulps,
            "attn_held": attn_held}


def moe_forms(fns, params, device) -> dict:
    """The MoE block's two forms at deepseek-moe-16b's prefill shape (8 x
    2,048 tokens: 64 groups, capacity 30 a expert), on layer 0's params and
    a random bf16 input: the model's index dispatch (``moe.moe_block``) and
    the reference's dense one-hot (``moe.moe_block_plain``), each timed
    between CUDA events (median of 10 calls); the two must agree within
    ``MOE_INDEX_ULPS``.  The model keeps the faster form."""
    from repro_torch.models import moe

    cfg = fns.cfg
    p = params["layers"][0]["moe"]
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn((8, 2048, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    kw = {"top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor}
    forms = {"index": moe.moe_block, "dense": moe.moe_block_plain}
    with torch.no_grad():
        y_index, y_dense = (f(p, x, **kw)[0] for f in forms.values())
        ulps = float((y_index.float() - y_dense.float()).abs().max()) \
            / bf16_ulp(y_dense)
        if ulps > MOE_INDEX_ULPS:
            fail(f"{MOE_ARCH} MoE block, 8 x 2048 tokens: the index form "
                 f"{ulps:g} ulps from the dense one-hot (limit "
                 f"{MOE_INDEX_ULPS})")
        ms = {form: event_ms(lambda f=f: f(p, x, **kw), reps=10)
              for form, f in forms.items()}
    log(f"{MOE_ARCH} MoE block (layer 0, 8 x 2048 tokens): index dispatch "
        f"{ms['index']:.3f} ms, dense one-hot {ms['dense']:.3f} ms between "
        f"CUDA events; outputs within {ulps:g} ulps")
    return {"ms": ms, "ulps": ulps}


def moe_vs_cpu(fns, params, device) -> list:
    """Phase 4f, the MoE layer on the card against a CPU copy:
    deepseek-moe-16b's first two layers at full width on one 256-token
    prompt (one routing group: capacity 30 a expert), each layer one step
    from the CPU chain's input, on the card and on a CPU copy of its bf16
    params.

    * Routing first: the two sides' MoE inputs differ by the attention's
      bf16 roundings, so a near-tie in the f32 router can pick another
      expert.  The (token, choice) pairs routed differently are counted; a
      layer fails above ``MOE_FLIP_SHARE`` of them.  A token is alike when
      its experts and the experts it is dispatched to (within capacity)
      are the same on both sides.
    * The layer's output, held within ``LM_LAYER_ULPS`` bf16 ulps of its
      largest magnitude at the alike tokens only.
    * B6 on the layer's own q, k, v (group 1, dh 128): ``hold_b6_bf16``.
    * The model's index dispatch against the dense one-hot form
      (``moe.moe_block_plain``) on the card, on the card's own input: the
      same dispatched slots exactly, outputs within ``MOE_INDEX_ULPS``.
    Returns each layer's readings."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.models import lm, moe
    from repro_torch.tree import tree_map

    cfg = fns.cfg
    n_exp = cfg.n_experts
    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                           device=device, dtype=torch.int32)
    counter = flash_attention_call
    original_moe = lm.moe_block
    seen = {"attn": [], "moe": []}

    def recording_moe(p, x, **kw):
        y, aux = original_moe(p, x, **kw)
        seen["moe"].append((p, x, kw, y))
        return y, aux

    def step(h, lp):
        lm.moe_block = recording_moe
        try:
            with recording_b6() as calls:
                out, _, _ = lm._block(cfg, 1, h, lp, return_kv=False)
        finally:
            lm.moe_block = original_moe
        seen["attn"] += calls
        return out

    def routing(p, x, kw):
        r = moe.route(p.router, moe._groups(x, moe.GROUP_SIZE), cfg.top_k,
                      kw["capacity_factor"])
        slot, keep = moe.slots(r, n_exp)
        kept = torch.zeros((*r.idx.shape[:2], n_exp + 1), dtype=torch.bool,
                           device=r.idx.device)
        kept.scatter_(2, torch.where(keep, r.idx, n_exp), True)
        return r, slot, keep, kept[..., :n_exp]

    readings = []
    with torch.no_grad():
        h_c = lm._embed(params, tokens).cpu()
        for i, lp_g in enumerate(params["layers"][:2]):
            lp_c = tree_map(lambda t: t.cpu(), lp_g)
            seen["attn"].clear(), seen["moe"].clear()
            before = counter.launches
            one = step(h_c.to(device), lp_g)
            torch.cuda.synchronize()
            launches = counter.launches - before
            nxt = step(h_c, lp_c)
            (p_g, x_g, kw, y_g), (p_c, x_c, _, _) = seen["moe"]
            if launches != 1 or len(seen["attn"]) != 2:
                fail(f"{MOE_ARCH} layer {i}: {launches} B6 launches")
            r_g, slot_g, keep_g, kept_g = routing(p_g, x_g, kw)
            r_c, _, _, kept_c = routing(p_c, x_c, kw)
            flipped = r_g.idx.cpu() != r_c.idx
            share = float(flipped.float().mean())
            alike = (~flipped.any(-1) & (kept_g.cpu() == kept_c).all(-1))[0]
            if share > MOE_FLIP_SHARE or not alike.any():
                fail(f"{MOE_ARCH} layer {i}, card vs CPU: {share:.4f} of "
                     f"the (token, choice) pairs routed differently (limit "
                     f"{MOE_FLIP_SHARE}), {int(alike.sum())} of 256 tokens "
                     f"alike")
            got, want = one[0, alike].float().cpu(), nxt[0, alike].float()
            layer_ulps = float((got - want).abs().max()) / bf16_ulp(want)
            if layer_ulps > LM_LAYER_ULPS:
                fail(f"{MOE_ARCH} layer {i}: one step {layer_ulps:g} bf16 "
                     f"ulps off at the alike tokens (limit {LM_LAYER_ULPS})")
            # B6 on the layer's own q, k, v
            held = hold_recorded_b6(seen["attn"][0],
                                    f"B6 in {MOE_ARCH} layer {i}")
            # the index dispatch against the dense one-hot, on the card
            dense = moe.dense_combine(r_g, n_exp) > 0
            cap = r_g.capacity
            mask = torch.zeros((*r_g.idx.shape[:2], n_exp * cap + 1),
                               dtype=torch.bool, device=device)
            mask.scatter_(2, torch.where(keep_g, r_g.idx * cap + slot_g,
                                         n_exp * cap), True)
            y_plain, _ = moe.moe_block_plain(p_g, x_g, **kw)
            index_ulps = float((y_g.float() - y_plain.float()).abs().max()) \
                / bf16_ulp(y_plain)
            if not torch.equal(mask[..., :-1].reshape(dense.shape), dense) \
                    or index_ulps > MOE_INDEX_ULPS:
                fail(f"{MOE_ARCH} layer {i}: the index dispatch differs from "
                     f"the dense one-hot ({index_ulps:g} ulps, limit "
                     f"{MOE_INDEX_ULPS})")
            reading = {"layer": i, "flip_share": share,
                       "alike_tokens": int(alike.sum()),
                       "dropped_choices": int((~keep_g).sum()),
                       "layer_ulps": layer_ulps, "index_vs_dense_ulps":
                       index_ulps, "b6": held}
            log(f"{MOE_ARCH} layer {i}, 1 x 256 tokens, card vs CPU copy: "
                f"{share:.4f} of the (token, choice) pairs routed "
                f"differently (limit {MOE_FLIP_SHARE}), {reading['alike_tokens']}"
                f" of 256 tokens alike; one step within {layer_ulps:g} bf16 "
                f"ulps there (limit {LM_LAYER_ULPS}); "
                f"{reading['dropped_choices']} of {256 * cfg.top_k} choices "
                f"dropped at capacity {cap}; index dispatch == dense one-hot "
                f"(slots equal, outputs within {index_ulps:g} ulps, limit "
                f"{MOE_INDEX_ULPS}); B6 (group 1, dh 128): scores within "
                f"{held['scores_vs_bound']:.3g} of the f32 orders' bound, "
                f"on them {held['ulps']:g} ulps, {held['share']:.3g} of the "
                f"elements differ")
            readings.append(reading)
            h_c = nxt
    return readings


def ssm_phase() -> tuple:
    """Phase 4g, serving: mamba2-1.3b (all 48 layers, no attention: 0 B6
    launches) and hymba-1.5b (all 32 layers: 64 B6 launches a run) at full
    width through the launcher, twice each.  Returns (B6's launches, the
    reports)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    total, reports = 0, []
    for arch in (SSM_ARCH, HYBRID_ARCH):
        n, reps = token_runs(arch, get_config(arch),
                             lambda a=arch: launcher.main(launcher_argv(a)),
                             2)
        total += n
        reports += reps
        free_device()
    return total, reports


def layers_vs_cpu(fns, params, device, layers: list, n_tokens: int) -> list:
    """Phases 4g and 4h, a decoder-only LM's layers on the card against a
    CPU copy of their bf16 params (the SSM, hybrid and VLM families): one
    request of ``n_tokens`` at full width, each of ``layers`` one step from
    the CPU chain's input, then 4 decode steps of those layers (the same
    embedded tokens on both sides, each side continuing its own cache).  A
    VLM's input is the launcher's prefix embeddings over the prompt's
    first positions, checked bit for bit on the card.

    * The block's output within ``LM_LAYER_ULPS`` bf16 ulps of its largest
      magnitude, at prefill and at each decode step;
    * the mixer's f32 state within ``SSM_STATE_RTOL`` of its largest
      magnitude, and its bf16 conv tails within ``LM_LAYER_ULPS`` ulps,
      after prefill and after each step;
    * an attention layer's B6 on the layer's own q, k, v
      (``hold_recorded_b6``), and its K and V (a hybrid's ring-aligned)
      within ``LM_LAYER_ULPS`` ulps.
    Returns each layer's readings."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.launch.serve import token_batch
    from repro_torch.models import lm
    from repro_torch.models.common import COMPUTE
    from repro_torch.tree import tree_map

    cfg = fns.cfg
    flags = lm.global_flags(cfg)
    mixer = cfg.family in ("ssm", "hybrid")
    gen = torch.Generator(device=device).manual_seed(4)
    batch = token_batch(cfg, 1, n_tokens + 4, gen, device)
    tokens, prefix = batch["tokens"], batch.get("prefix_embeds")
    counter = flash_attention_call

    def hold_cache(what, got, want) -> dict:
        r = {}
        if mixer:
            mixer_g, mixer_c = (c if cfg.family == "ssm" else c["ssm"]
                                for c in (got, want))
            r["state_rel"] = float(
                (mixer_g.state.cpu() - mixer_c.state).abs().max()
                / mixer_c.state.abs().max())
            r["tail_ulps"] = max(ulps(getattr(mixer_g, f),
                                      getattr(mixer_c, f))
                                 for f in ("conv_x", "conv_B", "conv_C"))
        if cfg.family != "ssm":
            r["kv_ulps"] = max(ulps(got[n], want[n]) for n in ("k", "v"))
        if r.get("state_rel", 0.0) > SSM_STATE_RTOL or max(
                v for k, v in r.items() if k != "state_rel") > LM_LAYER_ULPS:
            fail(f"{cfg.name} {what}, card vs CPU: {r} (limits: state "
                 f"{SSM_STATE_RTOL}, {LM_LAYER_ULPS} ulps)")
        return r

    readings = []
    with torch.no_grad():
        h_g = lm._embed(params, tokens[:, :n_tokens], prefix)
        if prefix is not None:  # the prefix in place of the first tokens
            n_pre = prefix.shape[1]
            if not (torch.equal(h_g[:, :n_pre], prefix.to(COMPUTE))
                    and torch.equal(h_g[:, n_pre:], lm._embed(
                        params, tokens[:, n_pre:n_tokens]))):
                fail(f"{cfg.name}: the prefix embeddings did not overwrite "
                     f"the first {n_pre} positions")
        h_c = h_g.cpu()
        del h_g
        steps_in = lm._embed(params, tokens[:, n_tokens:]).cpu()  # (1, 4, d)
        for i in layers:
            lp_g = params["layers"][i]
            lp_c = tree_map(lambda t: t.cpu(), lp_g)
            g = flags[i]
            before = counter.launches
            with recording_b6() as calls:
                one, kv_g, _ = lm._block(cfg, 1, h_c.to(device), lp_g,
                                      return_kv=True, is_global=g)
            torch.cuda.synchronize()
            launches = counter.launches - before
            nxt, kv_c, _ = lm._block(cfg, 1, h_c, lp_c, return_kv=True,
                                  is_global=g)
            want_launches = 0 if cfg.family == "ssm" else 1
            if launches != want_launches or len(calls) != want_launches:
                fail(f"{cfg.name} layer {i}: {launches} B6 launches, "
                     f"expected {want_launches}")
            r = {"layer": i, "global": g, "layer_ulps": ulps(one, nxt)}
            if r["layer_ulps"] > LM_LAYER_ULPS:
                fail(f"{cfg.name} layer {i}, card vs CPU: one step "
                     f"{r['layer_ulps']:g} bf16 ulps off (limit "
                     f"{LM_LAYER_ULPS})")
            if calls:  # B6 on the layer's own q, k, v
                r["b6"] = hold_recorded_b6(
                    calls[0], f"B6 in {cfg.name} layer {i} (window "
                    f"{calls[0][3].get('window')})")
            del calls
            cache_g = lm.layer_cache(cfg, kv_g, g, n_tokens)
            cache_c = lm.layer_cache(cfg, kv_c, g, n_tokens)
            r["prefill"] = hold_cache(f"layer {i} after prefill", cache_g,
                                      cache_c)
            r["decode_ulps"], r["decode"] = [], []
            for t in range(4):
                h1 = steps_in[:, t]
                y_g = lm._decode_block(cfg, 1, h1.to(device), lp_g, cache_g,
                                       n_tokens + t)
                y_c = lm._decode_block(cfg, 1, h1, lp_c, cache_c,
                                       n_tokens + t)
                r["decode_ulps"].append(ulps(y_g, y_c))
                r["decode"].append(hold_cache(f"layer {i} decode step {t}",
                                              cache_g, cache_c))
            if max(r["decode_ulps"]) > LM_LAYER_ULPS:
                fail(f"{cfg.name} layer {i}: decode outputs "
                     f"{r['decode_ulps']} bf16 ulps off (limit "
                     f"{LM_LAYER_ULPS})")
            b6 = r.get("b6")
            kind = {"hybrid": "global" if g else "window", "ssm": "mixer"}.get(
                cfg.family, "attention")
            log(f"{cfg.name} layer {i} ({kind}), 1 x "
                f"{n_tokens} tokens, card vs CPU copy: one step within "
                f"{r['layer_ulps']:g} bf16 ulps (limit {LM_LAYER_ULPS}); "
                f"after prefill {json.dumps(r['prefill'])}; 4 decode steps "
                f"within {max(r['decode_ulps']):g} ulps, last "
                f"{json.dumps(r['decode'][-1])} (limits: state "
                f"{SSM_STATE_RTOL}, {LM_LAYER_ULPS} ulps)"
                + (f"; B6: scores within {b6['scores_vs_bound']:.3g} of the "
                   f"f32 orders' bound, on them {b6['ulps']:g} ulps, "
                   f"{b6['share']:.3g} of the elements differ" if b6 else ""))
            readings.append(r)
            h_c = nxt
    return readings


def ssd_time(fns, device) -> dict:
    """The SSD scan alone (``ssm.ssd_chunked``) at the prefill shape, 8 x
    2,048 tokens, on random f32 inputs of the model's head count, head dim
    and state (dt about the init's 0.01): the wall time of one call between
    CUDA events, a layer and times the layers, beside the scan's f32
    products (``ssd_flops``) at the f32 peak."""
    from repro_torch.analysis.roofline import H100, ssd_flops
    from repro_torch.models import ssm

    cfg = fns.cfg
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=device).manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, bm, cm = randn(8, 2048, h, p), randn(8, 2048, n), randn(8, 2048, n)
    dt = ssm.softplus(randn(8, 2048, h) - 4.6)
    a = -torch.linspace(1.0, 16.0, h, device=device)
    with torch.no_grad():
        ms = event_ms(lambda: ssm.ssd_chunked(x, dt, a, bm, cm,
                                              cfg.ssm_chunk), reps=5)
    bound = ssd_flops(cfg, 8, 2048) / cfg.n_layers / H100["peak_fp32_flops"]
    log(f"{cfg.name} SSD scan, 8 x 2048 tokens, one layer: {ms:.3f} ms "
        f"between CUDA events, x {cfg.n_layers} layers = "
        f"{ms * cfg.n_layers:.1f} ms; f32 products' bound "
        f"{bound * 1e3:.3f} ms a layer")
    return {"ms_per_layer": ms, "ms": ms * cfg.n_layers,
            "bound_ms_per_layer": bound * 1e3}


def serve_batch_example() -> dict:
    """Phase 4g: ``examples/torch_serve_batch.py`` at its defaults (mamba2,
    smoke config, 8 x 48-token prompts, 24 tokens) on the card: exit 0, a
    ``token_report`` last, no B6 launch (no attention)."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call

    saved = flash_attention_call.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = example("torch_serve_batch").main([])
    lines = buf.getvalue().splitlines()
    launches = flash_attention_call.launches - saved
    if rc != 0 or not lines or not lines[-1].startswith("token_report "):
        log("\n".join(lines[-20:]))
        fail(f"examples/torch_serve_batch.py exited {rc} without a report")
    rep = report_of(lines, "token_report", "torch_serve_batch")
    if launches or rep["flash_attn_launches"] or \
            (rep["requests"], rep["prompt"], rep["gen"]) != (8, 48, 24):
        fail(f"examples/torch_serve_batch.py: {launches} B6 launches, "
             f"report {rep}")
    log("examples/torch_serve_batch.py: token_report " + json.dumps(
        {k: v for k, v in rep.items() if k != "tokens"}))
    return rep


def encdec_vs_cpu(fns, params, device) -> list:
    """Phase 4h, seamless-m4t-large-v2's first two encoder and decoder layers
    on the card against a CPU copy of their bf16 params, on one request of
    the serving shape (2,048 decoder tokens beside 512 frames), each layer
    one step from the CPU chain's input.

    * Encoder layers: the block's output within ``LM_LAYER_ULPS`` bf16 ulps
      of its largest magnitude, and B6 (unmasked, S 512) on the layer's own
      q, k, v (``hold_recorded_b6``).
    * Decoder layers, both sides over the card's encoder output (all 24
      layers and the final norm): the block's output, its self-attention
      K/V and its cross K/V (projected from the encoder output) within
      ``LM_LAYER_ULPS`` ulps; B6 on the self-attention's (causal, S 2,048)
      and the cross-attention's (2,048 queries unmasked over 512 keys) own
      q, k, v.
    * 4 decode steps of those decoder layers (the same embedded tokens on
      both sides, each continuing its own cache): outputs and self K/V
      within ``LM_LAYER_ULPS`` ulps, the cross K/V untouched.
    Returns each layer's readings."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.launch.serve import token_batch
    from repro_torch.models import encdec
    from repro_torch.models.common import COMPUTE
    from repro_torch.tree import tree_map

    cfg, n = fns.cfg, 2048
    gen = torch.Generator(device=device).manual_seed(4)
    batch = token_batch(cfg, 1, n, gen, device)
    steps = torch.randint(0, cfg.vocab_size, (1, 4), generator=gen,
                          device=device, dtype=torch.int32)
    counter = flash_attention_call
    readings = []

    def step(what, block, lp_g, h_c, *extra):
        """One layer on the card (B6 recorded) and on the CPU copy."""
        lp_c = tree_map(lambda t: t.cpu(), lp_g)
        before = counter.launches
        with recording_b6() as calls:
            one = block(h_c.to(device), lp_g, *(e[0] for e in extra))
        torch.cuda.synchronize()
        launches = counter.launches - before
        nxt = block(h_c, lp_c, *(e[1] for e in extra))
        held = [hold_recorded_b6(c, f"B6 in {cfg.name} {what} ({kind})")
                for c, kind in zip(calls, ("self", "cross"))]
        if launches != len(calls):
            fail(f"{cfg.name} {what}: {launches} B6 launches for "
                 f"{len(calls)} attention calls")
        return one, nxt, lp_c, held, launches

    with torch.no_grad():
        h_c = batch["frames"].to(COMPUTE).cpu()
        for i in (0, 1):
            one, nxt, _, held, launches = step(
                f"encoder layer {i}", lambda h, lp: encdec._enc_block(
                    cfg, 1, h, lp), params["enc"]["layers"][i], h_c)
            r = {"layer": f"enc {i}", "layer_ulps": ulps(one, nxt),
                 "b6": held}
            if launches != 1 or r["layer_ulps"] > LM_LAYER_ULPS:
                fail(f"{cfg.name} encoder layer {i}, card vs CPU: {r} "
                     f"({launches} B6 launches; limit {LM_LAYER_ULPS} ulps)")
            readings.append(r)
            h_c = nxt
        enc_g = encdec.encode(cfg, 1, params, batch["frames"])
        enc = (enc_g, enc_g.cpu())
        h_c = encdec._embed(params, batch["tokens"]).cpu()
        steps_in = encdec._embed(params, steps).cpu()  # (1, 4, d)
        for i in (0, 1):
            lp_g = params["dec"]["layers"][i]
            (one, kv_g), (nxt, kv_c), lp_c, held, launches = step(
                f"decoder layer {i}", lambda h, lp, e: encdec._dec_block(
                    cfg, 1, h, lp, e, return_kv=True), lp_g, h_c, enc)
            layer_g, layer_c = ({"k": k.to(COMPUTE), "v": v.to(COMPUTE),
                                 "cross_k": ck.to(COMPUTE),
                                 "cross_v": cv.to(COMPUTE)}
                                for (k, v), (ck, cv) in (kv_g, kv_c))
            cross = {name: layer_g[name].clone()
                     for name in ("cross_k", "cross_v")}
            r = {"layer": f"dec {i}", "layer_ulps": ulps(one, nxt),
                 "cache_ulps": {name: ulps(layer_g[name], layer_c[name])
                                for name in layer_g},
                 "b6": held, "decode_ulps": [], "decode_kv_ulps": []}
            for t in range(4):
                h1 = steps_in[:, t]
                y_g = encdec._decode_block(cfg, 1, h1.to(device), lp_g,
                                           layer_g, n + t)
                y_c = encdec._decode_block(cfg, 1, h1, lp_c, layer_c, n + t)
                r["decode_ulps"].append(ulps(y_g, y_c))
                r["decode_kv_ulps"].append(max(
                    ulps(layer_g[name], layer_c[name]) for name in ("k", "v")))
            worst = max(r["layer_ulps"], *r["cache_ulps"].values(),
                        *r["decode_ulps"], *r["decode_kv_ulps"])
            if launches != 2 or worst > LM_LAYER_ULPS or not all(
                    torch.equal(layer_g[name], t)
                    for name, t in cross.items()):
                fail(f"{cfg.name} decoder layer {i}, card vs CPU: "
                     f"{launches} B6 launches (expected 2), worst {worst} "
                     f"bf16 ulps (limit {LM_LAYER_ULPS}), cross cache "
                     f"untouched by decode: readings {r}")
            readings.append(r)
            h_c = nxt
    for r in readings:
        log(f"{cfg.name} {r['layer']}, 1 x {n} tokens beside "
            f"{batch['frames'].shape[1]} frames, card vs CPU copy: "
            + json.dumps({k: v for k, v in r.items() if k != "layer"}))
    return readings


def encdec_vlm_phase(device) -> tuple:
    """Phase 4h: seamless-m4t-large-v2 (24 encoder and 24 decoder layers)
    at full width through the launcher, twice (8 requests of 2,048-token
    prompts beside 512 frames, 32 tokens: 144 B6 launches a run), its first
    layers against a CPU copy (``encdec_vs_cpu``) and its breakdown; then
    llava-next-34b at full width (all 60 layers, 64.05 GiB of bf16
    weights: nothing else may be alive on the card) through the launcher
    once (4 requests of 3,072 tokens, the first 2,880 positions its prefix
    embeddings: 120 B6 launches), its first two layers against a CPU copy
    on 1 x 3,072 tokens (``layers_vs_cpu``) and its breakdown.  Returns
    (B6's launches, the reports)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    with took(f"token_runs {ENCDEC_ARCH}"):
        n_ed, reports = token_runs(
            ENCDEC_ARCH, get_config(ENCDEC_ARCH),
            lambda: launcher.main(launcher_argv(ENCDEC_ARCH)), 2)
    with took(f"encdec_vs_cpu and lm_breakdown {ENCDEC_ARCH}"):
        fns, params = lm_model(device, ENCDEC_ARCH)
        encdec_vs_cpu(fns, params, device)
        lm_breakdown(fns, params, device)
    del params
    free_device()
    with took(f"token_runs {VLM_ARCH}"):
        n_vlm, vlm_reports = token_runs(
            VLM_ARCH, get_config(VLM_ARCH),
            lambda: launcher.main(launcher_argv(VLM_ARCH, 4, VLM_PROMPT)), 1,
            requests=4)
    free_device()
    with took(f"layers_vs_cpu and lm_breakdown {VLM_ARCH}"):
        fns, params = lm_model(device, VLM_ARCH)
        layers_vs_cpu(fns, params, device, [0, 1], VLM_PROMPT)
        lm_breakdown(fns, params, device, 4, VLM_PROMPT)
    del params
    free_device()
    return n_ed + n_vlm, reports + vlm_reports


def bwd_cases() -> list:
    """Phase 4i's B6-bwd cases: label, B, S or (Sq, Sk), Hq, Hkv, dh,
    causal, window."""
    return [
        ("tinyllama-1.1b training shape", 8, 2048, 32, 4, 64, True, 0),
        ("group 1 at dh 128", 2, 2048, 16, 16, 128, True, 0),
        ("group 7 at dh 128 (llava-next-34b's heads)", 1, 2048, 56, 8, 128,
         True, 0),
        ("window 1,024, group 5 (hymba-1.5b's heads)", 2, 2048, 25, 5, 64,
         True, 1024),
        ("unmasked, 2,048 queries over 512 keys", 2, (2048, 512), 16, 16, 64,
         False, 0),
        ("unmasked, S 512 (seamless-m4t-large-v2's encoder)", 2, 512, 16, 16,
         64, False, 0),
        ("ragged unmasked, 200 queries over 50 keys", 2, (200, 50), 8, 2, 64,
         False, 0),
        ("causal, a length not a multiple of the tile (300)", 2, 300, 8, 2,
         32, True, 0),
        ("dh 16, window 24, ragged 100", 1, 100, 4, 2, 16, True, 24),
    ]


def bwd_inputs(case, device, seed: int = 23) -> tuple:
    """A case's bf16 q, k, v (B, S, H, dh), its kernel layout and the
    forward's upstream gradient in that layout (zero on the padded rows, as
    autograd hands it to the backward)."""
    from repro_torch.kernels.flash_attn.ops import kernel_layout

    _, b, s, hq, hkv, dh, causal, window = case
    s, sk = s if isinstance(s, tuple) else (s, s)
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn((b, n, h, dh), generator=gen,
                               device=device).to(torch.bfloat16)
                   for n, h in ((s, hq), (sk, hkv), (sk, hkv), (s, hq)))
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window)
    dof = kernel_layout(do, k, v, causal=causal, window=window)[0]
    return qf, kf, vf, dof, kw


def per_kv_head(fn, qf, kf, vf, of, dof, lse, kw, chunk: int = 4):
    """``fn`` (a plain backward or its bounds) run ``chunk`` kv heads at a
    time, the results concatenated: the plain versions' (rows, Sk) f32
    intermediates at the training shape would take ~20 GB at once."""
    g = kw["group"]
    a = {x: kw[x] for x in ("causal", "window", "group", "kv_len")}
    parts = []
    for i in range(0, kf.shape[0], chunk):
        ql, kl = slice(i * g, (i + chunk) * g), slice(i, i + chunk)
        parts.append(fn(qf[ql], kf[kl], vf[kl], of[ql], dof[ql], lse[ql],
                        **a))
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


def hold_bwd(what: str, got, want, bounds) -> float:
    """(dq, dk, dv) against the plain version's within ``ref.bwd_bounds``
    element by element (``ref.bwd_ratio`` at most 1).  Returns the worst
    ratio."""
    from repro_torch.kernels.flash_attn import ref

    worst = 0.0
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        r = float(ref.bwd_ratio(g, w, b).max())
        if not torch.isfinite(g).all() or not r <= 1:
            fail(f"{what}: {name} {r:.3g}x its bound from the plain "
                 f"version's (finite: {bool(torch.isfinite(g).all())})")
        worst = max(worst, r)
    return worst


def check_flash_attention_bwd(device) -> dict:
    """Phase 4i, kernels: B6 with its log-sum-exp (``return_lse``) and
    B6-bwd on the card, at every case of :func:`bwd_cases`:

    * B6's output with ``lse`` requested is bit-equal to the launch without
      it, and ``lse`` lies within ``LSE_ATOL`` of the plain version's;
    * B6-bwd's (dq, dk, dv), launched twice (bit for bit), lie within
      ``ref.bwd_bounds`` of ``ref.flash_attention_bwd_plain`` on the same
      inputs (the kernel's own out and lse), element by element;
    * the plain backward, in float32 on one kv head, lies within
      ``PLAIN_BWD_RTOL`` of the largest magnitude from autograd through
      the plain forward (in bf16 the forward's own roundings, acc / l with
      p rounded, differ from P = exp(s - lse), and autograd rounds dP to
      bf16 through the cast);
    * the bounds catch two planted faults, each run through the plain
      backward in the kernel's place: the causal mask dropped (or, on an
      unmasked case, one added), and dK not summed over the group (dK of
      each group's first query head alone).

    Returns the readings, the largest absolute error among them."""
    from repro_torch.kernels.flash_attn import kernel, ref

    fwd, bwd = kernel.flash_attention_call, kernel.flash_attention_bwd_call
    saved = fwd.launches, bwd.launches
    out_rows, worst_err, worst_ratio = [], 0.0, 0.0
    for case in bwd_cases():
        label, b, s, hq, hkv, dh, causal, window = case
        qf, kf, vf, dof, kw = bwd_inputs(case, device)
        a = {x: kw[x] for x in ("causal", "window", "group", "kv_len")}
        s_txt = f"S {s}" if not isinstance(s, tuple) else \
            f"Sq {s[0]}, Sk {s[1]}"
        what = (f"B6-bwd {label} (B {b}, {s_txt}, Hq {hq}, Hkv {hkv}, dh "
                f"{dh}, causal {causal}, window {window})")
        plain_out = fwd(qf, kf, vf, **kw)
        out, lse = fwd(qf, kf, vf, **kw, return_lse=True)
        if not torch.equal(out, plain_out):
            fail(f"{what}: B6's output with lse differs from without it")
        _, lse_want = ref.flash_attention_plain(qf, kf, vf, **kw,
                                                return_lse=True)
        lse_err = float((lse - lse_want).abs().max())
        if not lse_err <= LSE_ATOL:
            fail(f"{what}: lse {lse_err:.3g} from the plain version's "
                 f"(limit {LSE_ATOL})")
        got = bwd(qf, kf, vf, out, dof, lse, **a)
        again = bwd(qf, kf, vf, out, dof, lse, **a)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{what}: a launch and its repeat differ")
        want = per_kv_head(ref.flash_attention_bwd_plain, qf, kf, vf, out,
                           dof, lse, kw)
        bounds = per_kv_head(ref.bwd_bounds, qf, kf, vf, out, dof, lse, kw)
        ratio = hold_bwd(what, got, want, bounds)
        err = max(float((x.double() - y.double()).abs().max())
                  for x, y in zip(got, want))
        share = max(float((x != y).float().mean()) for x, y in zip(got, want))
        # the plain backward against autograd through the plain forward, in
        # float32 on the first kv head (its query heads)
        g = kw["group"]
        q1, k1, v1 = (x.float().requires_grad_(True)
                      for x in (qf[:g], kf[:1], vf[:1]))
        o1, l1 = ref.flash_attention_plain(q1, k1, v1, **kw, return_lse=True)
        auto = torch.autograd.grad(o1, (q1, k1, v1), dof[:g].float())
        mine = ref.flash_attention_bwd_plain(
            q1.detach(), k1.detach(), v1.detach(), o1.detach(),
            dof[:g].float(), l1.detach(), **a)
        auto_ratio = max(float((x - y).abs().max() / y.abs().max())
                         for x, y in zip(mine, auto))
        if not auto_ratio <= PLAIN_BWD_RTOL:
            fail(f"{what}: the plain backward {auto_ratio:.3g} of the "
                 f"largest magnitude from autograd through the plain forward "
                 f"(float32; limit {PLAIN_BWD_RTOL})")
        # planted faults, through the plain backward on the first two kv
        # heads: each must break the bounds
        n2 = min(2, kf.shape[0])
        sl, kl = slice(0, n2 * g), slice(0, n2)
        planted = {"causal mask dropped" if causal else "causal mask added":
                   ref.flash_attention_bwd_plain(
                       qf[sl], kf[kl], vf[kl], out[sl], dof[sl], lse[sl],
                       **{**a, "causal": not causal})[1:]}
        if g > 1:
            one = ref.flash_attention_bwd_plain(
                qf[sl][::g].contiguous(), kf[kl], vf[kl],
                out[sl][::g].contiguous(), dof[sl][::g].contiguous(),
                lse[sl][::g].contiguous(), **{**a, "group": 1})
            planted["dK of one query head a group"] = one[1:2]
        caught = {}
        for fault, parts in planted.items():
            r = max(float(ref.bwd_ratio(x, w[kl], bb[kl]).max())
                    for x, w, bb in zip(parts, want[1:], bounds[1:]))
            if not r > 1:
                fail(f"{what}: the bounds miss a planted fault ({fault}: "
                     f"{r:.3g}x)")
            caught[fault] = r
        worst_err = max(worst_err, err, lse_err)
        worst_ratio = max(worst_ratio, ratio)
        row = {"case": label, "ratio": ratio, "max_abs_err": err,
               "share_not_bit_equal": share, "lse_err": lse_err,
               "plain_vs_autograd_f32": auto_ratio, "faults": caught}
        out_rows.append(row)
        log(f"{what}: within {ratio:.3g} of the bounds (max abs err "
            f"{err:.3g}, {share:.3g} of the elements not bit-equal), lse "
            f"{lse_err:.3g}, out with lse bit-equal, repeat bit-identical; "
            f"plain vs autograd (f32) {auto_ratio:.3g} of the largest; "
            f"planted faults " + ", ".join(f"{f} {r:.3g}x"
                                           for f, r in caught.items()))
        del qf, kf, vf, dof, out, lse, got, again, want, bounds
        free_device()
    # a float32 CUDA input under grad has no backward: it raises
    x = torch.zeros((1, 8, 2, 16), device=device, requires_grad=True)
    from repro_torch.kernels.flash_attn.ops import flash_attention
    try:
        flash_attention(x, x, x)
    except RuntimeError as e:  # torchlint: disable=FALLBACK -- the call must raise: the handler logs the refusal, else fails
        log(f"B6 float32 under grad refused: {str(e)[:80]}...")
    else:
        fail("B6 float32 under grad on the card did not raise")
    fwd.launches, bwd.launches = saved
    return {"cases": out_rows, "max_abs_err": worst_err,
            "worst_ratio": worst_ratio}


def b6_bwd_floor_ms(case) -> float:
    """The two-kernel B6-bwd's own floor at a causal ``bwd_cases`` case:
    14*B*Hq*dh*pairs FLOP (S and dP again in the second kernel; pairs
    S(S+1)/2) at the bf16 tensor-core peak.  Worked out from the shape,
    not measured: it goes in log lines, not in the kernels line."""
    from repro_torch.analysis.roofline import H100

    _, b, s, hq, _, dh, causal, window = case
    if not causal or window or not isinstance(s, int):
        raise ValueError("b6_bwd_floor_ms: a causal case of one length "
                         "and no window expected")
    return 14 * b * hq * dh * (s * (s + 1) // 2) \
        / H100["peak_bf16_flops"] * 1e3


def b6_bwd_time(err: float, device) -> dict:
    """Phase 5 for B6-bwd at tinyllama-1.1b's training shape (B 8, Hq 32,
    Hkv 4, dh 64, S 2,048, causal): the kernels' device time (both, summed
    by the profiler), the wall time of one wrapper call, the plain
    backward's device time (and ``forward_lse``: B6 at the same shape
    with and without its log-sum-exp, the wall time of one call with it,
    the plain forward with it, and SDPA's forward with inputs that require
    grad, which saves its log-sum-exp for its backward), and SDPA's
    backward on the same inputs in its (B, H, S, dh) layout
    (``torch.autograd.grad`` of ``scaled_dot_product_attention(is_causal=
    True, enable_gqa=True)``; yardsticks the port never calls).  Bound:
    10*B*Hq*dh*pairs FLOP (S, dP, dV, dK, dQ; pairs S(S+1)/2) at the bf16
    tensor-core peak, against q, k, v, out, dout and lse read once and dq,
    dk, dv written once (the two-kernel design's own floor is
    :func:`b6_bwd_floor_ms`, logged beside it, never in the row)."""
    import torch.nn.functional as F

    from repro_torch.analysis.roofline import H100
    from repro_torch.kernels.flash_attn import kernel, ref

    case = bwd_cases()[0]
    _, b, s, hq, hkv, dh, causal, _ = case
    qf, kf, vf, dof, kw = bwd_inputs(case, device, seed=29)
    a = {x: kw[x] for x in ("causal", "window", "group", "kv_len")}
    bwd, fwd = kernel.flash_attention_bwd_call, kernel.flash_attention_call
    saved = bwd.launches, fwd.launches
    out, lse = fwd(qf, kf, vf, **kw, return_lse=True)
    ql, kl, vl = (x.reshape(b, -1, s, dh).detach().requires_grad_(True)
                  for x in (qf, kf, vf))
    # B6 itself with and without the log-sum-exp (this late in the process
    # the profiler drops a session's first records: the sum after a
    # marker, as for SDPA; a call launches B6 and nothing else)
    lse_call = lambda: fwd(qf, kf, vf, **kw, return_lse=True)  # noqa: E731
    fwd_lse = {
        "ms_without_lse": device_ms(lambda: fwd(qf, kf, vf, **kw), None,
                                    reps=20, lead=20,
                                    label="flash_attn without lse"),
        "ms": device_ms(lse_call, None, reps=20, lead=20,
                        label="flash_attn with lse"),
        "wall_ms": event_ms(lse_call, reps=20),
        "plain_ms": device_ms(lambda: ref.flash_attention_plain(
            qf, kf, vf, **kw, return_lse=True), None, reps=2, warmup=1),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, enable_gqa=True), None, reps=20,
            lead=20, label="SDPA forward under grad")}
    call = lambda: bwd(qf, kf, vf, out, dof, lse, **a)  # noqa: E731
    dol = dof.reshape(b, hq, s, dh)
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                           enable_gqa=True)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        o_lib, (ql, kl, vl), dol, retain_graph=True)
    t = {"ms": device_ms(call, None, reps=10, lead=5,
                         label="flash_attn_bwd"),
         "wall_ms": event_ms(call, reps=10),
         "plain_ms": device_ms(lambda: per_kv_head(
             ref.flash_attention_bwd_plain, qf, kf, vf, out, dof, lse, kw),
             None, reps=2, warmup=1),
         "library_ms": device_ms(lib, None, reps=10, lead=10,
                                 label="SDPA backward")}
    got = call()
    lib_err = max(float((x.reshape(y.shape).double() - y.double()).abs()
                        .max()) for x, y in zip(lib(), got))
    bwd.launches, fwd.launches = saved
    pairs = s * (s + 1) // 2
    nops = 10 * b * hq * dh * pairs
    # q, out, dout and k, v read, lse read (f32), dq and dk, dv written
    nbytes = 2 * (3 * b * s * hq * dh + 2 * b * s * hkv * dh) \
        + 4 * b * hq * s + 2 * (b * s * hq * dh + 2 * b * s * hkv * dh)
    t_ops = nops / H100["peak_bf16_flops"] * 1e3
    t_bytes = nbytes / H100["hbm_bytes_per_s"] * 1e3
    log(f"  B6-bwd vs SDPA's backward: max abs diff {lib_err:.3g} (not held: "
        f"another algorithm)")
    t.update({"name": "flash_attn_bwd", "route": "cuda",
              "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
              "replaces": "none: src/repro/models/attention.py:88 (XLA's "
                          "VJP of the reference's attention; the TPU kernel "
                          "B6 has no backward)",
              "launches": None, "max_abs_err": err,
              "bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "shape": f"B {b}, Hq {hq}, Hkv {hkv}, dh {dh}, S {s}, causal, "
                       f"bf16", "bytes": nbytes, "ops": nops,
              "forward_lse": fwd_lse})
    del qf, kf, vf, dof, out, lse, ql, kl, vl, o_lib
    free_device()
    return t


def lm_train_vs_cpu(device, arch: str = LM_ARCH, n_layers: int = 2,
                    seq: int = 512, grad_ulps: int = TRAIN_GRAD_ULPS,
                    lever: dict | None = None) -> dict:
    """Phases 4i and 4j: ``arch`` at full width, its first ``n_layers``
    layers (an encoder-decoder's first ``n_layers`` encoder and decoder
    layers), one batch of 1 x ``seq`` tokens from ``TextPipeline`` (made on
    the card, copied to the CPU: an encoder-decoder's frames too): the loss
    and every gradient leaf on the card (B6, B6-bwd, cuBLAS) against a CPU
    copy of the same f32 masters (the plain versions), both under
    deterministic algorithms.  The loss within ``TRAIN_LOSS_RTOL``, each
    leaf within ``grad_ulps`` bf16 ulps of its largest magnitude on the
    CPU.  MoE, routing first (:class:`RoutingReplay`): the card's
    recompute must repeat the card's routing, the CPU's own choices may
    differ from the card's in at most ``MOE_FLIP_SHARE`` of a layer's
    (token, choice) pairs, and the CPU copy then trains on the card's
    routing, so that both sides compute one function.  ``lever``: config
    fields set on both sides (phase 4m's ``parallel_block``).  Returns the
    readings."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.lm_text import TextPipeline
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.launch.train import deterministic, lm_batches
    from repro_torch.models import registry
    from repro_torch.tree import leaves, rebuild, tree_map

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              **(lever or {}))
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_enc_layers=n_layers)
    fns = registry.build(cfg)
    pipe = TextPipeline(seq_len=seq, batch_size=1, vocab_size=256)

    def loss_and_grads(params, batch):
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = fns.loss(rebuild(params, live), batch)
        return loss.detach(), torch.autograd.grad(loss, live,
                                                  materialize_grads=True)

    fwd, bwd = kernel.flash_attention_call, kernel.flash_attention_bwd_call
    saved = fwd.launches, bwd.launches
    t0 = time.perf_counter()
    with deterministic():
        params = fns.init(0, device=device)
        cpu_params = tree_map(lambda t: t.cpu(), params)
        batch = lm_batches(cfg, pipe, device)(0)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        replay = RoutingReplay(cfg, params, cpu_params)
        fwd.launches = bwd.launches = 0
        with replay.recording():
            loss_g, grads_g = loss_and_grads(params, batch)
        torch.cuda.synchronize()
        counts = fwd.launches, bwd.launches
        with replay.replaying():
            loss_c, grads_c = loss_and_grads(cpu_params, cpu_batch)
    fwd.launches, bwd.launches = saved
    if counts != train_launches(cfg):
        fail(f"{arch} card vs CPU training: B6 / B6-bwd launches {counts}, "
             f"not {train_launches(cfg)}")
    loss_gap = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst = 0.0
    for i, (g, c) in enumerate(zip(grads_g, grads_c)):
        c = c.float()
        top = float(c.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
        err = float((g.float().cpu() - c).abs().max())
        if not torch.isfinite(g).all() or not err <= grad_ulps * ulp:
            fail(f"{arch} card vs CPU training: gradient leaf {i} "
                 f"{tuple(g.shape)} {err:.3g} off, {grad_ulps} bf16 ulps of "
                 f"its largest magnitude are {grad_ulps * ulp:.3g}")
        worst = max(worst, err / ulp if ulp else 0.0)
    if not loss_gap <= TRAIN_LOSS_RTOL:
        fail(f"{arch} card vs CPU training: loss {float(loss_g)} vs "
             f"{float(loss_c)} ({loss_gap:.3g} > {TRAIN_LOSS_RTOL})")
    out = {"arch": arch, "layers": n_layers, "tokens": seq,
           "lever": lever or {},
           "loss_card": float(loss_g), "loss_cpu": float(loss_c),
           "loss_rel_gap": loss_gap, "worst_grad_ulps": worst,
           "leaves": len(grads_g), "launches": counts,
           "seconds": time.perf_counter() - t0}
    if replay.flips is not None:
        out["routing_flips"] = replay.flips
    log(f"{arch} training, first {n_layers} layers at full width, 1 x "
        f"{seq} tokens: loss card {out['loss_card']:.6f} vs CPU "
        f"{out['loss_cpu']:.6f} (rel {loss_gap:.3g}, limit "
        f"{TRAIN_LOSS_RTOL}); {len(grads_g)} gradient leaves within "
        f"{worst:.3g} bf16 ulps of their largest (limit {grad_ulps}); "
        f"B6 {counts[0]}, B6-bwd {counts[1]} launches"
        + (f"; routing flips CPU vs card by layer {replay.flips} of "
           f"{replay.pairs} (token, choice) pairs each, the card's recompute "
           f"repeating its routing" if replay.flips is not None else "")
        + f"; {out['seconds']:.1f} s")
    del params, cpu_params, grads_g, grads_c
    free_device()
    return out


class RoutingReplay:
    """MoE card vs CPU (:func:`lm_train_vs_cpu`): ``recording()`` keeps each
    layer's top-k experts from the card's forward (a router's layer is
    found by its storage) and fails if the card's remat recompute routes
    otherwise; ``replaying()`` has the CPU copy compute its own routing,
    counts its flips against the card's (``flips``, by layer; fails above
    ``MOE_FLIP_SHARE``), then take the card's experts with the CPU's own
    probabilities at them, renormalised, as its gates.  A no-op for the
    other families (``flips`` None)."""

    def __init__(self, cfg, params, cpu_params):
        self.moe = cfg.family == "moe"
        self.flips = [] if self.moe else None
        self.idx, self.pairs = {}, 0
        self.layer_of = {}
        if self.moe:
            for tree in (params, cpu_params):
                for i, lp in enumerate(tree["layers"]):
                    self.layer_of[lp["moe"].router.data_ptr()] = i

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe

        if not self.moe:
            yield
            return
        route = moe.route
        moe.route = lambda router, xg, top_k, cf: fn(
            route(router, xg, top_k, cf), self.layer_of[router.data_ptr()])
        try:
            yield
        finally:
            moe.route = route

    def recording(self):
        def record(r, layer):
            if layer not in self.idx:
                self.idx[layer] = r.idx
            elif not torch.equal(self.idx[layer], r.idx):
                fail(f"MoE layer {layer}: the card's remat recompute routed "
                     f"otherwise than its forward")
            return r
        return self._patched(record)

    def replaying(self):
        def replay(r, layer):
            want = self.idx[layer].cpu()
            if len(self.flips) == layer:  # the forward: count the flips
                self.pairs = want.numel()
                self.flips.append(int((r.idx != want).sum()))
                if self.flips[-1] > MOE_FLIP_SHARE * self.pairs:
                    fail(f"MoE layer {layer}: {self.flips[-1]} of "
                         f"{self.pairs} (token, choice) pairs routed "
                         f"otherwise on the CPU than on the card, over "
                         f"{MOE_FLIP_SHARE}")
            vals = torch.gather(r.probs, -1, want)
            return r._replace(gates=vals / vals.sum(-1, keepdim=True),
                              idx=want)
        return self._patched(replay)


def lm_train(argv) -> tuple:
    """One LM run of the training launcher, ``launcher.main(argv)``, B6's
    and B6-bwd's counts set to 0 just before it and read just after.
    Returns (report, counts)."""
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.launch import train as launcher

    fwd, bwd = kernel.flash_attention_call, kernel.flash_attention_bwd_call
    fwd.launches = bwd.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(argv)
    counts = {"flash_attn": fwd.launches, "flash_attn_bwd": bwd.launches}
    lines = buf.getvalue().splitlines()
    log("\n".join(lines[:1] + [ln for ln in lines if ln.startswith("step")]
                  + lines[-2:-1]))
    if rc != 0:
        fail(f"train launcher {' '.join(argv)} returned {rc}")
    return report_of(lines, "train_report", " ".join(argv)), counts


def lm_step_work(cfg, b: int, s: int) -> dict:
    """A training step's least work, for its bound.  Products (bf16): the
    forward's, ``serving_work``'s counts with the head on every token — 2
    x the params a token passes through, less the embedding (a gather);
    MoE only its k routed and its shared experts; an encoder-decoder's
    encoder layers and cross K/V projections over its ``enc_len_for(s)``
    frames —; the backward twice that; the blocks' forward again where
    they are recomputed (every family but the hybrid; the head is outside
    the blocks), less each block's last product (:func:`recompute_skip`:
    torch's checkpoint stops its recompute once the backward's saved
    tensors are back, and nothing saved comes after it).  Attention: 4 B
    Hq dh a kept pair (causal, within a hybrid's window, unmasked over the
    frames) forward, again in a recompute, 10 in B6-bwd (S, dP, dV, dK,
    dQ).  An SSM's scan products
    (``analysis.roofline.ssd_flops``, f32 at the f32 peak): forward,
    backward twice, and again in a recompute.  Bytes: Adam's update reads
    params, grads and both moments and writes params and moments, f32 (28
    bytes a param, every expert's)."""
    from repro_torch.analysis.roofline import H100, ssd_flops
    from repro_torch.configs.base import param_count

    work = serving_work(cfg, b, s)
    remat = cfg.family != "hybrid"
    head = 2 * cfg.d_model * cfg.padded_vocab(1) * b * s
    attn = work["attention_ops"] // 4 * (18 if remat else 14)
    flops = (4 if remat else 3) * work["block_ops"] + 3 * head + attn \
        - (recompute_skip(cfg, b, s) if remat else 0)
    scan = (4 if remat else 3) * ssd_flops(cfg, b, s)
    nbytes = 28 * param_count(cfg)
    t_ops = (flops / H100["peak_bf16_flops"]
             + scan / H100["peak_fp32_flops"]) * 1e3
    t_bytes = nbytes / H100["hbm_bytes_per_s"] * 1e3
    return {"flops": flops, "scan_flops": scan, "attention_flops": attn,
            "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def recompute_skip(cfg, b: int, s: int) -> int:
    """The products a training step's recompute leaves out: each
    checkpointed block's last product, whose output the backward does not
    need (its inputs are saved before it) — the FFN's output projection
    (an MoE block's shared experts' one; with none, the routed experts'
    combine saves last and nothing is left out), an SSM block's out
    projection, over every decoder layer and an encoder-decoder's encoder
    layers over its frames."""
    from repro_torch.models.encdec import enc_len_for

    d = cfg.d_model
    if cfg.family == "ssm":
        return 2 * cfg.d_inner * d * b * s * cfg.n_layers
    width = cfg.n_shared_experts * cfg.d_ff if cfg.family == "moe" \
        else cfg.d_ff
    tokens = b * s * cfg.n_layers
    if cfg.family == "encdec":
        tokens += b * enc_len_for(s) * cfg.n_enc_layers
    return 2 * width * d * tokens


def train_launches(cfg) -> tuple:
    """B6's and B6-bwd's launches in one training step of ``cfg``: one of
    each an attention (an encoder-decoder's encoder layer one, its decoder
    layer two: self and cross), B6 once more where the block is recomputed
    (every family but the hybrid)."""
    if cfg.family == "ssm":
        n = 0
    elif cfg.family == "encdec":
        n = cfg.n_enc_layers + 2 * cfg.n_layers
    else:
        n = cfg.n_layers
    return (n if cfg.family == "hybrid" else 2 * n), n


def lm_train_breakdown(device, b: int = 8, s: int = 2048,
                       arch: str = LM_ARCH, layers: int = 0) -> dict:
    """Where the device time of one of phase 4i's or 4j's training steps
    goes: ``arch`` at full width (its first ``layers`` layers, 0 for all;
    random weights from seed 0), b x s tokens of ``TextPipeline``, the
    launcher's step (Adam at its default rate, global norm clipped to 1.0)
    under deterministic algorithms; one step as
    warm-up, then one under the profiler.  Device time summed by kernel
    class (``kernel_class``: B6, B6-bwd, the matrix products, everything
    else) and the idle share 1 - busy / wall, wall on the host clock around
    the step (it ends in a synchronisation).  Late in a long process the
    profiler drops a session's first records (thousands of them here), so
    the session (:func:`device_events`) opens with a whole step of its own
    before its marker."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_text import TextPipeline
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.launch.train import deterministic, lm_batches
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    name = cfg.name + (f" ({layers} layers)" if layers else "")
    fwd, bwd = kernel.flash_attention_call, kernel.flash_attention_bwd_call
    saved = fwd.launches, bwd.launches
    with deterministic():
        fns = registry.build(cfg)
        opt = adam(3e-4)
        step = make_train_step(fns.loss, opt, max_grad_norm=1.0)
        run = {"state": init_train_state(fns.init(0, device=device), opt)}
        pipe = TextPipeline(seq_len=s, batch_size=b,
                            vocab_size=min(cfg.vocab_size, 256))
        batch = lm_batches(cfg, pipe, device)(0)

        def one_step():
            run["state"], metrics = step(run["state"], batch)
            return metrics

        one_step()  # warm-up
        torch.cuda.synchronize()
        evs, (wall, metrics) = device_events(
            lambda: host_wall(one_step), lead=one_step,
            label=f"{name} training step")
    fwd.launches, bwd.launches = saved
    by_class, by_name = sum_by_class(evs)
    busy = sum(by_class.values())
    if busy <= 0 or (train_launches(cfg)[1] and "B6-bwd" not in by_class):
        fail(f"{name} training step: the profiler recorded "
             f"{sorted(by_class)} (B6-bwd expected)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
           "by_class_ms": by_class, "loss": float(metrics["loss"]),
           "top": [(n[:80], v) for n, v in top]}
    log(f"breakdown {name} training step {b} x {s}: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}); by "
        f"class {json.dumps({k: round(v, 3) for k, v in by_class.items()})}"
        f"; top {[(n[:60], round(v, 3)) for n, v in top]}")
    del run, batch, fns
    free_device()
    return out


def lm_train_breakdown_fresh(b: int = 8, s: int = 2048, arch: str = LM_ARCH,
                             layers: int = 0) -> dict:
    """:func:`lm_train_breakdown` in a process of its own (one card, this
    checkout's build).  This late in this long process, one H100 run's
    profiler kept no record of a whole training step, where a fresh process
    keeps them all; whether :func:`device_events`' lead-in step and marker
    alone would cure that is untried, so the step is profiled here.  Its
    log line is passed on; it fails when the child fails."""
    free_device()
    code = ("import json, torch, chip_smoke\n"
            "from repro_torch.kernels.common import disable_tf32\n"
            "disable_tf32()\n"
            f"out = chip_smoke.lm_train_breakdown(torch.device('cuda', 0), "
            f"{b}, {s}, {arch!r}, {layers})\n"
            "print('lm_train_breakdown ' + json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.splitlines()
    for ln in lines:
        if not ln.startswith("lm_train_breakdown "):
            log(ln)
    if r.returncode or not lines:
        fail(f"{arch} training-step breakdown (own process) exited "
             f"{r.returncode}: {r.stderr.strip()[-400:]}")
    return json.loads(lines[-1].split(" ", 1)[1])


def lm_train_phase(device, smi: str, b: int = 8, s: int = 2048) -> tuple:
    """Phase 4i, training: B6 with its lse and B6-bwd held
    (``check_flash_attention_bwd``), the card against the CPU
    (``lm_train_vs_cpu``), then tinyllama-1.1b whole (22 layers, random
    weights from seed 0) through ``repro_torch.launch.train`` at 8 x 2,048
    tokens a step, twice:

    * run A, ``TRAIN_STEPS`` steps uninterrupted, no checkpoint: the loss
      falls; B6 and B6-bwd counted from 0 just before the run, 44 and 22
      launches a step (phase 4k repeats it on the mesh);
    * run B, the same from a fresh checkpoint directory with a crash
      injected at step 3: its steps before the
      crash repeat A's losses bit for bit (a rerun), and after the restart
      from the step-0 checkpoint (12 bytes a parameter: params and Adam's
      moments) its losses and params digest equal A's (crash + restart ==
      uninterrupted, at full depth).

    Returns (B6-bwd's kernel readings, the phase's record, the main path's
    launch counts of run A)."""
    with took("check_flash_attention_bwd"):
        held = check_flash_attention_bwd(device)
    with took("lm_train_vs_cpu"):
        vs_cpu = lm_train_vs_cpu(device)
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    steps = TRAIN_STEPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        base = ["--arch", LM_ARCH, "--steps", str(steps), "--batch", str(b),
                "--seq", str(s), "--device", device.type]
        with took("4i run A"):
            rep_a, counts = lm_train(base + ["--ckpt-every", "0",
                                             "--ckpt-dir", f"{tmp}/a"])
        with took("4i run B"):
            rep_b, counts_b = lm_train(base + [
                "--ckpt-every", "1000", "--ckpt-dir", f"{tmp}/b",
                "--inject-fault-at", "3"])
    per_step = train_launches(cfg)
    if (counts["flash_attn"], counts["flash_attn_bwd"]) != \
            (per_step[0] * steps, per_step[1] * steps) or \
            rep_a["train_step_calls"] != steps:
        fail(f"{LM_ARCH} training: launches {counts} over "
             f"{rep_a['train_step_calls']} steps, not {per_step} a step")
    calls_b = rep_b["train_step_calls"]
    if (counts_b["flash_attn"], counts_b["flash_attn_bwd"]) != \
            (per_step[0] * calls_b, per_step[1] * calls_b) or \
            calls_b != steps + 3:
        fail(f"{LM_ARCH} training with a crash: launches {counts_b} over "
             f"{calls_b} steps")
    first, last = rep_a["first_loss"], rep_a["last_loss"]
    if not (math.isfinite(last) and last < first):
        fail(f"{LM_ARCH} training: loss {first} -> {last} did not fall")
    if rep_b["loss_log"][:3] != rep_a["loss_log"][:3]:
        fail(f"{LM_ARCH} training: a rerun's losses differ: "
             f"{rep_b['loss_log'][:3]} vs {rep_a['loss_log'][:3]}")
    if rep_b["losses"] != rep_a["losses"] or \
            rep_b["params_digest"] != rep_a["params_digest"]:
        fail(f"{LM_ARCH} training: crash + restart differs from "
             f"uninterrupted: {rep_b['losses']} vs {rep_a['losses']}, "
             f"digest {rep_b['params_digest']} vs {rep_a['params_digest']}")
    work = lm_step_work(cfg, b, s)
    with took("lm_train_breakdown_fresh"):
        breakdown = lm_train_breakdown_fresh(b, s)
    steps_s = sum(rep_a["step_ms"]) / 1e3
    record = {
        "arch": LM_ARCH, "batch": b, "seq": s, "steps": steps,
        "losses": rep_a["losses"], "ms_per_step": rep_a["ms_per_step"],
        "tokens_per_s": rep_a["tokens_per_s"],
        "peak_device_gib": rep_a["peak_device_gib"],
        "step_bound_ms": work["bound_ms"], "step_bound_by": work["bound_by"],
        "step_flops": work["flops"],
        "launches_per_step": {"flash_attn": counts["flash_attn"] / steps,
                              "flash_attn_bwd": counts["flash_attn_bwd"]
                              / steps},
        "runner_wall_s": rep_a["wall_s"],
        "setup_s": rep_a["wall_s"] - steps_s,
        "restart_run_wall_s": rep_b["wall_s"],
        "rerun_bit_equal_steps": 3, "restart_bit_equal": True,
        "params_digest": rep_a["params_digest"],
        "vs_cpu": vs_cpu, "breakdown": breakdown, "smi": smi}
    log(f"{LM_ARCH} training at {b} x {s} tokens, all {cfg.n_layers} layers: "
        f"{record['ms_per_step']:.1f} ms a step (median of steps 2-{steps}), "
        f"{record['tokens_per_s']:.0f} tokens/s, bound "
        f"{work['bound_ms']:.1f} ms ({work['bound_by']}: "
        f"{work['flops']:.4g} FLOP), peak {record['peak_device_gib']:.2f} "
        f"GiB; the runner's wall {rep_a['wall_s']:.1f} s of which "
        f"{record['setup_s']:.1f} s outside the steps; with the step-0 "
        f"checkpoint and the crash {rep_b['wall_s']:.1f} s; "
        f"launches a step B6 {per_step[0]}, B6-bwd {per_step[1]}  [{smi}]")
    return held, record, counts


def family_train(arch: str, layers: int, b: int, quant, cut: str,
                 smi: str) -> tuple:
    """Phase 4j for one entry of ``FAMILY_TRAIN``: ``FAMILY_STEPS`` steps of
    ``b`` x ``FAMILY_SEQ`` tokens through ``repro_torch.launch.train``
    (random weights from seed 0, byte-level batches, Adam with clipping),
    twice, B6's and B6-bwd's counts set to 0 just before each run:

    * run A without checkpoints (``--ckpt-every 0``): the loss falls, the
      launches a step are :func:`train_launches`';
    * run B the same again (a rerun), or for mamba2-1.3b with its step-0
      checkpoint and a crash at step 2 (steps 0-1, the restore, steps 0-2):
      its steps before the crash repeat A's losses bit for bit, and it ends
      on A's losses and params digest bit for bit; its checkpoint directory
      is deleted once read.

    A ``b`` under 8 is first raised to the largest batch whose step fits
    (:func:`fit_batch`).  Beside the step's time: tokens/s, peak memory,
    the bound (:func:`lm_step_work`) and the batch tries.  Returns (the
    ``lm_train_run`` record, the launches of both runs)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import param_count

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers,
                              quant=quant or full.quant)
    name = arch + (f" ({layers} of {full.n_layers} layers)"
                   if layers else "") + (f" --quant {quant}" if quant else "")
    b, tries = fit_batch(cfg, b)
    if tries:
        cut = f"batch {b} of 8, the largest that fits ({tries}): {cut}"
    base = ["--arch", arch, "--steps", str(FAMILY_STEPS), "--batch", str(b),
            "--seq", str(FAMILY_SEQ), "--device", "cuda"]
    if layers:
        base += ["--layers", str(layers)]
    if quant:
        base += ["--quant", quant]
    crash = arch == SSM_ARCH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_4j_") as tmp:
        rep_a, counts_a = lm_train(base + ["--ckpt-every", "0",
                                           "--ckpt-dir", f"{tmp}/a"])
        free_device()
        if crash:
            rep_b, counts_b = lm_train(base + [
                "--ckpt-every", "1000", "--ckpt-dir", f"{tmp}/b",
                "--inject-fault-at", "2"])
            shutil.rmtree(f"{tmp}/b")
        else:
            rep_b, counts_b = lm_train(base + ["--ckpt-every", "0",
                                               "--ckpt-dir", f"{tmp}/b"])
        free_device()
    per_step = train_launches(cfg)
    calls = {"A": rep_a["train_step_calls"], "B": rep_b["train_step_calls"]}
    if calls != {"A": FAMILY_STEPS, "B": FAMILY_STEPS + 2 * crash}:
        fail(f"{name} training: {calls} train-step calls")
    for run, counts in (("A", counts_a), ("B", counts_b)):
        want = {"flash_attn": per_step[0] * calls[run],
                "flash_attn_bwd": per_step[1] * calls[run]}
        if counts != want:
            fail(f"{name} training, run {run}: launches {counts}, not "
                 f"{per_step} a step over {calls[run]} steps")
    first, last = rep_a["first_loss"], rep_a["last_loss"]
    if not (math.isfinite(last) and last < first):
        fail(f"{name} training: loss {first} -> {last} did not fall")
    if crash and rep_b["loss_log"][:2] != rep_a["loss_log"][:2]:
        fail(f"{name} training: the steps before the crash differ from the "
             f"first run's: {rep_b['loss_log'][:2]} vs {rep_a['loss_log'][:2]}")
    if rep_b["losses"] != rep_a["losses"] or \
            rep_b["params_digest"] != rep_a["params_digest"]:
        fail(f"{name} training: the second run ({'crash + restart' if crash else 'a rerun'}) "
             f"differs from the first: {rep_b['losses']} vs {rep_a['losses']}, "
             f"digest {rep_b['params_digest']} vs {rep_a['params_digest']}")
    work = lm_step_work(cfg, b, FAMILY_SEQ)
    state_gib = 16 * param_count(cfg) / 2 ** 30
    peak = rep_a["peak_device_gib"]
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    record = {
        "arch": arch, "layers": cfg.n_layers, "quant": quant, "batch": b,
        "seq": FAMILY_SEQ, "steps": FAMILY_STEPS, "cut": cut,
        "losses": rep_a["losses"], "params_digest": rep_a["params_digest"],
        "balance_loss": rep_a["balance_loss"],
        "ms_per_step": rep_a["ms_per_step"], "step_ms": rep_a["step_ms"],
        "tokens_per_s": rep_a["tokens_per_s"], "peak_device_gib": peak,
        "state_gib": state_gib,
        "batch_tries": tries,
        "card_gib": card_gib, "step_bound_ms": work["bound_ms"],
        "step_bound_by": work["bound_by"], "step_flops": work["flops"],
        "scan_flops": work["scan_flops"],
        "launches_per_step": {"flash_attn": per_step[0],
                              "flash_attn_bwd": per_step[1]},
        "second_run": "crash at step 2 + restart" if crash else "rerun",
        "second_run_bit_equal": True, "runner_wall_s": rep_a["wall_s"],
        "second_run_wall_s": rep_b["wall_s"], "smi": smi}
    balance = (f", balance term {rep_a['balance_loss']:.6f}"
               if rep_a["balance_loss"] is not None else "")
    log(f"{name} training at {b} x {FAMILY_SEQ} tokens: "
        f"{record['ms_per_step']:.1f} ms a step (median of steps "
        f"2-{FAMILY_STEPS}), {record['tokens_per_s']:.0f} tokens/s, bound "
        f"{work['bound_ms']:.1f} ms ({work['bound_by']}), peak {peak:.2f} "
        f"GiB of {card_gib:.2f} (state {state_gib:.2f}); losses "
        f"{list(rep_a['losses'].values())}{balance}; launches a step B6 "
        f"{per_step[0]}, B6-bwd {per_step[1]}; second run "
        f"({record['second_run']}, {rep_b['wall_s']:.1f} s) bit for bit; cut: "
        f"{cut}  [{smi}]")
    return record, {"flash_attn": counts_a["flash_attn"]
                    + counts_b["flash_attn"],
                    "flash_attn_bwd": counts_a["flash_attn_bwd"]
                    + counts_b["flash_attn_bwd"]}


def fit_batch(cfg, b: int) -> tuple:
    """The largest batch from ``b`` up to 8 whose training step fits on the
    card: (it, each try of a larger one — :func:`next_batch` — as (batch,
    what it did)); ``b`` itself is taken to fit (``FAMILY_TRAIN``), and the
    run at it says whether it does."""
    tries = []
    while b < 8:
        got = next_batch(cfg, b + 1)
        tries.append((b + 1, got))
        if got == "out of memory":
            break
        b += 1
    return b, tries


def next_batch(cfg, b: int) -> str:
    """One training step of ``cfg`` at ``b`` x ``FAMILY_SEQ`` tokens, as the
    launcher's (fresh weights from seed 0, Adam, clipping, deterministic):
    "out of memory" when the card cannot hold it, else its peak."""
    from repro_torch.data.lm_text import TextPipeline
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.launch.train import deterministic, lm_batches
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state, make_train_step

    saved = (kernel.flash_attention_call.launches,
             kernel.flash_attention_bwd_call.launches)
    torch.cuda.reset_peak_memory_stats()
    try:
        with deterministic():
            fns = registry.build(cfg)
            step = make_train_step(fns.loss, adam(3e-4), max_grad_norm=1.0)
            pipe = TextPipeline(seq_len=FAMILY_SEQ, batch_size=b,
                                vocab_size=256)
            step(init_train_state(fns.init(0, device="cuda"), adam(3e-4)),
                 lm_batches(cfg, pipe, "cuda")(0))
            torch.cuda.synchronize()
        out = (f"fits, peak "
               f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    except torch.OutOfMemoryError:
        out = "out of memory"
    (kernel.flash_attention_call.launches,
     kernel.flash_attention_bwd_call.launches) = saved
    free_device()
    return out


def b6_bwd_shape_time(case, device) -> dict:
    """B6-bwd (both kernels, summed by the profiler after a marker) at one
    of phase 4j's training shapes beside its bound — 10*B*Hq*dh*pairs FLOP
    at the bf16 peak, pairs as B6's (``b6_time``), against q, k, v, out,
    dout and lse read once and dq, dk, dv written once — and SDPA's
    backward on the same inputs (``is_causal`` as B6's; a window as a
    boolean band ``attn_mask``, off SDPA's flash path): a yardstick the
    port never calls."""
    import torch.nn.functional as F

    from repro_torch.analysis.roofline import H100
    from repro_torch.kernels.flash_attn import kernel

    label, b, s, hq, hkv, dh, causal, window = case
    s, sk = s if isinstance(s, tuple) else (s, s)
    qf, kf, vf, dof, kw = bwd_inputs(case, device, seed=31)
    a = {x: kw[x] for x in ("causal", "window", "group", "kv_len")}
    bwd, fwd = kernel.flash_attention_bwd_call, kernel.flash_attention_call
    saved = bwd.launches, fwd.launches
    out, lse = fwd(qf, kf, vf, **kw, return_lse=True)
    call = lambda: bwd(qf, kf, vf, out, dof, lse, **a)  # noqa: E731
    ql = qf.reshape(b, hq, -1, dh)[:, :, :s].detach().requires_grad_(True)
    kl, vl = (x.reshape(b, hkv, -1, dh)[:, :, :sk].detach()
              .requires_grad_(True) for x in (kf, vf))
    dol = dof.reshape(b, hq, -1, dh)[:, :, :s]
    if window:
        pos = torch.arange(s, device=device)
        band = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=band,
                                               enable_gqa=True)
    else:
        o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                               enable_gqa=True)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        o_lib, (ql, kl, vl), dol, retain_graph=True)
    t = {"ms": device_ms(call, None, reps=10, lead=5,
                         label=f"flash_attn_bwd {label}"),
         "wall_ms": event_ms(call, reps=10),
         "library_ms": device_ms(lib, None, reps=10, lead=10,
                                 label=f"SDPA backward {label}")}
    bwd.launches, fwd.launches = saved
    pairs = sum(min(i + 1, window or s) for i in range(s)) if causal \
        else s * sk
    nops = 10 * b * hq * dh * pairs
    nbytes = 2 * (3 * b * s * hq * dh + 2 * b * sk * hkv * dh) \
        + 4 * b * hq * s + 2 * (b * s * hq * dh + 2 * b * sk * hkv * dh)
    t_ops = nops / H100["peak_bf16_flops"] * 1e3
    t_bytes = nbytes / H100["hbm_bytes_per_s"] * 1e3
    masks = (", causal" + (f", window {window}" if window else "")
             if causal else f", Sk {sk}, unmasked")
    t.update({"bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "shape": f"{label}: B {b}, Hq {hq}, Hkv {hkv}, dh {dh}, S {s}"
                       f"{masks}, bf16", "bytes": nbytes, "ops": nops})
    del qf, kf, vf, dof, out, lse, ql, kl, vl, o_lib
    free_device()
    return t


def family_train_phase(device, smi: str) -> tuple:
    """Phase 4j, last: each entry of ``FAMILY_TRAIN`` trained twice
    (:func:`family_train`); the card against the CPU on the first 2 layers
    (an encoder-decoder's 2 + 2) at 1 x 512 tokens for the MoE, SSM, hybrid
    and encoder-decoder families (:func:`lm_train_vs_cpu`: MoE routing
    counted first and replayed); one step of mamba2-1.3b and of
    deepseek-moe-16b, each at its depth here, profiled by kernel class, each
    in a process of its own (:func:`lm_train_breakdown_fresh`); B6-bwd timed at the
    training shapes (``FAMILY_BWD_SHAPES``).  Returns (the records, the
    launches of the training runs, the B6-bwd timings by key)."""
    records, launches = [], {"flash_attn": 0, "flash_attn_bwd": 0}
    for arch, layers, b, quant, cut in FAMILY_TRAIN:
        t0 = time.perf_counter()
        rec, counts = family_train(arch, layers, b, quant, cut, smi)
        rec["seconds"] = time.perf_counter() - t0
        records.append(rec)
        for k in launches:
            launches[k] += counts[k]
    with took("lm_train_vs_cpu, four families"):
        vs_cpu = {arch: lm_train_vs_cpu(device, arch,
                                        grad_ulps=FAMILY_GRAD_ULPS)
                  for arch in (MOE_ARCH, SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH)}
    by_arch = {r["arch"]: r for r in records if not r["quant"]}
    for arch, out in vs_cpu.items():
        by_arch[arch]["vs_cpu"] = out
    for arch in (SSM_ARCH, MOE_ARCH):
        with took(f"lm_train_breakdown_fresh {arch}"):
            by_arch[arch]["breakdown"] = lm_train_breakdown_fresh(
                8, FAMILY_SEQ, arch, by_arch[arch]["layers"])
    bwd_times = {}
    batch_of = {r["arch"]: r["batch"] for r in records if not r["quant"]}
    for key, arch, (label, *shape), per_step in FAMILY_BWD_SHAPES:
        t = b6_bwd_shape_time((label, batch_of[arch], *shape), device)
        t["launches_per_step"] = per_step
        bwd_times[key] = t
    for rec in records:
        log("lm_train_run " + json.dumps(rec))
    return records, launches, bwd_times

# phase 4k: the dense archs whose heads a tp mesh splits (B6 per rank)
TP_ARCHS = ("tinyllama-1.1b", "granite-8b", "qwen2.5-14b", "minitron-8b")
TP_DEGREES = (2, 4)
TP_SEQ = 2048


def free_port() -> int:
    """A free TCP port on localhost (the world-1 process group's store)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_lm_run(b: int, s: int, arch: str = LM_ARCH, steps: int = TRAIN_STEPS,
                extra=()) -> dict:
    """``arch`` through ``torchrun --standalone --nproc-per-node 1 -m
    repro_torch.launch.train --mesh single`` at ``steps`` steps of b x s
    tokens, ``--ckpt-every 0`` (and ``extra``): its ``train_report`` (a
    process of its own, so B6's and B6-bwd's counts start at 0 in it)."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
            "--arch", arch, "--mesh", "single", "--steps",
            str(steps), "--batch", str(b), "--seq", str(s),
            "--ckpt-every", "0", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:  # stop torchrun and its worker
            os.killpg(proc.pid, 9)
            proc.wait()
    lines = out.splitlines()
    log("\n".join([ln for ln in lines if ln.startswith(("arch=", "step"))]))
    if proc.returncode != 0:
        fail(f"torchrun ... --mesh single returned {proc.returncode}:\n"
             + "\n".join(lines[-120:]))
    return report_of(lines, "train_report", " ".join(argv[3:]))


def check_b6_tp_slices(device, cases=None) -> list:
    """B6, and B6 + B6-bwd under grad, at the heads one rank of a tp mesh
    holds: for each case (default: each dense arch, causal over
    ``TP_SEQ``) at tp 2 and 4 (heads padded by ``padded_heads(tp)``),
    random bf16 q, k, v of 1 x Sq (k, v 1 x Sk) tokens run once over all
    the heads and once per rank's slice in turn; the slices' outputs (and
    dq, dk, dv) concatenated must equal the one launch's bit for bit:
    heads are independent and a slice holds whole GQA groups.  A case is
    (label, arch, Sq, Sk, causal, window)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.ops import flash_attention

    if cases is None:
        cases = [(arch, arch, TP_SEQ, TP_SEQ, True, 0) for arch in TP_ARCHS]
    gen = torch.Generator(device=device).manual_seed(41)
    out = []
    for label, arch, sq, sk, causal, window in cases:
        cfg = get_config(arch)
        attend = lambda q, k, v: flash_attention(  # noqa: E731
            q, k, v, causal=causal, window=window)
        for tp in TP_DEGREES:
            hq, hkv = cfg.padded_heads(tp)
            dh = cfg.head_dim
            q, k, v = (torch.randn((1, n, h, dh), generator=gen,
                                   device=device).to(torch.bfloat16)
                       for n, h in ((sq, hq), (sk, hkv), (sk, hkv)))
            dout = torch.randn((1, sq, hq, dh), generator=gen,
                               device=device).to(torch.bfloat16)

            def run(qs, ks, vs, dos):
                leaves = [t.detach().requires_grad_(True)
                          for t in (qs, ks, vs)]
                with torch.no_grad():
                    fwd = attend(*leaves)
                o = attend(*leaves)
                grads = torch.autograd.grad(o, leaves, dos)
                return [fwd, o.detach(), *grads]

            whole = run(q, k, v, dout)
            lq, lkv = hq // tp, hkv // tp
            parts = [run(q[:, :, r * lq:(r + 1) * lq],
                         k[:, :, r * lkv:(r + 1) * lkv],
                         v[:, :, r * lkv:(r + 1) * lkv],
                         dout[:, :, r * lq:(r + 1) * lq]) for r in range(tp)]
            for i, what in enumerate(("B6", "B6 under grad", "dq", "dk",
                                      "dv")):
                joined = torch.cat([p[i] for p in parts], dim=2)
                if not torch.equal(joined, whole[i]):
                    fail(f"{label} tp {tp}: {what} over the ranks' heads "
                         f"({lq}, {lkv}) differs from one launch over "
                         f"({hq}, {hkv})")
            out.append({"case": label, "arch": arch, "tp": tp,
                        "heads": [hq, hkv], "local_heads": [lq, lkv],
                        "group": lq // lkv, "sq": sq, "sk": sk,
                        "causal": causal, "window": window})
            masks = ("causal" + (f", window {window}" if window else "")
                     if causal else "unmasked")
            log(f"B6 and B6 + B6-bwd at {label}'s tp-{tp} local heads "
                f"(Hq, Hkv) = ({lq}, {lkv}) (group {lq // lkv}, dh {dh}, "
                f"1 x {sq} over {sk}, {masks}): the {tp} ranks' slices "
                f"concatenated == one launch over ({hq}, {hkv}), bit for "
                f"bit")
    return out


def mesh_mrf_and_serving(device) -> dict:
    """MRF under ``--mesh single`` at world 1 (a one-rank NCCL group made
    here, ``(data=1, model=1)``): ``mrf-fpga`` with the ``fused`` (B2) and
    ``float`` backends through the launcher, each against its mesh-less
    run bit for bit (params digest, losses, B2's launches); then the
    executor's B4 and B5 maps under the mesh's rules against the integer
    oracle and against the mesh-less executor, bit for bit.  Returns the
    launches made under the mesh by kernel."""
    import torch.distributed as dist

    from repro_torch.core import qat
    from repro_torch.data.pipeline import denormalize_targets
    from repro_torch.dist.sharding import make_mesh, use_rules
    from repro_torch.kernels.qat_dense import fused as fused_fwd
    from repro_torch.kernels.qat_dense import kernel as qat_kernel
    from repro_torch.launch.mesh import rules_for
    from repro_torch.serve.executor import WaveExecutor

    launches = {"fused_train_multistep": 0, "fused_forward": 0,
                "qat_dense": 0}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        for backend, extra in (("fused", ["--tile-batch", "128",
                                          "--optimizer", "sgd",
                                          "--chunk-steps", "10"]),
                               ("float", [])):
            argv = ["--arch", "mrf-fpga", "--backend", backend, "--steps",
                    "20", "--batch", "256", "--lr", "1e-3", "--ckpt-every",
                    "0", *extra]
            plain, meshed = train(argv), train(argv + ["--mesh", "single"])
            if meshed["dtensor_leaves"] != meshed["state_leaves"] or \
                    meshed["mesh"] != {"data": 1, "model": 1}:
                fail(f"mrf-fpga {backend} --mesh single: state not DTensors "
                     f"on (1, 1): {meshed}")
            for key in ("params_digest", "first_loss", "last_loss",
                        "launches"):
                if meshed[key] != plain[key]:
                    fail(f"mrf-fpga {backend}: --mesh single {key} "
                         f"{meshed[key]} != mesh-less {plain[key]}")
            launches["fused_train_multistep"] += meshed["launches"][
                "fused_train_multistep"]
            log(f"mrf-fpga {backend} under --mesh single == mesh-less, bit "
                f"for bit: digest {meshed['params_digest']}, loss "
                f"{meshed['first_loss']:.6f} -> {meshed['last_loss']:.6f}, "
                f"B2 launches {meshed['launches']['fused_train_multistep']}")
        from repro_torch.core.mrf_net import ADAPTED_HIDDEN
        ints = calibrated_net(ADAPTED_HIDDEN, 5, device)
        gen = torch.Generator(device=device).manual_seed(6)
        x = torch.rand((5000, 64), generator=gen, device=device) * 2 - 1
        oracle = denormalize_targets(qat.int_forward(
            [dataclasses.replace(layer, **{
                f.name: getattr(layer, f.name).cpu()
                for f in dataclasses.fields(layer)
                if getattr(layer, f.name) is not None}) for layer in ints],
            x.cpu())).numpy()
        rules = rules_for(make_mesh((1, 1), ("data", "model"), "cuda"),
                          global_batch=x.shape[0])
        for impl, counter in (("fused", fused_fwd.fused_forward_call),
                              ("layered", qat_kernel.qat_dense_call)):
            plain = WaveExecutor(backend="int8", int_layers=ints,
                                 int8_impl=impl).dispatch([x]).wait()
            counter.launches = 0
            with use_rules(rules):
                meshed = WaveExecutor(backend="int8", int_layers=ints,
                                      int8_impl=impl).dispatch([x]).wait()
            launches["fused_forward" if impl == "fused" else
                     "qat_dense"] += counter.launches
            if counter.launches <= 0 or not (meshed == oracle).all() or \
                    not (meshed == plain).all():
                fail(f"executor {impl} under the mesh: maps differ from the "
                     f"oracle or the mesh-less executor ({counter.launches} "
                     f"launches)")
            log(f"executor int8 {impl} under the (1, 1) mesh's rules: "
                f"{x.shape[0]} voxels == qat.int_forward oracle and == "
                f"mesh-less, bit for bit ({counter.launches} launches)")
    finally:
        dist.destroy_process_group()
    return launches


def mesh_phase(device, smi: str, record_4i: dict, b: int = 8,
               s: int = 2048) -> tuple:
    """Phase 4k, the sharded path: tinyllama-1.1b trained whole through
    ``torchrun ... --mesh single`` twice (:func:`mesh_lm_run`): the params
    and Adam's moments DTensors on the (1, 1) mesh, B6 and B6-bwd in
    ``local_map``; every loss and the params digest equal phase 4i's
    mesh-less run A of the same steps bit for bit, its B6 and B6-bwd
    launches a step (44 / 22), and the rerun repeats it bit for bit.  Then
    B6 at the tp meshes' local heads (:func:`check_b6_tp_slices`) and MRF
    training and serving under the mesh (:func:`mesh_mrf_and_serving`).
    Returns (its record, the main path's launches by kernel)."""
    from repro_torch.configs import get_config

    per_step = train_launches(get_config(LM_ARCH))
    runs = [mesh_lm_run(b, s) for _ in range(2)]
    rep = runs[0]
    if rep["mesh"] != {"data": 1, "model": 1} or \
            rep["dtensor_leaves"] != rep["state_leaves"] or \
            rep["state_leaves"] <= 0:
        fail(f"--mesh single: the state is not DTensors on the (1, 1) mesh: "
             f"{ {k: rep.get(k) for k in ('mesh', 'dtensor_leaves', 'state_leaves')} }")
    if rep["losses"] != record_4i["losses"] or \
            rep["params_digest"] != record_4i["params_digest"]:
        fail(f"--mesh single differs from phase 4i's mesh-less run: losses "
             f"{rep['losses']} vs {record_4i['losses']}, digest "
             f"{rep['params_digest']} vs {record_4i['params_digest']}")
    if (rep["flash_attn_launches"], rep["flash_attn_bwd_launches"]) != \
            (per_step[0] * TRAIN_STEPS, per_step[1] * TRAIN_STEPS):
        fail(f"--mesh single: launches {rep['flash_attn_launches']} / "
             f"{rep['flash_attn_bwd_launches']}, not {per_step} a step")
    again = runs[1]
    if (again["losses"], again["params_digest"]) != \
            (rep["losses"], rep["params_digest"]):
        fail(f"--mesh single: a rerun differs: {again['losses']} vs "
             f"{rep['losses']}")
    log(f"{LM_ARCH} under torchrun --mesh single (DTensor params and "
        f"moments, {rep['state_leaves']} leaves on the (1, 1) mesh): losses "
        f"and digest == phase 4i's mesh-less run bit for bit, a rerun too; "
        f"{rep['ms_per_step']:.1f} ms a step against 4i's "
        f"{record_4i['ms_per_step']:.1f}, peak {rep['peak_device_gib']:.2f} "
        f"GiB against {record_4i['peak_device_gib']:.2f}; launches a step "
        f"B6 {per_step[0]}, B6-bwd {per_step[1]}  [{smi}]")
    slices = check_b6_tp_slices(device)
    free_device()
    launches = mesh_mrf_and_serving(device)
    launches["flash_attn"] = rep["flash_attn_launches"]
    launches["flash_attn_bwd"] = rep["flash_attn_bwd_launches"]
    record = {"arch": LM_ARCH, "mesh": rep["mesh"], "batch": b, "seq": s,
              "steps": TRAIN_STEPS, "losses": rep["losses"],
              "params_digest": rep["params_digest"],
              "ms_per_step": rep["ms_per_step"],
              "step_ms": [r["step_ms"] for r in runs],
              "ms_per_step_4i": record_4i["ms_per_step"],
              "peak_device_gib": rep["peak_device_gib"],
              "peak_device_gib_4i": record_4i["peak_device_gib"],
              "tokens_per_s": rep["tokens_per_s"],
              "wall_s": [r["wall_s"] for r in runs],
              "dtensor_leaves": rep["dtensor_leaves"],
              "bit_equal_4i": True, "rerun_bit_equal": True,
              "b6_tp_slices": slices, "launches": launches, "smi": smi}
    return record, launches


# phase 4l: the attention shapes of the families trained under the mesh
# whose heads a tp mesh splits per rank — (label, arch, Sq, Sk, causal,
# window): hymba's window and global layers, deepseek's, seamless's decoder
# self- and cross-attention (its encoder's 512 frames at seamless's heads)
MESH_FAMILY_CASES = (
    ("hymba-1.5b window", HYBRID_ARCH, TP_SEQ, TP_SEQ, True, 1024),
    ("hymba-1.5b global", HYBRID_ARCH, TP_SEQ, TP_SEQ, True, 0),
    ("deepseek-moe-16b", MOE_ARCH, TP_SEQ, TP_SEQ, True, 0),
    ("seamless-m4t-large-v2 self", ENCDEC_ARCH, TP_SEQ, TP_SEQ, True, 0),
    ("seamless-m4t-large-v2 cross", ENCDEC_ARCH, TP_SEQ, 512, False, 0),
)


def mesh_family_phase(device, smi: str, records_4j: list) -> tuple:
    """Phase 4l, the other families on the sharded path: each of phase
    4j's non-QAT entries (mamba2-1.3b, hymba-1.5b, deepseek-moe-16b at its
    4j depth, seamless-m4t-large-v2) through ``torchrun ... --mesh single``
    with 4j's run A's arguments (:func:`mesh_lm_run`; the depth as
    ``--layers``): every state leaf a DTensor on the (1, 1) mesh — the
    experts and SSM heads placed over ``model``, the MoE block and the
    SSM mixer's scan in ``local_map``, B6 and B6-bwd per rank —; every
    loss and the params digest equal to 4j's run A bit for bit; B6's and
    B6-bwd's launches :func:`train_launches`' a step.  Then B6 and B6 +
    B6-bwd at these families' tp-2 and tp-4 local heads
    (``MESH_FAMILY_CASES``, :func:`check_b6_tp_slices`).  Returns (its
    record, the launches of its runs by kernel)."""
    from repro_torch.configs import get_config

    runs, launches = [], {"flash_attn": 0, "flash_attn_bwd": 0}
    for a in (r for r in records_4j if not r["quant"]):
        arch = a["arch"]
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=a["layers"])
        extra = (["--layers", str(a["layers"])]
                 if a["layers"] != full.n_layers else [])
        t0 = time.perf_counter()
        rep = mesh_lm_run(a["batch"], a["seq"], arch, a["steps"], extra)
        seconds = time.perf_counter() - t0
        per_step = train_launches(cfg)
        name = arch + (f" ({a['layers']} of {full.n_layers} layers)"
                       if extra else "")
        if rep["mesh"] != {"data": 1, "model": 1} or \
                rep["dtensor_leaves"] != rep["state_leaves"] or \
                rep["state_leaves"] <= 0:
            fail(f"{name} --mesh single: the state is not DTensors on the "
                 f"(1, 1) mesh: { {k: rep.get(k) for k in ('mesh', 'dtensor_leaves', 'state_leaves')} }")
        if rep["train_step_calls"] != a["steps"] or \
                (rep["flash_attn_launches"], rep["flash_attn_bwd_launches"]) \
                != (per_step[0] * a["steps"], per_step[1] * a["steps"]):
            fail(f"{name} --mesh single: {rep['train_step_calls']} steps, "
                 f"launches {rep['flash_attn_launches']} / "
                 f"{rep['flash_attn_bwd_launches']}, not {per_step} a step")
        if rep["losses"] != a["losses"] or \
                rep["params_digest"] != a["params_digest"]:
            fail(f"{name} --mesh single differs from phase 4j's mesh-less "
                 f"run A: losses {rep['losses']} vs {a['losses']}, digest "
                 f"{rep['params_digest']} vs {a['params_digest']}")
        launches["flash_attn"] += rep["flash_attn_launches"]
        launches["flash_attn_bwd"] += rep["flash_attn_bwd_launches"]
        rec = {"arch": arch, "layers": a["layers"], "batch": a["batch"],
               "seq": a["seq"], "steps": a["steps"], "mesh": rep["mesh"],
               "losses": rep["losses"], "params_digest": rep["params_digest"],
               "bit_equal_4j": True, "dtensor_leaves": rep["dtensor_leaves"],
               "ms_per_step": rep["ms_per_step"], "step_ms": rep["step_ms"],
               "ms_per_step_4j": a["ms_per_step"],
               "tokens_per_s": rep["tokens_per_s"],
               "tokens_per_s_4j": a["tokens_per_s"],
               "peak_device_gib": rep["peak_device_gib"],
               "peak_device_gib_4j": a["peak_device_gib"],
               "balance_loss": rep["balance_loss"],
               "launches_per_step": {"flash_attn": per_step[0],
                                     "flash_attn_bwd": per_step[1]},
               "wall_s": rep["wall_s"], "seconds": seconds, "smi": smi}
        runs.append(rec)
        log(f"{name} under torchrun --mesh single at {a['batch']} x "
            f"{a['seq']} tokens ({rep['state_leaves']} DTensor leaves on the "
            f"(1, 1) mesh): losses and digest == phase 4j's mesh-less run A "
            f"bit for bit; {rep['ms_per_step']:.1f} ms a step against 4j's "
            f"{a['ms_per_step']:.1f}, {rep['tokens_per_s']:.0f} tokens/s "
            f"against {a['tokens_per_s']:.0f}, peak "
            f"{rep['peak_device_gib']:.2f} GiB against "
            f"{a['peak_device_gib']:.2f}; launches a step B6 {per_step[0]}, "
            f"B6-bwd {per_step[1]}; {seconds:.1f} s  [{smi}]")
        free_device()
    with took("check_b6_tp_slices, 4l"):
        slices = check_b6_tp_slices(device, MESH_FAMILY_CASES)
    for rec in runs:
        log("mesh_family_run " + json.dumps(rec))
    return {"runs": runs, "b6_tp_slices": slices, "smi": smi}, launches


LEVER_STEPS = 3
INT8_LOSS_SHARE = 0.1       # the reference's test_int8_hlo_close_to_float
COUNTER_RTOL = 0.01         # the counter against lm_step_work's FLOP
INT8_DENSE_SHAPES = ((8, 256, 2048, 5632), (1, 8, 2048, 2048))


def lever_run(cfg, b: int, s: int, device, count: bool = False) -> dict:
    """One run of the port's train step (``train/step.py``, Adam at the
    launcher's 3e-4, global norm clipped to 1.0, deterministic algorithms)
    on ``cfg`` at full width, random weights from seed 0, the launcher's
    batches (``lm_batches``, steps 0..LEVER_STEPS-1): the losses, ms a
    step (host clock around a step that ends in reading its loss; the
    median of the steps after the first), the peak of
    ``torch.cuda.max_memory_allocated`` from the initial state on, B6 and
    B6-bwd launches a step, the params digest.  ``count``: one more step
    under ``analysis.cost.StepCounter`` (its record under ``cost``)."""
    from repro_torch.analysis.cost import StepCounter
    from repro_torch.data.lm_text import TextPipeline
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.launch.train import (deterministic, lm_batches,
                                          params_digest, warm_backward)
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_map

    fwd, bwd = kernel.flash_attention_call, kernel.flash_attention_bwd_call
    free_device()
    out = {"losses": [], "step_ms": []}
    with deterministic():
        fns = registry.build(cfg)
        opt = adam(3e-4)
        step = make_train_step(fns.loss, opt, max_grad_norm=1.0)
        pipe = TextPipeline(seq_len=s, batch_size=b,
                            vocab_size=min(cfg.vocab_size, 256))
        batches = lm_batches(cfg, pipe, device)
        warm_backward(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        state = init_train_state(fns.init(0, device=device), opt)
        before = fwd.launches, bwd.launches
        for i in range(LEVER_STEPS):
            batch = batches(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            out["losses"].append(float(metrics["loss"]))
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches_per_step"] = [
            (fwd.launches - before[0]) / LEVER_STEPS,
            (bwd.launches - before[1]) / LEVER_STEPS]
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        out["ms_per_step"] = statistics.median(out["step_ms"][1:])
        out["params_digest"] = params_digest(state.params)
        # the activations one forward keeps for its backward (the step's
        # peak is Adam's update, where they are gone)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        live = tree_map(lambda p: p.detach().requires_grad_(True),
                        state.params)
        loss = fns.loss(live, batches(0))
        torch.cuda.synchronize()
        out["forward_kept_gib"] = (torch.cuda.memory_allocated(device)
                                   - base) / 2 ** 30
        del loss, live
        if count:
            batch = batches(LEVER_STEPS)
            counter = StepCounter((state, batch))
            with counter:
                new = step(state, batch)
            torch.cuda.synchronize()
            out["cost"] = counter.result()
            del new
    del state, batch
    free_device()
    return out


def int8_dense_vs_cpu(device) -> list:
    """``dense(quant="int8-hlo")`` (``torch._int_mm`` on the card) against
    the CPU on the same x and f32 w, bf16 and f32, at an MLP product of
    phase 4m's step and at a decode step's 8 rows (padded to 17 for the
    card's operator): bit for bit."""
    from repro_torch.models.common import dense

    rows = []
    gen = torch.Generator().manual_seed(11)
    for b, sq, k, n in INT8_DENSE_SHAPES:
        w = 0.02 * torch.randn((k, n), generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((b, sq, k), generator=gen).to(dtype)
            got = dense(x.to(device), w.to(device), quant="int8-hlo").cpu()
            want = dense(x, w, quant="int8-hlo")
            if not torch.equal(got, want):
                fail(f"int8-hlo dense {(b, sq, k, n)} {dtype}: card != CPU, "
                     f"{float((got.float() - want.float()).abs().max()):.3g}"
                     f" off")
            rows.append({"shape": [b, sq, k, n], "dtype": str(dtype),
                         "bit_equal": True})
    return rows


def int8_product_times(device, m: int = 16384, k: int = 2048,
                       n: int = 5632) -> dict:
    """int8-hlo's product alone at tinyllama's widest MLP product (8 x
    2,048 tokens): ``torch._int_mm`` with its second operand row-major (as
    ``models.common.int8_product`` passes it) and column-major, beside the
    bf16 product of the float step; ms between CUDA events
    (:func:`event_ms`).  Both layouts give the same int32 sums."""
    gen = torch.Generator(device=device).manual_seed(3)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    b_cols = b.t().contiguous().t()
    if not torch.equal(torch._int_mm(a, b), torch._int_mm(a, b_cols)):
        fail("_int_mm: a column-major operand gives other sums")
    xb = torch.randn((m, k), generator=gen, device=device).bfloat16()
    wb = torch.randn((k, n), generator=gen, device=device).bfloat16()
    out = {"shape": [m, k, n],
           "int_mm_row_major_ms": event_ms(lambda: torch._int_mm(a, b)),
           "int_mm_col_major_ms": event_ms(lambda: torch._int_mm(a, b_cols)),
           "bf16_mm_ms": event_ms(lambda: torch.matmul(xb, wb))}
    del a, b, b_cols, xb, wb
    return out


def lever_phase(device, smi: str, b: int = 8, s: int = 2048) -> tuple:
    """Phase 4m: the dry-run slice's levers and its cost counter on the
    card, tinyllama-1.1b whole (22 layers) at 4i's 8 x 2,048 tokens, the
    launcher's batches, 3 steps a run (:func:`lever_run`):

    1. ``remat="full"``: ms a step, peak GiB, B6 / B6-bwd launches a step
       (44 / 22), and one more step under ``analysis.cost.StepCounter``:
       its products' and attention's FLOP within ``COUNTER_RTOL`` of
       ``lm_step_work``; the dry-run's fake trace of the same step at
       world 1 (``launch.dryrun.trace_cell``, no mesh) counts the same
       FLOP, its memory peak printed beside the card's as a ratio;
    2. ``remat="save_attn"``: losses and params digest bit-equal to run 1,
       the same launches, its peak and a forward's kept activations beside
       run 1's (the step's peak is Adam's update, after the backward);
    3. ``parallel_block``: losses finite and the first loss within 10% of
       run 1's; its first 2 layers card vs CPU (``lm_train_vs_cpu``);
    4. ``quant="int8-hlo"``: ``dense`` card vs CPU bit for bit
       (:func:`int8_dense_vs_cpu`); the first loss within
       ``INT8_LOSS_SHARE`` of run 1's; ms a step beside run 1's; its
       product alone beside bf16's (:func:`int8_product_times`).

    Returns (the ``dryrun_run`` record, B6's and B6-bwd's launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.launch import dryrun

    fwd, bwd = kernel.flash_attention_call, kernel.flash_attention_bwd_call
    fwd.launches = bwd.launches = 0
    cfg = get_config(LM_ARCH)
    runs = {"full": lever_run(cfg, b, s, device, count=True)}
    for name, lever in (("save_attn", dict(remat="save_attn")),
                        ("parallel_block", dict(parallel_block=True)),
                        ("int8-hlo", dict(quant="int8-hlo"))):
        runs[name] = lever_run(dataclasses.replace(cfg, **lever), b, s,
                               device)
    launches = {"flash_attn": fwd.launches,
                "flash_attn_bwd": bwd.launches}
    full, saved = runs["full"], runs["save_attn"]
    want = [float(n) for n in train_launches(cfg)]
    for name, run in runs.items():
        if run["launches_per_step"] != want:
            fail(f"4m {name}: B6 / B6-bwd launches a step "
                 f"{run['launches_per_step']}, not {want}")
        if not all(map(math.isfinite, run["losses"])):
            fail(f"4m {name}: losses {run['losses']}")
    if saved["losses"] != full["losses"] or \
            saved["params_digest"] != full["params_digest"]:
        fail(f"4m save_attn differs from full: {saved['losses']} vs "
             f"{full['losses']}, digest {saved['params_digest']} vs "
             f"{full['params_digest']}")
    first = full["losses"][0]
    for name in ("parallel_block", "int8-hlo"):
        gap = abs(runs[name]["losses"][0] - first) / first
        runs[name]["first_loss_gap"] = gap
        if not gap < INT8_LOSS_SHARE:
            fail(f"4m {name}: first loss {runs[name]['losses'][0]} vs "
                 f"full's {first} ({gap:.3g} >= {INT8_LOSS_SHARE})")
    pb_vs_cpu = lm_train_vs_cpu(device, lever=dict(parallel_block=True))
    int8_rows = int8_dense_vs_cpu(device)
    int8_times = int8_product_times(device)

    cost = full.pop("cost")
    work = lm_step_work(cfg, b, s)
    counter_gap = cost["flops"] / work["flops"] - 1
    if not abs(counter_gap) <= COUNTER_RTOL:
        fail(f"4m counter: {cost['flops']:.6g} FLOP against lm_step_work's "
             f"{work['flops']:.6g} ({counter_gap:+.3g})")
    t0 = time.perf_counter()
    fake = dryrun.trace_cell(cfg, ShapeCell("phase_4m", s, b, "train"))
    trace_s = time.perf_counter() - t0
    if fake["flops"] != cost["flops"] or \
            fake["flops_by_op"] != cost["flops_by_op"]:
        fail(f"4m: the fake trace counts {fake['flops_by_op']}, the card's "
             f"step {cost['flops_by_op']}")
    fake_peak = fake["memory"]["peak_per_device_bytes"] / 2 ** 30
    record = {
        "arch": LM_ARCH, "batch": b, "seq": s, "steps": LEVER_STEPS,
        "runs": runs, "save_attn_peak_gib_over_full":
            saved["peak_gib"] - full["peak_gib"],
        "save_attn_predicted_gib": cfg.n_layers * b * s * cfg.d_model * 2
            / 2 ** 30,
        "save_attn_forward_kept_gib_over_full":
            saved["forward_kept_gib"] - full["forward_kept_gib"],
        "parallel_block_vs_cpu": pb_vs_cpu, "int8_dense_vs_cpu": int8_rows,
        "int8_product_times": int8_times,
        "counter": {"flops": cost["flops"], "flops_by_op": cost["flops_by_op"],
                    "hbm_bytes": cost["hbm_bytes"], "ops": cost["ops"],
                    "memory": cost["memory"],
                    "lm_step_work_flops": work["flops"],
                    "gap": counter_gap},
        "fake_trace": {"flops": fake["flops"], "trace_s": trace_s,
                       "peak_gib": fake_peak,
                       "peak_over_card_peak": fake_peak / full["peak_gib"],
                       "memory": fake["memory"]},
        "launches": launches, "smi": smi}
    log(f"4m {LM_ARCH} at {b} x {s}, {LEVER_STEPS} steps a run: full "
        f"{full['ms_per_step']:.1f} ms a step, peak {full['peak_gib']:.2f} "
        f"GiB; save_attn bit-equal, peak {saved['peak_gib']:.2f} GiB "
        f"(+{record['save_attn_peak_gib_over_full']:.3f}, predicted "
        f"+{record['save_attn_predicted_gib']:.3f}), a forward's kept "
        f"activations {saved['forward_kept_gib']:.3f} against "
        f"{full['forward_kept_gib']:.3f} GiB; parallel_block first "
        f"loss {runs['parallel_block']['losses'][0]:.6f}; int8-hlo "
        f"{runs['int8-hlo']['ms_per_step']:.1f} ms a step, first loss "
        f"{runs['int8-hlo']['losses'][0]:.6f} vs {first:.6f}, _int_mm "
        f"{int8_times['int_mm_row_major_ms']:.3f} ms (column-major "
        f"{int8_times['int_mm_col_major_ms']:.3f}) against bf16 "
        f"{int8_times['bf16_mm_ms']:.3f} at {int8_times['shape']}; counter "
        f"{cost['flops']:.6g} FLOP ({counter_gap:+.2e} of lm_step_work), "
        f"the fake trace the same in {trace_s:.1f} s, its peak "
        f"{fake_peak:.2f} GiB = {record['fake_trace']['peak_over_card_peak']:.4f}"
        f" of the card's  [{smi}]")
    return record, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke run needs an NVIDIA H100", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.common import disable_tf32
        from repro_torch.kernels.qat_dense import ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, smi = device_facts()
    device = torch.device("cuda", 0)
    disable_tf32()
    build.check_device(device)

    t0 = time.perf_counter()
    logs = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)} "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for kname, text in logs.items():
        for ln in text.splitlines():
            if any(w in ln for w in ("registers", "smem", "spill", "C75",
                                     "arning")):
                log(f"  ptxas {kname}: {ln.strip()}")

    with took("check_sass"):
        check_sass(build)

    t_checks = time.perf_counter()
    from repro_torch.core import mrf_net
    layers = {arch: calibrated_net(hidden, 1, device)
              for arch, hidden in (("mrf-fpga", mrf_net.ADAPTED_HIDDEN),
                                   ("mrf-original", mrf_net.ORIGINAL_HIDDEN),
                                   ("wide (256, 256, 32)", (256, 256, 32)))}
    nets = {arch: ops.prepad_int_layers(ls) for arch, ls in layers.items()}
    with took("check_kernels"):
        errs = check_kernels(nets, device)
    with took("check_training_data"):
        check_training_data(device)
    with took("check_training_kernels"):
        errs.update(check_training_kernels(device))
    with took("check_flash_attention"):
        errs["flash_attn"] = check_flash_attention(device)
    with took("flash_attention_timing"):
        flash_row = flash_attention_timing(errs["flash_attn"], device)
    log(f"kernel checks and B6's timing: "
        f"{time.perf_counter() - t_checks:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t_serve = time.perf_counter()
        launches = serve_phase(pathlib.Path(tmp), device)
        log(f"serving phase: {time.perf_counter() - t_serve:.1f} s")
        t_chaos = time.perf_counter()
        chaos = chaos_phase(pathlib.Path(tmp), device)
        for kname, n in chaos["launches"].items():
            launches[kname] += n
        log(f"chaos phase: {time.perf_counter() - t_chaos:.1f} s")
        t_train = time.perf_counter()
        with took("train_phase"):
            train_launches, reports = train_phase(pathlib.Path(tmp), device)
        with took("train_then_serve"):
            launches["fused_forward"] += train_then_serve(device)
        log(f"training phases: {time.perf_counter() - t_train:.1f} s")
    launches.update(train_launches)
    t_paper = time.perf_counter()
    paper_launches, eq3_runs = paper_phase()
    for kname, n in paper_launches.items():
        launches[kname] += n
    log(f"paper phase (4e): {time.perf_counter() - t_paper:.1f} s")
    t_lm = time.perf_counter()
    launches["flash_attn"], token_reports = token_phase()
    fns, lm_params = lm_model(device)
    model_vs_cpu(fns, lm_params, device)
    log(f"LM phases: {time.perf_counter() - t_lm:.1f} s")
    t_moe = time.perf_counter()
    n_moe, moe_reports = moe_phase()
    launches["flash_attn"] += n_moe
    moe_fns, moe_params = lm_model(device, MOE_ARCH)
    moe_vs_cpu(moe_fns, moe_params, device)
    moe_forms(moe_fns, moe_params, device)
    log(f"MoE phase (4f): {time.perf_counter() - t_moe:.1f} s")
    t_ssm = time.perf_counter()
    n_ssm, ssm_reports = ssm_phase()
    launches["flash_attn"] += n_ssm
    ssm_fns, ssm_params = lm_model(device, SSM_ARCH)
    layers_vs_cpu(ssm_fns, ssm_params, device, [0, 1], 600)
    hyb_fns, hyb_params = lm_model(device, HYBRID_ARCH)
    layers_vs_cpu(hyb_fns, hyb_params, device, [0, 1], 1152)
    scan = ssd_time(ssm_fns, device)
    serve_batch_example()
    log(f"SSM and hybrid phase (4g): {time.perf_counter() - t_ssm:.1f} s")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"kernel {kname} was never launched on the main path")

    t_timing = time.perf_counter()
    with took("timing_phase"):
        rows = timing_phase(nets["mrf-fpga"], layers["mrf-fpga"], launches,
                            errs, device)
    with took("training_timing"):
        rows += training_timing(launches, errs, device)
    flash_row["launches"] = launches["flash_attn"]
    rows.append(flash_row)
    log(f"kernel timings (5): {time.perf_counter() - t_timing:.1f} s")
    t_breakdown = time.perf_counter()
    # last: its profiler sessions come after every kernel's timing
    lm_breakdown(fns, lm_params, device)
    lm_breakdown(moe_fns, moe_params, device)
    del lm_params, moe_params
    free_device()
    busy = lm_breakdown(ssm_fns, ssm_params, device)["prefill 8 x 2048"][
        "busy_ms"]
    log(f"{SSM_ARCH} prefill 8 x 2048: the SSD scan ~{scan['ms']:.1f} ms "
        f"(phase 4g, between CUDA events) of {busy:.1f} ms device busy "
        f"(share ~{scan['ms'] / busy:.2f})")
    lm_breakdown(hyb_fns, hyb_params, device)
    del ssm_params, hyb_params
    free_device()
    log(f"serving breakdowns: {time.perf_counter() - t_breakdown:.1f} s")
    t_4h = time.perf_counter()
    n_4h, encdec_vlm_reports = encdec_vlm_phase(device)
    flash_row["launches"] += n_4h
    log(f"encoder-decoder and VLM phase (4h): "
        f"{time.perf_counter() - t_4h:.1f} s")
    free_device()
    t_4i = time.perf_counter()
    bwd_held, lm_train_record, lm_counts = lm_train_phase(device, smi)
    flash_row["launches"] += lm_counts["flash_attn"]
    with took("b6_bwd_time"):
        bwd_row = b6_bwd_time(bwd_held["max_abs_err"], device)
    bwd_row["launches"] = lm_counts["flash_attn_bwd"]
    rows.append(bwd_row)
    log(f"LM training phase (4i): {time.perf_counter() - t_4i:.1f} s")
    t_4j = time.perf_counter()
    fam_records, fam_counts, fam_bwd = family_train_phase(device, smi)
    flash_row["launches"] += fam_counts["flash_attn"]
    bwd_row["launches"] += fam_counts["flash_attn_bwd"]
    bwd_row.update(fam_bwd)
    log(f"the other families' training phase (4j): "
        f"{time.perf_counter() - t_4j:.1f} s")
    free_device()
    t_4k = time.perf_counter()
    mesh_record, mesh_launches = mesh_phase(device, smi, lm_train_record)
    for r in rows:  # B6, B6-bwd, B2, B4, B5 launched on the sharded path
        r["launches"] += mesh_launches.get(r["name"], 0)
    log(f"the sharded path's phase (4k): {time.perf_counter() - t_4k:.1f} s")
    free_device()
    free, total = torch.cuda.mem_get_info()
    log(f"before phase 4l this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
        f"GiB in PyTorch's cache; the card has {free / 2 ** 30:.2f} of "
        f"{total / 2 ** 30:.2f} GiB free")
    t_4l = time.perf_counter()
    mesh_family_record, mesh_family_launches = mesh_family_phase(
        device, smi, fam_records)
    for r in rows:  # B6 and B6-bwd launched on the other families' runs
        r["launches"] += mesh_family_launches.get(r["name"], 0)
    log(f"the other families on the sharded path (4l): "
        f"{time.perf_counter() - t_4l:.1f} s")
    free_device()
    t_4m = time.perf_counter()
    lever_record, lever_launches = lever_phase(device, smi)
    for r in rows:  # B6 and B6-bwd launched on the levers' runs
        r["launches"] += lever_launches.get(r["name"], 0)
    log(f"the levers and the counter (4m): "
        f"{time.perf_counter() - t_4m:.1f} s")
    for r in rows:
        log(f"time {r['name']} ({r['shape']}): {r['ms']:.6f} ms on the "
            f"device, {r['wall_ms']:.6f} ms per call, plain "
            f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})  [{smi}]")
        if r["library_ms"] is not None:
            log(f"  {r['name']}: library call {r['library_ms']:.6f} ms on the "
                f"device, {r['launches']} launches on the main path")
        if "wave" in r:
            w = r["wave"]
            log(f"time {r['name']} ({w['shape']}): {w['ms']:.6f} ms on the "
                f"device, {w['wall_ms']:.6f} ms per call, plain "
                f"{w['plain_ms']:.6f} ms, bound {w['bound_ms']:.6f} ms "
                f"({w['bound_by']}); launch floor {r['launch_floor_ms']:.6f} "
                f"ms; {r['launches']} launches on the main path  [{smi}]")
        if "samples" in r:
            per_sample = r["ms"] / r["samples"]
            log(f"  {r['name']}: cluster {r['cluster']}, "
                f"{per_sample * 1e3:.4f} us a sample, one-SM bound "
                f"{r['bound_one_sm_ms']:.6f} ms, {r['cluster']} SMs' "
                f"{r['bound_c_sms_ms']:.6f} ms; projection, not a "
                f"measurement, for the {r['algorithm']}: 250 M samples x "
                f"{per_sample * 1e3:.4f} us = {per_sample * 250e6 / 1e3:.1f} "
                f"s (the FPGA's stated 200 s: 160 cycles a sample at "
                f"200 MHz)")
            for b in r["by_cluster"]:
                log(f"  {r['name']} cluster {b['cluster']}: " + (
                    f"{b['ms']:.6f} ms on the device, {b['cluster']} SMs' "
                    f"bound {b['bound_c_sms_ms']:.6f} ms" if "ms" in b
                    else f"not launched: {b['refused']}"))
        for d in (r[k] for k in B6_SHAPES if k in r):
            log(f"time {r['name']} ({d['shape']}): {d['ms']:.6f} ms on the "
                f"device, {d['wall_ms']:.6f} ms per call, plain "
                f"{d['plain_ms']:.6f} ms, bound {d['bound_ms']:.6f} ms "
                f"({d['bound_by']}), library call {d['library_ms']:.6f} ms  "
                f"[{smi}]")
    for rep in reports:
        log(f"train_run {json.dumps(rep)}")
    for rep in token_reports + moe_reports + ssm_reports + \
            encdec_vlm_reports:
        log("token_run " + json.dumps(
            {k: v for k, v in rep.items() if k != "tokens"}))
    r = bwd_row
    log(f"time {r['name']} ({r['shape']}): {r['ms']:.6f} ms on the device, "
        f"{r['wall_ms']:.6f} ms per call, plain {r['plain_ms']:.6f} ms, bound "
        f"{r['bound_ms']:.6f} ms ({r['bound_by']}), the two-kernel "
        f"design's floor {b6_bwd_floor_ms(bwd_cases()[0]):.6f} ms, SDPA's "
        f"backward {r['library_ms']:.6f} ms, {r['launches']} launches on the "
        f"main path  [{smi}]")
    for key, *_ in FAMILY_BWD_SHAPES:
        d = r[key]
        log(f"time {r['name']} ({d['shape']}): {d['ms']:.6f} ms on the "
            f"device, {d['wall_ms']:.6f} ms per call, bound "
            f"{d['bound_ms']:.6f} ms ({d['bound_by']}), SDPA's backward "
            f"{d['library_ms']:.6f} ms, {d['launches_per_step']} launches a "
            f"training step  [{smi}]")
    f = r["forward_lse"]
    log(f"time flash_attn with lse ({r['shape']}): {f['ms']:.6f} ms on the "
        f"device, {f['ms_without_lse']:.6f} ms without it, {f['wall_ms']:.6f} "
        f"ms per call, plain (with lse) {f['plain_ms']:.6f} ms, SDPA's "
        f"forward under grad {f['library_ms']:.6f} ms  [{smi}]")
    log("lm_train_run " + json.dumps(lm_train_record))
    log("mesh_run " + json.dumps(mesh_record))
    log("dryrun_run " + json.dumps(lever_record))
    log("chaos_run " + json.dumps(chaos))
    log("eq3_run " + json.dumps(eq3_summary(eq3_runs, rows, name, smi)))
    log("timed between CUDA events, the profiler having kept too little: "
        + (json.dumps(EVENT_TIMED) if EVENT_TIMED else "none"))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
