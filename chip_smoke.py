#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``), then the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one
   process per source, all started together); every instance of kernels
   B, C, E, F and I and of the backward kernels of G and I must build with
   no stack frame and no spills (F's instances and G's forward and
   backward instances also print their registers);
2. the k-means kernels ``l1_topk2`` and ``centroid_update`` at the serve
   path's shapes (``centroid_update`` also at k = 8, d = 8,192 with 1,024
   rows all assigned), each held bit for bit against its plain PyTorch
   version on the same inputs, with times (CUDA events and the profiler's
   device time per launch), the plain version's time and a one-call
   PyTorch yardstick;
3. live fleet serving of the paper's §9.2 visual-sensing workload at
   Table-3 widths (CIFAR-100 and VWW agile CNNs, random seeded weights, a
   k-means bank fitted on 384 training samples each, a solar harvester at
   eta = 0.71, 25 requests per task, 64 devices): after one untimed run
   (the example warms its fleet before timing it), scan with adaptation on a
   per-device and on a shared bank, then scan and fused (the
   ``serve_fused_steps`` kernel, one launch per segment) without adaptation,
   which must agree on every carry leaf; the scan's serve loop (on the
   card each step is two CUDA graph replays around kernel D's launch) must
   also equal the CPU's plain run from the same built state.  The launch counts
   are zeroed before this phase and read after it (kernels C, D, E).
   Kernel C is then timed over the whole horizon (545 steps) at 64 and
   1,024 devices: CUDA events around the wrapper's calls, and its device
   time per launch and per step (``_busy_ms``), with the units completed;
3a. the §9.2 scalar run (act one of ``examples/intermittent_serving.py``):
   the event-driven ``ServeEngine`` under edf, rr and zygarde (adaptation
   on for zygarde), 25 requests per task, each policy's counters and
   jobs/s; phase 3's fleet live rate must exceed the scalar rate.  The
   counts are zeroed before and read after: kernel D once per unit the
   models ran, kernel E once per adaptation;
3b. the scalar engine == the one-device fleet (``feature_batch=1``) bit
   for bit on the card, on the clock-commensurate recipe (persistent
   supply, charged start, dt 50 ms, 0.2 s units, period 2 s, deadline
   1.5 s, threshold 0.02): units, schedule, predictions and margins for
   zygarde and edf with adaptation on and off, each §9.2 model as one
   task; and the same miss sets on the overload recipe (deadline 0.7 s);
3c. the intermittent substrate: each unit of the CIFAR-100 model cut into
   4 fragments, one request through them under a weak harvester and a
   0.02 F capacitor equal, tensor for tensor, to the run under a
   persistent supply, with reboots;
3d. the million-job stream: 4,096 devices, each task cycling its 25
   requests to 123 jobs (1,007,616 jobs), ``run_stream(mode="fused")`` in
   8 chunks, then the adaptive scan stream in both bank modes on 64
   devices in 3 chunks (counts zeroed before, read after: kernel C once
   per chunk); the fused stream equals ``run(mode="fused")`` over the
   repeated request list on every log field and carry leaf, with both
   runs' jobs/s, peak memory and table bytes; the scan streams equal
   phase 3's runs; kernel C equals its plain version on the staged
   windows of the first chunk (negative ``job0``) and a middle one;
4. the replay fleet of the same two models as a sweep: job profiles from
   250 test samples per task, policies x eta x capacitor x seed = 1,600
   devices, 255 s at dt = 55 ms.  ``simulate_fleet`` in the ``vmap`` and
   ``pallas`` (the ``fleet_priority`` kernel, one launch per step) modes
   over the first 290 of its 4,636 steps (a depth cut: both are
   host-bound), and in the ``fused`` mode (the ``fleet_fused_steps``
   kernel, one launch per segment) over those steps and the whole
   horizon; the three modes must agree on every result leaf over the cut,
   and the whole fused run with ``run_segments`` in four fused segments
   and ``sweep``; the card's run equals the CPU's plain run over
   the first steps on a slice of devices; both kernels are held bit for
   bit against their plain versions and timed (A also by its device time
   per launch, back to back; B by its device time
   per segment and per step of the fleet, at 1,600 and 16,000 devices:
   CUDA events around launches enqueued while the card spins, so that no
   host work falls inside).  The launch counts are zeroed before this
   phase and read after it (kernels A, B);
4a. telemetry at full width: the phase 4 sweep over its first fortieth
   (116 steps, a depth cut), ``ring_size=256``, in the ``vmap`` and ``pallas``
   modes, each plain, ``counters`` and ``full`` (kernel A once per step of
   each pallas run), every result and carry leaf equal to the plain run's
   and pallas telemetry equal to vmap's bit for bit, with the ms per step
   of each tier; on 64 devices over 300 steps both tiers equal the on-card
   ``record_step`` fold and the CPU's plain run (ints exact, the floats'
   gap printed); then phase 3's scan with adaptation at ``full`` (every log
   field and carry leaf equal to phase 3's run, kernel D launched as often
   there) and, on a shared bank (kernel E), ``run_stream(telemetry=
   counters)`` in 3 chunks equal to ``run``'s counters over the same 3
   segments.  Counts zeroed before the phase and read after it (kernels
   A, D, E);
5. kernel F ``pairwise_l1`` held bit for bit against its plain version at
   the forecaster's first-batch shape (256 x 256 x 6), at a ``d`` that
   spans two blocks (33 x 17 x 1,100), at 1,000 x 1,000 x 64 (the 64
   tile) and at 4,096 x 4,096 x 512, with times (CUDA events, and the
   device time per launch by ``_busy_ms``), ``torch.cdist(p=1)`` as the
   one-call yardstick, and the bound;
6. offline tuning, the ``examples/adapt_tune.py`` problem at a size its
   users tune with: three harvesters x seeds 0-15 (48 cells), 30 s at
   dt = 25 ms, driver ``es`` with budget 128 and population 16, so 768
   devices per objective call (one launch of kernel B each).  The tuned
   score must beat the paper default, and one population block scored on
   the card must equal the same block scored on the CPU.  The launch
   counts are zeroed before the search and read after it (kernel B);
7. online adaptation: ``examples/online_adapt.py``'s demo (seed 11, the
   solar -> RF -> occluded trace, 318 s, 127 segments; the 10 x 10 static
   grid, the paper default, the feedback and the forecast arms, all fused)
   with its three assertions; then the forecast arm on a fleet of 256
   devices (trace seeds 0-255), where the forecaster's first batch seeds
   its table through kernel F.  The launch counts are zeroed before the
   demo and read after the fleet arm (kernels B, D, E, F; F must launch).
   Over one cycle (106 s) the card's feedback and forecast arms equal the
   CPU's plain runs on every history entry and result leaf;
8. anytime serving of the dense model configs at qwen1.5-0.5b's published
   widths (24 layers, d_model 1,024, 16 heads, vocab 151,936, bf16; seeded
   random weights, fresh exit heads): ``prefill`` of one 4,096-token
   prompt (twice, each timed) and 64 ``decode_step``s (timed in two
   halves); ``anytime_forward`` on 2 x 512 tokens
   and ``calibrate_thresholds`` at 0.98 agreement; the
   ``AnytimeServeEngine`` (16 slots, 16-token prompts, 48 new tokens, 64
   steps: a depth cut from 256, to 128 for phase 4a and to 64 for phase
   11) on 64 requests
   every 0.25 s with a 2.5 s deadline under
   ``calibrate_harvester(0.71, 0.35)`` and under a persistent supply, with
   the calibrated thresholds and again under EDF.  The launch counts are
   zeroed before and read after (kernel G, once per layer of each prefill
   and of ``anytime_forward``; kernel H, once per layer of every decode
   and engine step); then kernel G against its plain version in bf16 (the
   tensor-core kernel) and f32 (the SIMT kernel) at the main path's shape,
   causal 4,096, a 4,096 window over 8,192, glm4-9b's GQA geometry, an odd
   length, a query offset and recurrentgemma-9b's geometry (16 heads on one
   kv head, hd 256, window 2,048), timed beside
   ``scaled_dot_product_attention``, each row with its kernel's path, the
   instance's registers as ``-Xptxas -v`` reported them and its useful
   TFLOP/s beside the bound; and the port on
   the card against the port on the CPU (a reduced ``forward`` and a
   prefill + decode within 1e-4, one EDF engine run equal, also with
   ``telemetry=full``, whose telemetry equals the CPU's);
9. the same anytime path for the RG-LRU hybrid at recurrentgemma-9b's
   published widths (38 layers: 26 rec, 12 attn with MQA and a 2,048-token
   window; d_model 4,096, RG-LRU width 4,096 in 16 blocks, d_ff 12,288,
   vocab 256,000, bf16, 10 units; 9.19 B parameters): the counts zeroed
   before and read after (kernel G and kernel I once per attention and
   recurrent layer of each prefill and of ``anytime_forward``, kernel H once
   per attention layer of every decode and engine step); kernel H against
   its plain version at the decode shape, an engine batch, qwen1.5-0.5b's
   and glm4-9b's geometry and a ragged cache, beside
   ``scaled_dot_product_attention``, each row with its split of the cache
   and the GB/s it reached of the bound's bytes;
   kernel I against its plain version bit for bit at the prefill's and
   ``anytime_forward``'s shapes (its TMA path) and an odd one (its
   ``cp.async`` path), with its device time per launch (``_busy_ms``);
   and the reduced hybrid on
   the card against the CPU (a ``forward``, a prefill + decode, an EDF
   engine run);
10. the rest of the model zoo at published widths, one model resident at a
    time (each freed before the next, each with its peak device memory):
    dbrx-132b (8 of its 40 layers: 27.3 B parameters; 16 experts top-4,
    48 heads on 8 kv heads) with everything phase 8 runs but the profiles
    (a 4,096-token prefill twice, 32 decode steps, the engine under solar
    with the calibrated thresholds and under EDF); qwen3-moe-235b-a22b (4
    of its 94 layers; 128 experts top-8, 64 heads on 4) with a 4,096-token
    prefill and 16 decode steps; xlstm-125m (whole) with phase 8's runs (a
    4,096-token prefill once); seamless-m4t-medium (12 encoder layers over
    1,024 stub frames, 12 decoder layers) and internvl2-2b (256 stub patch
    rows before 3,840 text tokens) with a prefill, 64 decode steps and
    ``anytime_forward``.  Counts zeroed before and read after each model:
    kernel G once per attention, cross-attention and encoder layer of each
    sequence pass, kernel H once per attention and cross-attention layer
    of every decode and engine step.  Then kernel G against plain in bf16
    and f32 at dbrx's G = 6, qwen3-moe's 64/4, the encoder's non-causal
    1,024, the cross-attention (512 x 1,024) and internvl2's 16/8, and
    kernel H at dbrx's decode, its engine batch and the cross decode, each
    beside SDPA; and each family's reduced size on the card against the
    CPU (a ``forward`` and a prefill + decode within 1e-4, the MoE
    routers' choices equal call by call first, an EDF engine run equal on
    dbrx-132b and xlstm-125m);
11. training at full width: (a) ``train_agile_cnn`` on the serve
    workload's CIFAR-100 and VWW CNNs at Table-3 widths as
    ``src/repro/launch/serve.py`` calls it (layer-aware loss, 3 epochs, 768
    pairs), then one epoch each of the contrastive and cross-entropy
    baselines (Fig. 15), each with its loss history (the layer-aware loss
    must fall), the bank's per-unit exit accuracy on the test split and
    kernel D's launches (the threshold calibration), and 5 siamese steps of
    a narrowed CNN on the card against the CPU from the same initial
    parameters; (b) qwen1.5-0.5b whole (24 layers, bf16) and (c)
    recurrentgemma-9b at its published widths cut to one period (rec, rec,
    attn), ``train_step_lm`` on one fixed batch of ``make_lm_tokens`` (2 x
    4,096 in 2 microbatches, 3 steps; 8 x 4,096 in the config's 8, 2
    steps): the loss must fall, with ms per step, tokens/s, peak memory and
    the launches of kernels G and I forward and backward (counted per
    layer and microbatch), then one further step under ``torch.profiler``:
    the device-time shares of G's backward, I's backward, G's and I's
    forwards, the products (cuBLAS / CUTLASS GEMMs) and the rest, and the
    card's idle share of the step; (d) the backward kernels of G and I
    against their plain versions (G within 1e-4 of each gradient's largest
    in f32 and 2^-7 in bf16 at qwen's, dbrx's, the hybrid's window and a
    non-causal offset shape, each row with its instance: tensor-core in
    bf16, SIMT in f32, and its registers; I bit for bit) with times,
    bounds and, for G, the backward of ``scaled_dot_product_attention`` by
    autograd as the yardstick; (e) one step's gradients of every assigned
    config at its reduced size on the card against the CPU;
12. the launch drivers as a user calls them, in process: (a)
    ``repro_torch.launch.train.main`` on stablelm-3b whole (32 layers,
    d_model 2,560, hd 80, bf16; 2.80 B parameters) at 16 x 4,096 in its 4
    microbatches, 2 steps: s per step, tokens/s, peak memory, finite
    losses, kernel G's forward and backward launches equal to the reckoned
    counts under activation checkpointing (256 and 256 per step); (b) one
    LM backward of stablelm-3b cut to 4 layers at 4 x 4,096 with and
    without ``remat``: the peak above the call's start of each, and the
    reduced config's gradients with and without ``remat`` card against
    card; (c) ``launch.serve.main`` with the scalar engine (kernels D and
    E) and the anytime engine on qwen1.5-0.5b (kernel H), and a reduced
    xlstm-125m training run whose checkpoint under ``experiments/ckpt/``
    reloads equal;
13. the mesh entry points on the card's meshes (``make_fleet_mesh()``,
    ``make_host_mesh``: one block each), each mesh run equal on every leaf
    to its run without a mesh: phase 4's grid over its first fortieth by
    ``sweep`` in pallas mode and phase 4's config by ``run_segments`` in 3
    pallas segments with a hook (kernel A), an objective block of phase
    6's problem (B), phase 3's two adaptive serve runs (D, E), the reduced
    qwen1.5-0.5b anytime engine (H) and ``launch.train.main --mesh host``
    on the reduced config (G forward and backward); ``--mesh single-pod``
    exits 1 naming the 256 cards needed and the cards visible.  Counts
    zeroed before the mesh runs and read after;
14. profiling and the H100 roofline (``repro_torch.launch.profiling``,
    ``op_cost``, ``op_stats``, ``lowering``, ``dryrun``) on qwen1.5-0.5b
    whole: ``profile_call`` of a 4,096-token ``prefill`` (10 timed calls)
    and of the train step at 2 x 4,096 in 2 microbatches (3 timed calls),
    each with its first call, steady times, modelled flops by type, bytes,
    bound, dominant term and measured over bound; the op counter's items
    of kernel G (and its backward) equal the launches of the counted call,
    and ``lower_step`` on ``meta`` for the same ``InputShape`` equals the
    card's count on flops, products, bytes and the items of each kernel;
    the train step's costliest items; ``profile_call`` of phase 4's fused
    sweep (kernel B); a Chrome trace of one prefill that names G's CUDA
    function; and ``dryrun.main`` for qwen1.5-0.5b x train_4k on the
    single-pod layout (256 devices, ``meta``).  Its counted calls'
    launches are checked in the phase and kept out of the paths' counts;
15. the serve engines over meshes of the one card listed several times
    (``make_fleet_mesh(4, device="cuda:0")``, ``make_mesh(shape, ("data",
    "model"), "cuda:0")``): (a) phase 3's serve run cut to its first 136
    of 545 steps with the per-device bank (no adaptation) and the shared
    bank adapting, each block's kernel D per step and the shared update
    through kernel E's partial entry per block and its finish, each equal
    to the same mesh run on the CPU (every leaf without adaptation; every
    integer leaf with it, floats within 1e-4); (b) the anytime engine for
    qwen1.5-0.5b at its published widths (16 slots, 16 steps) on ``(2,
    2)`` and ``(1, 4)``: its 16 kv heads split, kernel H on each block's
    heads; (c) recurrentgemma-9b cut to one period on ``(1, 2)``: its one
    kv head's cache split by length (H's stats, merge and PV entries) and
    its RG-LRU state and conv buffer by width; both with the result
    arrays equal to the one-block run's and the decode state within 1e-5;
    (d) H's slice entries and merge against their plain versions at the
    hybrid's decode shape cut 2 and 4 ways (bf16, f32) and E's partial
    entry and finish bit for bit, each timed beside its bound.  Counts
    zeroed before each path's runs and read after;
16. one JSON line naming every kernel (and the slice entries of E and H)
    with its launches, error, times and bound.  Every phase prints its
    seconds.  Each kernel's bound is its
    ``work()`` (:mod:`repro_torch.kernels._cost`) over the H100 peaks of
    :mod:`repro_torch.launch.op_stats`.

Depth cuts that pay for phase 11: the hybrid anytime path (phase 9) runs
32 decode steps (from 64) and its engine 64 steps (from 128), the dense
anytime engine (phase 8) 64 steps (from 128), and the telemetry sweep
(phase 4a) its first 232 steps (from 464).  Depth cuts that pay for phase
12: the replay's vmap and pallas runs (phase 4) take 580 steps (from
1,159), the telemetry sweep (phase 4a) 116 (from 232), and the hybrid
anytime path (phase 9) 16 decode steps and a 32-step engine (from 32 and
64).  Depth cuts that pay for phase 13: the replay's vmap and pallas runs
(phase 4) take 290 steps (from 580) and the stablelm-3b training run
(phase 12a) 2 steps (from 3).  Phase 15 took 27 s on its own on the card
and needed no cut.

TF32 is off for the whole run (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): f32 products are full f32, as on
the CPU.
The second-to-last line is the card's ``nvidia-smi`` name and power limit;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
the script exits non-zero and prints no result.  It imports only
``repro_torch``, ``torch`` and ``numpy``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SRC = "src/repro_torch/kernels/csrc/"
# the kernels each main path runs
SERVE_KERNELS = ("serve_fused_steps", "l1_topk2", "centroid_update")
SCALAR_KERNELS = ("l1_topk2", "centroid_update")
STREAM_KERNELS = ("serve_fused_steps", "l1_topk2", "centroid_update")
REPLAY_KERNELS = ("fleet_priority", "fleet_fused_steps")
TUNE_KERNELS = ("fleet_fused_steps",)
ONLINE_KERNELS = ("fleet_fused_steps", "l1_topk2", "centroid_update",
                  "pairwise_l1")
TELEMETRY_KERNELS = ("fleet_priority", "l1_topk2", "centroid_update")
TRAIN_CNN_KERNELS = ("l1_topk2",)
MESH_KERNELS = ("fleet_priority", "fleet_fused_steps", "l1_topk2",
                "centroid_update", "decode_gqa", "flash_attention",
                "flash_attention_bwd")
MESH_SERVE_KERNELS = ("l1_topk2", "centroid_partial", "centroid_finish")
MESH_ANY_KERNELS = ("decode_gqa", "decode_gqa_stats", "decode_gqa_merge",
                    "decode_gqa_pv")
# the entries of E and H that only a mesh of several blocks runs
SLICE_ENTRIES = {"centroid_partial": "centroid_update",
                 "centroid_finish": "centroid_update",
                 "decode_gqa_stats": "decode_gqa",
                 "decode_gqa_merge": "decode_gqa",
                 "decode_gqa_pv": "decode_gqa"}
REPLACES = {
    "fleet_priority": "src/repro/kernels/fleet_priority.py:83",
    "fleet_fused_steps": "src/repro/kernels/fleet_step.py:114",
    "serve_fused_steps": "src/repro/kernels/fleet_step.py:226",
    "l1_topk2": "src/repro/kernels/l1_topk2.py:46",
    "centroid_update": "src/repro/kernels/centroid_update.py:34",
    "pairwise_l1": "src/repro/kernels/pairwise_l1.py:32",
    "flash_attention": "src/repro/kernels/flash_attn.py:90",
    "decode_gqa": "src/repro/kernels/decode_gqa.py:65",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:52",
    # the gradients of G and I: the reference differentiates XLA's
    # attention and associative scan (no Pallas backward); these replace
    # those gradients where the port runs G and I
    "flash_attention_bwd": "src/repro/kernels/flash_attn.py:90",
    "rglru_scan_bwd": "src/repro/kernels/rglru_scan.py:52",
}
SOURCES = {
    "fleet_priority": SRC + "fleet_priority.cu",
    "fleet_fused_steps": SRC + "fleet_fused.cu",
    "serve_fused_steps": SRC + "serve_fused.cu",
    "l1_topk2": SRC + "l1_topk2.cu",
    "centroid_update": SRC + "centroid_update.cu",
    "pairwise_l1": SRC + "pairwise_l1.cu",
    "flash_attention": SRC + "flash_attn.cu",
    "decode_gqa": SRC + "decode_gqa.cu",
    "rglru_scan": SRC + "rglru_scan.cu",
    "flash_attention_bwd": SRC + "flash_attn_bwd.cu",
    "rglru_scan_bwd": SRC + "rglru_scan_bwd.cu",
}


@dataclasses.dataclass(frozen=True)
class Scale:
    """What the run serves; ``FULL`` is the configuration run on the card, the
    narrow one rehearses the same phases on the CPU."""

    cnns: tuple          # ((dataset name, CNNConfig or None = Table 3), ...)
    n_train: int
    n_requests: int
    n_devices: int
    big_devices: int     # second fleet size for the fused kernel's time
    n_segments: int
    parity_jobs: int     # requests of each scalar == fleet run
    stream_devices: int  # the stream: devices, jobs per task (the base
    stream_jobs: int     # requests cycled), chunks, and the fewest jobs
    stream_chunks: int   # it must release
    min_stream_jobs: int
    l1_rows: int         # kernel D check: requests x units of both tasks
    l1_dim: int          # selected features S of the serve tables
    l1_k: int            # centroid rows C of the serve bank
    cu_shape: tuple      # kernel E check: (k, d, B), the main path's
    cu_wide: tuple       # kernel E's second shape, every row assigned
    replay_jobs: int     # test samples profiled per replay task
    replay_cut_steps: int  # steps of the replay's vmap and pallas runs
    policies: tuple      # the replay sweep's axes
    etas: tuple
    capacitors_f: tuple
    seeds: int
    big_seeds: int       # seeds of the second sweep kernel B is timed on
    cpu_check_steps: int
    cpu_check_devices: int
    pw_shapes: tuple     # kernel F checks: (B1, B2, d); the first is the
    #                      main path's, the last is timed beside it
    tune_seeds: int      # offline tuning: seeds per harvester
    tune_horizon: float
    tune_budget: int
    tune_pop: int
    demo_horizon: float  # online adaptation: the demo's horizon (s)
    demo_grid: int       # static (eta, E_opt) grid points per axis
    fleet_devices: int   # devices of the fleet forecast arm
    cpu_check_s: float   # horizon of the card == CPU online check
    check_gains: bool    # the examples' score assertions (need full depth)
    anytime: "AnyRun"    # phase 8: the dense anytime path
    hybrid: "AnyRun"     # phase 9: the RG-LRU hybrid's anytime path
    zoo: tuple           # phase 10: the rest of the model zoo, AnyRuns
    flash_shapes: tuple  # kernel G checks: (B, S, Skv, H, KV, hd, causal,
    #                      window, q_offset); the first is the main path's
    decode_shapes: tuple  # kernel H checks: (B, H, KV, hd, C, dtype,
    #                       round_p, window); the first is phase 9's decode
    rglru_shapes: tuple   # kernel I checks: (B, S, W, with h0); the first
    #                       is phase 9's prefill
    zoo_flash_shapes: tuple   # phase 10's kernel G and H checks, as
    zoo_decode_shapes: tuple  # flash_shapes and decode_shapes
    zoo_check_steps: int      # the card-vs-CPU EDF engine runs' steps
    train_cnn: "CNNTrain"     # phase 11a: the agile CNNs trained
    train_lm: tuple           # phases 11b-c: TrainRuns of the LM step
    flash_bwd_shapes: tuple   # phase 11d: G's backward, as flash_shapes
    rglru_bwd_shapes: tuple   # phase 11d: I's backward, (B, S, W)
    launch: "LaunchRun"       # phase 12: the launch drivers
    mesh_serve_steps: int     # phase 15a: the first steps of phase 3's run
    mesh_anytime: tuple       # phases 15b-c: MeshAnys
    mesh_decode_shape: tuple  # phase 15d: the long-cache timing rows of
    #                           H's slices (B, H, KV, hd, C, window), cut 2
    #                           and 4 ways


@dataclasses.dataclass(frozen=True)
class MeshAny:
    """One anytime engine run over meshes of one card (phases 15b-c): the
    model (``n_layers`` a depth cut), the engine's slots, steps, prompt and
    new tokens, the requests, and the ``(data, model)`` mesh shapes."""

    arch: str
    narrow: bool
    n_layers: int
    slots: int
    steps: int
    prompt: int
    new: int
    requests: int
    meshes: tuple


# the anytime engine's runs of phases 8 and 9: (supply, policy)
ENGINE_RUNS = (("solar", "anytime"), ("solar", "edf"),
               ("persistent", "anytime"), ("persistent", "edf"))


@dataclasses.dataclass(frozen=True)
class AnyRun:
    """One anytime-serving path: the model, the prefill + decode run,
    ``anytime_forward``'s batch and the engine's request trace."""

    arch: str
    narrow: bool         # the config's reduced() size (CPU rehearsal)
    prefill_len: int     # text tokens of the prefill + decode run (a
    #                      VLM's patches and an encoder's frames come on top)
    decode_steps: int
    full_cache: bool     # prefill's cache holds prompt + decode (no ring)
    fwd_shape: tuple     # anytime_forward's (B, S) text tokens, or () none
    requests: int        # the engine's request trace
    slots: int
    prompt: int
    new: int
    max_steps: int       # the engine's horizon in steps
    n_layers: int = 0    # a depth cut (0: the published depth)
    prefill_reps: int = 2
    engines: tuple = ENGINE_RUNS
    profile: bool = True  # profile a decode step and an engine step


@dataclasses.dataclass(frozen=True)
class CNNTrain:
    """Phase 11a: ``train_agile_cnn`` on each of ``names`` (the serve
    workload's datasets) as ``src/repro/launch/serve.py`` calls it, then one
    epoch of each Fig. 15 baseline."""

    names: tuple
    n_train: int
    n_test: int
    epochs: int
    n_pairs: int
    cfgs: tuple = ()     # per name: a CNNConfig, or () for Table 3


@dataclasses.dataclass(frozen=True)
class TrainRun:
    """One LM training run of phase 11: ``steps`` calls of
    ``train_step_lm`` on one fixed batch of ``batch`` x ``seq`` tokens."""

    arch: str
    narrow: bool         # the config's reduced() size (CPU rehearsal)
    n_layers: int        # a depth cut (0: the published depth)
    batch: int
    seq: int
    microbatches: int
    steps: int


@dataclasses.dataclass(frozen=True)
class LaunchRun:
    """Phase 12: the drivers of ``repro_torch.launch`` called in process
    as a user calls them, and what activation checkpointing buys."""

    train: tuple         # argv of the training run (the device is added)
    probe: tuple         # (arch, n_layers, batch, seq, reduced): one LM
    #                      backward with and without remat, one microbatch
    check_layers: int    # layers of the reduced card-vs-card gradients
    serve_scalar: tuple  # argv of the two serving runs
    serve_anytime: tuple
    ckpt_train: tuple    # argv of the checkpointed training run


FULL = Scale(cnns=(("cifar100", None), ("vww", None)), n_train=384,
             n_requests=25, n_devices=64, big_devices=1024, n_segments=4,
             parity_jobs=6, stream_devices=4096, stream_jobs=123,
             stream_chunks=8, min_stream_jobs=1_000_000,
             l1_rows=2 * 25 * 5, l1_dim=150, l1_k=5,
             cu_shape=(5, 8192, 64), cu_wide=(8, 8192, 1024),
             replay_jobs=250, replay_cut_steps=290,
             policies=("zygarde", "edf", "edf-m", "rr"),
             etas=(0.2, 0.5, 0.71, 0.9, 1.0),
             capacitors_f=(0.01, 0.025, 0.05, 0.1, 0.2), seeds=16,
             big_seeds=160, cpu_check_steps=300, cpu_check_devices=64,
             pw_shapes=((256, 256, 6), (33, 17, 1100), (1000, 1000, 64),
                        (4096, 4096, 512)),
             tune_seeds=16, tune_horizon=30.0, tune_budget=128, tune_pop=16,
             demo_horizon=318.0, demo_grid=10, fleet_devices=256,
             cpu_check_s=106.0, check_gains=True,
             anytime=AnyRun("qwen1.5-0.5b", False, 4096, 64, True, (2, 512),
                            64, 16, 16, 48, 64),
             hybrid=AnyRun("recurrentgemma-9b", False, 4096, 16, False,
                           (2, 512), 64, 16, 16, 48, 32),
             flash_shapes=((2, 512, 512, 16, 16, 64, True, 0, 0),
                           (1, 4096, 4096, 16, 16, 64, True, 0, 0),
                           (1, 8192, 8192, 16, 16, 64, True, 4096, 0),
                           (1, 4096, 4096, 32, 2, 128, True, 0, 0),
                           (2, 37, 37, 16, 16, 64, True, 0, 0),
                           (1, 512, 4608, 16, 16, 64, True, 0, 4096),
                           (1, 4096, 4096, 16, 1, 256, True, 2048, 0),
                           (1, 4096, 4096, 32, 32, 80, True, 0, 0)),
             decode_shapes=((1, 16, 1, 256, 2176, "bfloat16", True, 2048),
                            (16, 16, 1, 256, 64, "bfloat16", True, 2048),
                            (1, 16, 16, 64, 4160, "bfloat16", True, 0),
                            (1, 32, 2, 128, 4096, "float32", False, 16),
                            (2, 16, 1, 256, 37, "bfloat16", True, 0),
                            (2, 16, 1, 256, 37, "float32", False, 0)),
             rglru_shapes=((1, 4096, 4096, False), (2, 512, 4096, False),
                           (3, 37, 53, True)),
             zoo=(AnyRun("dbrx-132b", False, 4096, 32, True, (2, 512), 64,
                         16, 16, 48, 128, n_layers=8,
                         engines=ENGINE_RUNS[:2], profile=False),
                  AnyRun("qwen3-moe-235b-a22b", False, 4096, 16, True, (),
                         0, 16, 16, 48, 0, n_layers=4, prefill_reps=1,
                         engines=(), profile=False),
                  AnyRun("xlstm-125m", False, 4096, 64, True, (2, 512), 64,
                         16, 16, 48, 128, prefill_reps=1, profile=False),
                  AnyRun("seamless-m4t-medium", False, 1024, 64, True,
                         (2, 512), 0, 16, 16, 48, 0, prefill_reps=1,
                         engines=(), profile=False),
                  AnyRun("internvl2-2b", False, 3840, 64, True, (2, 512), 0,
                         16, 16, 48, 0, prefill_reps=1, engines=(),
                         profile=False)),
             zoo_flash_shapes=((1, 4096, 4096, 48, 8, 128, True, 0, 0),
                               (1, 4096, 4096, 64, 4, 128, True, 0, 0),
                               (1, 1024, 1024, 16, 16, 64, False, 0, 0),
                               (2, 512, 1024, 16, 16, 64, False, 0, 0),
                               (1, 4096, 4096, 16, 8, 128, True, 0, 0)),
             zoo_check_steps=96,
             zoo_decode_shapes=((1, 48, 8, 128, 4128, "bfloat16", True, 0),
                                (16, 48, 8, 128, 64, "bfloat16", True, 0),
                                (1, 16, 16, 64, 1024, "bfloat16", True, 0)),
             train_cnn=CNNTrain(("cifar100", "vww"), 384, 256, 3, 768),
             train_lm=(TrainRun("qwen1.5-0.5b", False, 0, 2, 4096, 2, 3),
                       TrainRun("recurrentgemma-9b", False, 3, 8, 4096, 8,
                                2)),
             flash_bwd_shapes=((1, 4096, 4096, 16, 16, 64, True, 0, 0),
                               (1, 1024, 1024, 48, 8, 128, True, 0, 0),
                               (1, 4096, 4096, 16, 1, 256, True, 2048, 0),
                               (1, 512, 1024, 16, 16, 64, False, 0, 512),
                               (1, 4096, 4096, 32, 32, 80, True, 0, 0)),
             rglru_bwd_shapes=((1, 4096, 4096), (2, 512, 4096)),
             launch=LaunchRun(
                 train=("--arch", "stablelm-3b", "--steps", "2", "--batch",
                        "16", "--seq", "4096", "--log-every", "1"),
                 probe=("stablelm-3b", 4, 4, 4096, False), check_layers=6,
                 serve_scalar=("--engine", "scalar", "--tasks", "mnist",
                               "--requests", "20"),
                 serve_anytime=("--engine", "anytime", "--arch",
                                "qwen1.5-0.5b", "--requests", "12"),
                 ckpt_train=("--arch", "xlstm-125m", "--reduced", "--steps",
                             "4", "--batch", "2", "--seq", "16",
                             "--ckpt-every", "4")),
             mesh_serve_steps=136,
             mesh_anytime=(MeshAny("qwen1.5-0.5b", False, 8, 16, 88, 16,
                                   48, 16, ((2, 2), (1, 4))),
                           MeshAny("recurrentgemma-9b", False, 3, 16, 120,
                                   16, 48, 16, ((1, 2),))),
             mesh_decode_shape=(1, 16, 1, 256, 2176, 2048))


def _narrow():
    from repro_torch.models.cnn import CNNConfig

    return Scale(
        cnns=(("cifar100", CNNConfig("cifar100-narrow", (32, 32, 3),
                                     ((4, 5, True), (8, 5, True)), (16, 8),
                                     5)),
              ("vww", CNNConfig("vww-narrow", (32, 32, 3),
                                ((4, 5, True), (4, 5, True), (8, 5, True)),
                                (8,), 2))),
        n_train=48, n_requests=4, n_devices=3, big_devices=5, n_segments=2,
        parity_jobs=3, stream_devices=3, stream_jobs=20, stream_chunks=4,
        min_stream_jobs=0,
        l1_rows=2 * 4 * 5, l1_dim=150, l1_k=5, cu_shape=(5, 256, 3),
        cu_wide=(8, 64, 40),
        replay_jobs=6, replay_cut_steps=40, policies=("zygarde", "rr"),
        etas=(0.5, 1.0),
        capacitors_f=(0.05,), seeds=2, big_seeds=3, cpu_check_steps=20,
        cpu_check_devices=3,
        pw_shapes=((16, 16, 6), (9, 5, 600), (64, 64, 64)),
        tune_seeds=1, tune_horizon=2.0, tune_budget=8, tune_pop=4,
        demo_horizon=10.0, demo_grid=2, fleet_devices=4, cpu_check_s=5.0,
        check_gains=False,
        anytime=AnyRun("qwen1.5-0.5b", True, 48, 4, True, (2, 32), 4, 2, 4,
                       4, 40),
        hybrid=AnyRun("recurrentgemma-9b", True, 48, 4, False, (2, 32), 4, 2,
                      4, 4, 40),
        flash_shapes=((2, 32, 32, 4, 4, 64, True, 0, 0),
                      (1, 37, 37, 4, 2, 16, True, 8, 0),
                      (1, 16, 80, 4, 4, 16, True, 0, 64)),
        decode_shapes=((1, 4, 1, 64, 48, "bfloat16", True, 64),
                       (2, 4, 2, 16, 37, "float32", False, 16)),
        rglru_shapes=((1, 48, 256, False), (3, 37, 53, True)),
        zoo=tuple(AnyRun(arch, True, 48, 4, True, fwd, n_req, 2, 4, 4, steps,
                         prefill_reps=1, engines=eng, profile=False)
                  for arch, fwd, n_req, steps, eng in (
                      ("dbrx-132b", (2, 32), 3, 16, ENGINE_RUNS[:1]),
                      ("qwen3-moe-235b-a22b", (), 0, 0, ()),
                      ("xlstm-125m", (2, 32), 3, 16, ENGINE_RUNS[1:2]),
                      ("seamless-m4t-medium", (2, 32), 0, 0, ()),
                      ("internvl2-2b", (2, 32), 0, 0, ()))),
        zoo_check_steps=24,
        zoo_flash_shapes=((1, 37, 37, 12, 2, 32, True, 0, 0),
                          (2, 16, 40, 4, 4, 16, False, 0, 0)),
        zoo_decode_shapes=((1, 12, 2, 32, 40, "bfloat16", True, 0),),
        train_cnn=CNNTrain(("cifar100", "vww"), 64, 32, 1, 64,
                           cfgs=tuple(c for _, c in (
                               ("cifar100", CNNConfig(
                                   "cifar100-narrow", (32, 32, 3),
                                   ((4, 5, True), (8, 5, True)), (16, 8), 5)),
                               ("vww", CNNConfig(
                                   "vww-narrow", (32, 32, 3),
                                   ((4, 5, True), (8, 5, True)), (8,),
                                   2))))),
        train_lm=(TrainRun("qwen1.5-0.5b", True, 0, 2, 32, 2, 2),
                  TrainRun("recurrentgemma-9b", True, 3, 2, 32, 2, 2)),
        flash_bwd_shapes=((1, 40, 40, 4, 4, 16, True, 0, 0),
                          (1, 24, 56, 6, 1, 16, False, 0, 7)),
        rglru_bwd_shapes=((1, 48, 256), (3, 37, 53)),
        launch=LaunchRun(
            train=("--arch", "stablelm-3b", "--reduced", "--steps", "2",
                   "--batch", "4", "--seq", "32", "--log-every", "1"),
            probe=("stablelm-3b", 4, 2, 32, True), check_layers=6,
            serve_scalar=("--engine", "scalar", "--tasks", "mnist",
                          "--requests", "4"),
            serve_anytime=("--engine", "anytime", "--arch", "qwen1.5-0.5b",
                           "--requests", "4"),
            ckpt_train=("--arch", "xlstm-125m", "--reduced", "--steps", "4",
                        "--batch", "2", "--seq", "16", "--ckpt-every",
                        "4")),
        mesh_serve_steps=24,
        mesh_anytime=(MeshAny("qwen1.5-0.5b", True, 0, 4, 12, 2, 2, 6,
                              ((2, 2), (1, 4))),
                      MeshAny("recurrentgemma-9b", True, 0, 4, 12, 2, 2, 6,
                              ((1, 2),))),
        mesh_decode_shape=(1, 4, 1, 64, 48, 64))


# --------------------------------------------------------------------------- #
# Measurement helpers.
# --------------------------------------------------------------------------- #


def _ms(fn, device, reps=20, warmup=2) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls after a
    warm-up on the card; one call on the host clock in a CPU rehearsal."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _bound(work):
    """``(ms, "bytes" or "operations")``: the least time on the card of
    one kernel call's ``work()`` (:mod:`repro_torch.kernels._cost`), the
    larger of its bytes over HBM bandwidth and its operations over the
    peak of their type (the H100 data sheet's, in
    :mod:`repro_torch.launch.op_stats`)."""
    from repro_torch.launch.op_stats import kernel_bound

    seconds, by = kernel_bound(work)
    return seconds * 1e3, by


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _device_ms(fn, device, calls: int = 20):
    """``torch.profiler`` over ``calls`` calls of ``fn`` after one warm-up:
    ``({kernel name: (device ms in all, launches the profiler saw)},
    host-clock ms per call)``.  An empty dict without a card (or when the
    profiler sees no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {}, float("nan")
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
        host = (time.perf_counter() - t0) / calls
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t and e.key and "Memcpy" not in e.key and "Memset" not in e.key \
                and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (t / 1e3, e.count)
    return kernels, 1e3 * host


def _kernel_ms(fn, device, match: str, calls: int = 20) -> float:
    """Device ms per launch of the kernels whose name holds ``match``
    (:func:`_device_ms`), over the launches the profiler saw; NaN if none
    ran on a card."""
    kernels, _ = _device_ms(fn, device, calls)
    hits = [v for k, v in kernels.items() if match in k]
    n = sum(c for _, c in hits)
    return sum(t for t, _ in hits) / n if n else float("nan")


def _busy_ms(fn, device, reps: int = 5, spin_cycles: int = 40_000_000):
    """Device ms per call of ``fn`` for launches far longer than their
    wrapper's host work: CUDA events around ``reps`` calls enqueued while
    the card spins (``torch.cuda._sleep``, ~20 ms), so the span holds the
    calls' device work back to back and none of the host's.  NaN without a
    card."""
    import torch

    if device.type != "cuda":
        return float("nan")
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_err(a, b) -> float:
    import torch

    if a.dtype == torch.bool or not a.dtype.is_floating_point:
        return float((a != b).sum())
    return float((a - b).abs().max()) if a.numel() else 0.0


# --------------------------------------------------------------------------- #
# Phases.
# --------------------------------------------------------------------------- #


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


#: kernel G's instances as ``-Xptxas -v`` reported them in this run's build:
#: (path, padded head dim) -> "N registers, M bytes spilled"
FLASH_REGISTERS: dict = {}


def _flash_registers(log: str) -> dict:
    """Kernel G's instances in a ``-Xptxas -v`` log: the entry function
    names ``flash_tc_kernel<HDP>`` (tensor cores) and
    ``flash_attn_kernel<HDP>`` (SIMT), each with its register count and
    spill stores."""
    import re

    found, entry, spill = {}, None, "0"
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            hdp = re.search(r"kernelILi(\d+)E", name)
            path = ("tensor-core" if "flash_tc_kernel" in name else
                    "simt" if "flash_attn_kernel" in name else None)
            entry = (path, int(hdp.group(1))) if path and hdp else None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            found[entry] = f"{m.group(1)} registers, {spill} bytes spilled"
            entry = None
    return found


#: G's backward instances in this run's build: (path, padded head dim) ->
#: "dq: N registers, M bytes spilled; dk/dv: ..."
FLASH_BWD_REGISTERS: dict = {}


def _flash_bwd_registers(log: str) -> dict:
    """G's backward instances in a ``-Xptxas -v`` log: the tensor-core
    pair ``dq_tc_kernel<HDP>`` / ``dkdv_tc_kernel<HDP, DEAD>`` and the
    SIMT pair ``dq_kernel<HD>`` / ``dkdv_kernel<HD, DEAD>`` (``DEAD``: the
    dk/dv instance that adds the rows that see no key), each with its
    register count and spill stores."""
    import re

    found, entry, spill = {}, None, "0"
    for line in log.splitlines():
        m = re.search(r"entry function '\S*?(dq|dkdv)(_tc)?_kernelILi(\d+)E"
                      r"(Lb([01])E)?", line)
        if m:
            kernel = ("dq" if m.group(1) == "dq" else
                      "dk/dv with dead rows" if m.group(5) == "1" else "dk/dv")
            entry = ("tensor-core" if m.group(2) else "simt",
                     int(m.group(3)), kernel)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            path, hdp, kernel = entry
            part = f"{kernel}: {m.group(1)} registers, {spill} bytes spilled"
            found[(path, hdp)] = "; ".join(
                sorted(filter(None, (found.get((path, hdp)), part))))
            entry = None
    return found


def _pw_registers(log: str) -> dict:
    """Kernel F's instances in a ``-Xptxas -v`` log: ``{(BM, BN,
    three-level fold): registers}`` of each ``pairwise_l1_kernel<BM, BN,
    MULTI>``."""
    import re

    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\S*pairwise_l1_kernelILi(\d+)ELi"
                      r"(\d+)ELb([01])E", line)
        if m:
            entry = (int(m.group(1)), int(m.group(2)), m.group(3) == "1")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            found[entry] = int(m.group(1))
            entry = None
    return found


def _stack_frames(log: str) -> dict:
    """``{entry function: (stack frame bytes, spill store bytes)}`` from a
    ``-Xptxas -v`` log."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            found[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return found


def _build_phase() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    usage = []
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                usage.append(f"{name}: {line.strip()}")
    FLASH_REGISTERS.update(_flash_registers(logs.get("flash_attn", "")))
    FLASH_BWD_REGISTERS.update(_flash_bwd_registers(
        _build.build_log("flash_attn_bwd")))
    print(f"build: {len(_build.SOURCES)} kernels in {secs:.2f} s "
          f"({len(logs)} compiled this run)")
    for line in usage:
        print("  ptxas " + line)
    for (path, hdp), regs in sorted(FLASH_REGISTERS.items()):
        print(f"  flash_attention {path} instance, head dim padded to {hdp}: "
              f"{regs}")
    for (path, hdp), regs in sorted(FLASH_BWD_REGISTERS.items()):
        print(f"  flash_attention_bwd {path} instance, head dim padded to "
              f"{hdp}: {regs}")
    pw_log = _build.build_log("pairwise_l1")
    for (bm, bn, multi), regs in sorted(_pw_registers(pw_log).items()):
        print(f"  pairwise_l1 instance, {bm} x {bn} tile"
              f"{', three-level fold' if multi else ''}: {regs} registers")
    # kernels B and C keep their carry in registers, I its carry, E its
    # running sums (whole and partial instances), F its chains and fold sums, and the backward kernels of
    # G and I their accumulators and carry: no instance may need a stack
    # (the log of this build, or the one kept beside a cached library)
    for kernel, lib, entry, n in (
            ("fleet_fused_steps", "fleet_fused", "fleet_fused_kernel", 4),
            ("serve_fused_steps", "serve_fused", "serve_fused_kernel", 4),
            ("rglru_scan", "rglru_scan", "rglru_scan_kernel", 2),
            ("centroid_update", "centroid_update", "centroid_update_kernel",
             2),
            ("pairwise_l1", "pairwise_l1", "pairwise_l1_kernel", 4),
            ("flash_attention_bwd", "flash_attn_bwd", "dq_kernel", 3),
            ("flash_attention_bwd", "flash_attn_bwd", "dkdv_kernel", 6),
            ("flash_attention_bwd", "flash_attn_bwd", "dq_tc_kernel", 3),
            ("flash_attention_bwd", "flash_attn_bwd", "dkdv_tc_kernel", 6),
            ("rglru_scan_bwd", "rglru_scan_bwd", "rglru_scan_bwd_kernel",
             2)):
        frames = _stack_frames(_build.build_log(lib))
        print(f"  {kernel} functions (stack frame, spill stores in bytes): "
              f"{json.dumps(frames)}")
        if sum(entry in k for k in frames) != n or any(
                f != (0, 0) for f in frames.values()):
            raise AssertionError(f"{kernel}: a function of {lib}.cu uses a "
                                 f"stack frame or spills, or an instance is "
                                 f"missing")


def _l1_times(device, xx, cc) -> dict:
    """Kernel D on ``xx`` against ``cc`` (``(k, d)`` shared or ``(B, k, d)``
    per row): the event time of a call, the profiler's device time per
    launch, the plain version's and ``cdist`` + ``topk``'s time, and the
    bound (x and c read, d1, d2 and the index written)."""
    import torch

    from repro_torch.kernels import l1_topk2 as L1

    k, d = cc.shape[-2:]
    ms = _ms(lambda: L1.l1_topk2(xx, cc), device)
    plain_ms = _ms(lambda: L1.l1_topk2_plain(xx, cc), device)
    cb = cc if cc.dim() == 3 else cc[None]
    xb = xx[:, None] if cc.dim() == 3 else xx[None]

    def yardstick():
        dist = torch.cdist(xb, cb, p=1).reshape(xx.shape[0], k)
        return torch.topk(dist, 2, dim=-1, largest=False)

    lib_ms = _ms(yardstick, device)
    bound_ms, by = _bound(L1.work(xx.shape[0], k, d, cc.dim() == 3))
    # the kernel's own time on the card, without the wrapper's host work
    dev_ms = _kernel_ms(lambda: L1.l1_topk2(xx, cc), device,
                        "l1_topk2_kernel")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def _l1_phase(device, scale: Scale, rng) -> dict:
    """Kernel D at the serve path's classify shapes.  The main path launches
    it only from the scan's ``_classify_rows``: one row per device, each
    against its own set of ``k`` centroid rows (``(D, k, d)``); that shape
    gives the row's numbers.  The whole request stream's selected features
    against one shared set (``(k, d)``) is timed beside it."""
    import torch

    from repro_torch.kernels import l1_topk2 as L1

    B, d, k, D = scale.l1_rows, scale.l1_dim, scale.l1_k, scale.n_devices
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(
        device)
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(
        device)
    c_rows = torch.from_numpy(rng.normal(size=(D, k, d)).astype(
        np.float32)).to(device)
    x_rows = x[:D].contiguous()
    err = 0.0
    for xx, cc in ((x, c), (x_rows, c_rows)):
        out = L1.l1_topk2(xx, cc)
        ref = L1.l1_topk2_plain(xx, cc)
        for a, b in zip(out, ref):
            if not torch.equal(a, b):
                raise AssertionError("l1_topk2 kernel != plain version")
            err = max(err, _max_err(a, b))

    rows, shared = _l1_times(device, x_rows, c_rows), _l1_times(device, x, c)
    for label, r in ((f"per-row centroids, B={D}", rows),
                     (f"shared centroids, B={B}", shared)):
        print(f"l1_topk2 ({label}, d={d}, k={k}): bit-equal to plain; "
              f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms per "
              f"launch), plain {r['plain_ms']:.4f} ms, "
              f"cdist+topk {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    return dict(rows, max_abs_err=err, shape=f"x ({D}, {d}), c ({D}, {k}, "
                f"{d})", shared_centroids=dict(
                    shared, shape=f"x ({B}, {d}), c ({k}, {d})"))


def _cu_times(device, c, x, a) -> dict:
    """Kernel E on centroids ``c``, rows ``x`` and their clusters ``a``
    (-1: not assigned), weight 32: the event time of a call, the profiler's
    device time per launch, the plain version's and ``index_add_``'s time,
    and the bound (the assigned rows of x, c read and written, assign);
    printed as one line."""
    import torch

    from repro_torch.kernels import centroid_update as CU

    (k, d), B = c.shape, x.shape[0]
    ms = _ms(lambda: CU.centroid_update(c, x, a, 32.0), device)
    dev_ms = _kernel_ms(lambda: CU.centroid_update(c, x, a, 32.0),
                        device, "centroid_update_kernel")
    plain_ms = _ms(lambda: CU.centroid_update_plain(c, x, a, 32.0),
                   device, reps=1, warmup=0)
    valid = a >= 0
    xv, av = x[valid], a[valid].to(torch.int64)
    lib_ms = _ms(lambda: torch.zeros_like(c).index_add_(0, av, xv), device)
    n_valid = int(valid.sum())
    bound_ms, by = _bound(CU.work(k, d, B, n_valid))
    print(f"centroid_update (k={k}, d={d}, B={B}, {n_valid} rows "
          f"assigned): bit-equal to plain; kernel {ms:.4f} ms (device "
          f"{dev_ms:.5f} ms per launch), plain {plain_ms:.4f} ms, "
          f"index_add_ {lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                shape=f"c ({k}, {d}), x ({B}, {d}), {n_valid} assigned")


def _cu_phase(device, scale: Scale, rng) -> dict:
    """Kernel E at the shared-bank adaptation's shape: one (task, unit)
    table of k = 5 centroids at the widest feature width, one row per
    device, most devices not adapting this step (assign = -1); then
    ``scale.cu_wide`` with every row assigned, where x is read once.  Each
    row as :func:`_cu_times` gives it."""
    import torch

    from repro_torch.kernels import centroid_update as CU

    rows = []
    for (k, d, B), share in ((scale.cu_shape, 0.25), (scale.cu_wide, 1.0)):
        c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(
            device)
        x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(
            device)
        assign_np = np.where(rng.random(B) < share, rng.integers(0, k, B),
                             -1).astype(np.int32)
        a = torch.from_numpy(assign_np).to(device)
        out = CU.centroid_update(c, x, a, 32.0)
        ref = CU.centroid_update_plain(c, x, a, 32.0)
        if not torch.equal(out, ref):
            raise AssertionError(f"centroid_update kernel != plain version "
                                 f"at {(k, d, B)}")
        rows.append(dict(_cu_times(device, c, x, a),
                         max_abs_err=_max_err(out, ref)))
    row = dict(rows[0])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    row["shapes"] = rows[1:]
    return row


def _models(device, scale: Scale):
    """Seeded random CNNs (Table-3 widths on the card) and banks fitted on
    each dataset's training split, as examples/intermittent_serving.py."""
    import torch

    from repro_torch.core import kmeans as km
    from repro_torch.core.agile import AgileCNN
    from repro_torch.data import make_dataset
    from repro_torch.models import cnn

    models, sets = [], []
    for seed, (name, narrow) in enumerate(scale.cnns):
        cfg = narrow or cnn.PAPER_CNNS[name]
        ds = make_dataset(name, n_train=scale.n_train,
                          n_test=max(128, scale.replay_jobs), seed=seed)
        params = cnn.init_cnn_params(
            cfg, torch.Generator().manual_seed(seed), device=device)
        with torch.no_grad():
            feats = cnn.cnn_forward_all(
                cfg, params, torch.from_numpy(ds.x_train).to(device))
        bank = km.fit_bank([f.cpu().numpy() for f in feats], ds.y_train,
                           device=device)
        models.append(AgileCNN(cfg, params, bank))
        sets.append(ds)
    return models, sets


def _serve_requests(scale: Scale, sets):
    """The §9.2 request stream: ``scale.n_requests`` test samples per task,
    one released every second."""
    from repro_torch.serve import Request

    n = scale.n_requests
    return [[Request(ds.x_test[i], int(ds.y_test[i]), release=float(i))
             for i in range(n)] for ds in sets]


@functools.lru_cache(maxsize=None)
def _solar():
    """The §9.2 solar harvester, calibrated once per run."""
    from repro_torch.core import energy

    return energy.calibrate_harvester(0.71, 0.35, name="solar")


def _serve_config(models, policy: str, adapt: bool, n_jobs: int):
    """The §9.2 serving config: period 1 s, deadline 2 s, 0.22 s and 7 mJ
    per unit, seed 3, a horizon of ``n_jobs`` releases plus 5 s."""
    from repro_torch.serve import ServeConfig

    u_max = max(m.n_units for m in models)
    return ServeConfig(policy=policy, period=1.0, deadline=2.0,
                       horizon=n_jobs + 5.0, adapt=adapt,
                       unit_time=np.full(u_max, 0.22),
                       unit_energy=np.full(u_max, 7e-3), seed=3)


def _serve_engine(device, scale: Scale, models, adapt: bool,
                  bank_mode: str, n_jobs: Optional[int] = None,
                  feature_batch: Optional[int] = None):
    """The §9.2 fleet serving engine under zygarde, the solar harvester at
    eta = 0.71 (``n_jobs`` releases per task, default the request
    stream's)."""
    from repro_torch.serve import FleetServeEngine

    cfg = _serve_config(models, "zygarde", adapt,
                        n_jobs or scale.n_requests)
    return FleetServeEngine(models, _solar(), eta=0.71, config=cfg,
                            bank_mode=bank_mode, device=device,
                            feature_batch=feature_batch)


def _serve_phase(device, scale: Scale, models, sets) -> dict:
    import torch

    from repro_torch.kernels import fleet_step, ops

    t0 = time.perf_counter()
    n = scale.n_requests
    requests = _serve_requests(scale, sets)

    def engine(adapt, bank_mode):
        return _serve_engine(device, scale, models, adapt, bank_mode)

    _solar()
    seeds = list(range(scale.n_devices))
    print(f"serve setup: {len(models)} tasks "
          f"({', '.join(m.cfg.name for m in models)}), bank fit and "
          f"harvester calibration in {time.perf_counter() - t0:.2f} s")

    # one untimed run first, as examples/intermittent_serving.py warms its
    # fleet before it times it (the timed runs below find the allocator
    # and the conv algorithms warm; phase 3a holds the first one's rate to
    # the scalar engine's, the example's own relation)
    engine(True, "per-device").run(requests, scale.n_devices, seeds=seeds,
                                   n_segments=scale.n_segments, mode="scan")
    _sync(device)

    # ---- the main path: counts zeroed just before, read just after ------
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    res, run_launches = {}, {}
    for label, adapt, mode, bank_mode in (
            ("scan adapt per-device", True, "scan", "per-device"),
            ("scan adapt shared", True, "scan", "shared"),
            ("scan", False, "scan", "per-device"),
            ("fused", False, "fused", "per-device")):
        before = fleet_step.serve_launches
        counts0 = ops.launch_counts()
        r = engine(adapt, bank_mode).run(
            requests, scale.n_devices, seeds=seeds,
            n_segments=scale.n_segments, mode=mode)
        res[label] = r
        run_launches[label] = {k: v - counts0[k]
                               for k, v in ops.launch_counts().items()}
        print(f"serve {label}: {r.jobs} jobs on {scale.n_devices} devices "
              f"in {r.wall_s:.3f} s = {r.jobs_per_sec:.1f} jobs/s, "
              f"{int(r.fleet.scheduled.sum())} on time, "
              f"{int(r.fleet.units_executed.sum())} units")
        if mode == "fused" and device.type == "cuda":
            rose = fleet_step.serve_launches - before
            if rose != scale.n_segments:
                raise AssertionError(f"fused run launched serve_fused_steps "
                                     f"{rose} times, not {scale.n_segments}")
    launches = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    launches = {k: launches[k] for k in SERVE_KERNELS}
    print(f"serve path launches {json.dumps(launches)}, peak device memory "
          f"{peak / 2**20:.1f} MiB")
    if device.type == "cuda":
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"main path never launched {missing}")

    # ---- outputs are right ------------------------------------------------
    scan, fused = res["scan"], res["fused"]
    c_err = 0.0
    for part in ("dev", "bank", "log"):
        a_p, b_p = getattr(scan.carry, part), getattr(fused.carry, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            if not torch.equal(a, b):
                raise AssertionError(f"fused != scan at {part}.{f}")
            c_err = max(c_err, _max_err(a, b))
    n_tasks = len(models)
    for label, r in res.items():
        if r.jobs != scale.n_devices * n_tasks * n:
            raise AssertionError(f"{label}: {r.jobs} jobs released")
        if not np.isfinite(r.margin).all() or r.units.shape != (
                scale.n_devices, n_tasks, n):
            raise AssertionError(f"{label}: malformed outcome log")
        if int(r.fleet.units_executed.sum()) == 0:
            raise AssertionError(f"{label}: no unit executed")
    print(f"fused == scan on every carry leaf; all {len(res)} runs released "
          f"{scan.jobs} jobs with finite margins")

    # the card's serve loop (kernel D) == the CPU's plain loop, same state
    eng = engine(False, "per-device")
    cfg, statics, tables, carry0, _ = eng.build(
        requests, scale.n_devices, seeds=seeds)
    n_chk = min(200, statics.n_steps)
    S_, C_ = tables.fidx.shape[-1], carry0.bank.centroids.shape[-2]
    if (S_, C_) != (scale.l1_dim, scale.l1_k):
        raise AssertionError(f"serve tables have S={S_}, C={C_}: kernel D "
                             f"was timed at d={scale.l1_dim}, "
                             f"k={scale.l1_k}")
    on_dev = eng._scan_steps(cfg, tables, carry0, 0, statics=statics,
                             n_steps=n_chk, adapt=False)
    cpu = torch.device("cpu")

    def to_cpu(tree):
        return type(tree)(*[to_cpu(x) if isinstance(x, tuple) else x.to(cpu)
                            for x in tree])

    on_cpu = eng._scan_steps(to_cpu(cfg), to_cpu(tables), to_cpu(carry0),
                             0, statics=statics, n_steps=n_chk, adapt=False)
    for part in ("dev", "log"):
        a_p, b_p = getattr(on_dev, part), getattr(on_cpu, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            if not torch.equal(a.to(cpu), b):
                raise AssertionError(f"{device} serve loop != CPU reference "
                                     f"at {part}.{f}")
    print(f"serve loop on {device} == plain CPU reference over {n_chk} "
          f"steps, every dev/log leaf")

    _profile_phase(device, eng, cfg, statics, tables, carry0)

    # ---- kernel C: time per launch at two fleet sizes --------------------
    c_rows = {}
    for n_dev in (scale.n_devices, scale.big_devices):
        r = _serve_kernel_times(device, scale, models, requests, n_dev,
                                plain=n_dev == scale.n_devices)
        c_rows[n_dev] = r
        print(f"serve_fused_steps (D={n_dev}, {r['steps']} steps, "
              f"{r['units']} units): kernel {r['ms']:.4f} ms/launch (device "
              f"{r['device_ms']:.4f} ms, {r['us_per_step']:.4f} us per "
              f"step)" + (f", plain {r['plain_ms']:.1f} ms"
                          if r["plain_ms"] else "")
              + f", bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    big = c_rows[scale.big_devices]
    row = dict(c_rows[scale.n_devices], max_abs_err=c_err, library_ms=None,
               ms_big_fleet=big["ms"], device_ms_big_fleet=big["device_ms"],
               us_per_step_big_fleet=big["us_per_step"],
               units_big_fleet=big["units"], big_fleet=scale.big_devices,
               fused_jobs_per_s=res["fused"].jobs_per_sec)
    return dict(launches=launches, c_row=row, runs=res,
                run_launches=run_launches)


def _serve_kernel_times(device, scale: Scale, models, requests, n_dev: int,
                        plain: bool = False) -> dict:
    """Kernel C over the whole §9.2 horizon from the t = 0 carry on
    ``n_dev`` devices (per-device banks, no adaptation): CUDA-event ms per
    launch with the wrapper, device ms per launch (``_busy_ms``) and per
    step, the units completed, the bound, and with ``plain`` the plain
    version's ms."""
    import torch

    from repro_torch.kernels import fleet_step

    eng = _serve_engine(device, scale, models, False, "per-device")
    cfg, st, tab, car, _ = eng.build(requests, n_dev,
                                     seeds=list(range(n_dev)))
    job0 = torch.zeros(len(models), dtype=torch.int32, device=device)

    def launch():
        return fleet_step.serve_fused_steps(cfg, car, tab, 0, job0,
                                            statics=st, n_steps=st.n_steps)

    out = launch()
    ms = _ms(launch, device, reps=5, warmup=1)
    dev_ms = _busy_ms(launch, device)
    plain_ms = None
    if plain:
        plain_ms = _ms(lambda: fleet_step.serve_fused_steps_plain(
            cfg, car, tab, 0, job0, statics=st, n_steps=st.n_steps), device,
            reps=1, warmup=0)
    units = int(out.dev.m_units.sum())
    S_, C_ = tab.fidx.shape[-1], car.bank.centroids.shape[-2]
    carry_b = _nbytes(*car.dev) + _nbytes(*car.log)
    cfg_b = fleet_step._cfg_bytes(cfg)
    bound_ms, by = _bound(fleet_step.serve_work(
        n_dev, st.queue_size, st.n_steps, cfg_b, carry_b, S_, C_, units))
    return dict(ms=ms, device_ms=dev_ms, us_per_step=1e3 * dev_ms / st.n_steps,
                units=units, steps=st.n_steps, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


def _profile_phase(device, eng, cfg, statics, tables, carry0):
    """Where the serve scan's time goes, over 100 steps (no adaptation)
    from the built state."""
    kw = dict(statics=statics, adapt=False)
    _profile(device, "scan", cfg.policy.shape[0], min(100, statics.n_steps),
             lambda n: eng._scan_steps(cfg, tables, carry0, 0, n_steps=n,
                                       **kw))


def _profile(device, label: str, n_dev: int, n: int, run_steps,
             watch: str = "") -> None:
    """``torch.profiler`` over ``run_steps(n)`` after a warm-up of 5 steps:
    kernel launches per step, device-busy time and its share of the
    window's wall time, the kernels with the most device time, and the
    device time per launch of the kernel named ``watch``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        print(f"{label} profile: not measured (no card)")
        return
    run_steps(5)                                            # warm-up
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(n)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    if not kernels:
        print(f"{label} profile: not measured (the profiler saw no device "
              "activity)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    print(f"{label} profile ({n} steps, D={n_dev}): wall "
          f"{wall_ms:.1f} ms ({wall_ms / n:.3f} ms/step, profiler on), "
          f"{launches / n:.1f} kernel launches/step, device busy "
          f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of wall; "
          "top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top))
    for e in kernels:
        if watch and watch in e.key:
            per = e.self_device_time_total / e.count
            print(f"{label} profile: {watch} {per:.2f} us device time per "
                  f"launch (x{e.count})")


# --------------------------------------------------------------------------- #
# The scalar engine, scalar == fleet, the intermittent substrate, the stream.
# --------------------------------------------------------------------------- #


def _fresh(models, threshold: Optional[float] = None):
    """Private copies of the agile models (adaptation replaces their bank
    entries, never the shared models'), with an optional uniform utility
    threshold."""
    import torch

    from repro_torch.core.agile import AgileCNN

    out = []
    for m in models:
        bank = [uc if threshold is None else uc._replace(
            threshold=torch.full((), threshold, dtype=torch.float32,
                                 device=uc.threshold.device))
                for uc in m.bank]
        out.append(AgileCNN(m.cfg, m.params, bank))
    return out


def _scalar_phase(device, scale: Scale, models, sets,
                  fleet_rate: float) -> dict:
    """Act one of examples/intermittent_serving.py: the scalar
    ``ServeEngine`` under edf, rr and zygarde (adaptation on for zygarde)
    on the §9.2 workload.  Counts zeroed before, read after: kernel D once
    per executed unit, kernel E once per adaptation."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    requests = _serve_requests(scale, sets)
    _solar()
    ops.reset_launch_counts()
    res, rates, exec_units, adapted = {}, {}, 0, 0
    for policy in ("edf", "rr", "zygarde"):
        cfg = _serve_config(models, policy, policy == "zygarde",
                            scale.n_requests)
        eng = ServeEngine(_fresh(models), _solar(), eta=0.71, config=cfg)
        r, secs = _timed(lambda: eng.run(requests), device)
        res[policy], rates[policy] = r, r.released / secs
        profs = [p for t in eng.profiles_ for p in t]
        # the profiles are lazy: a unit runs the model when the scheduler
        # first reads its outcome (never, for a job EDF or RR drop late)
        ran = sum(p._exec_units for p in profs)
        if not 0 < ran <= r.units_executed:
            raise AssertionError(f"scalar {policy}: the models ran {ran} "
                                 f"units, the scheduler {r.units_executed}")
        exec_units += ran
        adapted += sum(p._exited for p in profs) if cfg.adapt else 0
        np.testing.assert_array_equal(r.task_scheduled + r.task_misses,
                                      r.task_released)
        if not 0 < r.correct <= r.scheduled <= r.released:
            raise AssertionError(f"scalar {policy}: malformed counters")
        print(f"scalar {policy}: {r.scheduled}/{r.released} scheduled, "
              f"{r.correct} correct, {r.optional_units} optional units, "
              f"{r.reboots} reboots, {r.idle_no_energy:.2f} s idle, "
              f"{r.units_executed} units ({ran} run by the model) in "
              f"{secs:.3f} s = {rates[policy]:.1f} jobs/s")
    launches = ops.launch_counts()
    launches = {k: launches[k] for k in SCALAR_KERNELS}
    print(f"scalar path launches {json.dumps(launches)} ({exec_units} "
          f"model units run, {adapted} adaptations)")
    if device.type == "cuda" and (launches["l1_topk2"] != exec_units
                                  or launches["centroid_update"] != adapted
                                  or not adapted):
        raise AssertionError("scalar path: kernel D must launch once per "
                             "model unit run and kernel E once per "
                             "adaptation")
    d_one, e_one = _one_row_checks(device, models, sets)
    zyg, edf, rr = res["zygarde"], res["edf"], res["rr"]
    print(f"scalar: zygarde schedules {zyg.scheduled - edf.scheduled:+d} "
          f"jobs vs EDF and {zyg.scheduled - rr.scheduled:+d} vs RR; fleet "
          f"live {fleet_rate:.1f} jobs/s ({scale.n_devices} devices) vs "
          f"scalar {rates['zygarde']:.1f} jobs/s; "
          f"{time.perf_counter() - t0:.2f} s")
    if scale.check_gains and fleet_rate <= rates["zygarde"]:
        raise AssertionError("the fleet live path should outrun the scalar "
                             "event loop")
    return dict(launches=launches, rates=rates, d_one_row=d_one,
                e_one_row=e_one)


def _one_row_checks(device, models, sets):
    """Kernels D and E == their plain versions, bit for bit, at the scalar
    engine's shapes: each unit of each model classifies one test request's
    selected features (1, S) against that unit's (k, S) centroids, and
    adapts its (k, d_u) centroids with that one row, assigned to each
    cluster in turn.  Timed at the first model's first unit (D) and its
    widest unit (E).  Returns the two kernel-line entries."""
    import torch

    from repro_torch.kernels import centroid_update as CU
    from repro_torch.kernels import l1_topk2 as L1

    err_d, err_e, n_d, n_e, first, widest = 0.0, 0.0, 0, 0, None, None
    for m, ds in zip(models, sets):
        state = m._initial_state(ds.x_test[0])
        for u, uc in enumerate(m.bank):
            state, feats = m._run_unit(state, u)
            fidx = uc.feature_idx.to(torch.int64)
            x = feats[:, fidx].to(torch.float32).contiguous()
            c = uc.centroids[:, fidx].contiguous()
            out = L1.l1_topk2(x, c)
            for a, b in zip(out, L1.l1_topk2_plain(x, c)):
                if not torch.equal(a, b):
                    raise AssertionError(f"l1_topk2 kernel != plain at one "
                                         f"row ({m.cfg.name}, unit {u})")
                err_d = max(err_d, _max_err(a, b))
            n_d += 1
            full = feats.to(torch.float32).contiguous()
            cents = uc.centroids.contiguous()
            for j in range(cents.shape[0]):
                a = torch.tensor([j], dtype=torch.int32, device=device)
                got = CU.centroid_update(cents, full, a, 32.0)
                ref = CU.centroid_update_plain(cents, full, a, 32.0)
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"centroid_update kernel != plain at one row "
                        f"({m.cfg.name}, unit {u}, cluster {j})")
                err_e = max(err_e, _max_err(got, ref))
                n_e += 1
            if first is None:
                first = (x, c)
            if widest is None or full.shape[1] > widest[1].shape[1]:
                widest = (cents, full, out[2].to(torch.int32))
    d_one = dict(_l1_times(device, *first), max_abs_err=err_d,
                 shape=f"x {tuple(first[0].shape)}, c "
                       f"{tuple(first[1].shape)}, scalar engine")
    print(f"l1_topk2 (one row, the scalar engine's shape, {n_d} units "
          f"checked): bit-equal to plain; kernel {d_one['ms']:.4f} ms "
          f"(device {d_one['device_ms']:.4f} ms per launch), plain "
          f"{d_one['plain_ms']:.4f} ms, cdist+topk "
          f"{d_one['library_ms']:.4f} ms, bound {d_one['bound_ms']:.6f} ms "
          f"({d_one['bound_by']})")
    print(f"centroid_update at one row: bit-equal to plain on {n_e} (unit, "
          f"cluster) pairs; timed at the widest unit:")
    e_one = dict(_cu_times(device, *widest), max_abs_err=err_e)
    e_one["shape"] += ", scalar engine"
    return d_one, e_one


def _parity_run(device, model, cfg, reqs, threshold):
    """One request stream through the scalar engine and the one-device
    fleet (``feature_batch=1``) under a persistent supply: the scalar
    result, its per-job (units, sched, pred, margin) and the fleet result."""
    from repro_torch.core import energy
    from repro_torch.serve import FleetServeEngine, ServeEngine

    supply = energy.Harvester("battery", 1.0, 0.0, 1.0)
    eng = ServeEngine(_fresh([model], threshold), supply, eta=1.0,
                      config=cfg)
    res = eng.run([reqs])
    units = np.array([j.unit for j in eng.jobs_])
    sched = np.array([0 <= j.mandatory_done_time <= j.deadline
                      for j in eng.jobs_])
    profs = eng.profiles_[0]
    pred = np.array([p._preds[u - 1] if u > 0 else -1
                     for p, u in zip(profs, units)])
    margin = np.array([p._margins[u - 1] if u > 0 else 0.0
                       for p, u in zip(profs, units)], np.float32)
    fres = FleetServeEngine(_fresh([model], threshold), supply, eta=1.0,
                            config=cfg, feature_batch=1,
                            device=device).run([reqs], n_devices=1)
    return res, (units, sched, pred, margin), fres


def _parity_phase(device, scale: Scale, models, sets) -> None:
    """The scalar engine == the one-device fleet, bit for bit, on the
    clock-commensurate recipe (persistent supply, charged start, dt 50 ms,
    0.2 s units, period 2 s, deadline 1.5 s, uniform threshold 0.02):
    units, schedule, predictions and margins, zygarde and edf with
    adaptation on and off, each §9.2 model as one task; then the overload
    recipe (period 1 s, deadline 0.7 s): the same miss sets."""
    from repro_torch.serve import Request, ServeConfig

    t0 = time.perf_counter()
    n = scale.parity_jobs

    def config(policy, adapt, period=2.0, deadline=1.5):
        return ServeConfig(policy=policy, period=period, deadline=deadline,
                           horizon=n * period + 2.0, adapt=adapt,
                           start_charged=True, sim_dt=0.05)

    def requests(ds, period):
        return [Request(ds.x_test[j], int(ds.y_test[j]), release=j * period)
                for j in range(n)]

    cases = [(0, "zygarde", False), (0, "zygarde", True), (0, "edf", False),
             (0, "edf", True), (1, "zygarde", True), (1, "edf", False)]
    for k, policy, adapt in cases:
        m, cfg = models[k], config(policy, adapt)
        res, (units, sched, pred, margin), f = _parity_run(
            device, m, cfg, requests(sets[k], cfg.period), 0.02)
        gap = np.abs(margin - f.margin[0, 0, :n])
        for name, a, b in (("units", units, f.units[0, 0, :n]),
                           ("sched", sched, f.sched[0, 0, :n]),
                           ("pred", pred, f.pred[0, 0, :n]),
                           ("margin bits", margin.view(np.uint32),
                            f.margin[0, 0, :n].view(np.uint32))):
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"scalar != fleet on {device} ({m.cfg.name}, {policy}, "
                    f"adapt={adapt}): {name} {a.tolist()} vs {b.tolist()} "
                    f"(largest margin gap {gap.max():.3g})")
        for name, a in (("scheduled", res.scheduled),
                        ("correct", res.correct),
                        ("deadline_misses", res.deadline_misses),
                        ("units_executed", res.units_executed)):
            if a != int(getattr(f.fleet, name)[0]):
                raise AssertionError(f"scalar != fleet: {name}")
        if adapt and not (f.exit_unit[0, 0, :n] >= 0).all():
            raise AssertionError("parity: a job never adapted")
        print(f"parity {m.cfg.name} {policy} adapt={adapt}: scalar == fleet "
              f"bit for bit ({int(units.sum())} units, {int(sched.sum())}/"
              f"{n} on time)")
    for threshold in (None, 10.0):
        cfg = config("zygarde", False, period=1.0, deadline=0.7)
        res, (_, sched, _, _), f = _parity_run(
            device, models[0], cfg, requests(sets[0], 1.0), threshold)
        if not np.array_equal(sched, f.sched[0, 0, :n]) or (
                res.deadline_misses != int(f.fleet.deadline_misses[0])):
            raise AssertionError(f"overload miss sets differ "
                                 f"(threshold {threshold})")
        if threshold == 10.0 and (sched.any() or res.deadline_misses != n):
            raise AssertionError("overload: a job met its deadline with "
                                 "early exit disabled")
        print(f"parity overload (threshold {threshold}): the same "
              f"{res.deadline_misses} misses of {n}")
    print(f"parity: {time.perf_counter() - t0:.2f} s")


def _intermittent_phase(device, scale: Scale, models, sets) -> None:
    """The fragment substrate: each unit of the CIFAR-100 model cut into 4
    fragments, one request through them under a weak harvester and a
    0.02 F capacitor and under a persistent supply; the outputs equal
    tensor for tensor, and power really failed."""
    import torch

    from repro_torch.core import energy
    from repro_torch.core.intermittent import fragment_unit, run_intermittent

    t0 = time.perf_counter()
    model = models[0]
    frags = []
    for u in range(model.n_units):
        def unit(s, u=u):
            h, f = model._run_unit(s["h"], u)
            return {"h": h, "feats": s["feats"] + [f]}
        frags += fragment_unit(unit, 4, 0.22, 4e-2, name=f"unit{u}")
    state0 = {"h": model._initial_state(sets[0].x_test[0]), "feats": []}
    ref, rs = run_intermittent(frags, state0,
                               energy.Harvester("battery", 1.0, 0.0, 10.0))
    out, st = run_intermittent(frags, state0,
                               energy.Harvester("weak", 0.7, 0.7, 0.05),
                               energy.Capacitor(capacitance_f=0.02), seed=1,
                               max_wall=1e4)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if st.reboots <= 0 or st.fragments_run != rs.fragments_run:
        raise AssertionError(f"intermittent run: {st}")
    for a, b in zip([out["h"]] + out["feats"], [ref["h"]] + ref["feats"]):
        if a.device.type != device.type:
            raise AssertionError(f"the fragments ran on {a.device}")
        if not torch.equal(a, b):
            raise AssertionError("the run with power failures != the run "
                                 "without")
    print(f"intermittent ({model.cfg.name}, {len(frags)} fragments): output "
          f"equal to the persistent run; {st.reboots} reboots, "
          f"{st.fragments_reexecuted} fragments re-executed, "
          f"{st.off_time:.2f} s off of {st.wall_time:.2f} s; "
          f"{time.perf_counter() - t0:.2f} s")


def _table_bytes(eng, J: int) -> int:
    """Bytes of the serve tables over a ``J``-job axis (the stacked
    features, labels and the classifier metadata)."""
    K = len(eng.models)
    U, S_ = eng._bank_tables["fidx"].shape[1:]
    F = eng.bank0.centroids.shape[-1]
    meta = sum(_nbytes(t) for t in eng._bank_tables.values())
    return K * J * (U * (S_ + F) + 1) * 4 + meta


def _stream_phase(device, scale: Scale, models, sets, serve_runs) -> dict:
    """The million-job stream: ``scale.stream_devices`` devices, each task
    cycling its base requests to ``scale.stream_jobs`` jobs, fused, in
    ``scale.stream_chunks`` chunks; then the adaptive scan stream in both
    bank modes at the serve phase's 64 devices in 3 chunks.  Counts zeroed
    before, read after (kernel C once per chunk).  Then the checks: the
    fused stream == ``run(mode="fused")`` over the repeated request list
    on every log field and carry leaf, the scan streams == the serve
    phase's monolithic runs, and kernel C == its plain version on the
    first chunk (negative ``job0``) and a middle one (positive)."""
    import torch

    from repro_torch.fleet.state import ServeCarry, ServeLog
    from repro_torch.kernels import fleet_step, ops
    from repro_torch.serve import Request
    from repro_torch.serve.fleet_engine import _shift_log

    t0 = time.perf_counter()
    D, total, nc = scale.stream_devices, scale.stream_jobs, scale.stream_chunks
    base = _serve_requests(scale, sets)
    n_base = scale.n_requests
    seeds = list(range(D))

    # one request per convolution: the stream computes its base requests'
    # features in a batch of 25, the monolithic run in one of 123, and
    # cuDNN's algorithms differ in the last bits between batch shapes
    # (tools/feature_batch_gap.py)
    eng = _serve_engine(device, scale, models, False, "per-device",
                        n_jobs=total, feature_batch=1)

    def allocated():
        return (torch.cuda.memory_allocated(device)
                if device.type == "cuda" else 0)

    # ---- the main path: counts zeroed just before, read just after ------
    ops.reset_launch_counts()
    st_start = allocated()
    st = eng.run_stream(base, D, seeds=seeds, total_jobs=total, n_chunks=nc,
                        mode="fused")
    fused_launches = ops.launch_counts()["serve_fused_steps"]
    scans = {}
    for bank_mode in ("per-device", "shared"):
        scans[bank_mode] = _serve_engine(
            device, scale, models, True, bank_mode).run_stream(
                base, scale.n_devices, seeds=range(scale.n_devices),
                n_chunks=3)
    launches = ops.launch_counts()
    launches = {k: launches[k] for k in STREAM_KERNELS}
    print(f"stream path launches {json.dumps(launches)}")
    if device.type == "cuda" and (fused_launches != st.n_chunks or any(
            v == 0 for v in launches.values())):
        raise AssertionError(f"stream path: kernel C launched "
                             f"{fused_launches} times for {st.n_chunks} "
                             f"chunks, or a kernel never ran")

    # ---- outputs are right ------------------------------------------------
    n_tasks = len(models)
    if st.jobs != D * n_tasks * total or st.jobs < scale.min_stream_jobs:
        raise AssertionError(f"the stream released {st.jobs} jobs")
    repeated = [[Request(b[j % n_base].x, b[j % n_base].label,
                         release=float(j)) for j in range(total)]
                for b in base]
    # peaks above the memory live at each call's start (the stream's
    # result, which the comparison needs, is live during the monolithic run)
    mono_start = allocated()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mono = eng.run(repeated, D, seeds=seeds, mode="fused")
    mono_peak = (torch.cuda.max_memory_allocated(device) - mono_start
                 if device.type == "cuda" else 0)
    st_peak = st.peak_bytes - st_start if st.peak_bytes else 0
    for f in ("units", "pred", "correct", "margin", "exit_unit", "sched"):
        a, b = getattr(st, f), getattr(mono, f)
        if a.shape != b.shape or not np.array_equal(
                a.view(np.uint8), b.view(np.uint8)):
            raise AssertionError(f"stream != monolithic fused run: log.{f}")
    for part in ("dev", "bank"):
        _equal_leaves(getattr(st.carry, part), getattr(mono.carry, part),
                      f"stream vs monolithic {part}")
    if not np.isfinite(st.margin).all() or int(st.fleet.units_executed.sum(
            )) == 0:
        raise AssertionError("stream: malformed outcome log")
    Wl = st.carry.log.units.shape[-1]
    mono_bytes = _table_bytes(eng, total)
    if st.chunk_table_bytes != _table_bytes(eng, Wl) or not (
            st.chunk_table_bytes < mono_bytes):
        raise AssertionError(f"stream window bytes {st.chunk_table_bytes} "
                             f"vs monolithic {mono_bytes}")
    print(f"stream fused: {st.jobs} jobs on {D} devices ({total} per task, "
          f"{st.n_chunks} chunks, window {Wl} of {total} jobs) in "
          f"{st.wall_s:.3f} s = {st.jobs_per_sec:.1f} jobs/s, peak "
          f"{st_peak / 2**20:.1f} MiB above the call's start, window tables "
          f"{st.chunk_table_bytes / 2**20:.2f} MiB; monolithic fused run "
          f"{mono.wall_s:.3f} s = {mono.jobs_per_sec:.1f} jobs/s, peak "
          f"{mono_peak / 2**20:.1f} MiB above the call's start, tables "
          f"{mono_bytes / 2**20:.2f} MiB; equal on every log field and "
          "carry leaf")
    for bank_mode, r in scans.items():
        ref = serve_runs[f"scan adapt {bank_mode}"]
        for f in ("units", "pred", "correct", "margin", "exit_unit",
                  "sched"):
            if not np.array_equal(getattr(r, f).view(np.uint8),
                                  getattr(ref, f).view(np.uint8)):
                raise AssertionError(f"scan stream ({bank_mode}) != the "
                                     f"serve phase's run: log.{f}")
        for part in ("dev", "bank"):
            _equal_leaves(getattr(r.carry, part), getattr(ref.carry, part),
                          f"scan stream ({bank_mode}) {part}")
        print(f"stream scan adapt {bank_mode}: {r.jobs} jobs in 3 chunks, "
              f"{r.wall_s:.3f} s = {r.jobs_per_sec:.1f} jobs/s, equal to "
              f"the monolithic run on every leaf")

    row = dict(jobs=st.jobs, devices=D, chunks=st.n_chunks, window=Wl,
               jobs_per_s=st.jobs_per_sec, wall_s=st.wall_s,
               peak_bytes=st.peak_bytes, peak_above_start_bytes=st_peak,
               chunk_table_bytes=st.chunk_table_bytes,
               monolithic_jobs_per_s=mono.jobs_per_sec,
               monolithic_wall_s=mono.wall_s,
               monolithic_peak_above_start_bytes=mono_peak,
               monolithic_table_bytes=mono_bytes)
    del st, mono, scans      # each holds a per-device bank of the fleet

    # ---- the stream's chunks again, each part timed; kernel C == plain on
    # the staged windows of chunk 0 (negative job0) and a middle chunk -----
    cfg, stc, tabs_np, dev0, bank0, _, _, base_len = eng.build_stream(
        base, D, seeds=seeds, total_jobs=total)
    Wl, n_run, chunks = eng._stream_chunks(cfg, stc, tabs_np, base_len, nc)
    mid = n_run // 2
    carry = ServeCarry(dev=dev0, bank=bank0, log=eng.log0(D, Wl))
    parts = dict(stage_s=0.0, copy_s=0.0, shift_s=0.0, launch_sync_s=0.0,
                 log_back_s=0.0, kernel_device_ms=0.0)
    checked = []
    for c in range(n_run):
        t_a = time.perf_counter()
        ch = next(chunks)
        parts["stage_s"] += time.perf_counter() - t_a - ch.copy_s
        parts["copy_s"] += ch.copy_s
        if (c == 0 and not (ch.w0 < 0).all()) or (
                c == mid and not (ch.w0 > 0).all()):
            raise AssertionError(f"job0 of chunk {c}: {ch.w0}")
        t_a = time.perf_counter()
        carry = carry._replace(log=_shift_log(carry.log, ch.shift))
        _sync(device)
        parts["shift_s"] += time.perf_counter() - t_a

        def launch():
            return fleet_step.serve_fused_steps(
                cfg, carry, ch.tables, ch.s0, ch.job0, statics=stc,
                n_steps=ch.s1 - ch.s0)

        t_a = time.perf_counter()
        out = launch()
        _sync(device)
        parts["launch_sync_s"] += time.perf_counter() - t_a
        parts["kernel_device_ms"] += _busy_ms(launch, device, reps=3)
        t_a = time.perf_counter()
        for f in ServeLog._fields:
            getattr(out.log, f).cpu().numpy()
        parts["log_back_s"] += time.perf_counter() - t_a
        if c in (0, mid):
            ref = fleet_step.serve_fused_steps_plain(
                cfg, carry, ch.tables, ch.s0, ch.job0, statics=stc,
                n_steps=ch.s1 - ch.s0)
            for part in ("dev", "log"):
                _equal_leaves(getattr(out, part), getattr(ref, part),
                              f"kernel C vs plain, chunk {c} {part}")
            checked.append(f"chunk {c} (steps {ch.s0}-{ch.s1}, job0 "
                           f"{ch.w0.tolist()})")
        carry = out
    print(f"serve_fused_steps == plain bit for bit on the staged windows "
          f"(W = {Wl} of {total} jobs, D = {D}) of " + " and ".join(checked))
    # wall_s counts copy, shift and launch + sync; staging and the log's
    # copy back, like the reference's, fall outside it
    print("stream parts over its " + str(n_run) + " chunks (s): "
          + ", ".join(f"{k} {v:.6f}" for k, v in parts.items()
                      if k != "kernel_device_ms")
          + f"; kernel C's device time {parts['kernel_device_ms']:.4f} ms "
          f"in all; stream phase {time.perf_counter() - t0:.2f} s")
    row["parts"] = parts
    return dict(launches=launches, row=row)


def _replay_tasks(models, sets, scale: Scale):
    """The replay workload: one periodic task per model, its job profiles
    from ``scale.replay_jobs`` test samples (``AgileCNN.profile_batch``),
    period 1 s, deadline 2 s, 0.22 s and 7 mJ per unit."""
    from repro_torch.core.scheduler import TaskSpec

    n = scale.replay_jobs
    return tuple(
        TaskSpec(task_id=k, period=1.0, deadline=2.0,
                 unit_time=np.full(m.n_units, 0.22),
                 unit_energy=np.full(m.n_units, 7e-3),
                 profiles=m.profile_batch(ds.x_test[:n], ds.y_test[:n]))
        for k, (m, ds) in enumerate(zip(models, sets)))


def _replay_grid(tasks, scale: Scale, seeds: int):
    from repro_torch.core import energy
    from repro_torch.fleet import SweepGrid

    return SweepGrid(
        task=tasks, policies=scale.policies, etas=scale.etas,
        harvesters=(energy.calibrate_harvester(0.71, 0.35, name="solar"),),
        capacitors=tuple(energy.Capacitor(c) for c in scale.capacitors_f),
        seeds=tuple(range(seeds)), horizon=scale.replay_jobs + 5.0, dt=0.055)


def _steps(statics, n: int):
    """``statics`` cut to a horizon of ``n`` steps."""
    return dataclasses.replace(statics, horizon=n * statics.dt)


def _timed(fn, device):
    """``fn()`` and its wall seconds on the host clock, ending in a
    device synchronisation."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _equal_leaves(a, b, what: str) -> None:
    import torch

    for f, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y.to(x.device)):
            raise AssertionError(f"{what}: leaf {f} differs")


def _replay_phase(device, scale: Scale, models, sets) -> dict:
    """The replay fleet sweep: the main path through every mode, then the
    kernels A and B against their plain versions, with times."""
    import torch

    from repro_torch.core import step as S
    from repro_torch.fleet import (build, init_fleet, run_segments,
                                   simulate_fleet, sweep)
    from repro_torch.kernels import fleet_priority as FP
    from repro_torch.kernels import fleet_step as FS
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    tasks = _replay_tasks(models, sets, scale)
    grid = _replay_grid(tasks, scale, scale.seeds)
    cfg, statics, meta = build(grid, device)
    D, n_steps = len(meta), statics.n_steps
    print(f"replay setup: {len(tasks)} tasks x {scale.replay_jobs} profiled "
          f"jobs, {D} devices ({len(scale.policies)} policies x "
          f"{len(scale.etas)} etas x {len(scale.capacitors_f)} capacitors x "
          f"{scale.seeds} seeds), {n_steps} steps of {statics.dt} s, built "
          f"in {time.perf_counter() - t0:.2f} s")

    # load both kernels once, so no mode's time includes it
    for mode in ("pallas", "fused"):
        run_segments(cfg, _steps(statics, 1), 1, mode=mode)

    # ---- the main path: counts zeroed just before, read just after ------
    # vmap and pallas run the first ``replay_cut_steps`` steps (a depth cut:
    # both are host-bound at ~10 ms per step), fused the whole horizon and
    # the cut one, so every mode is held to fused over the same steps
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    n_cut = min(scale.replay_cut_steps, n_steps)
    cut = _steps(statics, n_cut)
    res, rate = {}, {}
    for mode, st in (("vmap", cut), ("pallas", cut), ("fused", cut),
                     ("fused full", statics)):
        r, secs = _timed(lambda: simulate_fleet(cfg, st, mode=mode.split()[0]),
                         device)
        res[mode] = r
        rate[mode] = float(r.released.sum()) / secs
        print(f"replay {mode} ({st.n_steps} steps): {int(r.released.sum())} "
              f"jobs on {D} devices in {secs:.3f} s = {rate[mode]:.1f} "
              f"jobs/s, {int(r.scheduled.sum())} on time, "
              f"{int(r.units_executed.sum())} units")
    (seg, carry), secs = _timed(lambda: run_segments(
        cfg, statics, scale.n_segments, mode="fused"), device)
    print(f"replay run_segments (fused, {scale.n_segments} segments): "
          f"{secs:.3f} s")
    (swept, _), secs = _timed(lambda: sweep(grid, mode="fused",
                                            device=device), device)
    print(f"replay sweep (fused, grid built anew): {secs:.3f} s")
    launches = ops.launch_counts()
    launches = {k: launches[k] for k in REPLAY_KERNELS}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print(f"replay path launches {json.dumps(launches)}, peak device memory "
          f"{peak / 2**20:.1f} MiB")
    if device.type == "cuda":
        want = {"fleet_priority": n_cut,
                "fleet_fused_steps": 3 + scale.n_segments}
        if launches != want:
            raise AssertionError(f"replay path launched {launches}, not "
                                 f"{want} (A once per step of the pallas "
                                 f"run, B once per segment)")

    # ---- outputs are right ------------------------------------------------
    for label, other in (("pallas", res["pallas"]), ("fused", res["fused"])):
        _equal_leaves(res["vmap"], other, f"replay {label} != vmap over "
                      f"{n_cut} steps")
    for label, other in (("run_segments", seg), ("sweep", swept)):
        _equal_leaves(res["fused full"], other, f"replay {label} != fused")
    r = res["fused full"]
    K = len(tasks)
    if r.task_released.shape != (D, K) or not bool(
            (r.released == K * scale.replay_jobs).all()):
        raise AssertionError("replay: malformed result or releases")
    if int(r.units_executed.sum()) == 0 or not bool(
            torch.isfinite(r.busy_time).all()):
        raise AssertionError("replay: no unit executed or non-finite times")
    if not bool((r.task_scheduled + r.task_misses
                 == r.task_released).all()):
        raise AssertionError("replay: jobs not conserved per task")
    print(f"replay fused == pallas == vmap over the first {n_cut} steps, "
          f"fused == run_segments == sweep over all {n_steps}, on every "
          "result leaf; jobs conserved per task")

    # the card's vmap loop == the CPU's plain loop on a slice of devices
    cpu = torch.device("cpu")
    n_chk, d_chk = min(scale.cpu_check_steps, n_steps), min(
        scale.cpu_check_devices, D)
    sl = S.StepParams(*[x[:d_chk].contiguous() for x in cfg])
    on_dev = FS.fleet_fused_steps_plain(sl, init_fleet(sl, statics), 0,
                                        statics=statics, n_steps=n_chk)
    sl_cpu = S.StepParams(*[x.to(cpu) for x in sl])
    on_cpu = FS.fleet_fused_steps_plain(sl_cpu, init_fleet(sl_cpu, statics),
                                        0, statics=statics, n_steps=n_chk)
    _equal_leaves(on_cpu, on_dev, f"replay loop on {device} != CPU")
    print(f"replay loop on {device} == plain CPU reference over {n_chk} "
          f"steps on {d_chk} devices, every carry leaf")

    for mode in ("vmap", "pallas"):
        _profile(device, f"replay {mode}", D, 50, lambda n: run_segments(
            cfg, _steps(statics, n), 1, mode=mode),
            watch="fleet_priority_kernel")

    a_row = _priority_check(device, cfg, statics, FP)
    b_row = _fused_check(device, cfg, statics, FS, init_fleet)
    big = _replay_grid(tasks, scale, scale.big_seeds)
    cfg_big, st_big, meta_big = build(big, device)
    c_big = init_fleet(cfg_big, st_big)
    ms_big = _ms(lambda: FS.fleet_fused_steps(
        cfg_big, c_big, 0, statics=st_big, n_steps=b_row["segment_steps"]),
        device, reps=3, warmup=1)
    dev_big = _busy_ms(lambda: FS.fleet_fused_steps(
        cfg_big, c_big, 0, statics=st_big, n_steps=b_row["segment_steps"]),
        device)
    print(f"fleet_fused_steps at D={len(meta_big)}: {ms_big:.3f} ms per "
          f"{b_row['segment_steps']}-step segment (device {dev_big:.3f} ms)")
    del cfg_big, c_big
    b_row.update(ms_big_fleet=ms_big, device_ms_big_fleet=dev_big,
                 big_fleet=len(meta_big))
    return dict(launches=launches, a_row=a_row, b_row=b_row, cfg=cfg,
                statics=statics, grid=grid)


def _priority_inputs(device, cfg, statics):
    """Kernel A's operands at the replay path's shape, from the state the
    fused run reaches mid-horizon: ``(args, kwargs)`` of
    ``fleet_priority``."""
    from repro_torch.core import step as S
    from repro_torch.kernels import fleet_step as FS

    mid = statics.n_steps // 2
    carry = FS.fleet_fused_steps(cfg, S.init_carry(cfg, statics), 0,
                                 statics=statics, n_steps=mid)
    t = S.step_clock(mid, statics.dt, device)
    carry = S.drop_expired(cfg, S.admit(cfg, carry, t, statics), t)
    lax, util, mand, gate_e, drain, power, forced, _ = S.pick_inputs(
        cfg, carry, t, statics)
    args = (cfg.policy, carry.q_active, lax, carry.q_release, util, mand,
            cfg.alpha, cfg.beta, cfg.eta, cfg.persistent, carry.energy,
            cfg.e_opt, power, cfg.capacity, gate_e, drain, forced,
            carry.q_task, carry.rr_cursor)
    return (tuple(a.contiguous() for a in args),
            dict(n_tasks=cfg.period.shape[-1], dt=statics.dt))


def _priority_check(device, cfg, statics, FP) -> dict:
    """Kernel A at the replay path's shape, from the state the fused run
    reaches mid-horizon, and at an odd (prime) device count."""
    import torch

    args, kw = _priority_inputs(device, cfg, statics)
    D, Q = args[1].shape
    odd = max(d for d in range(1, D + 1)
              if all(d % p for p in range(2, int(d ** 0.5) + 1)))
    err = 0.0
    for n in (D, odd):
        sub = tuple(a[:n] for a in args)
        out = FP.fleet_priority(*sub, **kw)
        ref = FP.fleet_priority_plain(*sub, **kw)
        for name, a, b in zip(("sel", "picked", "run", "e_new"), out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"fleet_priority != plain at D={n}: "
                                     f"{name}")
            err = max(err, _max_err(a, b))
    ms = _ms(lambda: FP.fleet_priority(*args, **kw), device, reps=50)
    # device time per launch: launches enqueued while the card spins, each
    # with the card's gap between launches (the profiler loses A's launches
    # after the replay profiles of this process; tools/kernel_device_times.py
    # --only A reads the kernel's own time)
    dev_ms = _busy_ms(lambda: FP.fleet_priority(*args, **kw), device,
                      reps=50)
    plain_ms = _ms(lambda: FP.fleet_priority_plain(*args, **kw), device)
    bound_ms, by = _bound(FP.work(D, Q, _nbytes(*args)))
    print(f"fleet_priority (D={D}, Q={Q}; also D={odd}): bit-equal to "
          f"plain; kernel {ms:.4f} ms (device {dev_ms:.5f} ms back to "
          f"back), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
                shape=f"D={D}, Q={Q}; odd D={odd}")


def _fused_check(device, cfg, statics, FS, init_fleet) -> dict:
    """Kernel B over one whole segment (a quarter of the horizon) against
    its plain version, on every carry leaf, with times and the bound."""
    n = statics.n_steps // 4
    c0 = init_fleet(cfg, statics)
    out = FS.fleet_fused_steps(cfg, c0, 0, statics=statics, n_steps=n)
    ref, plain_s = _timed(lambda: FS.fleet_fused_steps_plain(
        cfg, c0, 0, statics=statics, n_steps=n), device)
    _equal_leaves(ref, out, "fleet_fused_steps != plain")
    err = max(_max_err(a, b) for a, b in zip(out, ref))
    ms = _ms(lambda: FS.fleet_fused_steps(cfg, c0, 0, statics=statics,
                                          n_steps=n), device, reps=5,
             warmup=1)
    # device time per launch: the profiler misses these long launches once
    # the replay modes have been profiled in this process
    dev_ms = _busy_ms(lambda: FS.fleet_fused_steps(
        cfg, c0, 0, statics=statics, n_steps=n), device)
    D, Q = cfg.policy.shape[0], statics.queue_size
    units = int(out.m_units.sum())
    bound_ms, by = _bound(FS.fleet_work(D, Q, n, FS._cfg_bytes(cfg),
                                        _nbytes(*c0), units))
    print(f"fleet_fused_steps (D={D}, {n} steps, {units} units): bit-equal "
          f"to plain on every carry leaf; kernel {ms:.3f} ms/launch (device "
          f"{dev_ms:.3f} ms, {1e3 * dev_ms / n:.3f} us per step of the "
          f"fleet), plain "
          f"{plain_s * 1e3:.1f} ms, bound {bound_ms:.6f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                us_per_step=1e3 * dev_ms / n, plain_ms=plain_s * 1e3,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
                segment_steps=n, shape=f"D={D}, {n} steps")


# --------------------------------------------------------------------------- #
# Telemetry on the replay fleet and the serve scan.
# --------------------------------------------------------------------------- #

# telemetry fields held exactly (tests/test_telemetry.py:INT_FIELDS); the
# float fields take that file's tolerances where two paths compute them
TEL_INT = ("c_release", "c_miss", "c_sched", "c_retired", "c_power_fail",
           "c_reboot", "c_knob", "exit_hist", "occ_sum", "occ_max",
           "n_steps", "ring_kind", "ring_head")
TEL_COUNTERS = ("c_release", "c_miss", "c_sched", "c_reboot",
                "c_power_fail", "occ_sum", "occ_max", "energy_sum",
                "energy_min", "n_steps")


def _tel_gap(a, b, what: str, fields=None, tol: bool = True) -> float:
    """The integer fields of two telemetries equal, the floats within the
    reference's tolerances (1e-4 for the sums and ring values, 1e-6
    otherwise) when ``tol``; returns the largest float gap (infinities
    must match)."""
    import torch

    gap = 0.0
    for f in fields or a._fields:
        x, y = getattr(a, f), getattr(b, f).to(getattr(a, f).device)
        if f in TEL_INT:
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: telemetry {f} differs")
            continue
        fin = torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), fin) or not torch.equal(
                x[~fin], y[~fin]):
            raise AssertionError(f"{what}: telemetry {f} infinities differ")
        if fin.any():
            gap = max(gap, float((x[fin] - y[fin]).abs().max()))
        if tol:
            rt = 1e-4 if f in ("slack_sum", "energy_sum", "ring_val") \
                else 1e-6
            torch.testing.assert_close(x, y, rtol=rt, atol=rt,
                                       msg=f"{what}: telemetry {f}")
    return gap


def _telemetry_phase(device, scale: Scale, replay: dict, serve: dict,
                     models, sets) -> dict:
    """Telemetry at full width.  Replay: the 1,600-device sweep of phase 4
    over its first fortieth (a depth cut), ``ring_size=256``, in the vmap and
    pallas modes, each plain, ``counters`` and ``full`` (counts zeroed
    before, read after: kernel A once per step of each pallas run); every
    carry leaf equals the plain run's, pallas telemetry equals vmap's bit
    for bit; on 64 devices over 300 steps the collection paths equal the
    on-card ``record_step`` fold and the CPU's plain run.  Serve: phase
    3's scan with adaptation (per-device bank) at ``full``, every log
    field and carry leaf equal to phase 3's run and kernels D and E
    launched as often; with a shared bank (kernel E) at ``counters``,
    ``run_stream`` in 3 chunks equal to ``run`` over the same 3 segments
    and D and E launched as often as in phase 3's shared run."""
    import torch

    from repro_torch import telemetry as TEL
    from repro_torch.fleet import init_fleet, run_segments
    from repro_torch.fleet import simulator as FSim
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg, statics = replay["cfg"], replay["statics"]
    D = cfg.n_devices
    n = -(-statics.n_steps // 40)
    st = _steps(statics, n)
    tiers = {"plain": None,
             "counters": TEL.TelemetryConfig(ring_size=256,
                                             level="counters"),
             "full": TEL.TelemetryConfig(ring_size=256, level="full")}
    requests = _serve_requests(scale, sets)
    seeds = list(range(scale.n_devices))
    eng = _serve_engine(device, scale, models, True, "per-device")
    # the shared bank adapts through kernel E (a per-device bank, in place)
    eng_shared = _serve_engine(device, scale, models, True, "shared")

    # ---- the main path: counts zeroed just before, read just after ------
    ops.reset_launch_counts()
    out, ms = {}, {}
    for mode in ("vmap", "pallas"):
        for tier, tcfg in tiers.items():
            out[mode, tier], secs = _timed(lambda: run_segments(
                cfg, st, 1, mode=mode, telemetry=tcfg), device)
            ms[mode, tier] = 1e3 * secs / n
    a_launches = ops.launch_counts()["fleet_priority"]
    counts0 = ops.launch_counts()
    serve_full, secs_full = _timed(lambda: eng.run(
        requests, scale.n_devices, seeds=seeds, n_segments=scale.n_segments,
        telemetry=tiers["full"]), device)
    counts1 = ops.launch_counts()
    serve_cnt, secs_cnt = _timed(lambda: eng_shared.run(
        requests, scale.n_devices, seeds=seeds, n_segments=3,
        telemetry=tiers["counters"]), device)
    counts2 = ops.launch_counts()
    serve_de = {label: {k: c1[k] - c0[k]
                        for k in ("l1_topk2", "centroid_update")}
                for label, c0, c1 in (("per-device", counts0, counts1),
                                      ("shared", counts1, counts2))}
    stream_cnt = eng_shared.run_stream(requests, scale.n_devices,
                                       seeds=seeds, n_chunks=3,
                                       telemetry=tiers["counters"])
    launches = ops.launch_counts()
    launches = {k: launches[k] for k in TELEMETRY_KERNELS}
    print(f"telemetry path launches {json.dumps(launches)}")
    if device.type == "cuda":
        plain_de = {m: {k: serve["run_launches"][f"scan adapt {m}"][k]
                        for k in ("l1_topk2", "centroid_update")}
                    for m in serve_de}
        if a_launches != 3 * n or serve_de != plain_de or any(
                v == 0 for v in launches.values()):
            raise AssertionError(
                f"telemetry path: kernel A launched {a_launches} times (not "
                f"{3 * n}), kernels D and E {serve_de} in the serve runs "
                f"(phase 3's plain runs: {plain_de}), or a kernel never ran")

    # ---- outputs are right: replay --------------------------------------
    for mode in ("vmap", "pallas"):
        res0, carry0 = out[mode, "plain"]
        for tier in ("counters", "full"):
            res, carry, tel = out[mode, tier]
            _equal_leaves(res0, res, f"replay {mode} {tier} result")
            _equal_leaves(carry0, carry, f"replay {mode} {tier} carry")
            if int(tel.n_steps.min()) != n or int(tel.c_release.sum()) != \
                    int(carry.next_rel.sum()):
                raise AssertionError(f"replay {mode} {tier}: telemetry "
                                     "does not reconcile with the carry")
    for tier in ("counters", "full"):
        _equal_leaves(out["vmap", tier][2], out["pallas", tier][2],
                      f"replay pallas {tier} telemetry != vmap")
    tel = out["vmap", "full"][2]
    print(f"replay telemetry ({D} devices, {n} steps, ring 256): every "
          f"result and carry leaf equal to the plain run at both tiers in "
          f"both modes; pallas == vmap on every telemetry field; "
          f"{int(tel.c_miss.sum())} misses, {int(tel.c_power_fail.sum())} "
          f"power failures, {int(tel.c_reboot.sum())} reboots, "
          f"{int(tel.c_retired.sum())} retired, "
          f"{int(tel.ring_head.sum())} ring events")
    for mode in ("vmap", "pallas"):
        p = ms[mode, "plain"]
        print(f"replay {mode} ms per step: plain {p:.3f}, counters "
              f"{ms[mode, 'counters']:.3f} "
              f"({100 * (ms[mode, 'counters'] / p - 1):+.1f}%), full "
              f"{ms[mode, 'full']:.3f} "
              f"({100 * (ms[mode, 'full'] / p - 1):+.1f}%)")

    # 64 devices, 300 steps: the collection paths == the on-card reference
    # fold; the card == the CPU's plain run
    n_chk = min(scale.cpu_check_steps, n)
    d_chk = min(scale.cpu_check_devices, D)
    sl = type(cfg)(*[x[:d_chk].contiguous() for x in cfg])
    cpu = torch.device("cpu")
    sl_cpu = type(cfg)(*[x.to(cpu) for x in sl])
    gaps = {}
    for tier in ("counters", "full"):
        tcfg = tiers[tier]
        _, c_dev, t_dev = run_segments(sl, _steps(statics, n_chk), 1,
                                       telemetry=tcfg)
        _, t_ref = FSim._run_steps_tel_reference(
            sl, init_fleet(sl, statics), TEL.init_fleet_telemetry(tcfg, sl),
            0, statics, n_chk, "vmap")
        _tel_gap(t_dev, t_ref, f"{tier} vs the record_step fold",
                 None if tier == "full" else TEL_COUNTERS)
        _, c_cpu, t_cpu = run_segments(sl_cpu, _steps(statics, n_chk), 1,
                                       telemetry=tcfg)
        _equal_leaves(c_dev, c_cpu, f"telemetry run on {device} != CPU")
        gaps[tier] = _tel_gap(t_dev, t_cpu, f"{tier} on {device} vs CPU",
                              tol=False)
    print(f"replay telemetry on {d_chk} devices over {n_chk} steps: both "
          f"tiers == the record_step fold on {device} (ints exact, floats "
          f"within the reference's tolerances); {device} vs CPU: carry "
          f"equal, ints exact, largest float gap counters "
          f"{gaps['counters']:.3g}, full {gaps['full']:.3g}")
    for tier in ("counters", "full"):
        _profile(device, f"replay vmap telemetry {tier}", D, 20,
                 lambda k: run_segments(cfg, _steps(statics, k), 1,
                                        mode="vmap", telemetry=tiers[tier]))

    # ---- outputs are right: serve ---------------------------------------
    ref = serve["runs"]["scan adapt per-device"]
    for f in ("units", "pred", "correct", "margin", "exit_unit", "sched"):
        if not np.array_equal(getattr(serve_full, f).view(np.uint8),
                              getattr(ref, f).view(np.uint8)):
            raise AssertionError(f"serve with telemetry != phase 3's run: "
                                 f"log.{f}")
    _equal_leaves(serve_full.fleet, ref.fleet, "serve telemetry fleet")
    for part in ("dev", "bank", "log"):
        _equal_leaves(getattr(serve_full.carry, part),
                      getattr(ref.carry, part), f"serve telemetry {part}")
    for f in ("units", "pred", "correct", "margin", "exit_unit", "sched"):
        if not np.array_equal(getattr(stream_cnt, f).view(np.uint8),
                              getattr(serve_cnt, f).view(np.uint8)):
            raise AssertionError(f"stream with telemetry != run: log.{f}")
    _equal_leaves(stream_cnt.telemetry, serve_cnt.telemetry,
                  "stream counters != run counters")
    tf = serve_full.telemetry
    if int(tf.c_release.sum()) != serve_full.jobs or int(
            tf.exit_hist.sum()) != int(tf.c_retired.sum()):
        raise AssertionError("serve telemetry does not reconcile")
    steps = int(tf.n_steps[0])
    serve_ms = {
        "per-device plain": ref.wall_s,
        "per-device full": serve_full.wall_s,
        "shared plain": serve["runs"]["scan adapt shared"].wall_s,
        "shared counters": serve_cnt.wall_s}
    serve_ms = {k: 1e3 * v / steps for k, v in serve_ms.items()}
    print(f"serve telemetry full ({scale.n_devices} devices, {steps} steps, "
          f"{scale.n_segments} segments): every log field and carry leaf "
          f"equal to phase 3's run; kernels D and E launched "
          f"{json.dumps(serve_de)} (per-device at full, shared at "
          f"counters), as in phase 3's plain runs; {int(tf.c_retired.sum())} "
          f"retired, {int(tf.c_miss.sum())} misses, "
          f"{int(tf.c_power_fail.sum())} power failures; ms per step "
          f"(plain: phase 3's runs): per-device plain "
          f"{serve_ms['per-device plain']:.3f}, full "
          f"{serve_ms['per-device full']:.3f}; shared plain "
          f"{serve_ms['shared plain']:.3f}, counters "
          f"{serve_ms['shared counters']:.3f}")
    print(f"stream counters (shared bank, 3 chunks) == run counters (3 "
          f"segments) on every telemetry field and log field; telemetry phase "
          f"{time.perf_counter() - t0:.2f} s")
    return dict(launches=launches, ms_per_step={
        f"replay {m} {t}": v for (m, t), v in ms.items()} | {
        f"serve scan {k}": v for k, v in serve_ms.items()})


# --------------------------------------------------------------------------- #
# The adaptation path: kernel F, offline tuning, online adaptation.
# --------------------------------------------------------------------------- #


def _pw_phase(device, scale: Scale, rng) -> dict:
    """Kernel F at the shapes of ``scale.pw_shapes``, each held bit for bit
    against its plain version; times at the main path's shape (the fleet
    forecast arm's first window batch) and at the largest shape: CUDA
    events around wrapper calls, and the device time per launch
    (``_busy_ms``: launches enqueued while the card spins)."""
    import torch

    from repro_torch.kernels import pairwise_l1 as PW

    def pair(B1, B2, d):
        return tuple(torch.from_numpy(rng.normal(size=(n, d)).astype(
            np.float32)).to(device) for n in (B1, B2))

    err = 0.0
    for B1, B2, d in scale.pw_shapes:
        x, y = pair(B1, B2, d)
        out, ref = PW.pairwise_l1(x, y), PW.pairwise_l1_plain(x, y)
        if not torch.equal(out, ref):
            raise AssertionError(f"pairwise_l1 kernel != plain version at "
                                 f"{(B1, B2, d)}")
        err = max(err, _max_err(out, ref))

    def times(B1, B2, d):
        x, y = pair(B1, B2, d)
        big = B1 * B2 * d > 1 << 26
        ms = _ms(lambda: PW.pairwise_l1(x, y), device)
        dev_ms = _busy_ms(lambda: PW.pairwise_l1(x, y), device,
                          reps=5 if big else 20)
        plain_ms = _ms(lambda: PW.pairwise_l1_plain(x, y), device,
                       reps=3 if big else 20, warmup=1)
        lib_ms = _ms(lambda: torch.cdist(x, y, p=1), device)
        bound_ms, by = _bound(PW.work(B1, B2, d))
        tile = PW.tile_plan(B1, B2, min(512, d))
        print(f"pairwise_l1 ({B1} x {B2} x {d}, {tile} tile): kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} "
              f"ms, cdist(p=1) {lib_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({by})")
        return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                    shape=f"{B1} x {B2} x {d}")

    print(f"pairwise_l1: bit-equal to plain at {list(scale.pw_shapes)}")
    row = times(*scale.pw_shapes[0])
    row["large"] = times(*scale.pw_shapes[-1])
    row["max_abs_err"] = err
    return row


def _tune_task(n_jobs=30, n_units=4, exit_at=1, correct_from=2):
    """``examples/adapt_tune.py``'s task: the utility test passes after
    unit 1, predictions are correct from unit 2."""
    from repro_torch.core.scheduler import JobProfile, TaskSpec

    margins = np.linspace(0.05, 0.5, n_units)
    passes = np.zeros(n_units, bool)
    passes[exit_at:] = True
    correct = np.zeros(n_units, bool)
    correct[correct_from:] = True
    prof = JobProfile(margins, passes, correct)
    return TaskSpec(task_id=0, period=1.0, deadline=2.0,
                    unit_time=np.full(n_units, 0.1),
                    unit_energy=np.full(n_units, 8e-3),
                    profiles=[prof] * n_jobs)


def _tune_problem(device, scale: Scale):
    """``examples/adapt_tune.py``'s problem at ``scale`` and its search
    space over (eta, E_opt fraction)."""
    from repro_torch import adapt
    from repro_torch.core import energy

    problem = adapt.TuneProblem(
        task=_tune_task(),
        harvesters=(energy.Harvester("solar", 0.95, 0.95, 0.08),
                    energy.Harvester("rf", 0.85, 0.85, 0.05),
                    energy.Harvester("piezo", 0.90, 0.90, 0.06)),
        seeds=tuple(range(scale.tune_seeds)), horizon=scale.tune_horizon,
        device=device)
    space = adapt.SearchSpace.of(eta=(0.05, 1.0),
                                 e_opt_fraction=(0.05, 0.95))
    return problem, space


def _tune_phase(device, scale: Scale) -> dict:
    """Offline tuning of (eta, E_opt fraction) with the ES driver; one
    objective call is one fused fleet run (kernel B)."""
    import torch

    from repro_torch import adapt
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    problem, space = _tune_problem(device, scale)
    base, statics = problem._base
    d0 = base.n_devices
    print(f"tune setup: {d0} cells (3 harvesters x {scale.tune_seeds} "
          f"seeds), {statics.n_steps} steps of {statics.dt} s, built in "
          f"{time.perf_counter() - t0:.2f} s")
    objective = problem.objective()
    calls = []

    def timed(params):
        t = time.perf_counter()
        out = objective(params)
        calls.append((time.perf_counter() - t, len(out)))
        return out

    # ---- the main path: counts zeroed just before, read just after ------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    default_score = problem.score(problem.default_params())
    result = adapt.tune(timed, space, budget=scale.tune_budget, driver="es",
                        seed=0, pop_size=scale.tune_pop)
    wall = time.perf_counter() - t0
    launches = {k: ops.launch_counts()[k] for k in TUNE_KERNELS}
    secs = sum(c[0] for c in calls)
    n_pad = 1 << (scale.tune_pop - 1).bit_length()
    rate = n_pad * d0 * statics.n_steps * len(calls) / secs
    print(f"tune es (budget {scale.tune_budget}, population "
          f"{scale.tune_pop}): {len(calls)} objective calls of "
          f"{n_pad * d0} devices in {wall:.3f} s, {1e3 * secs / len(calls):.2f}"
          f" ms per call = {rate:.4g} device-steps/s; best "
          f"{result.best_score:.4f} (eta={result.best_params['eta']:.3f}, "
          f"e_opt_fraction={result.best_params['e_opt_fraction']:.3f}) vs "
          f"paper default {default_score:.4f}; launches {json.dumps(launches)}")
    if device.type == "cuda" and launches["fleet_fused_steps"] != len(
            calls) + 1:
        raise AssertionError(f"tuning launched fleet_fused_steps "
                             f"{launches} times, not once per objective "
                             f"call ({len(calls) + 1})")
    if scale.check_gains and not result.best_score > default_score:
        raise AssertionError("the tuned score does not beat the paper "
                             "default")

    # ---- one population block: the card's scores == the CPU's -----------
    params = space.to_dict(space.sample(np.random.default_rng(0),
                                        scale.tune_pop))
    on_dev = objective(params)
    cpu_problem = dataclasses.replace(problem, device=torch.device("cpu"))
    on_cpu, cpu_s = _timed(lambda: cpu_problem.objective()(params),
                           torch.device("cpu"))
    if not np.array_equal(on_dev, on_cpu):
        raise AssertionError("tuning block scored on the card != the CPU")
    print(f"tune block of {scale.tune_pop} candidates: card == CPU plain "
          f"run on every score ({cpu_s:.1f} s on the CPU)")
    return dict(launches=launches, calls=len(calls),
                ms_per_call=1e3 * secs / len(calls), device_steps_s=rate,
                best=result.best_score, default=default_score)


# examples/online_adapt.py's demo (that file imports the JAX package)
DEMO_SEED = 11
DEMO_P_ON = 0.06
DEMO_REGIMES_S = (32, 40, 34)          # solar, RF, occluded
DEMO_HORIZON = float(sum(DEMO_REGIMES_S) * 3)
DEMO_CAPACITANCE_F = 0.1
DEMO_MISS_WEIGHT = 1.5
DEMO_SEGMENT_S = 2.5
FEEDBACK_KW = dict(rho=0.5, window_s=20.0, n_max=4, supply_window_s=5.0,
                   supply_rho=0.7, e_opt_bounds=(0.05, 0.95),
                   miss_target=0.1)


def _demo_task():
    from repro_torch.core.scheduler import JobProfile, TaskSpec

    n_units = 5
    margins = np.linspace(0.05, 0.5, n_units)
    passes = np.zeros(n_units, bool)
    passes[1:] = True
    correct = np.zeros(n_units, bool)
    correct[n_units - 1:] = True
    prof = JobProfile(margins, passes, correct)
    return TaskSpec(task_id=0, period=1.0, deadline=1.3,
                    unit_time=np.full(n_units, 0.1),
                    unit_energy=np.full(n_units, 8e-3),
                    profiles=[prof] * (int(DEMO_HORIZON) + 2))


def _demo_trace(seed: int) -> np.ndarray:
    """solar -> RF -> occluded, three times; one slot per second (+2)."""
    from repro_torch.core import energy

    rng = np.random.default_rng(seed)
    rf = energy.Harvester("rf", 0.50, 0.72, DEMO_P_ON)
    occ = energy.Harvester("occluded", 0.20, 0.97, DEMO_P_ON)
    solar_s, rf_s, occ_s = DEMO_REGIMES_S
    segs = []
    for _ in range(3):
        segs.append(np.ones(solar_s))
        segs.append(rf.sample_events(rng, rf_s, init=1))
        segs.append(occ.sample_events(rng, occ_s, init=0))
    segs.append(np.zeros(2))
    return np.concatenate(segs).astype(np.float32)


def _demo_default(events: np.ndarray) -> float:
    from repro_torch.core import energy

    return max(energy.eta_factor((events > 0).astype(np.int8)), 0.05)


def _demo_fleet(items, horizon: float, device):
    """One device per (events, eta, e_opt fraction) on the demo's task."""
    from repro_torch import fleet
    from repro_torch.core import energy
    from repro_torch.fleet import grid as fgrid

    task = _demo_task()
    cap = energy.Capacitor(capacitance_f=DEMO_CAPACITANCE_F)
    harv = energy.Harvester("nonstationary", 0.5, 0.5, DEMO_P_ON)
    devices = [fgrid.device_config(task, harv, eta, cap, policy="zygarde",
                                   horizon=horizon, events=ev,
                                   e_opt_fraction=frac)
               for ev, eta, frac in items]
    statics = fleet.FleetStatics(queue_size=3, dt=0.025, horizon=horizon,
                                 slot_s=1.0)
    return fgrid.stack_configs(devices, device), statics


def _demo_score(res) -> np.ndarray:
    from repro_torch.core.utility import scalarized_objective

    return scalarized_objective(res.correct, res.released,
                                res.deadline_misses,
                                miss_weight=DEMO_MISS_WEIGHT).cpu().numpy()


def _adapter(arm: str, statics, cfg):
    from repro_torch import adapt

    if arm == "feedback":
        return adapt.OnlineAdapter(statics, cfg, **FEEDBACK_KW)
    return adapt.OnlineAdapter(statics, cfg, controllers=[
        adapt.EtaController(rho=0.5, window_s=20.0, n_max=4),
        adapt.ForecastController(
            window_s=8.0, horizon_s=10.0, n_clusters=4, supply_window_s=5.0,
            supply_rho=0.7, e_opt_bounds=(0.05, 0.95), miss_target=0.1)])


def _online_phase(device, scale: Scale) -> dict:
    """The online demo and the fleet forecast arm (the main path), then the
    card against the CPU over one cycle."""
    import torch

    from repro_torch import fleet
    from repro_torch.kernels import ops

    horizon = scale.demo_horizon
    n_seg = int(horizon / DEMO_SEGMENT_S)
    events = _demo_trace(DEMO_SEED)
    g = scale.demo_grid
    grid_pts = [(eta, frac) for eta in np.linspace(0.1, 1.0, g)
                for frac in np.linspace(0.05, 0.95, g)]
    eta0 = _demo_default(events)
    t0 = time.perf_counter()
    cfg_g, st = _demo_fleet([(events, e, f) for e, f in grid_pts], horizon,
                            device)
    cfg1, st1 = _demo_fleet([(events, eta0, 0.7)], horizon, device)
    fleet_items = [(ev, _demo_default(ev), 0.7) for ev in
                   map(_demo_trace, range(scale.fleet_devices))]
    cfg_f, st_f = _demo_fleet(fleet_items, horizon, device)
    print(f"online setup: demo trace {horizon:.0f} s, {n_seg} segments; "
          f"{len(grid_pts)} static points; a fleet of {scale.fleet_devices} "
          f"traces; built in {time.perf_counter() - t0:.2f} s")

    # ---- the main path: counts zeroed just before, read just after ------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    static_scores = _demo_score(fleet.simulate_fleet(cfg_g, st,
                                                     mode="fused"))
    best = int(np.argmax(static_scores))
    default_score = float(_demo_score(fleet.simulate_fleet(
        cfg1, st1, mode="fused"))[0])
    arms = {}
    for arm in ("feedback", "forecast"):
        ad = _adapter(arm, st1, cfg1)
        r, _ = fleet.run_segments(cfg1, st1, n_seg, hook=ad.hook,
                                  mode="fused")
        arms[arm] = float(_demo_score(r)[0])
    demo_s = time.perf_counter() - t0
    demo_launches = dict(ops.launch_counts())
    print(f"online demo ({demo_s:.2f} s): best static eta="
          f"{grid_pts[best][0]:.2f} e_opt={grid_pts[best][1]:.2f} "
          f"{static_scores[best]:+.4f}; paper default {default_score:+.4f}; "
          f"feedback {arms['feedback']:+.4f}; forecast "
          f"{arms['forecast']:+.4f}")

    t0 = time.perf_counter()
    ad_f = _adapter("forecast", st_f, cfg_f)
    setup_s = time.perf_counter() - t0
    hook_s = [0.0]

    def timed_hook(seg, t_end, c, carry):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = ad_f.hook(seg, t_end, c, carry)
        hook_s[0] += time.perf_counter() - t
        return out

    (res_f, _), wall = _timed(lambda: fleet.run_segments(
        cfg_f, st_f, n_seg, hook=timed_hook, mode="fused"), device)
    total = ops.launch_counts()
    launches = {k: total[k] for k in ONLINE_KERNELS}
    arm_launches = {k: total[k] - demo_launches[k] for k in ONLINE_KERNELS}
    jobs = int(res_f.released.sum())
    print(f"online fleet forecast arm: {scale.fleet_devices} devices x "
          f"{n_seg} segments in {wall:.3f} s (adapter set-up {setup_s:.2f} "
          f"s outside), hook {hook_s[0]:.3f} s = "
          f"{100 * hook_s[0] / wall:.1f}% of the wall, {jobs} jobs = "
          f"{jobs / wall:.1f} jobs/s, {int(res_f.scheduled.sum())} on time; "
          f"launches {json.dumps(arm_launches)}")
    print(f"online path launches {json.dumps(launches)}")
    if device.type == "cuda":
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"online path never launched {missing}")
    if scale.check_gains:
        if not arms["feedback"] > static_scores[best]:
            raise AssertionError("online adaptation does not beat the best "
                                 "static constants")
        if not arms["feedback"] > default_score:
            raise AssertionError("online adaptation does not beat the "
                                 "paper default")
        if not arms["forecast"] >= arms["feedback"]:
            raise AssertionError("the forecast arm does not beat the "
                                 "feedback arm")
        print("online demo: online > best static, online > default, "
              "forecast >= online")
    if not (res_f.released.min() > 0 and np.isfinite(_demo_score(res_f)).all()):
        raise AssertionError("fleet forecast arm: malformed result")

    # ---- the card == the CPU's plain run over one cycle -----------------
    cpu = torch.device("cpu")
    for arm in ("feedback", "forecast"):
        runs = {}
        for dev in (device, cpu):
            c1, s1 = _demo_fleet([(events, eta0, 0.7)], scale.cpu_check_s,
                                 dev)
            ad = _adapter(arm, s1, c1)
            r, _ = fleet.run_segments(
                c1, s1, int(scale.cpu_check_s / DEMO_SEGMENT_S),
                hook=ad.hook, mode="fused")
            runs[dev.type] = (r, ad.history)
        (r_dev, h_dev), (r_cpu, h_cpu) = runs[device.type], runs["cpu"]
        _equal_leaves(r_cpu, r_dev, f"online {arm} on {device} != CPU")
        if len(h_dev) != len(h_cpu):
            raise AssertionError(f"online {arm}: history lengths differ")
        for a, b in zip(h_dev, h_cpu):
            for k in b:
                same = (a[k] == b[k] if b[k] is None or np.isscalar(b[k])
                        else np.array_equal(a[k], b[k]))
                if not same:
                    raise AssertionError(f"online {arm} on {device} != CPU "
                                         f"at segment {b['seg']}: {k}")
    print(f"online feedback and forecast arms on {device} == plain CPU runs "
          f"over {scale.cpu_check_s:.0f} s, every history entry and result "
          f"leaf")
    return dict(launches=launches, wall_s=wall, hook_s=hook_s[0],
                jobs_per_s=jobs / wall, demo=dict(
                    best_static=float(static_scores[best]),
                    default=default_score, **arms))

# --------------------------------------------------------------------------- #
# Anytime serving of the model configs (kernels G, H, I).
# --------------------------------------------------------------------------- #

ANY_PERIOD_S = 0.25
ANY_DEADLINE_S = 2.5
ANY_TARGET_AGREEMENT = 0.98
# kernel G against its plain version (rtol, atol).  Both take the same
# inputs, p rounded to v's dtype in both.  In bf16 both form each score as
# the f32 rounding of its exact dot product (the kernel on the f64 tensor
# cores), so they differ only in the summation order of the PV product; the
# f32 (SIMT) kernel's scores are f32 multiply-add chains.  The H100 runs
# show a largest gap of 4.8e-7 in bf16 and 2.4e-6 in f32.  f32 keeps the
# JAX sweep's tolerance; bf16 is held at 1e-5, so a kernel that skipped the
# bf16 rounding of p (a gap of about 1e-4), misplaced a mask, or formed its
# scores in another order (p crossing bf16 rounding boundaries: up to
# 1.4e-3, tools/flash_p_rounding_witness.py) fails.
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-5, 1e-5)}
# kernel H against its plain version (rtol, atol): both form each score in
# the same order and take exp and the softmax denominator in f64, so their
# weights p agree bit for bit (also after the bf16 rounding of round_p);
# they differ only in the summation order of the PV product, which the H100
# runs show as a largest gap of 1.27e-7 at every shape
DECODE_TOL = (1e-5, 1e-5)


def _any_config(run: AnyRun):
    from repro_torch.configs import get_config

    cfg = get_config(run.arch)
    if run.narrow:
        cfg = cfg.reduced()
        if run.arch == "qwen1.5-0.5b":
            cfg = dataclasses.replace(cfg, n_layers=4)
    elif run.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=run.n_layers)
    return cfg


def _any_requests(cfg, run: AnyRun, rng):
    from repro_torch.serve import AnytimeRequest

    return [AnytimeRequest(
        prompt=rng.integers(0, cfg.vocab, run.prompt).tolist(),
        n_tokens=run.new, release=ANY_PERIOD_S * i,
        deadline=ANY_PERIOD_S * i + ANY_DEADLINE_S)
        for i in range(run.requests)]


def _layer_kinds(cfg) -> dict:
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    return {k: kinds.count(k) for k in ("attn", "rec", "mlstm", "slstm")}


def _frontend(cfg, B: int, g, device) -> dict:
    """The stub frontend of a batch of ``B``: an encoder-decoder's frame
    embeddings or a VLM's patch embeddings (seeded, f32, on ``device``);
    nothing for a text-only config."""
    import torch

    n = cfg.n_enc_tokens or cfg.n_frontend_tokens
    if not n:
        return {}
    return {"frontend": torch.randn((B, n, cfg.d_model), generator=g,
                                    device=device)}


def _any_launches(cfg, run: AnyRun, n_passes: int) -> dict:
    """Kernel launches of one anytime path: per sequence pass (each prefill
    and ``anytime_forward``) kernel G once per attention layer, per
    cross-attention and per encoder layer, and kernel I once per recurrent
    layer; per decode and engine step kernel H once per attention and
    cross-attention layer."""
    kinds = _layer_kinds(cfg)
    attn = kinds["attn"] * (2 if cfg.is_encoder_decoder else 1)
    steps = run.decode_steps + len(run.engines) * run.max_steps
    want = {"flash_attention": n_passes * (attn + cfg.n_enc_layers),
            "decode_gqa": attn * steps,
            "rglru_scan": n_passes * kinds["rec"]}
    return {k: n for k, n in want.items() if n}


def _anytime_phase(device, scale: Scale, run: AnyRun) -> dict:
    """One anytime path at its config's published widths (seeded random
    weights, fresh exit heads; ``run.n_layers`` a depth cut): the prefill
    of one prompt (``prefill_reps`` times, with the config's stub frames or
    patches) and ``decode_steps`` decode steps; ``anytime_forward`` on
    ``fwd_shape`` and the exit thresholds calibrated from it; the anytime
    engine and EDF on one request trace under a solar harvester and a
    persistent supply (``run.engines``).  The launch counts are zeroed
    before and read after (:func:`_any_launches`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import energy
    from repro_torch.kernels import ops
    from repro_torch.models import anytime as A
    from repro_torch.models import transformer as T
    from repro_torch.serve import AnytimeConfig, AnytimeServeEngine

    cfg = _any_config(run)
    rng = np.random.default_rng(5)
    g = torch.Generator(device=device).manual_seed(7)
    t_phase = t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    heads = A.init_heads(cfg, device=device)
    _sync(device)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    kinds = {k: n for k, n in _layer_kinds(cfg).items() if n}
    tag = " (reduced)" if run.narrow else ""
    cut = (f" (a depth cut of its {get_config(run.arch).n_layers})"
           if run.n_layers and not run.narrow else "")
    extra = []
    if cfg.n_experts:
        extra.append(f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff "
                     f"{cfg.d_ff} each")
    if cfg.is_encoder_decoder:
        extra.append(f"{cfg.n_enc_layers} encoder layers over "
                     f"{cfg.n_enc_tokens} stub frames")
    if cfg.n_frontend_tokens:
        extra.append(f"{cfg.n_frontend_tokens} stub patch rows prepended")
    print(f"anytime model: {run.arch}{tag}, {cfg.n_layers} layers{cut} "
          f"{json.dumps(kinds)}, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"/ {cfg.n_kv_heads} kv, hd {cfg.resolved_head_dim}, window "
          f"{cfg.window}, vocab {cfg.padded_vocab}, {cfg.dtype}, "
          f"{cfg.n_units} units ({cfg.resolved_mandatory_units} mandatory)"
          f"{''.join('; ' + e for e in extra)}; {n_params / 1e6:.1f} M "
          f"parameters, {n_bytes / 2**30:.2f} GiB (param_count "
          f"{cfg.param_count() / 1e6:.1f} M), built in "
          f"{time.perf_counter() - t0:.2f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the main path: counts zeroed just before, read just after ------
    # host-clock times spread between calls, so the decode steps are timed
    # in two halves (and phases 8 and 9 run the prefill twice)
    ops.reset_launch_counts()
    P, steps = run.prefill_len, run.decode_steps
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, P)).astype(
        np.int32)).to(device)
    batch = dict({"tokens": toks}, **_frontend(cfg, 1, g, device))
    n_ctx = P + cfg.n_frontend_tokens
    cache_len = n_ctx + steps if run.full_cache else None
    pre_s = []
    for _ in range(run.prefill_reps):
        (logits, state), secs = _timed(lambda: T.prefill(
            cfg, params, batch, cache_len=cache_len), device)
        pre_s.append(secs)
    tok = torch.argmax(logits, -1).to(torch.int32)

    def decode(n):
        nonlocal logits, state, tok
        for _ in range(n):
            logits, state = T.decode_step(cfg, params, state, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)

    halves = (steps // 2, steps - steps // 2)
    dec_ms = [1e3 * _timed(lambda: decode(n), device)[1] / n for n in halves]
    if not (bool(logits.isfinite().all())
            and int(state["pos"][0]) == n_ctx + steps
            and tuple(logits.shape) == (1, cfg.padded_vocab)):
        raise AssertionError("prefill + decode: bad logits or state")
    front = (f" after {cfg.n_frontend_tokens} patch rows"
             if cfg.n_frontend_tokens else
             f" (the encoder over {cfg.n_enc_tokens} frames in it)"
             if cfg.is_encoder_decoder else "")
    front_fwd = (f", {cfg.n_frontend_tokens} patch rows each"
                 if cfg.n_frontend_tokens else
                 f", the encoder over {cfg.n_enc_tokens} frames each"
                 if cfg.is_encoder_decoder else "")
    print(f"prefill {P} tokens{front}: "
          f"{', again '.join(f'{t:.3f} s' for t in pre_s)}; "
          f"{steps} decode steps: {dec_ms[0]:.2f} ms per step over the "
          f"first {halves[0]}, {dec_ms[1]:.2f} over the next {halves[1]} "
          f"(host clock, synchronised)")

    fwd_s, thr, use = None, None, None
    if run.fwd_shape:
        B2, S2 = run.fwd_shape
        toks2 = torch.from_numpy(rng.integers(0, cfg.vocab, (B2, S2)).astype(
            np.int32)).to(device)
        batch2 = dict({"tokens": toks2}, **_frontend(cfg, B2, g, device))
        ul, fwd_s = _timed(lambda: A.anytime_forward(cfg, params, heads,
                                                     batch2), device)
        S_out = S2 + cfg.n_frontend_tokens
        if (tuple(ul.shape) != (cfg.n_units, B2, S_out, cfg.padded_vocab)
                or not bool(ul.isfinite().all())):
            raise AssertionError("anytime_forward: bad logits")
        (thr, use), cal_s = _timed(lambda: A.calibrate_thresholds(
            ul, target_agreement=ANY_TARGET_AGREEMENT), device)
        agree = [float((ul[u].argmax(-1) == ul[-1].argmax(-1)).float()
                       .mean()) for u in range(cfg.n_units)]
        del ul
        print(f"anytime_forward ({B2} x {S2} tokens{front_fwd}): "
              f"{fwd_s:.3f} s; "
              f"per-unit agreement with full depth "
              f"{[round(a, 4) for a in agree]}; thresholds at "
              f"{ANY_TARGET_AGREEMENT}: {[round(float(t), 3) for t in thr]} "
              f"enabled {[bool(u) for u in use]} ({cal_s:.3f} s)")

    reqs = _any_requests(cfg, run, rng)
    served, engine_ms = {}, []
    # the solar harvester of the §9.2 run, then a persistent supply: with
    # the engine's default energy model a 16-slot full-depth step costs far
    # more than 0.35 W refills
    supplies = {"solar": lambda: energy.calibrate_harvester(0.71, 0.35),
                "persistent": lambda: None}
    for supply_name, policy in run.engines:
        eng = AnytimeServeEngine(cfg, params, heads, serve_cfg=AnytimeConfig(
            policy=policy, batch_slots=run.slots, max_steps=run.max_steps,
            prompt_len=run.prompt, max_new_tokens=run.new),
            supply=supplies[supply_name](), seed=0)
        knobs = (eng.default_knobs(exit_thr=thr, use_exit_thr=use.float())
                 if policy == "anytime" else eng.default_knobs())
        res, wall = _timed(lambda: eng.run(reqs, knobs=knobs), device)
        steps_run = eng.scfg.max_steps
        if not (res.n_requests == len(reqs) and np.isfinite(res.horizon)
                and res.tokens.sum() <= res.requested.sum()
                and np.all(res.depth_sum <= cfg.n_units * res.tokens)):
            raise AssertionError(f"anytime engine ({policy}): bad result")
        served[f"{policy}, {supply_name}"] = res
        engine_ms.append(1e3 * wall / steps_run)
        print(f"engine {policy} ({supply_name} supply): {steps_run} steps of "
              f"{run.slots} slots in {wall:.3f} s "
              f"({1e3 * wall / steps_run:.2f} ms per step), "
              f"{res.completed / wall:.2f} requests completed/s, "
              f"{int(res.tokens.sum()) / wall:.2f} tokens/s; on-time "
              f"{res.on_time}/{res.n_requests}, completed {res.completed}, "
              f"mean depth {res.mean_depth:.3f}/{cfg.n_units}, agreement "
              f"{res.agreement:.4f}, score {res.score:.4f}, simulated "
              f"horizon {res.horizon:.2f} s")
    counts = ops.launch_counts()
    want = _any_launches(cfg, run, run.prefill_reps + bool(run.fwd_shape))
    launches = {k: counts[k] for k in want}
    peak = None
    if device.type == "cuda":
        if launches != want:
            raise AssertionError(f"{run.arch}: launches {launches} on the "
                                 f"anytime path, not {want}")
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"anytime launches {json.dumps(launches)}; peak device memory "
              f"{peak:.2f} GiB")
    if run.profile:
        # where a decode step's and an engine step's time goes (the prefix
        # state goes on decoding past its cache: the ring buffer wraps)
        _profile(device, "decode step", 1, 10, decode)
        tables = eng.pack(reqs)
        carry = [eng.init_carry(tables)]

        def engine_steps(n):
            for _ in range(n):
                carry[0] = eng._step(tables, carry[0], knobs)

        _profile(device, "engine step", run.slots, 5, engine_steps)
    secs = time.perf_counter() - t_phase
    print(f"anytime path {run.arch}: {secs:.1f} s in all")
    return dict(launches=launches, prefill_s=pre_s, decode_ms=dec_ms,
                forward_s=fwd_s, engine_ms=engine_ms, peak_gib=peak,
                seconds=secs,
                engine={p: r.as_dict() for p, r in served.items()})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _flash_phase(device, shapes) -> dict:
    """Kernel G against its plain version at ``shapes`` in bf16
    and f32, with the times of G, the plain version and one
    ``scaled_dot_product_attention`` call (the yardstick; never on the
    port's path) and the bound: the larger of the bytes (q, k, v read
    once, the f32 output written once) over HBM bandwidth and the useful
    (unmasked) flops over the dense peak of the input type."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as FA

    g = torch.Generator(device=device).manual_seed(3)
    rows = []
    for shape in shapes:
        B, S, Skv, H, KV, hd, causal, window, qo = shape
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn((B, S, H, hd), generator=g, device=device).to(dt)
            k = torch.randn((B, Skv, KV, hd), generator=g,
                            device=device).to(dt)
            v = torch.randn((B, Skv, KV, hd), generator=g,
                            device=device).to(dt)
            kw = dict(causal=causal, window=window, q_offset=qo)
            out = FA.flash_attention(q, k, v, **kw)
            ref = FA.flash_attention_plain(q, k, v, **kw)
            rtol, atol = FLASH_TOL[dtype]
            torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
            err = _max_err(out, ref)
            big = B * S * Skv * H > 1 << 28
            ms = _ms(lambda: FA.flash_attention(q, k, v, **kw), device,
                     reps=5 if big else 20)
            plain_ms = _ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                           device, reps=2 if big else 5, warmup=1)
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).contiguous()
            vt = v.transpose(1, 2).contiguous()
            if causal and not window and not qo and S == Skv:
                sdpa_kw = dict(is_causal=True)
            else:
                qpos = torch.arange(S, device=device)[:, None] + qo
                kpos = torch.arange(Skv, device=device)[None, :]
                mask = torch.ones((S, Skv), dtype=torch.bool, device=device)
                if causal:
                    mask &= qpos >= kpos
                if window:
                    mask &= qpos - kpos <= window
                sdpa_kw = dict(attn_mask=mask)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=KV != H, **sdpa_kw)

            lib_ms = _ms(sdpa, device, reps=5 if big else 20)
            work = FA.work(B, S, Skv, H, KV, hd, dt, **kw)
            flops = work.ops
            bound_ms, by = _bound(work)
            path = FA.kernel_path(dt, hd)
            hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
            regs = FLASH_REGISTERS.get((path, hdp), "registers not reported")
            label = (f"B={B} S={S} Skv={Skv} H={H} KV={KV} hd={hd}"
                     f"{' causal' if causal else ''}"
                     f"{f' window={window}' if window else ''}"
                     f"{f' q_offset={qo}' if qo else ''} {dtype}")
            print(f"flash_attention ({label}): {path} kernel ({regs}); max "
                  f"err {err:.3g} vs plain; kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.2f} TFLOP/s useful), plain "
                  f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms ({by})")
            rows.append(dict(shape=label, path=path, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=by,
                             tflop_s=flops / ms / 1e9))
    row = dict(rows[0])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    row["shapes"] = rows[1:]
    return row


def _decode_inputs(shape, g, device):
    """Kernel H's inputs at ``shape``: a cache of ``C`` slots holding
    positions 0 .. pos per row (pos from C - 1 down to C // 2 over the
    rows),
    the rest empty (-1)."""
    import torch

    B, H, KV, hd, C, dtype, round_p, window = shape
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, hd), generator=g, device=device).to(dt)
    k = torch.randn((B, C, KV, hd), generator=g, device=device).to(dt)
    v = torch.randn((B, C, KV, hd), generator=g, device=device).to(dt)
    pos = torch.linspace(C - 1, C // 2, B, device=device).to(torch.int32)
    slots = torch.arange(C, device=device, dtype=torch.int32)
    slot_pos = torch.where(slots[None, :] <= pos[:, None], slots[None, :],
                           -1).to(torch.int32)
    return q, k, v, slot_pos, pos


def _decode_phase(device, shapes) -> dict:
    """Kernel H against its plain version at ``shapes``, with
    the times of H, the plain version and one
    ``scaled_dot_product_attention`` call on the same cache with a boolean
    slot mask (the yardstick; never on the port's path) and the bound: the
    bytes that the function needs (q, the positions, the k and v rows of
    the slots that each row's mask keeps, each read once, the f32 output
    written once) over HBM bandwidth against the flops (4 * H * hd per kept
    slot of a row) over the f32 peak."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_gqa as DG

    g = torch.Generator(device=device).manual_seed(4)
    rows = []
    for shape in shapes:
        B, H, KV, hd, C, dtype, round_p, window = shape
        q, k, v, slot_pos, pos = _decode_inputs(shape, g, device)
        kw = dict(window=window, round_p=round_p)
        out = DG.decode_gqa(q, k, v, slot_pos, pos, **kw)
        ref = DG.decode_gqa_plain(q, k, v, slot_pos, pos, **kw)
        torch.testing.assert_close(out, ref, rtol=DECODE_TOL[0],
                                   atol=DECODE_TOL[1])
        err = _max_err(out, ref)
        ms = _ms(lambda: DG.decode_gqa(q, k, v, slot_pos, pos, **kw), device)
        plain_ms = _ms(lambda: DG.decode_gqa_plain(q, k, v, slot_pos, pos,
                                                   **kw), device, reps=5,
                       warmup=1)
        valid = DG.kept_slots(slot_pos, pos, window)
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        kt, vt = kt.contiguous(), vt.contiguous()
        mask = valid[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)

        lib_ms = _ms(sdpa, device)
        work = DG.work(B, H, KV, hd, C, q.dtype, n_valid=int(valid.sum()))
        nbytes = work.bytes
        bound_ms, by = _bound(work)
        nsplit, chunk = DG.split_plan(
            B, KV, C, torch.cuda.get_device_properties(
                device).multi_processor_count if device.type == "cuda"
            else 132)
        label = (f"B={B} H={H} KV={KV} hd={hd} C={C} {dtype}"
                 f"{' round_p' if round_p else ''}"
                 f"{f' window={window}' if window else ''}")
        print(f"decode_gqa ({label}): {nsplit} split(s) of {chunk} slots; "
              f"max err {err:.3g} vs plain; kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.2f} GB/s of the bound's bytes), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({by})")
        rows.append(dict(shape=label, splits=nsplit, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by,
                         gb_s=nbytes / ms / 1e6))
    row = dict(rows[0])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    row["shapes"] = rows[1:]
    return row


def _rglru_phase(device, scale: Scale) -> dict:
    """Kernel I against its plain version, bit for bit, at
    ``scale.rglru_shapes`` (the TMA path at W = 4,096, the ``cp.async``
    path at W = 53), with the event and device times of I, the plain
    version's time and the bound: a, b and h0 read once, h written once
    (bytes over HBM bandwidth; one FMA per element).  PyTorch has no
    linear-recurrence scan, so there is no one-call yardstick
    (``library_ms`` is null)."""
    import torch

    from repro_torch.kernels import rglru_scan as RS

    g = torch.Generator(device=device).manual_seed(5)
    rows = []
    for B, S, W, with_h0 in scale.rglru_shapes:
        a = 0.7 + 0.299 * torch.rand((B, S, W), generator=g, device=device)
        b = 0.1 * torch.randn((B, S, W), generator=g, device=device)
        h0 = (torch.randn((B, W), generator=g, device=device) if with_h0
              else torch.zeros((B, W), device=device))
        h, hl = RS.rglru_scan(a, b, h0)
        rh, rhl = RS.rglru_scan_plain(a, b, h0)
        if not (torch.equal(h, rh) and torch.equal(hl, rhl)):
            raise AssertionError(f"rglru_scan kernel != plain version at "
                                 f"{(B, S, W)}")
        ms = _ms(lambda: RS.rglru_scan(a, b, h0), device)
        # back to back on the card: the profiler loses launches after the
        # serve and replay profiles in one process
        dev_ms = _busy_ms(lambda: RS.rglru_scan(a, b, h0), device, reps=20)
        plain_ms = _ms(lambda: RS.rglru_scan_plain(a, b, h0), device, reps=1,
                       warmup=0)
        # h_last is the view h[:, -1]: no bytes of its own
        bound_ms, by = _bound(RS.work(B, S, W))
        path = RS.copy_path(W, a.data_ptr(), b.data_ptr(), h.data_ptr())
        label = f"B={B} S={S} W={W}{' h0' if with_h0 else ''}"
        print(f"rglru_scan ({label}, {path} path): equal to plain; kernel "
              f"{ms:.4f} ms (device {dev_ms:.5f} ms per launch), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}); no "
              "one-call PyTorch equivalent (no linear-recurrence scan)")
        rows.append(dict(shape=label, copy_path=path, max_abs_err=0.0, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms, bound_by=by))
    row = dict(rows[0])
    row["shapes"] = rows[1:]
    return row


class _RouteLog:
    """Records every MoE routing of a run (``moe.route`` wrapped while the
    log is open), so two runs' routers can be compared choice by choice."""

    def __init__(self):
        self.routes = []

    def __enter__(self):
        from repro_torch.models import moe

        self._route = route = moe.route

        def logged(*args, **kw):
            r = route(*args, **kw)
            self.routes.append((r.expert_idx.cpu(), r.keep.cpu()))
            return r

        moe.route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route


def _same_routes(a: _RouteLog, b: _RouteLog, what: str) -> int:
    """The routers' choices (``expert_idx``) and kept pairs (``keep``) of
    two runs equal, call by call; a flip is reported as one.  Returns the
    routing calls compared."""
    import torch

    if len(a.routes) != len(b.routes):
        raise AssertionError(f"{what}: {len(a.routes)} routing calls "
                             f"against {len(b.routes)}")
    for i, ((ia, ka), (ib, kb)) in enumerate(zip(a.routes, b.routes)):
        flips = int((ia != ib).sum())
        drops = int((ka != kb).sum())
        if flips or drops:
            raise AssertionError(f"{what}: routing call {i} flipped "
                                 f"{flips} expert choices and {drops} kept "
                                 f"pairs (a near-tie of the router, not a "
                                 f"gap of the layer)")
    return len(a.routes)


def _close_or_witness(card, cpu, what: str, inputs: str,
                      tol: float = 1e-4) -> None:
    """``torch.testing.assert_close(card, cpu, rtol=tol, atol=tol)`` with
    ``card`` moved to the CPU, unchanged; when it fails, the error also
    carries the witness ROADMAP Queue 3 asks for: the inputs, the shapes,
    the count of values past the tolerance (NaN and inf included) and the
    ten worst as (position, card, CPU)."""
    import torch

    card = card.detach().cpu()
    try:
        torch.testing.assert_close(card, cpu, rtol=tol, atol=tol)
    except AssertionError as e:
        head = (f"{what} ({inputs}; card {tuple(card.shape)} {card.dtype}, "
                f"CPU {tuple(cpu.shape)} {cpu.dtype})")
        if card.shape != cpu.shape or card.dtype != cpu.dtype:
            raise AssertionError(f"{head}: {e}") from e
        over = ~torch.isclose(card, cpu, rtol=tol, atol=tol)
        n = int(over.sum())
        gap = torch.nan_to_num((card - cpu).abs(), nan=float("inf"))
        gap = torch.where(over, gap, torch.full_like(gap, -1.0))
        worst = torch.topk(gap.reshape(-1), max(1, min(10, n))).indices
        rows = [(tuple(int(i) for i in np.unravel_index(int(j), cpu.shape)),
                 float(card.reshape(-1)[j]), float(cpu.reshape(-1)[j]))
                for j in worst]
        raise AssertionError(f"{head}: {n} of {cpu.numel()} values past "
                             f"rtol = atol = {tol}; worst (position, card, "
                             f"CPU): {rows}; {e}") from e


def _any_cpu_check(device, run: AnyRun, S: int, *, engine: bool = True,
                   telemetry: bool = True, engine_steps: int = 96) -> None:
    """The port on the card against the port on the CPU at the config's
    reduced size (f32), with the config's stub frames or patches: a
    ``forward`` of 2 x ``S`` tokens (kernels G and I against the chunked or
    dense path and the associative scan, rtol = atol = 1e-4; an MoE
    config's aux loss too), a prefill of ``S`` tokens and four decode steps
    (kernel H against the einsum path, 1e-4); an MoE config's router
    choices and kept pairs equal call by call first, so that a near-tie
    flip is reported as a flip.  With ``engine``, one EDF engine run (the
    result arrays equal: the depth is fixed and every emitted token agrees
    with itself); with ``telemetry`` also with ``telemetry=full`` (the same
    result arrays; the telemetry's integer fields equal the CPU's, its
    floats within ``tests/test_telemetry.py``'s tolerances).  The config's
    window must be a multiple of the CPU path's chunk
    (``attention.chunk_size``): on any other window the reference's
    chunked path, which the CPU port mirrors, drops keys that kernel G
    keeps (ROADMAP Queue 3), so the check asserts it first."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.serve import AnytimeConfig, AnytimeServeEngine
    from repro_torch.telemetry import TelemetryConfig

    cfg = get_config(run.arch).reduced()
    chunk = attention.chunk_size(S, S, cfg.attn_chunk)
    if cfg.window % chunk:
        raise AssertionError(f"{run.arch} reduced: window {cfg.window} is no "
                             f"multiple of the CPU path's chunk {chunk}")
    cpu = torch.device("cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(1), device=cpu)
    on_dev = convert.tree(params, device)
    rng = np.random.default_rng(9)
    batch = dict({"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, S)).astype(np.int32))},
        **_frontend(cfg, 2, torch.Generator().manual_seed(2), cpu))
    dev_batch = {k: v.to(device) for k, v in batch.items()}
    with _RouteLog() as ra:
        a, aux_a = T.forward(cfg, on_dev, dev_batch)
    with _RouteLog() as rb:
        b, aux_b = T.forward(cfg, params, batch)
    n_routes = _same_routes(ra, rb, f"{run.arch} forward on the card vs CPU")
    inputs = (f"{run.arch} reduced, parameters from torch.Generator seed 1, "
              f"tokens from numpy seed 9, batch 2 x {S}")
    _close_or_witness(a, b, f"{run.arch} forward logits on the card vs CPU",
                      inputs)
    a = a.cpu()
    torch.testing.assert_close(aux_a.cpu(), aux_b, rtol=1e-4, atol=1e-4)
    with _RouteLog() as ra:
        la, sa = T.prefill(cfg, on_dev, dev_batch)
    with _RouteLog() as rb:
        lb, sb = T.prefill(cfg, params, batch)
    dec_err = _max_err(la.cpu(), lb)
    for i in range(4):
        _close_or_witness(la, lb, f"{run.arch} prefill + {i} decode steps' "
                          f"logits on the card vs CPU", inputs)
        tok = torch.argmax(lb, -1).to(torch.int32)
        with ra:
            la, sa = T.decode_step(cfg, on_dev, sa, tok.to(device))
        with rb:
            lb, sb = T.decode_step(cfg, params, sb, tok)
        dec_err = max(dec_err, _max_err(la.cpu(), lb))
    _close_or_witness(la, lb, f"{run.arch} prefill + 4 decode steps' logits "
                      f"on the card vs CPU", inputs)
    n_routes += _same_routes(ra, rb, f"{run.arch} prefill + decode on the "
                             "card vs CPU")
    routes = (f"; {n_routes} routing calls with equal expert choices and "
              f"kept pairs" if n_routes else "")
    eng_line = ""
    if engine:
        sc = AnytimeConfig(policy="edf", batch_slots=2,
                           max_steps=engine_steps, prompt_len=4,
                           max_new_tokens=4)
        reqs = _any_requests(cfg, dataclasses.replace(
            run, requests=6, prompt=4, new=4), rng)
        r_dev = AnytimeServeEngine(cfg, on_dev, serve_cfg=sc).run(reqs)
        r_cpu = AnytimeServeEngine(cfg, params, serve_cfg=sc).run(reqs)
        for f in ("status", "finish", "agree", "tokens", "depth_sum"):
            if not np.array_equal(getattr(r_dev, f), getattr(r_cpu, f)):
                raise AssertionError(f"{run.arch} engine on the card != the "
                                     f"CPU: {f}")
        eng_line = (f"; EDF engine run equal on every result array "
                    f"({r_dev.on_time}/{r_dev.n_requests} on time)")
    if engine and telemetry:
        full = TelemetryConfig(ring_size=64, level="full")
        t_dev = AnytimeServeEngine(cfg, on_dev, serve_cfg=sc).run(
            reqs, telemetry=full)
        t_cpu = AnytimeServeEngine(cfg, params, serve_cfg=sc).run(
            reqs, telemetry=full)
        for f in ("status", "finish", "agree", "tokens", "depth_sum"):
            if not (np.array_equal(getattr(t_dev, f), getattr(r_dev, f))
                    and np.array_equal(getattr(t_cpu, f),
                                       getattr(r_cpu, f))):
                raise AssertionError(f"{run.arch} engine with telemetry != "
                                     f"without: {f}")
        tel_gap = _tel_gap(t_dev.telemetry, t_cpu.telemetry,
                           f"{run.arch} engine telemetry on the card vs CPU")
        if int(t_dev.telemetry.exit_hist.sum()) != int(t_dev.tokens.sum()):
            raise AssertionError(f"{run.arch} engine telemetry: the depth "
                                 "histogram does not count every token")
        eng_line += (f", also with telemetry=full, whose fields equal the "
                     f"CPU's (ints exact, largest float gap {tel_gap:.3g})")
    print(f"anytime card vs CPU ({run.arch} reduced): forward within 1e-4 "
          f"(max err {_max_err(a, b):.3g}); prefill + 4 decode steps within "
          f"1e-4 (max err {dec_err:.3g}){routes}{eng_line}")


def _zoo_phase(device, scale: Scale) -> dict:
    """Phase 10: the rest of the model zoo, one model resident at a time
    (each freed before the next), then kernels G and H at the zoo's new
    geometries and every family's reduced size on the card against the
    CPU."""
    import gc

    import torch

    out = {}
    for run in scale.zoo:
        out[run.arch] = _anytime_phase(device, scale, run)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    g_rows = _flash_phase(device, scale.zoo_flash_shapes)
    h_rows = _decode_phase(device, scale.zoo_decode_shapes)
    for run in scale.zoo:
        _any_cpu_check(device, run, 64, engine=bool(run.engines),
                       telemetry=False, engine_steps=scale.zoo_check_steps)
    return dict(runs=out, g_row=g_rows, h_row=h_rows)


# --------------------------------------------------------------------------- #
# Phase 11: training.
# --------------------------------------------------------------------------- #

#: the narrowed CNN of the card-vs-CPU siamese steps (phase 11a)
CHECK_CNN = dict(name="cifar100-check", input_shape=(32, 32, 3),
                 convs=((8, 5, True), (16, 5, True)), fcs=(32, 16),
                 n_classes=5)


def _falls(history) -> bool:
    """The loss fell: the mean of the last quarter (at least one step) under
    the mean of the first."""
    h = np.asarray(history, dtype=np.float64)
    n = max(1, len(h) // 4)
    return bool(np.all(np.isfinite(h)) and h[-n:].mean() < h[:n].mean())


def _cnn_close(a_params, b_params, lr: float, steps: int) -> float:
    """Largest parameter gap of two CNN runs of ``steps`` steps; raises
    unless every element of every leaf is within 1e-2 * lr."""
    from repro_torch.train.optimizer import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(a_params), tree_leaves(b_params)):
        gap = (a.detach().cpu().double() - b.detach().cpu().double()).abs()
        worst = max(worst, float(gap.max()))
        if not bool((gap <= 1e-2 * lr).all()):
            raise AssertionError(f"CNN parameters on the card vs CPU: gap "
                                 f"{float(gap.max()):.3g} after {steps} "
                                 f"steps, past 1e-2 * lr (lr {lr})")
    return worst


def _train_cnn_phase(device, scale: Scale) -> dict:
    """Phase 11a: the agile CNNs of the serve workload trained on the card
    with the layer-aware loss (``train_agile_cnn`` as
    ``src/repro/launch/serve.py`` calls it: 384 training samples, 3 epochs,
    768 pairs), the bank fitted and its thresholds calibrated (kernel D);
    then one epoch of each Fig. 15 baseline (contrastive, cross-entropy);
    each with its loss history, the bank's per-unit exit accuracy on the
    test split and kernel D's launches (counts zeroed before, read after);
    then 5 siamese steps of a narrowed CNN on the card against the CPU from
    the same initial parameters."""
    import torch

    from repro_torch.core import kmeans as km
    from repro_torch.data import make_dataset, make_siamese_pairs
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.train import adamw_init, train_agile_cnn
    from repro_torch.train import trainer as TR

    spec = scale.train_cnn
    runs = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i, name in enumerate(spec.names):
        cfg = spec.cfgs[i] if spec.cfgs else cnn.PAPER_CNNS[name]
        ds = make_dataset(name, n_train=spec.n_train, n_test=spec.n_test,
                          seed=i)
        for loss, epochs in (("layer_aware", spec.epochs),
                             ("contrastive", 1), ("cross_entropy", 1)):
            t1 = time.perf_counter()
            out = train_agile_cnn(ds, loss=loss, epochs=epochs,
                                  n_pairs=spec.n_pairs, seed=i, cfg=cfg,
                                  device=device)
            _sync(device)
            secs = time.perf_counter() - t1
            with torch.no_grad():
                feats = cnn.cnn_forward_all(cfg, out.params, torch.from_numpy(
                    ds.x_test).to(device))
            acc = km.bank_accuracy(out.bank, feats, ds.y_test)
            h = out.history
            print(f"train_agile_cnn ({name}, {cfg.name}, {loss}, {epochs} "
                  f"epoch(s), {len(h)} steps): loss {h[0]:.4f} -> "
                  f"{h[-1]:.4f}; exit accuracy per unit on the test split "
                  f"{[round(a, 4) for a in acc]}; {secs:.2f} s")
            if loss == "layer_aware" and not _falls(h):
                raise AssertionError(f"{name}: the layer-aware loss did not "
                                     f"fall: {h[:3]} ... {h[-3:]}")
            runs[f"{name}/{loss}"] = dict(first=h[0], last=h[-1],
                                          steps=len(h), seconds=secs,
                                          exit_accuracy=acc)
    counts = ops.launch_counts()
    launches = {k: counts[k] for k in TRAIN_CNN_KERNELS}
    others = {k: n for k, n in counts.items() if n and k not in launches}
    if device.type == "cuda" and (not launches["l1_topk2"] or others):
        raise AssertionError(f"train_agile_cnn: kernel D launched "
                             f"{launches['l1_topk2']} times, others {others}")
    print(f"train path launches {json.dumps(launches)}; "
          f"{time.perf_counter() - t0:.1f} s")

    # card vs CPU: the same initial parameters and pairs
    ccfg = cnn.CNNConfig(**CHECK_CNN)
    ds = make_dataset("cifar100", n_train=128, n_test=32, seed=5)
    x1, x2, diff = make_siamese_pairs(ds.x_train, ds.y_train, 80, seed=5)
    cpu = torch.device("cpu")
    p_cpu = cnn.init_cnn_params(ccfg, torch.Generator().manual_seed(5),
                                device=cpu)
    p_dev = {k: [{n: t.to(device) for n, t in layer.items()} for layer in v]
             for k, v in p_cpu.items()}
    o_cpu, o_dev = adamw_init(p_cpu), adamw_init(p_dev)
    loss_gap = 0.0
    lr = 1e-3
    for i in range(5):
        sl = slice(16 * i, 16 * i + 16)
        a, b, d = (torch.from_numpy(np.ascontiguousarray(x[sl]))
                   for x in (x1, x2, diff))
        p_cpu, o_cpu, l_cpu = TR.siamese_step(ccfg, p_cpu, o_cpu, a, b, d,
                                              lr=lr)
        p_dev, o_dev, l_dev = TR.siamese_step(
            ccfg, p_dev, o_dev, a.to(device), b.to(device), d.to(device),
            lr=lr)
        gap = abs(float(l_dev) - float(l_cpu))
        loss_gap = max(loss_gap, gap)
        if gap > 1e-5 * max(1.0, abs(float(l_cpu))):
            raise AssertionError(f"siamese step {i}: loss on the card "
                                 f"{float(l_dev)} vs CPU {float(l_cpu)}")
    p_gap = _cnn_close(p_dev, p_cpu, lr, 5)
    print(f"train card vs CPU ({ccfg.name}, 5 siamese steps): losses within "
          f"{loss_gap:.3g}, parameters within {p_gap:.3g} (lr {lr})")
    return dict(runs=runs, launches=launches)


def _lm_config(run: TrainRun):
    from repro_torch.configs import get_config

    cfg = get_config(run.arch)
    if run.narrow:
        cfg = cfg.reduced()
    if run.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=run.n_layers)
    return cfg


def _train_lm_phase(device, run: TrainRun) -> dict:
    """Phases 11b-c: ``run.steps`` calls of ``train_step_lm`` on one fixed
    batch of ``make_lm_tokens`` (seed 0), ``run.microbatches``
    microbatches, seeded random weights in the config's dtype: the loss of
    each step (it must fall), ms per step and tokens/s (host clock ending
    in a synchronisation), peak device memory, and the launches of kernels
    G and I and their backward kernels (counts zeroed before, read
    after); then, on a card, two further ``adamw_update`` calls alone
    (CUDA events), the update's share of a step."""
    import gc

    import torch

    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train import adamw_init, adamw_update, train_step_lm
    from repro_torch.train.optimizer import tree_leaves, tree_map

    cfg = _lm_config(run)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tokens = make_lm_tokens(cfg.vocab, run.seq, run.batch, seed=0)
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    _sync(device)
    setup = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(run.steps):
        t1 = time.perf_counter()
        params, opt, m = train_step_lm(cfg, params, opt, batch,
                                       microbatches=run.microbatches)
        _sync(device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    want = _train_launches(cfg, run.steps * run.microbatches)
    launches = {k: counts[k] for k in want}
    if device.type == "cuda" and {k: n for k, n in counts.items()
                                  if n} != want:
        raise AssertionError(f"{run.arch} training launches {counts}, "
                             f"expected {want}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{run.arch}: the loss did not fall: {losses}")
    shares = {}
    if device.type == "cuda":
        # one further step under the profiler (after the counts were read)
        def step():
            nonlocal params, opt
            params, opt, _ = train_step_lm(cfg, params, opt, batch,
                                           microbatches=run.microbatches)

        shares = _step_shares(step, device)
        print(f"train_step_lm ({run.arch}) profiled step: " + json.dumps(
            {k: round(v, 4) for k, v in shares.items()}))
    upd_ms = []
    if device.type == "cuda":
        grads = tree_map(lambda p: torch.full_like(p, 1e-4), params)
        for _ in range(2):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            params, opt = adamw_update(params, grads, opt)
            e1.record()
            e1.synchronize()
            upd_ms.append(e0.elapsed_time(e1))
        del grads
    toks = run.batch * run.seq
    rates = [toks / (ms / 1e3) for ms in step_ms]
    print(f"train_step_lm ({run.arch}, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters {str(T.dtype_of(cfg)).split('.')[-1]}"
          f", batch {run.batch} x {run.seq}, {run.microbatches} microbatches): "
          f"loss {[round(x, 4) for x in losses]}; ms per step "
          f"{[round(x, 1) for x in step_ms]} ({max(rates):.1f} tokens/s at "
          f"best); AdamW update alone {[round(x, 2) for x in upd_ms]} ms; "
          f"peak {peak:.2f} GiB; set-up {setup:.1f} s; launches "
          f"{json.dumps(launches)}")
    del params, opt, batch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, tokens_per_s=rates,
                update_ms=upd_ms, peak_gib=peak, n_params=n_params,
                launches=launches, profile=shares)


def _train_launches(cfg, passes: int) -> dict:
    """Kernel launches of ``passes`` forward and backward passes of
    ``forward`` under activation checkpointing: a layer of the stacked
    periods (every group, the leftover one too) runs its forward twice
    (the pass and the backward's recompute), a remainder layer once; the
    backward launches G's two kernels and I's one per layer."""
    from repro_torch.models import transformer as T

    period, n_scan, _ = T._layer_plan(cfg)
    want = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                          "rglru_scan", "rglru_scan_bwd"), 0)
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        fwd = 2 if i < n_scan * period else 1
        if kind == "attn":
            want["flash_attention"] += fwd * passes
            want["flash_attention_bwd"] += 2 * passes
        elif kind == "rec":
            want["rglru_scan"] += fwd * passes
            want["rglru_scan_bwd"] += passes
    return {k: n for k, n in want.items() if n}


#: kernel-name fragments of each part of a train step's device time
STEP_PARTS = (("g_bwd", ("dq_tc_kernel", "dkdv_tc_kernel", "dq_kernel",
                         "dkdv_kernel")),
              ("i_bwd", ("rglru_scan_bwd_kernel",)),
              ("g_fwd", ("flash_tc_kernel", "flash_attn_kernel")),
              ("i_fwd", ("rglru_scan_kernel",)),
              ("products", ("gemm", "Gemm", "GEMM", "cutlass", "xmma",
                            "nvjet", "cublas", "sm90_")))


def _step_shares(fn, device) -> dict:
    """One call of ``fn`` (a train step) under ``torch.profiler``: the
    step's host-clock ms (ending in a synchronisation; the profiler's own
    cost included), the device ms of all its kernels, the share of that
    device time in each part of :data:`STEP_PARTS` (by kernel name; the
    first part that matches takes a kernel) and in the rest, and the
    card's idle share of the step (1 - device / host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        host = (time.perf_counter() - t0) * 1e3
    parts = dict.fromkeys([p for p, _ in STEP_PARTS] + ["rest"], 0.0)
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if not t or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = next((p for p, keys in STEP_PARTS
                     if any(k in e.key for k in keys)), "rest")
        parts[part] += t / 1e3
    dev = sum(parts.values())
    out = dict(host_ms=host, device_ms=dev,
               idle_share=1.0 - dev / host if host else float("nan"))
    out.update({f"{p}_share": (t / dev if dev else float("nan"))
                for p, t in parts.items()})
    return out


def _sdpa_inputs(q, k, v, causal, window, qo):
    """``scaled_dot_product_attention``'s layout and mask for G's inputs."""
    import torch

    S, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if causal and not window and not qo and S == Skv:
        return qt, kt, vt, dict(is_causal=True)
    qpos = torch.arange(S, device=q.device)[:, None] + qo
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos <= window
    return qt, kt, vt, dict(attn_mask=mask)


def _flash_bwd_phase(device, shapes) -> dict:
    """Phase 11d, kernel G's backward against its plain version at
    ``shapes`` in bf16 and f32 (each gradient within 1e-4 of its largest in
    f32, 2^-7 in bf16), on the forward's own ``out`` and ``lse``, with the
    event time of a call, its device time (``_busy_ms``), the plain
    version's, and the backward of ``scaled_dot_product_attention`` by
    autograd (the yardstick; never on the port's path).  The bound: the
    bytes of q, k, v, out, dout and lse read once and dq, dk, dv written
    once, against 10 * hd flops per visible pair (s, dp, dv, dk, dq) over
    the dense peak of the input type (both instances do 14 * hd: s and dp
    are formed in both launches).  Each row names its instance
    (tensor-core in bf16, SIMT in f32) and its registers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as FA

    g = torch.Generator(device=device).manual_seed(21)
    rows = []
    for shape in shapes:
        B, S, Skv, H, KV, hd, causal, window, qo = shape
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn((B, S, H, hd), generator=g, device=device).to(dt)
            k = torch.randn((B, Skv, KV, hd), generator=g,
                            device=device).to(dt)
            v = torch.randn((B, Skv, KV, hd), generator=g,
                            device=device).to(dt)
            dout = torch.randn((B, S, H, hd), generator=g, device=device)
            kw = dict(causal=causal, window=window, q_offset=qo)
            if device.type == "cuda":
                out, lse = FA._launch(q, k, v, causal, window, qo, True)
            else:
                out, lse = FA.flash_attention_plain(q, k, v, **kw,
                                                    return_lse=True)
            got = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                **kw)
            tol = 1e-4 if dtype == "float32" else 2.0 ** -7
            err = 0.0
            for name, a, b in zip("qkv", got, want):
                gap = float((a.float() - b.float()).abs().max())
                top = float(b.float().abs().max())
                if not gap <= tol * top:
                    raise AssertionError(f"flash_attention_bwd d{name} at "
                                         f"{shape} {dtype}: gap {gap} of "
                                         f"{top}")
                err = max(err, gap)
            big = B * S * Skv * H > 1 << 28

            def call():
                return FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)

            ms = _ms(call, device, reps=3 if big else 10)
            dev_ms = _busy_ms(call, device, reps=3 if big else 10)
            plain_ms = _ms(lambda: FA.flash_attention_bwd_plain(
                q, k, v, out, lse, dout, **kw), device, reps=1, warmup=1)
            qt, kt, vt, sdpa_kw = _sdpa_inputs(q, k, v, causal, window, qo)
            qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
            o_lib = F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=KV != H, **sdpa_kw)
            g_lib = dout.transpose(1, 2).to(dt).contiguous()
            lib_ms = _ms(lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), g_lib, retain_graph=True), device,
                reps=3 if big else 10)
            work = FA.bwd_work(B, S, Skv, H, KV, hd, dt, **kw)
            flops = work.ops
            bound_ms, by = _bound(work)
            label = (f"B={B} S={S} Skv={Skv} H={H} KV={KV} hd={hd}"
                     f"{' causal' if causal else ''}"
                     f"{f' window={window}' if window else ''}"
                     f"{f' q_offset={qo}' if qo else ''} {dtype}")
            path = FA.kernel_path(dt, hd)
            regs = FLASH_BWD_REGISTERS.get(
                (path, 64 if hd <= 64 else 128 if hd <= 128 else 256),
                "registers not read (no build log)")
            print(f"flash_attention_bwd ({label}, {path}: {regs}): max err "
                  f"{err:.3g} vs plain; kernel {ms:.4f} ms (device "
                  f"{dev_ms:.4f} ms, {flops / dev_ms / 1e9:.2f} TFLOP/s "
                  f"useful), plain {plain_ms:.4f} ms, sdpa backward "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({by})")
            rows.append(dict(shape=label, path=path, max_abs_err=err, ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=by, tflop_s=flops / dev_ms / 1e9))
    row = dict(rows[0])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    row["shapes"] = rows[1:]
    return row


def _rglru_bwd_phase(device, shapes) -> dict:
    """Phase 11d, kernel I's backward against its plain version bit for
    bit at ``shapes``, with the event and device times, the plain
    version's and the bound (a, h, dh and h0 read once, da, db and dh0
    written once; two flops per element); PyTorch has no linear-recurrence
    scan, so no yardstick."""
    import torch

    from repro_torch.kernels import rglru_scan as RS

    g = torch.Generator(device=device).manual_seed(22)
    rows = []
    for B, S, W in shapes:
        a = 0.7 + 0.299 * torch.rand((B, S, W), generator=g, device=device)
        b = 0.1 * torch.randn((B, S, W), generator=g, device=device)
        h0 = torch.randn((B, W), generator=g, device=device)
        dh = torch.randn((B, S, W), generator=g, device=device)
        h, _ = RS.rglru_scan(a, b, h0)
        got = RS.rglru_scan_bwd(a, h0, h, dh)
        want = RS.rglru_scan_bwd_plain(a, h0, h, dh)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"rglru_scan_bwd kernel != plain at "
                                 f"{(B, S, W)}")
        ms = _ms(lambda: RS.rglru_scan_bwd(a, h0, h, dh), device)
        dev_ms = _busy_ms(lambda: RS.rglru_scan_bwd(a, h0, h, dh), device,
                          reps=20)
        plain_ms = _ms(lambda: RS.rglru_scan_bwd_plain(a, h0, h, dh), device,
                       reps=1, warmup=0)
        bound_ms, by = _bound(RS.bwd_work(B, S, W))
        label = f"B={B} S={S} W={W}"
        print(f"rglru_scan_bwd ({label}): equal to plain; kernel {ms:.4f} ms "
              f"(device {dev_ms:.5f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({by}); no one-call PyTorch equivalent")
        rows.append(dict(shape=label, max_abs_err=0.0, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms, bound_by=by))
    row = dict(rows[0])
    row["shapes"] = rows[1:]
    return row


def _train_cpu_check(device) -> None:
    """Phase 11e: one LM step's gradients (``lm_grads``) of every assigned
    config at its reduced size (f32) on the card against the CPU from the
    same parameters and batch: loss and aux within 1e-4, every gradient
    leaf within 1e-4 of that leaf's largest, or of 1e-3 of the model's
    largest where that is more (a leaf under it is rounding noise: the
    sLSTM's input-gate bias cancels exactly).  A dropped gradient of G or
    I shows here."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import trainer as TR
    from repro_torch.train.optimizer import tree_leaves

    cpu = torch.device("cpu")
    worst = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch).reduced()
        params = T.init_params(cfg, torch.Generator().manual_seed(3),
                               device=cpu)
        rng = np.random.default_rng(4)
        batch = dict({"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 64)).astype(np.int32))},
            **_frontend(cfg, 2, torch.Generator().manual_seed(4), cpu))
        g_dev, m_dev = TR.lm_grads(cfg, convert.tree(params, device),
                                   {k: v.to(device) for k, v in batch.items()})
        g_cpu, m_cpu = TR.lm_grads(cfg, params, batch)
        for key in ("loss", "aux"):
            a, b = float(m_dev[key]), float(m_cpu[key])
            if abs(a - b) > 1e-4 * max(1.0, abs(b)):
                raise AssertionError(f"{arch} step {key}: card {a} vs CPU "
                                     f"{b}")
        top = max(float(b.abs().max()) for b in tree_leaves(g_cpu))
        rel = 0.0
        for a, b in zip(tree_leaves(g_dev), tree_leaves(g_cpu)):
            gap = float((a.cpu() - b).abs().max())
            room = max(float(b.abs().max()), 1e-3 * top)
            if gap > 1e-4 * room:
                raise AssertionError(f"{arch}: a gradient leaf on the card "
                                     f"is {gap:.3g} from the CPU's (room "
                                     f"{1e-4 * room:.3g})")
            rel = max(rel, gap / room)
        worst[arch] = rel
    print("train card vs CPU (reduced, one step's gradients): worst leaf gap "
          "over its room " + json.dumps({k: float(f"{v:.3g}")
                                         for k, v in worst.items()}))


def _train_phase(device, scale: Scale) -> dict:
    """Phase 11: training at full width (11a-c), the backward kernels
    against their plain versions (11d) and the card against the CPU
    (11e)."""
    out = dict(cnn=_phase("11a (agile CNN training)", _train_cnn_phase,
                          device, scale))
    for sub, run in zip("bc", scale.train_lm):
        out[run.arch] = _phase(f"11{sub} (train {run.arch})",
                               _train_lm_phase, device, run)
    out["g_bwd"] = _phase("11d (flash_attention_bwd)", _flash_bwd_phase,
                          device, scale.flash_bwd_shapes)
    out["i_bwd"] = _phase("11d (rglru_scan_bwd)", _rglru_bwd_phase, device,
                          scale.rglru_bwd_shapes)
    _phase("11e (train card vs CPU)", _train_cpu_check, device)
    return out


def _lm_loss_grads(cfg, params, batch, remat: bool):
    """The LM loss's gradients through ``forward(..., remat=remat)`` (one
    microbatch; ``lm_grads``' loss), as a list in the tree's leaf order."""
    import torch

    from repro_torch.core import losses
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    logits, aux = T.forward(cfg, live, batch, remat=remat)
    S = batch["tokens"].shape[1]
    loss = (losses.lm_loss(logits[:, -S:], batch["tokens"])
            + cfg.router_aux_weight * aux)
    del logits
    return list(torch.autograd.grad(loss, tree_leaves(live)))


def _remat_probe(device, probe, check_layers: int) -> dict:
    """Phase 12b: one backward of the LM loss at ``probe``'s (arch cut to
    ``n_layers``, ``batch`` x ``seq``, one microbatch) through ``forward``
    with ``remat`` and then without: the peak device memory above the
    call's start of each and the difference per layer; then the same two
    backwards of the reduced config (``check_layers`` layers: a group and a
    leftover) on the card, their gradients compared card against card
    (bit-equal or not, and within phase 11e's tolerance)."""
    import dataclasses as dc
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_tokens
    from repro_torch.models import transformer as T

    arch, n_layers, B, S, reduced = probe
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = dc.replace(cfg, n_layers=n_layers)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(5),
                           device=device)
    batch = {"tokens": torch.from_numpy(make_lm_tokens(
        cfg.vocab, S, B, seed=5)).to(device)}
    peak = {}
    for remat in (True, False):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            start = torch.cuda.memory_allocated(device)
        grads = _lm_loss_grads(cfg, params, batch, remat)
        _sync(device)
        peak[remat] = ((torch.cuda.max_memory_allocated(device) - start)
                       / 2**30 if device.type == "cuda" else float("nan"))
        del grads
    del params, batch
    per_layer = (peak[False] - peak[True]) / n_layers
    print(f"remat probe ({arch} cut to {n_layers} layers, {B} x {S}, one "
          f"microbatch, {str(T.dtype_of(cfg)).split('.')[-1]}): one LM "
          f"backward peaks {peak[True]:.3f} GiB above its start with remat, "
          f"{peak[False]:.3f} GiB without ({per_layer:.3f} GiB per layer "
          f"saved)")
    # the reduced config's gradients with and without remat, card vs card
    cfg = dc.replace(get_config(arch).reduced(), n_layers=check_layers)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(6),
                           device=device)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)).to(device)}
    a = _lm_loss_grads(cfg, params, batch, True)
    b = _lm_loss_grads(cfg, params, batch, False)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    top = max(float(y.abs().max()) for y in b)
    rel = 0.0
    for x, y in zip(a, b):
        room = max(float(y.abs().max()), 1e-3 * top)
        gap = float((x - y).abs().max())
        if gap > 1e-4 * room:
            raise AssertionError(f"remat gradients on the card: a leaf is "
                                 f"{gap:.3g} from the no-remat one (room "
                                 f"{1e-4 * room:.3g})")
        rel = max(rel, gap / room)
    print(f"remat gradients card vs card ({arch} reduced, {check_layers} "
          f"layers, 2 x 64): {'bit-equal' if same else 'not bit-equal'}; "
          f"worst leaf gap {rel:.3g} of its room (1e-4 allowed)")
    return dict(peak_remat_gib=peak[True], peak_plain_gib=peak[False],
                per_layer_gib=per_layer, bit_equal=same)


def _launch_phase(device, scale: Scale) -> dict:
    """Phase 12, the launch drivers on the card as a user calls them: (a)
    ``repro_torch.launch.train.main`` on ``scale.launch.train`` (stablelm-3b
    whole at 16 x 4,096 in its 4 microbatches): seconds per step (the
    first warm), tokens/s, peak device memory, every loss finite, and the
    launches of G forward and backward equal to the reckoned counts
    (checkpointing: each layer's forward twice per microbatch); (b) what
    checkpointing buys (``_remat_probe``); (c) ``launch.serve.main`` with
    the scalar engine (kernels D and E must launch) and the anytime engine
    (its decode loop: kernel H must launch; the engine decodes its prompts
    token by token, so G does not), and a reduced checkpointed training run
    whose ``.npz`` under ``experiments/ckpt/`` reloads through
    ``repro_torch.train.load_checkpoint`` equal leaf by leaf.  Counts are
    zeroed before each driver call and read after it."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TR
    from repro_torch.train import load_checkpoint
    from repro_torch.train.optimizer import tree_leaves

    run = scale.launch
    dev = ["--device", device.type]
    out = {}
    # (a) the training driver at full width
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    res = TR.main(list(run.train) + dev)
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    del res["params"]
    def arg(flag):
        return run.train[run.train.index(flag) + 1]

    cfg = get_config(arg("--arch"))
    if "--reduced" in run.train:
        cfg = cfg.reduced()
    steps, B, S = (int(arg(k)) for k in ("--steps", "--batch", "--seq"))
    want = _train_launches(cfg, steps * cfg.train_microbatches)
    if device.type == "cuda" and {k: n for k, n in counts.items()
                                  if n} != want:
        raise AssertionError(f"launch.train {cfg.name}: launches {counts}, "
                             f"expected {want}")
    if not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"launch.train {cfg.name}: losses "
                             f"{res['losses']}")
    secs = res["seconds"]
    print(f"launch.train ({cfg.name}, {cfg.n_layers} layers, "
          f"{res['n_params'] / 1e9:.3f} B parameters, {B} x {S} in "
          f"{cfg.train_microbatches} microbatches, {steps} steps): losses "
          f"{[round(x, 4) for x in res['losses']]}; s per step "
          f"{[round(x, 3) for x in secs]} (the first warm); "
          f"{B * S / min(secs):.1f} tokens/s at best; peak {peak:.2f} GiB; "
          f"launches per step " + json.dumps(
              {k: counts[k] // steps for k in want}) + " (reckoned "
          + json.dumps({k: n // steps for k, n in want.items()}) + ")")
    out["train"] = dict(seconds=secs, losses=res["losses"], peak_gib=peak,
                        launches={k: counts[k] for k in want})
    del res
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (b) what checkpointing buys
    out["probe"] = _remat_probe(device, run.probe, run.check_layers)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (c) the serving driver, both engines, and a checkpointed run
    for name, argv, kernels in (("scalar", run.serve_scalar,
                                 ("l1_topk2", "centroid_update")),
                                ("anytime", run.serve_anytime,
                                 ("decode_gqa",))):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = SV.main(list(argv) + dev)
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        ran = {k for k, n in counts.items() if n}
        if device.type == "cuda" and ran != set(kernels):
            raise AssertionError(f"launch.serve {name}: launches {counts}, "
                                 f"expected {kernels} and nothing else")
        counts = {k: counts[k] for k in kernels}
        print(f"launch.serve ({name}): {secs:.2f} s; launches "
              f"{json.dumps(counts)}")
        out[f"serve {name}"] = dict(seconds=secs, result=res,
                                    launches=counts)
    ckpt = ROOT / "experiments" / "ckpt" / "chip_smoke_train"
    res = TR.main(list(run.ckpt_train) + dev + ["--ckpt-path", str(ckpt)])
    like = res["params"]
    back = load_checkpoint(res["checkpoints"][-1], like)
    if not all(torch.equal(x, y) for x, y in zip(tree_leaves(back),
                                                   tree_leaves(like))):
        raise AssertionError("launch.train checkpoint: a reloaded leaf "
                             "differs")
    print(f"launch.train checkpoint {res['checkpoints'][-1]}: "
          f"{len(tree_leaves(like))} leaves reloaded equal")
    return out


def _train_plain(cfg, device, steps: int, batch: int, seq: int):
    """``launch.train``'s loop without a mesh: parameters from a generator
    on ``device`` seeded 0, ``make_lm_tokens`` seeded 0, lr 3e-4."""
    import torch

    from repro_torch.data import make_lm_tokens
    from repro_torch.models import transformer as T
    from repro_torch.train import adamw_init, make_train_step

    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=3e-4)
    tokens = make_lm_tokens(cfg.vocab, seq, batch * steps, seed=0)
    for i in range(steps):
        params, opt, _ = step(params, opt, {"tokens": torch.from_numpy(
            tokens[i * batch:(i + 1) * batch]).to(device)})
    return params


def _same_carry(a, b, what: str) -> None:
    for part in ("dev", "bank", "log"):
        _equal_leaves(getattr(a, part), getattr(b, part), f"{what} {part}")


def _mesh_phase(device, scale: Scale, replay: dict, serve: dict, models,
                sets) -> dict:
    """Phase 13, the mesh entry points on the card's meshes
    (``make_fleet_mesh()``: every visible card, one block each;
    ``make_host_mesh``: 1 x 1), each mesh run held equal, on every leaf, to
    its run without a mesh: ``sweep`` of phase 4's grid over its first
    fortieth in pallas mode (kernel A), ``run_segments`` of phase 4's
    config over those steps in 3 pallas segments with a hook that rewrites
    eta (it must see the device axis padded to the mesh size), one block
    of phase 6's objective (kernel B), phase 3's serve runs with
    adaptation on both bank modes (kernels D and E; phase 3's own runs are
    the runs without a mesh), the reduced qwen1.5-0.5b anytime engine on
    the host mesh (kernel H) and ``launch.train.main --mesh host`` on the
    reduced config (kernel G forward and backward) against the same steps
    without a mesh; then ``--mesh single-pod`` must exit 1 naming the 256
    cards needed and the cards visible.  The runs without a mesh go first;
    the counts are zeroed just before the mesh runs and read just after."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.fleet import run_segments, sweep
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_fleet_mesh, make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import AnytimeConfig, AnytimeServeEngine
    from repro_torch.train.optimizer import tree_leaves

    fleet_mesh, host = make_fleet_mesh(device=device), make_host_mesh(device)
    cfg, statics = replay["cfg"], replay["statics"]
    n = -(-statics.n_steps // 40)
    grid = dataclasses.replace(replay["grid"], horizon=n * statics.dt)
    cut = _steps(statics, n)
    seen = []

    def hook(seg, t_end, cfg, carry):
        seen.append(cfg.n_devices)
        return cfg._replace(eta=torch.full_like(cfg.eta, 0.4 + 0.2 * seg))

    problem, space = _tune_problem(device, scale)
    block = space.to_dict(space.sample(np.random.default_rng(1),
                                       scale.tune_pop))
    any_cfg = get_config("qwen1.5-0.5b").reduced()
    any_params = T.init_params(
        any_cfg, torch.Generator(device=device).manual_seed(1), device=device)
    any_sc = AnytimeConfig(policy="edf", batch_slots=2, max_steps=48,
                           prompt_len=4, max_new_tokens=4)
    any_reqs = _any_requests(any_cfg, dataclasses.replace(
        scale.anytime, requests=6, prompt=4, new=4),
        np.random.default_rng(9))
    train_cfg = get_config("qwen1.5-0.5b").reduced()
    steps, B, S = 2, 2, 32
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", str(steps),
            "--batch", str(B), "--seq", str(S), "--log-every", "1",
            "--device", device.type]
    requests = _serve_requests(scale, sets)
    seeds = list(range(scale.n_devices))

    # ---- the runs without a mesh ------------------------------------------
    t0 = time.perf_counter()
    plain = dict(sweep=sweep(grid, mode="pallas", device=device)[0],
                 segments=run_segments(cfg, cut, 3, hook=hook,
                                       mode="pallas"),
                 objective=problem.objective()(block),
                 anytime=AnytimeServeEngine(any_cfg, any_params,
                                            serve_cfg=any_sc).run(any_reqs),
                 train=_train_plain(train_cfg, device, steps, B, S))
    _sync(device)
    plain_s = time.perf_counter() - t0

    # ---- the mesh path: counts zeroed just before, read just after ------
    ops.reset_launch_counts()
    secs = {}

    def timed(name, fn):
        out, secs[name] = _timed(fn, device)
        return out

    swept, meta = timed("sweep", lambda: sweep(
        grid, mode="pallas", device=device, mesh=fleet_mesh))
    segments = timed("run_segments", lambda: run_segments(
        cfg, cut, 3, hook=hook, mode="pallas", mesh=fleet_mesh))
    objective = timed("objective", lambda: dataclasses.replace(
        problem, mesh=fleet_mesh).objective()(block))
    served = {m: timed(f"serve {m}", lambda m=m: _serve_engine(
        device, scale, models, True, m).run(
        requests, scale.n_devices, seeds=seeds, n_segments=scale.n_segments,
        mesh=fleet_mesh)) for m in ("per-device", "shared")}
    anytime = timed("anytime", lambda: AnytimeServeEngine(
        any_cfg, any_params, serve_cfg=any_sc).run(any_reqs, mesh=host))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        trained = timed("train", lambda: TR.main(argv + ["--mesh", "host"]))
    mesh_s = sum(secs.values())
    counts = ops.launch_counts()
    launches = {k: counts[k] for k in MESH_KERNELS}
    print(f"mesh path launches {json.dumps(launches)}")
    if device.type == "cuda":
        want = dict(
            fleet_priority=2 * fleet_mesh.size * n, fleet_fused_steps=1,
            **{k: sum(serve["run_launches"][f"scan adapt {m}"][k]
                      for m in served)
               for k in ("l1_topk2", "centroid_update")},
            **_train_launches(train_cfg, steps * train_cfg.train_microbatches))
        got = {k: launches[k] for k in want}
        if got != want or launches["decode_gqa"] == 0:
            raise AssertionError(f"mesh path launched {launches}, expected "
                                 f"{want} and kernel H at least once")

    # ---- outputs are right --------------------------------------------------
    _equal_leaves(plain["sweep"], swept, "sweep over the fleet mesh")
    for what, a, b in zip(("result", "carry"), plain["segments"], segments):
        _equal_leaves(a, b, f"run_segments over the fleet mesh: {what}")
    D = cfg.n_devices
    pad = -(-D // fleet_mesh.size) * fleet_mesh.size
    if seen != [D] * 3 + [pad] * 3 or len(meta) != D:
        raise AssertionError(f"the hook saw {seen} devices, not {D} without "
                             f"the mesh and {pad} with it, or the sweep "
                             f"laid out {len(meta)} devices")
    if not np.array_equal(objective, plain["objective"]):
        raise AssertionError("objective over the fleet mesh != without")
    for m, r in served.items():
        _same_carry(serve["runs"][f"scan adapt {m}"].carry, r.carry,
                    f"serve ({m}) over the fleet mesh")
    for f in ("status", "finish", "agree", "tokens", "depth_sum"):
        if not np.array_equal(getattr(anytime, f),
                              getattr(plain["anytime"], f)):
            raise AssertionError(f"anytime engine over the host mesh: {f}")
    if "mesh={'data': 1, 'model': 1}" not in text.getvalue() or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(trained["params"]),
                                              tree_leaves(plain["train"]))):
        raise AssertionError("launch.train --mesh host != the same steps "
                             "without a mesh")
    err = io.StringIO()
    code = 0
    with contextlib.redirect_stderr(err):
        try:
            TR.main(argv + ["--mesh", "single-pod"])
        except SystemExit as e:
            code = e.code
    visible = torch.cuda.device_count()
    if code != 1 or f"needs 256 CUDA cards; {visible} " not in err.getvalue():
        raise AssertionError(f"launch.train --mesh single-pod: exit {code}, "
                             f"{err.getvalue().strip()!r}")
    print(f"mesh ({fleet_mesh!r}, {host!r}): sweep of {len(meta)} devices "
          f"over {n} steps (pallas), run_segments in 3 segments with a hook "
          f"(saw {pad} devices), an objective block of {scale.tune_pop}, "
          f"serve in both bank modes, the reduced anytime engine and "
          f"launch.train --mesh host each equal to its run without a mesh "
          f"on every leaf; mesh runs {mesh_s:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"), runs without {plain_s:.2f} s (serve's are phase 3's); "
          f"--mesh single-pod exits 1: {err.getvalue().strip()}")
    return dict(launches=launches, seconds=secs)


def _to(tree, device):
    """A tree of dicts, lists and tensors with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to(v, device) for v in tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*[_to(v, device) for v in tree])
    return tree.to(device) if hasattr(tree, "to") else tree


def _one_card_mesh(device, shape, axes):
    """``shape`` over the one card named with its index (the CPU device
    listed as many times in a rehearsal)."""
    from repro_torch.launch.mesh import make_mesh

    name = (f"cuda:{device.index or 0}" if device.type == "cuda"
            else device.type)
    return make_mesh(shape, axes, name)


def _mesh_serve_phase(device, scale: Scale, models, sets) -> dict:
    """Phase 15a: phase 3's §9.2 serve run (64 devices, solar at eta
    0.71) cut to its first ``mesh_serve_steps`` steps, on
    ``make_fleet_mesh(4, device="cuda:0")``: the per-device bank without
    adaptation and the shared bank with it, each block's kernel D
    launched on its block every step and the shared bank's update summed
    over the blocks (kernel E's partial entry per block, its finish once).
    Each equals the same mesh run of the port on the CPU from the card's
    build: the run without adaptation on every leaf bit for bit (phase 3's
    standard for its one-block run), the adaptive run on every integer and
    boolean leaf, its float leaves (centroids through the CNN's
    propagation convs, margins) within 1e-4."""
    import torch

    from repro_torch.core.agile import AgileCNN
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fleet_mesh

    requests = _serve_requests(scale, sets)
    n_dev = -(-scale.n_devices // 4) * 4     # a multiple of the 4 blocks
    seeds = list(range(n_dev))
    mesh = make_fleet_mesh(4, device=(f"cuda:{device.index or 0}"
                                      if device.type == "cuda" else "cpu"))
    cpu = torch.device("cpu")
    cpu_models = [AgileCNN(m.cfg, _to(m.params, cpu),
                           [_to(uc, cpu) for uc in m.bank]) for m in models]

    _, statics, *_ = _serve_engine(device, scale, models, False,
                                   "per-device").build(
        requests, n_dev, seeds=seeds)

    def engine(adapt, bank_mode, on):
        ms = models if on == device else cpu_models
        eng = _serve_engine(on, scale, ms, adapt, bank_mode)
        eng.config = dataclasses.replace(
            eng.config, horizon=scale.mesh_serve_steps * statics.dt)
        return eng

    cases = (("per-device", False), ("shared", True))
    built = {}
    for bank_mode, adapt in cases:
        eng = engine(adapt, bank_mode, device)
        built[bank_mode] = (eng, eng.build(requests, n_dev,
                                           seeds=seeds))
        if built[bank_mode][1][1].n_steps != scale.mesh_serve_steps:
            raise AssertionError("the cut serve run has "
                                 f"{built[bank_mode][1][1].n_steps} steps")
    _sync(device)

    # ---- the main path: counts zeroed just before, read just after ------
    ops.reset_launch_counts()
    runs, secs = {}, {}
    for bank_mode, adapt in cases:
        eng, b = built[bank_mode]
        eng.build = lambda *a, b=b, **k: b
        t0 = time.perf_counter()
        runs[bank_mode] = eng.run(requests, n_dev, seeds=seeds,
                                  mesh=mesh)
        _sync(device)
        secs[bank_mode] = time.perf_counter() - t0
    counts = ops.launch_counts()
    launches = {k: counts[k] for k in MESH_SERVE_KERNELS}
    print(f"mesh serve path launches {json.dumps(launches)}")
    n = scale.mesh_serve_steps
    if device.type == "cuda":
        want_d = len(cases) * n * mesh.size
        fin = launches["centroid_finish"]
        if (launches["l1_topk2"] != want_d or fin == 0
                or launches["centroid_partial"] != mesh.size * fin
                or counts["centroid_update"] != 0):
            raise AssertionError(
                f"mesh serve path launched {launches} (centroid_update "
                f"{counts['centroid_update']}): expected kernel D "
                f"{want_d} times (once per block and step), E's partial "
                f"entry {mesh.size} times per finish and no whole E")

    # ---- outputs are right: the same mesh runs on the CPU ---------------
    t0 = time.perf_counter()
    for bank_mode, adapt in cases:
        eng = engine(adapt, bank_mode, cpu)
        b = _to(built[bank_mode][1], cpu)
        eng.build = lambda *a, b=b, **k: b
        ref = eng.run(requests, n_dev, seeds=seeds,
                      mesh=make_fleet_mesh(4, device="cpu"))
        card = runs[bank_mode]
        for part in ("dev", "bank", "log"):
            a_p, b_p = getattr(card.carry, part), getattr(ref.carry, part)
            for f, a, r in zip(a_p._fields, a_p, b_p):
                what = f"serve ({bank_mode}) over {mesh!r}: {part}.{f}"
                if adapt and a.dtype.is_floating_point:
                    _close_or_witness(a, r, what, f"card vs CPU, {n} steps")
                elif not torch.equal(a.cpu(), r):
                    raise AssertionError(f"{what} != the CPU's mesh run")
        for f, a, r in zip(card.fleet._fields, card.fleet, ref.fleet):
            if not torch.equal(a.cpu(), r):
                raise AssertionError(f"serve ({bank_mode}) over {mesh!r}: "
                                     f"fleet.{f} != the CPU's mesh run")
    cpu_s = time.perf_counter() - t0
    adapted = runs["shared"].carry.bank.counts.sum() > \
        built["shared"][1][3].bank.counts.sum()
    if not bool(adapted):
        raise AssertionError("the shared bank did not adapt over the mesh")
    print(f"mesh serve ({mesh!r}, {n_dev} devices, the first {n} "
          f"steps): per-device bank without adaptation == the CPU's mesh "
          f"run on every leaf, the shared bank with adaptation on every "
          f"integer leaf (floats within 1e-4); card "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f", CPU {cpu_s:.2f} s")
    return dict(launches=launches, seconds=secs)


def _mesh_any_phase(device, runs) -> dict:
    """Phases 15b-c: the anytime engine for each :class:`MeshAny` at its
    published widths (seeded random weights, ``n_layers`` a depth cut; a
    persistent supply) on one block, then on each of its ``(data, model)``
    meshes of the one card: the result arrays equal the one-block run's
    bit for bit, more than half of the requests complete, and the decode
    state, gathered whole, is within 1e-5 of it.  qwen1.5-0.5b splits its
    16 kv heads (kernel H on each block's heads, also held against its
    plain version at each block's shape); recurrentgemma-9b's one kv head
    splits the cache length (H's slice entries and merge, whose per-block
    shapes phase 15d checks) and its RG-LRU state and conv buffer by
    width.  Counts are zeroed before the mesh runs and read after."""
    import torch

    from repro_torch.kernels import decode_gqa as DG
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.serve import AnytimeConfig, AnytimeServeEngine

    fields = ("status", "finish", "tardiness", "agree", "tokens",
              "depth_sum")
    out, total = {}, {k: 0 for k in MESH_ANY_KERNELS}
    slice_shapes, head_shapes = [], []
    for run in runs:
        cfg = _any_config(AnyRun(run.arch, run.narrow, 0, 0, False, (),
                                 run.requests, run.slots, run.prompt,
                                 run.new, run.steps, n_layers=run.n_layers))
        params = T.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device=device)
        eng = AnytimeServeEngine(cfg, params, serve_cfg=AnytimeConfig(
            batch_slots=run.slots, max_steps=run.steps,
            prompt_len=run.prompt, max_new_tokens=run.new))
        reqs = _any_requests(cfg, AnyRun(
            run.arch, run.narrow, 0, 0, False, (), run.requests, run.slots,
            run.prompt, run.new, run.steps), np.random.default_rng(15))
        seen = {}
        plain = eng.run(reqs, hook=lambda s, c, k: seen.update(one=c.state))
        _sync(device)
        kinds = _layer_kinds(cfg)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        on_mesh = {}
        for shape in run.meshes:
            mesh = _one_card_mesh(device, shape, ("data", "model"))
            on_mesh[shape] = (eng.run(reqs, mesh=mesh, hook=lambda s, c, k,
                                      shape=shape: seen.update(
                                          {shape: SH.gather(c.state)})),
                              mesh)
        _sync(device)
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        launches = {k: counts[k] for k in MESH_ANY_KERNELS}
        for k in total:
            total[k] += launches[k]
        want = {k: 0 for k in MESH_ANY_KERNELS}
        C = run.prompt + run.new                    # the engine's cache
        for shape, (_, mesh) in on_mesh.items():
            nd, nm = shape
            kv = cfg.n_kv_heads
            per = kinds["attn"] * run.steps
            block = (run.slots // nd, cfg.n_heads, kv, cfg.resolved_head_dim,
                     C, cfg.window or 0)
            if kv % nm == 0:
                want["decode_gqa"] += per * nd * nm
                head_shapes.append((block[0], block[1] // nm, kv // nm,
                                    *block[3:5], cfg.dtype, True, block[5]))
            else:
                want["decode_gqa_stats"] += per * nd * nm
                want["decode_gqa_merge"] += per * nd
                want["decode_gqa_pv"] += per * nd * nm
                slice_shapes.append(block + (nm,))
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"{run.arch} over meshes {run.meshes} "
                                 f"launched {launches}, expected {want}")
        if 2 * plain.completed <= run.requests:
            raise AssertionError(f"{run.arch}: {plain.completed} of "
                                 f"{run.requests} requests completed in "
                                 f"{run.steps} steps")
        worst = 0.0
        for shape, (res, mesh) in on_mesh.items():
            for f in fields:
                if not np.array_equal(getattr(res, f), getattr(plain, f)):
                    raise AssertionError(f"{run.arch} over {mesh!r}: {f} != "
                                         "the one-block run's")
            for a, b in zip(_leaves(seen[shape]), _leaves(seen["one"])):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
                if a.dtype.is_floating_point:
                    worst = max(worst, _max_err(a.float(), b.float()))
        print(f"mesh anytime {run.arch}{' (reduced)' if run.narrow else ''}"
              f" ({cfg.n_layers} layers {json.dumps(_layer_kinds(cfg))}, "
              f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, {run.slots} "
              f"slots, {run.steps} steps, cache {run.prompt + run.new}) on "
              f"meshes {list(run.meshes)} of one card: result arrays == the "
              f"one-block run's ({plain.completed} completed), decode state "
              f"within {worst:.3g}; launches {json.dumps(launches)}; "
              f"{secs:.2f} s")
        out[run.arch] = dict(launches=launches, seconds=secs)
    # kernel H at each head-cut block's shape against its plain version
    g = torch.Generator(device=device).manual_seed(15)
    for shape in dict.fromkeys(head_shapes):
        B, H, KV, hd, C, dtype, round_p, window = shape
        q, k, v, sp, pos = _decode_inputs(shape, g, device)
        got = DG.decode_gqa(q, k, v, sp, pos, window=window, round_p=round_p)
        ref = DG.decode_gqa_plain(q, k, v, sp, pos, window=window,
                                  round_p=round_p)
        torch.testing.assert_close(got, ref, rtol=DECODE_TOL[0],
                                   atol=DECODE_TOL[1])
        print(f"decode_gqa at a head-cut block's shape (B={B} H={H} KV={KV} "
              f"hd={hd} C={C} {dtype}): max err {_max_err(got, ref):.3g} vs "
              "plain")
    return dict(runs=out, launches=total,
                slice_shapes=list(dict.fromkeys(slice_shapes)))


def _slice_phase(device, scale: Scale, rng, path_shapes) -> dict:
    """Phase 15d: kernel H's slice entries (stats, merge, PV) against their
    plain versions in bf16 and f32, and the merged result against the
    whole cache's H (within ``DECODE_TOL`` in f32; its gap printed in
    bf16), at each ``path_shapes`` entry ``(B, H, KV, hd, C, window, n)``
    (a block's rows and whole cache of a phase 15c run, cut ``n`` ways:
    the first row, and the kernels line's) and also cut the other of 2
    and 4 ways, then at ``mesh_decode_shape``'s long cache cut 2 and 4
    ways (timing rows); rows whose cache ends early leave the last slices
    empty.  Kernel E's partial entry against its plain version bit for bit
    at phase 3's shared-bank shape cut over 4 blocks (16 rows each), and
    its finish.  Each timed with CUDA events beside its ``work()`` bound
    (the PV and stats entries per block, the merge per call), H's entries
    also on the device alone (``_busy_ms``);
    ``index_add_`` is the library call for E's partial sums, none computes
    the others' functions."""
    import torch

    from repro_torch.kernels import centroid_update as CU
    from repro_torch.kernels import decode_gqa as DG
    from repro_torch.launch import sharding as SH

    g = torch.Generator(device=device).manual_seed(15)
    rows = {k: [] for k in SLICE_ENTRIES}
    cuts = []
    for *shape, n in path_shapes:
        cuts += [(tuple(shape), m) for m in dict.fromkeys((n, 2, 4))]
    cuts += [(tuple(scale.mesh_decode_shape), n) for n in (2, 4)]
    cuts = list(dict.fromkeys(cuts))
    for dtype, (shape, n) in itertools.product(("bfloat16", "float32"),
                                               cuts):
        B, H, KV, hd, C, window = shape
        q, k, v, sp, pos = _decode_inputs((B, H, KV, hd, C, dtype, True,
                                           window), g, device)
        whole = DG.decode_gqa(q, k, v, sp, pos, window=window, round_p=True)
        c = C // n
        ks = [k[:, i * c:(i + 1) * c].contiguous() for i in range(n)]
        vs = [v[:, i * c:(i + 1) * c].contiguous() for i in range(n)]
        sps = [sp[:, i * c:(i + 1) * c].contiguous() for i in range(n)]
        label = f"B={B} C={C} {dtype}, {n} slices of {c}"
        stats = [DG.decode_gqa_stats(q, a, s, pos, window=window)
                 for a, s in zip(ks, sps)]
        plain = [DG.decode_gqa_stats_plain(q, a, s, pos, window=window)
                 for a, s in zip(ks, sps)]
        err = 0.0
        for (m1, l1, s1), (m2, l2, s2) in zip(stats, plain):
            if not (torch.equal(s1, s2) and torch.equal(m1, m2)):
                raise AssertionError(f"decode_gqa_stats ({label}): the "
                                     "kept scores or the maxima differ "
                                     "from plain")
            torch.testing.assert_close(l1, l2, rtol=1e-12, atol=0)
            err = max(err, _max_err(l1, l2))
        pm = torch.stack([s[0] for s in stats])
        ps = torch.stack([s[1] for s in stats])
        m, l = DG.decode_gqa_merge(pm, ps)
        m2, l2 = DG.decode_gqa_merge_plain(pm, ps)
        if not (torch.equal(m, m2) and torch.equal(l, l2)):
            raise AssertionError(f"decode_gqa_merge ({label}) != plain")
        pvs = [DG.decode_gqa_pv(x[2], b, m, l) for x, b in zip(stats, vs)]
        pv_err = 0.0
        for o1, x, b in zip(pvs, stats, vs):
            o2 = DG.decode_gqa_pv_plain(x[2], b, m, l)
            torch.testing.assert_close(o1, o2, rtol=DECODE_TOL[0],
                                       atol=DECODE_TOL[1])
            pv_err = max(pv_err, _max_err(o1, o2))
        # the blocks' PV sums in block order against the whole cache's
        # H: f32 weights move by an ulp of l at most; bf16 weights can
        # round the other way where l moves, so that gap is printed
        gap = _max_err(SH.block_sum(pvs), whole)
        if dtype == "float32":
            torch.testing.assert_close(SH.block_sum(pvs), whole,
                                       rtol=DECODE_TOL[0],
                                       atol=DECODE_TOL[1])
        print(f"decode_gqa slices ({label}): merged vs the whole "
              f"cache's kernel H, max gap {gap:.3g}")
        s_work = DG.slice_work(B, H, KV, hd, c, q.dtype, pv=False)
        p_work = DG.slice_work(B, H, KV, hd, c, q.dtype, pv=True)
        for name, fn, pfn, work, e in (
                ("decode_gqa_stats",
                 lambda: DG.decode_gqa_stats(q, ks[0], sps[0], pos,
                                             window=window),
                 lambda: DG.decode_gqa_stats_plain(q, ks[0], sps[0], pos,
                                                   window=window),
                 s_work, err),
                ("decode_gqa_merge", lambda: DG.decode_gqa_merge(pm, ps),
                 lambda: DG.decode_gqa_merge_plain(pm, ps),
                 DG.merge_work(n, B * H), 0.0),
                ("decode_gqa_pv",
                 lambda: DG.decode_gqa_pv(stats[0][2], vs[0], m, l),
                 lambda: DG.decode_gqa_pv_plain(stats[0][2], vs[0], m, l),
                 p_work, pv_err)):
            ms = _ms(fn, device)
            dev_ms = _busy_ms(fn, device)
            plain_ms = _ms(pfn, device, reps=3, warmup=1)
            bound_ms, by = _bound(work)
            rows[name].append(dict(
                shape=label, max_abs_err=e, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None))
            print(f"{name} (H={H} KV={KV} hd={hd} window {window}, "
                  f"{label}): max err {e:.3g} vs plain; "
                  f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({by})")

    # E's partial entry per block of phase 3's shared-bank update, then
    # the finish of the blocks' sums
    k_, d_, B_ = scale.cu_shape
    per = max(B_ // 4, 1)
    B_ = 4 * per
    cents = torch.from_numpy(rng.normal(size=(k_, d_)).astype(
        np.float32)).to(device)
    x = torch.from_numpy(rng.normal(size=(B_, d_)).astype(
        np.float32)).to(device)
    a = torch.from_numpy(np.where(rng.random(B_) < 0.5,
                                  rng.integers(0, k_, B_), -1).astype(
        np.int32)).to(device)
    parts = []
    for i in range(4):
        xb, ab = x[i * per:(i + 1) * per], a[i * per:(i + 1) * per]
        got = CU.centroid_partial(xb, ab, k_)
        ref = CU.centroid_partial_plain(xb, ab, k_)
        if not all(torch.equal(u, w) for u, w in zip(got, ref)):
            raise AssertionError("centroid_partial kernel != plain version")
        parts.append(got)
    sums = parts[0][0] + parts[1][0] + parts[2][0] + parts[3][0]
    cnt = parts[0][1] + parts[1][1] + parts[2][1] + parts[3][1]
    fin = CU.centroid_finish(cents, sums, cnt, 32.0)
    if not torch.equal(fin, CU.centroid_finish_plain(cents, sums, cnt,
                                                     32.0)):
        raise AssertionError("centroid_finish kernel != plain version")
    xb, ab = x[:per].contiguous(), a[:per].contiguous()
    valid = ab >= 0
    xv, av = xb[valid], ab[valid].to(torch.int64)
    for name, fn, pfn, work, lib in (
            ("centroid_partial", lambda: CU.centroid_partial(xb, ab, k_),
             lambda: CU.centroid_partial_plain(xb, ab, k_),
             CU.partial_work(k_, d_, per, int(valid.sum())),
             lambda: torch.zeros((k_, d_), device=device).index_add_(
                 0, av, xv)),
            ("centroid_finish",
             lambda: CU.centroid_finish(cents, sums, cnt, 32.0),
             lambda: CU.centroid_finish_plain(cents, sums, cnt, 32.0),
             CU.finish_work(k_, d_), None)):
        ms = _ms(fn, device)
        plain_ms = _ms(pfn, device, reps=3, warmup=1)
        lib_ms = _ms(lib, device) if lib is not None else None
        bound_ms, by = _bound(work)
        rows[name].append(dict(
            shape=f"k={k_} d={d_}" + (f" B={per}" if lib else ""),
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=by, library_ms=lib_ms))
        print(f"{name} (k={k_}, d={d_}" + (f", {per} rows of a block"
                                            if lib else "")
              + f"): bit-equal to plain; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms"
              + (f", index_add_ {lib_ms:.4f} ms" if lib else "")
              + f", bound {bound_ms:.6f} ms ({by})")
    out = {}
    for name, rs in rows.items():
        row = dict(rs[0])
        row["max_abs_err"] = max(r["max_abs_err"] for r in rs)
        row["shapes"] = rs[1:]
        out[name] = row
    return out


def _mesh_blocks_phase(device, scale: Scale, models, sets, rng) -> dict:
    """Phase 15: the serve engines over meshes of one card listed several
    times (15a the fleet scan, 15b-c the anytime engine) and the new
    entries of kernels E and H against their plain versions (15d)."""
    serve = _mesh_serve_phase(device, scale, models, sets)
    anytime = _mesh_any_phase(device, scale.mesh_anytime)
    rows = _slice_phase(device, scale, rng, anytime["slice_shapes"])
    return dict(serve=serve, anytime=anytime, rows=rows)


def _cost_line(label: str, meas, launches: dict) -> str:
    """One profiled call as a line: times, modelled work, bound, measured
    over bound, the counter's kernel items and the launches."""
    r = meas.roofline
    return (f"{label}: first call {meas.compile_s:.3f} s; steady "
            f"{meas.steady_s * 1e3:.3f} ms (min {meas.steady_min_s * 1e3:.3f}"
            f", max {meas.steady_max_s * 1e3:.3f}, {meas.repeats} calls); "
            f"flops {r['flops']:.6g} (products "
            f"{json.dumps(r['dot_flops_by_dtype'])}), "
            f"bytes {r['bytes']:.6g}; bound {r['bound_s'] * 1e3:.6g} ms "
            f"({r['dominant']}); measured / bound "
            f"{r['measured_over_bound']:.2f}; kernel items "
            f"{json.dumps(r['kernels'])}, launches {json.dumps(launches)}")


def _same_count(card, meta, what: str) -> None:
    """The card's op count equals the one lowered on ``meta``: flops,
    products, bytes and the items of every kernel."""
    fields = ("flops", "dot_flops", "bytes", "kernels")
    got = {f: getattr(card, f) for f in fields}
    want = {f: getattr(meta, f) for f in fields}
    if got != want:
        diff = sorted({(k, tuple(v)) for k, v in card.items.items()}
                      ^ {(k, tuple(v)) for k, v in meta.items.items()})
        raise AssertionError(f"{what}: the card's count {got} != meta's "
                             f"{want}; items apart: {diff[:12]}")


def _roofline_phase(device, scale: Scale, replay: dict) -> dict:
    """Phase 14, profiling and the H100 roofline (``repro_torch.launch
    .profiling``, ``op_cost``, ``op_stats``, ``lowering``, ``dryrun``) on
    qwen1.5-0.5b whole (phase 11b's config, bf16): ``profile_call`` of
    ``prefill`` on one prompt of phase 8's length (10 timed calls) and of
    the train step on phase 11b's batch and microbatches (3 timed calls),
    each with its first call, steady times, the counted call's flops by
    type, bytes, bound, dominant term and measured over bound; the
    counter's G (and G backward) items equal the launches of the counted
    call (24 per prefill; the train step's as ``_train_launches`` reckons
    them, two backward launches an item), and ``lower_step`` on ``meta``
    for the same ``InputShape`` equals the card's count on flops,
    products, bytes and the items of each kernel; the train step's
    costliest items (``top_cost_items``); ``profile_call`` of phase 4's
    fused sweep (kernel B, one launch); ``trace()`` around one prefill
    writes a Chrome trace that names G's CUDA function; and
    ``dryrun.main`` for qwen1.5-0.5b x train_4k on the single-pod layout.
    The counted calls' launches are read apart from the main paths'."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.configs import InputShape
    from repro_torch.data import make_lm_tokens
    from repro_torch.fleet import simulate_fleet
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import profiling as PR
    from repro_torch.launch.lowering import lower_step
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.op_cost import top_cost_items
    from repro_torch.models import transformer as T
    from repro_torch.train import adamw_init
    from repro_torch.train.trainer import make_train_step

    card = device.type == "cuda"
    run = scale.train_lm[0]
    cfg = dataclasses.replace(_lm_config(run),
                              train_microbatches=run.microbatches)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    one = make_abstract_mesh((1, 1), ("data", "model"))
    S = scale.anytime.prefill_len
    g = torch.Generator(device=device).manual_seed(14)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (1, S), generator=g,
                                      device=device, dtype=torch.int32)}
    tokens = make_lm_tokens(cfg.vocab, run.seq, run.batch, seed=0)
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    opt = adamw_init(params)

    @torch.no_grad()
    def prefill(params, batch):
        return T.prefill(cfg, params, batch)

    def joined(label, fn, args, repeats, warmup, **kw):
        meas = PR.measure(fn, *args, label=label, repeats=repeats,
                          warmup=warmup, **kw)
        ops.reset_launch_counts()
        PR.roofline_join(meas)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        print(_cost_line(label, meas, counts))
        return meas, counts

    # the CPU rehearsal times one call of each (its plain versions are slow)
    reps = (lambda n, w: (n, w)) if card else (lambda n, w: (1, 0))
    out = {}
    pre, pre_l = joined(f"profile_call prefill ({cfg.name}, 1 x {S})",
                        prefill, (params, prompt), *reps(10, 2))
    step = make_train_step(cfg)
    trn, trn_l = joined(f"profile_call train step ({cfg.name}, {run.batch} x "
                        f"{run.seq}, {run.microbatches} microbatches)",
                        step, (params, opt, batch), *reps(3, 1))
    low_pre = lower_step(cfg, InputShape("prefill", S, 1, "prefill"), one)
    low_trn = lower_step(cfg, InputShape("train", run.seq, run.batch,
                                         "train"), one)
    want = _train_launches(cfg, run.microbatches)
    if card:
        if pre.cost.kernels != {"flash_attention": cfg.n_layers} or \
                pre_l != {"flash_attention": cfg.n_layers}:
            raise AssertionError(f"prefill: G items {pre.cost.kernels}, "
                                 f"launches {pre_l}, not {cfg.n_layers}")
        items = dict(trn.cost.kernels)
        items["flash_attention_bwd"] *= 2      # two launches a call
        if items != trn_l or trn_l != want:
            raise AssertionError(f"train step: G items {trn.cost.kernels} "
                                 f"(backward x 2), launches {trn_l}, "
                                 f"reckoned {want}")
        _same_count(pre.cost, low_pre.cost, "prefill")
        _same_count(trn.cost, low_trn.cost, "train step")
        print("the counter's G and G-backward items == the counted calls' "
              f"launches {json.dumps(trn_l)} (train), {json.dumps(pre_l)} "
              "(prefill); lower_step on meta == the card's count on flops, "
              "products, bytes and kernel items, prefill and train step")
    total_b, total_f = trn.cost.bytes, trn.cost.flops
    top = top_cost_items(trn.cost, n=10, by="bytes")
    print("train step, costliest items by bytes: " + "; ".join(
        f"{r['op']} {r['type']} x{r['mult']}: "
        f"{100 * r['bytes'] / total_b:.1f} % of bytes, "
        f"{100 * r['flops'] / total_f:.1f} % of flops" for r in top))
    by_op = {}
    for (op, _), (_, f, b) in trn.cost.items.items():
        bf, bb = by_op.get(op, (0.0, 0.0))
        by_op[op] = (bf + f, bb + b)
    print("train step, bytes by op: " + "; ".join(
        f"{op} {100 * b / total_b:.1f} %" for op, (f, b) in sorted(
            by_op.items(), key=lambda kv: -kv[1][1])[:12]))
    del opt, batch

    # kernel B: the fused replay sweep of phase 4 (one launch per call)
    fused, fused_l = joined(
        f"profile_call simulate_fleet fused ({replay['cfg'].n_devices} "
        f"devices, {replay['statics'].n_steps} steps)", simulate_fleet,
        (replay["cfg"], replay["statics"]), *reps(10, 2), mode="fused")
    if fused.cost.kernels != {"fleet_fused_steps": 1} or (
            card and fused_l != {"fleet_fused_steps": 1}):
        raise AssertionError(f"fused sweep: items {fused.cost.kernels}, "
                             f"launches {fused_l}")

    # a Chrome trace of one prefill that names G's CUDA function
    with tempfile.TemporaryDirectory() as tmp:
        with PR.trace(tmp) as path:
            prefill(params, prompt)
            _sync(device)
        if path is None or not Path(path).exists():
            raise AssertionError("trace(): no Chrome trace written")
        text = Path(path).read_text()
        size = len(text)
    named = "flash_tc_kernel" in text
    if card and not named:
        raise AssertionError("the prefill's trace names no flash_tc_kernel")
    print(f"trace() of one prefill: {size} bytes of Chrome trace, G's "
          f"flash_tc_kernel named: {named}")
    del params, prompt, text

    quiet = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        rec = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k"])
    if rec["status"] != "ok" or rec["n_devices"] != 256:
        raise AssertionError(f"dry run: {rec['status']}, "
                             f"{rec.get('n_devices')} devices")
    r = rec["roofline"]
    print(f"dryrun qwen1.5-0.5b x train_4k (single pod, {rec['n_devices']} "
          f"devices, meta): {time.perf_counter() - t0:.1f} s; per device "
          f"{rec['op_flops_per_device']:.6g} flops, "
          f"{rec['op_bytes_per_device']:.6g} bytes, bound "
          f"{r['bound_s'] * 1e3:.3f} ms ({r['dominant']}), useful flops "
          f"{rec['useful_flops_ratio']:.3f}, kernels "
          f"{json.dumps(rec['kernels'])}, memory "
          f"{json.dumps(rec['memory'])}")
    if card:
        torch.cuda.empty_cache()
    for key, meas in (("prefill", pre), ("train", trn), ("fused", fused)):
        out[key] = dict(meas.roofline, steady_s=meas.steady_s,
                        compile_s=meas.compile_s)
    out["top_items"] = top
    return out


def _unnest(row: dict) -> list:
    """A kernel check's rows as one flat list: its first row, then the
    rest (``shapes``)."""
    return [{k: v for k, v in row.items() if k != "shapes"}] + row["shapes"]


def _phase(name: str, fn, *args):
    """``fn(*args)``, its seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def run(device_name: str = "cuda", scale: Scale = FULL) -> dict:
    """All phases on ``device_name``; returns the kernels report."""
    import torch

    device = torch.device(device_name)
    rng = np.random.default_rng(0)
    if device.type == "cuda":
        # f32 products in full f32 on the card (no TF32), as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _phase("1 (build)", _build_phase)
    d_row = _phase("2 (l1_topk2)", _l1_phase, device, scale, rng)
    e_row = _phase("2 (centroid_update)", _cu_phase, device, scale, rng)
    models, sets = _phase("3 (models)", _models, device, scale)
    serve = _phase("3 (serve)", _serve_phase, device, scale, models, sets)
    scalar = _phase("3a (scalar)", _scalar_phase, device, scale, models, sets,
                    serve["runs"]["scan adapt per-device"].jobs_per_sec)
    _phase("3b (parity)", _parity_phase, device, scale, models, sets)
    _phase("3c (intermittent)", _intermittent_phase, device, scale, models,
           sets)
    stream = _phase("3d (stream)", _stream_phase, device, scale, models, sets,
                    serve["runs"])
    replay = _phase("4 (replay)", _replay_phase, device, scale, models, sets)
    telemetry = _phase("4a (telemetry)", _telemetry_phase, device, scale,
                       replay, serve, models, sets)
    f_row = _phase("5 (pairwise_l1)", _pw_phase, device, scale, rng)
    tune = _phase("6 (tuning)", _tune_phase, device, scale)
    online = _phase("7 (online)", _online_phase, device, scale)
    anytime = _phase("8 (anytime, dense)", _anytime_phase, device, scale,
                     scale.anytime)
    g_row = _phase("8 (flash_attention)", _flash_phase, device,
                   scale.flash_shapes)
    _phase("8 (card vs CPU)", _any_cpu_check, device, scale.anytime, 128)
    hybrid = _phase("9 (anytime, hybrid)", _anytime_phase, device, scale,
                    scale.hybrid)
    h_row = _phase("9 (decode_gqa)", _decode_phase, device,
                   scale.decode_shapes)
    i_row = _phase("9 (rglru_scan)", _rglru_phase, device, scale)
    _phase("9 (card vs CPU)", _any_cpu_check, device, scale.hybrid, 128)
    zoo = _phase("10 (the model zoo)", _zoo_phase, device, scale)
    train = _train_phase(device, scale)
    launch = _phase("12 (launch drivers)", _launch_phase, device, scale)
    mesh = _phase("13 (mesh)", _mesh_phase, device, scale, replay, serve,
                  models, sets)
    _phase("14 (profiling and roofline)", _roofline_phase, device, scale,
           replay)
    blocks = _phase("15 (serve engines over meshes of one card)",
                    _mesh_blocks_phase, device, scale, models, sets, rng)
    # each path's launches were counted from zero; a kernel on several
    # paths reports their sum and the count of each
    paths = dict(serve=serve["launches"], scalar=scalar["launches"],
                 stream=stream["launches"], replay=replay["launches"],
                 telemetry=telemetry["launches"],
                 tune=tune["launches"], online=online["launches"],
                 anytime=anytime["launches"], hybrid=hybrid["launches"],
                 **{arch: r["launches"] for arch, r in zoo["runs"].items()},
                 train_cnn=train["cnn"]["launches"],
                 **{f"train {run.arch}": train[run.arch]["launches"]
                    for run in scale.train_lm},
                 **{f"launch {k}": v["launches"] for k, v in launch.items()
                    if "launches" in v},
                 mesh=mesh["launches"],
                 **{"mesh serve": blocks["serve"]["launches"],
                    "mesh anytime": blocks["anytime"]["launches"]})
    g_row, h_row = (dict(row, shapes=row["shapes"] + _unnest(z),
                         max_abs_err=max(row["max_abs_err"],
                                         z["max_abs_err"]))
                    for row, z in ((g_row, zoo["g_row"]),
                                   (h_row, zoo["h_row"])))
    rows = []
    for name, row in (("fleet_priority", replay["a_row"]),
                      ("fleet_fused_steps", replay["b_row"]),
                      ("serve_fused_steps",
                       dict(serve["c_row"], stream=stream["row"])),
                      ("l1_topk2", dict(
                          d_row, shapes=[scalar["d_one_row"]],
                          max_abs_err=max(d_row["max_abs_err"],
                                          scalar["d_one_row"]["max_abs_err"]))),
                      ("centroid_update", dict(
                          e_row, shapes=e_row["shapes"]
                          + [scalar["e_one_row"]],
                          max_abs_err=max(e_row["max_abs_err"],
                                          scalar["e_one_row"]["max_abs_err"]))),
                      ("pairwise_l1", f_row), ("flash_attention", g_row),
                      ("decode_gqa", h_row), ("rglru_scan", i_row),
                      ("flash_attention_bwd", train["g_bwd"]),
                      ("rglru_scan_bwd", train["i_bwd"])):
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        rows.append(dict(name=name, route="cuda", source=SOURCES[name],
                         replaces=REPLACES[name],
                         launches=sum(by_path.values()),
                         launches_by_path=by_path, **row))
    for name, parent in SLICE_ENTRIES.items():
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        rows.append(dict(name=name, route="cuda", source=SOURCES[parent],
                         replaces=REPLACES[parent],
                         launches=sum(by_path.values()),
                         launches_by_path=by_path, **blocks["rows"][name]))
    return {"kernels": rows}


def _rehearse(device: str = "cpu") -> dict:
    """Every phase at narrow widths with the plain versions (no card)."""
    return run(device, _narrow())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e})",
              file=sys.stderr)
        return 2
    card = _card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    report = run("cuda", FULL)
    print(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
