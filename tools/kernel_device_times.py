"""Device time per launch of kernels A-I, from the profiler.

    PYTHONPATH=src python tools/kernel_device_times.py [--only E,F,I]
    PYTHONPATH=src python tools/kernel_device_times.py --only Gbwd,Ibwd
    PYTHONPATH=src python tools/kernel_device_times.py --only Hslice

CUDA-event times of a wrapper call (``chip_smoke.py``) include the host
work between launches: at small sizes the card waits on the wrapper.
This script runs each kernel at the shapes ``chip_smoke.py`` checks, under
``torch.profiler``, and prints per shape the device time of every CUDA
kernel the calls launched (per call, with the launches the profiler saw),
their sum, and the host-clock time per call:

* A ``fleet_priority``: the replay sweep's 1,600 devices at the state the
  fused run reaches mid-horizon (``chip_smoke.py``'s operands), with the
  CUDA-event time of a wrapper call and, on the host clock, each step of
  the wrapper (the operand check, the outputs, the argument pack, the
  stream, the ctypes launch) beside the alternatives it was measured
  against;
* B ``fleet_fused_steps``: the replay sweep's 1,600 devices (the two §9.2
  models' job profiles, as ``chip_smoke.py`` builds them) over one
  1,159-step segment, with the time per step of the fleet;
* C ``serve_fused_steps``: the §9.2 serve run's whole horizon (545 steps)
  on 64 and 1,024 devices, with the time per step and the units
  completed;
* D ``l1_topk2``: x (64, 150) against per-row centroids (64, 5, 150) and
  x (250, 150) against one shared set (5, 150);
* E ``centroid_update``: the shared-bank adaptation's shape (k = 5, d =
  8,192, B = 64, about a quarter of the rows assigned) and k = 8, d =
  8,192, B = 1,024 with every row assigned (x 32 MB), each with its bound;
* F ``pairwise_l1`` at ``chip_smoke.py``'s first and last ``pw_shapes``
  (the forecaster's 256 x 256 x 6 and 4,096 x 4,096 x 512), and the
  large shape again from views that start off 16 bytes (the kernel's
  4-byte copies), each with its CUDA-event time, its bound
  (``PW.work``: 3 f32 operations per term at 67 TFLOP/s, or the bytes)
  and its FADD issue floor: 2 FADDs per term over 132 SMs x 128 FP32
  lanes at the SM clock ``nvidia-smi`` reads while the large shape runs;
* G ``flash_attention`` in bf16 at its seven shapes, H ``decode_gqa`` at
  its six;
* I ``rglru_scan`` at the hybrid's prefill (1, 4,096, 4,096) and
  ``anytime_forward``'s (2, 512, 4,096), each with its bound;
* T: one tuning objective call (``chip_smoke.py``'s tuning problem, one
  population block of 16 candidates), with B's share of its host-clock
  time;
* Gbwd: G's backward (``flash_attention_bwd``) in bf16 at phase 11d's
  shapes (``chip_smoke.FULL.flash_bwd_shapes``), each kernel of a call,
  their sum, the backward of ``scaled_dot_product_attention`` by autograd
  on the same inputs (the yardstick) and the bound (``FA.bwd_work``: 10
  hd flops per visible pair at the bf16 peak, or the bytes);
* Ibwd: I's backward (``rglru_scan_bwd``) at phase 11d's shapes
  (``chip_smoke.FULL.rglru_bwd_shapes``), with its bound (bytes);
* Hslice: H's slice entries (stats, merge, PV) at ``chip_smoke.py``
  phase 15d's cuts, each with its CUDA-event ms, its device ms and its
  bound.

E, F, I, Gbwd, Ibwd and Hslice touch only the wrappers' public calls,
``_launch``, each kernel's ``work()`` (for the bound) and ``chip_smoke``'s
helpers, so the script also times another checkout's kernels when copied
into it (one that has ``work()``: this tree and later; ``slice_work``
for Hslice): ``PYTHONPATH`` names the tree,
one process per tree, e.g. parent, change, change, parent.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import centroid_update as CU  # noqa: E402
from repro_torch.kernels import decode_gqa as DG  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import fleet_step as FS  # noqa: E402
from repro_torch.kernels import l1_topk2 as L1  # noqa: E402
from repro_torch.kernels import pairwise_l1 as PW  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402

CALLS = 20


def profile(label: str, fn, calls: int = CALLS) -> float:
    """Print the device time per call of every kernel ``fn`` launches;
    return their sum (ms)."""
    kernels, host = chip_smoke._device_ms(fn, torch.device("cuda"), calls)
    total = sum(t for t, _ in kernels.values()) / calls
    parts = "; ".join(f"{k[:60]} {t / calls:.4f} (x{n})" for k, (t, n) in
                      sorted(kernels.items(), key=lambda kv: -kv[1][0]))
    print(f"{label}: device {total:.4f} ms per call over {calls} calls, host "
          f"clock {host:.4f} ms per call [{parts}]")
    return total


def host_us(fn, calls: int = 2000) -> float:
    """Host-clock microseconds per call of ``fn`` (work it enqueues on the
    card is not waited for), after a warm-up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def kernel_a(dev) -> None:
    from repro_torch.fleet import build
    from repro_torch.kernels import _build
    from repro_torch.kernels import fleet_priority as FP

    scale = chip_smoke.FULL
    models, sets = chip_smoke._models(dev, scale)
    tasks = chip_smoke._replay_tasks(models, sets, scale)
    cfg, statics, meta = build(chip_smoke._replay_grid(tasks, scale,
                                                       scale.seeds), dev)
    args, kw = chip_smoke._priority_inputs(dev, cfg, statics)
    D, Q = args[1].shape
    ms = chip_smoke._ms(lambda: FP.fleet_priority(*args, **kw), dev,
                        reps=200)
    print(f"A (D={D}, Q={Q}): {ms:.5f} ms per call (CUDA events, 200 calls "
          f"back to back)")
    profile(f"A (D={D}, Q={Q})", lambda: FP.fleet_priority(*args, **kw),
            calls=200)
    # the wrapper's steps on the host clock, each beside what it replaced
    (policy, active, laxity, release, utility, mandatory, alpha, beta, eta,
     persistent, energy, e_opt, power, capacity, gate_e, drain, forced, task,
     rr_cursor) = args
    ins = (policy, alpha, beta, eta, persistent, energy, e_opt, power,
           capacity, forced, rr_cursor, active, laxity, release, utility,
           mandatory, gate_e, drain, task)
    outs = FP._outputs(D, dev)
    ptrs = [t.data_ptr() for t in ins + outs]
    packed = FP._PACK.pack(*ptrs, D, Q, kw["n_tasks"], kw["dt"])
    fn = FP._kernel()
    names = [f for f, _ in FP._PriorityArgs._fields_]

    def per_field_checks():     # the previous wrapper's checks
        dev0 = ins[0].device
        for f, t in zip(FP._IN_VEC + FP._IN_ROW, ins):
            want = FP._DTYPES.get(f, torch.float32)
            shape = (D,) if f in FP._IN_VEC else (D, Q)
            if t.dtype != want or tuple(t.shape) != shape or t.device != dev0:
                raise ValueError(f)
            t.contiguous()

    def four_empty():
        return (torch.empty(D, dtype=torch.int32, device=dev),
                torch.empty(D, dtype=torch.bool, device=dev),
                torch.empty(D, dtype=torch.bool, device=dev),
                torch.empty(D, dtype=torch.float32, device=dev))

    def set_fields():
        a = FP._PriorityArgs()
        for f, v in zip(names, ptrs + [D, Q, kw["n_tasks"], kw["dt"]]):
            setattr(a, f, v)
        return a

    stream = _build.stream_handle(dev)
    # (step, what the wrapper does, what it replaced or was measured
    # against); each pair is timed kept, other, other, kept
    steps = (
        ("whole call", lambda: FP.fleet_priority(*args, **kw), None),
        ("operand check", lambda: FP._checked(ins),
         ("field by field", per_field_checks)),
        ("outputs (views of one buffer)", lambda: FP._outputs(D, dev),
         ("four torch.empty", four_empty)),
        ("pointers (data_ptr x 23)",
         lambda: [t.data_ptr() for t in ins + outs], None),
        ("arguments (struct.pack)", lambda: FP._PACK.pack(
            *ptrs, D, Q, kw["n_tasks"], kw["dt"]),
         ("ctypes fields set one by one", set_fields)),
        ("arguments (struct.pack)", lambda: FP._PACK.pack(
            *ptrs, D, Q, kw["n_tasks"], kw["dt"]),
         ("ctypes constructor", lambda: FP._PriorityArgs(
             *ptrs, D, Q, kw["n_tasks"], kw["dt"]))),
        ("stream (the raw query)", lambda: _build.stream_handle(dev),
         ("torch.cuda.current_stream", lambda: ctypes.c_void_p(
             torch.cuda.current_stream(dev).cuda_stream))),
        ("ctypes call of a no-op C function",
         lambda: _build.load("fleet_priority").priority_args_size(), None),
        ("ctypes launch", lambda: fn(packed, FP._THREADS, stream), None),
    )
    for label, kept, other in steps:
        if other is None:
            t = [host_us(kept) for _ in range(2)]
            print(f"  A host step, {label}: {sum(t) / 2:.3f} us per call "
                  f"({t[0]:.3f}, {t[1]:.3f})")
            continue
        name, alt = other
        a0, b0, b1, a1 = (host_us(kept), host_us(alt), host_us(alt),
                          host_us(kept))
        print(f"  A host step, {label}: {(a0 + a1) / 2:.3f} us per call "
              f"({a0:.3f}, {a1:.3f}); {name}: {(b0 + b1) / 2:.3f} "
              f"({b0:.3f}, {b1:.3f})")


def kernel_b(dev) -> None:
    scale = chip_smoke.FULL
    models, sets = chip_smoke._models(dev, scale)
    tasks = chip_smoke._replay_tasks(models, sets, scale)
    from repro_torch.fleet import build, init_fleet

    cfg, statics, meta = build(chip_smoke._replay_grid(tasks, scale,
                                                       scale.seeds), dev)
    c0 = init_fleet(cfg, statics)
    n = statics.n_steps // 4
    K, U = cfg.period.shape[-1], cfg.unit_time.shape[-1]
    ms = profile(f"B (D={len(meta)}, {n} steps, Q={statics.queue_size}, "
                 f"K={K}, U={U})",
                 lambda: FS.fleet_fused_steps(cfg, c0, 0, statics=statics,
                                              n_steps=n), calls=5)
    print(f"  B: {1e3 * ms / n:.4f} us per step of the fleet")


def kernel_c(dev) -> None:
    scale = chip_smoke.FULL
    models, sets = chip_smoke._models(dev, scale)
    requests = chip_smoke._serve_requests(scale, sets)
    for n_dev in (scale.n_devices, scale.big_devices):
        r = chip_smoke._serve_kernel_times(dev, scale, models, requests,
                                           n_dev)
        print(f"C (D={n_dev}, {r['steps']} steps, {r['units']} units): "
              f"{r['ms']:.4f} ms per launch (CUDA events), device "
              f"{r['device_ms']:.4f} ms ({r['us_per_step']:.4f} us per step)")


def kernel_d(dev) -> None:
    rng = np.random.default_rng(0)
    shapes = ((64, 150, 5, True), (250, 150, 5, False))
    for B, d, k, per_row in shapes:
        x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(
            dev)
        c = torch.from_numpy(rng.normal(size=(B, k, d) if per_row
                                        else (k, d)).astype(np.float32)).to(
            dev)
        profile(f"D x ({B}, {d}), c {tuple(c.shape)}",
                lambda: L1.l1_topk2(x, c))


def _stream(dev):
    from repro_torch.kernels import _build

    return _build.stream_handle(dev)


def kernel_e(dev) -> None:
    rng = np.random.default_rng(0)
    for k, d, B, share in ((5, 8192, 64, 0.25), (8, 8192, 1024, 1.0)):
        c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(
            dev)
        x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(
            dev)
        a = np.where(rng.random(B) < share, rng.integers(0, k, B), -1)
        a = torch.from_numpy(a.astype(np.int32)).to(dev)
        n = int((a >= 0).sum())
        ms = chip_smoke._ms(lambda: CU.centroid_update(c, x, a, 32.0), dev,
                            reps=200)
        label = f"E (k={k}, d={d}, B={B}, {n} rows assigned)"
        dev_ms = profile(label, lambda: CU.centroid_update(c, x, a, 32.0),
                         calls=100)
        bound = chip_smoke._bound(CU.work(k, d, B, n))[0]
        print(f"  {label}: {ms:.5f} ms per call (CUDA events, 200 calls), "
              f"device {dev_ms:.5f}, bound {bound:.6f} ms (bytes)")
        if hasattr(CU, "_kernel"):   # the wrapper's host work
            out = torch.empty_like(c)
            stream = _stream(dev)
            launch = lambda: CU._kernel()(  # noqa: E731
                c.data_ptr(), x.data_ptr(), a.data_ptr(), B, k, d, 32.0,
                out.data_ptr(), stream)
            print(f"  {label} host us per call: whole call "
                  f"{host_us(lambda: CU.centroid_update(c, x, a, 32.0)):.2f}"
                  f", the ctypes launch alone {host_us(launch):.2f}")


def _sm_clock_mhz(fn, calls: int) -> float:
    """The SM clock (MHz) ``nvidia-smi`` reads while ``calls`` calls of
    ``fn`` run on the card (enqueued first, read before they end)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(calls):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return float(out.stdout.split()[0])


def _offset_copy(a: torch.Tensor) -> torch.Tensor:
    """``a`` as a contiguous view that starts 4 bytes past 16."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


def kernel_f(dev) -> None:
    rng = np.random.default_rng(0)
    shapes = (chip_smoke.FULL.pw_shapes[0], chip_smoke.FULL.pw_shapes[-1])
    inputs = [tuple(torch.from_numpy(rng.normal(size=(n, d)).astype(
        np.float32)).to(dev) for n in (B1, B2)) for B1, B2, d in shapes]
    xl, yl = inputs[-1]
    mhz = _sm_clock_mhz(lambda: PW.pairwise_l1(xl, yl), 40)
    print(f"F: SM clock {mhz:.0f} MHz under load ({shapes[-1]})")
    runs = list(zip(shapes, inputs))
    if hasattr(PW, "copy_path"):   # the large shape on the 4-byte copies
        runs.append((shapes[-1], (_offset_copy(xl), _offset_copy(yl))))
    for (B1, B2, d), (x, y) in runs:
        reps = 20 if B1 * B2 * d > 1 << 26 else 200
        ms = chip_smoke._ms(lambda: PW.pairwise_l1(x, y), dev, reps=reps)
        kernels, host = chip_smoke._device_ms(
            lambda: PW.pairwise_l1(x, y), dev, reps)
        hits = [v for k, v in kernels.items() if "pairwise_l1_kernel" in k]
        n = sum(c for _, c in hits)
        dev_ms = sum(t for t, _ in hits) / n if n else float("nan")
        bound, by = chip_smoke._bound(PW.work(B1, B2, d))
        floor = 2.0 * B1 * B2 * d / (132 * 128 * mhz * 1e6) * 1e3
        how = ""
        if hasattr(PW, "copy_path"):
            bd = min(512, d)
            how = (f", {PW.tile_plan(B1, B2, bd)} tile, "
                   f"{PW.copy_path(d, bd, x.data_ptr(), y.data_ptr())} "
                   f"copies")
        print(f"  F ({B1} x {B2} x {d}{how}): {ms:.5f} ms per call (CUDA "
              f"events, {reps} calls), device {dev_ms:.5f} ms per launch "
              f"({n} launches seen), host clock {host:.5f} ms per call; "
              f"bound {bound:.6f} ms ({by}); FADD floor {floor:.6f} ms")


def kernel_i(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(5)
    for B, S, W in ((1, 4096, 4096), (2, 512, 4096)):
        a = 0.7 + 0.299 * torch.rand((B, S, W), generator=g, device=dev)
        b = 0.1 * torch.randn((B, S, W), generator=g, device=dev)
        h0 = torch.zeros((B, W), device=dev)
        ms = chip_smoke._ms(lambda: RS.rglru_scan(a, b, h0), dev, reps=50)
        label = f"I (B={B} S={S} W={W})"
        dev_ms = profile(label, lambda: RS.rglru_scan(a, b, h0), calls=50)
        bound = chip_smoke._bound(RS.work(B, S, W))[0]
        print(f"  {label}: {ms:.5f} ms per call (CUDA events, 50 calls), "
              f"device {dev_ms:.5f}, bound {bound:.6f} ms (bytes)")
        if hasattr(RS, "_kernel") and S <= 512:
            # the wrapper's host work, where the card keeps up with it
            h = torch.empty_like(a)
            stream = _stream(dev)
            launch = lambda: RS._kernel()(  # noqa: E731
                a.data_ptr(), b.data_ptr(), h0.data_ptr(), B, S, W, 1,
                h.data_ptr(), stream)
            steps = (("whole call", lambda: RS.rglru_scan(a, b, h0)),
                     ("torch.empty of h", lambda: torch.empty_like(a)),
                     ("the ctypes launch (3 TMA maps encoded)", launch))
            print(f"  {label} host us per call: " + "; ".join(
                f"{name} {host_us(fn, calls=500):.2f}" for name, fn in steps))


def tune_call(dev) -> None:
    """One objective call of the tuning phase: every kernel's device time,
    their sum and B's against the call's host-clock time."""
    scale = chip_smoke.FULL
    problem, space = chip_smoke._tune_problem(dev, scale)
    params = space.to_dict(space.sample(np.random.default_rng(0),
                                        scale.tune_pop))
    objective = problem.objective()
    calls = 5
    kernels, host = chip_smoke._device_ms(lambda: objective(params), dev,
                                          calls)
    total = sum(t for t, _ in kernels.values()) / calls
    b = sum(t for k, (t, _) in kernels.items()
            if "fleet_fused_kernel" in k) / calls
    parts = "; ".join(f"{k[:60]} {t / calls:.4f} (x{n})" for k, (t, n) in
                      sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8])
    print(f"T (objective call, {scale.tune_pop} candidates x "
          f"{problem._base[0].n_devices} cells): host clock {host:.4f} ms "
          f"per call; device {total:.4f} ms ({100 * total / host:.1f} %), "
          f"B {b:.4f} ms ({100 * b / host:.1f} %) [{parts}]")


def kernel_g(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(3)
    for B, S, Skv, H, KV, hd, causal, window, qo in \
            chip_smoke.FULL.flash_shapes:
        q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
        kw = dict(causal=causal, window=window, q_offset=qo)
        profile(f"G (B={B} S={S} Skv={Skv} H={H} KV={KV} hd={hd} window="
                f"{window} q_offset={qo}) bf16",
                lambda: FA.flash_attention(q, k, v, **kw))


def kernel_h(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(4)
    for shape in chip_smoke.FULL.decode_shapes:
        q, k, v, slot_pos, pos = chip_smoke._decode_inputs(shape, g, dev)
        B, H, KV, hd, C, dtype, round_p, window = shape
        kw = dict(window=window, round_p=round_p)
        profile(f"H (B={B} H={H} KV={KV} hd={hd} C={C} {dtype} round_p="
                f"{round_p}) splits={DG.split_plan(B, KV, C, 132)[0]}",
                lambda: DG.decode_gqa(q, k, v, slot_pos, pos, **kw))


def _slice_cuts():
    """Phase 15d's cuts ``((B, H, KV, hd, C, window), n)``: each block of a
    ``FULL.mesh_anytime`` run whose kv heads do not divide its mesh's
    ``model`` axis (its rows and whole cache) cut 2 and 4 ways, then
    ``FULL.mesh_decode_shape``'s long cache cut 2 and 4 ways."""
    from repro_torch.configs import get_config

    cuts = []
    for run in chip_smoke.FULL.mesh_anytime:
        cfg = get_config(run.arch)
        for nd, nm in run.meshes:
            if cfg.n_kv_heads % nm:
                block = (run.slots // nd, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim, run.prompt + run.new,
                         cfg.window or 0)
                cuts += [(block, m) for m in dict.fromkeys((nm, 2, 4))]
    cuts += [(tuple(chip_smoke.FULL.mesh_decode_shape), n) for n in (2, 4)]
    return list(dict.fromkeys(cuts))


def kernel_hslice(dev) -> None:
    """H's slice entries (stats, merge, PV) of a block's first slice at
    phase 15d's cuts, each with its CUDA-event ms (``chip_smoke._ms``: the
    wrapper's host work included), its device ms (``chip_smoke._busy_ms``:
    calls enqueued while the card spins), its host-clock us per call, its
    bound, and the stats' and PV's device time by kernel (the profiler).
    Takes either interface of the PV entry (from the stats' kept scores, or
    from q and k), so a copy in an older checkout times that checkout's
    entries."""
    g = torch.Generator(device=dev).manual_seed(15)
    for dtype in ("bfloat16", "float32"):
        for (B, H, KV, hd, C, window), n in _slice_cuts():
            q, k, v, sp, pos = chip_smoke._decode_inputs(
                (B, H, KV, hd, C, dtype, True, window), g, dev)
            c = C // n
            k0, v0, sp0 = (t[:, :c].contiguous() for t in (k, v, sp))
            st = DG.decode_gqa_stats(q, k0, sp0, pos, window=window)
            pm = torch.stack([st[0]] * n)
            ps = torch.stack([st[1]] * n)
            m, l = DG.decode_gqa_merge(pm, ps)
            if len(st) == 3:
                pv = lambda st=st, v0=v0, m=m, l=l: DG.decode_gqa_pv(
                    st[2], v0, m, l)
            else:
                pv = (lambda q=q, k0=k0, v0=v0, sp0=sp0, m=m, l=l,
                      w=window: DG.decode_gqa_pv(q, k0, v0, sp0, pos, m, l,
                                                 window=w))
            label = (f"H={H} KV={KV} hd={hd} window {window}, B={B} C={C} "
                     f"{dtype}, {n} slices of {c}")
            for name, fn, work in (
                    ("stats", lambda q=q, k0=k0, sp0=sp0, w=window:
                     DG.decode_gqa_stats(q, k0, sp0, pos, window=w),
                     DG.slice_work(B, H, KV, hd, c, q.dtype, pv=False)),
                    ("merge", lambda pm=pm, ps=ps: DG.decode_gqa_merge(pm,
                                                                       ps),
                     DG.merge_work(n, B * H)),
                    ("PV", pv, DG.slice_work(B, H, KV, hd, c, q.dtype,
                                             pv=True))):
                ms = chip_smoke._ms(fn, dev, reps=50, warmup=5)
                dev_ms = chip_smoke._busy_ms(fn, dev, reps=20)
                bound = chip_smoke._bound(work)[0]
                print(f"Hslice {name} ({label}): event {ms:.4f} ms, device "
                      f"{dev_ms:.4f} ms per call, host {host_us(fn, 500):.1f}"
                      f" us per call, bound {bound:.6f} ms")
                if name != "merge":
                    profile(f"  Hslice {name} ({label}) by kernel", fn)


def kernel_gbwd(dev) -> None:
    import torch.nn.functional as F

    import repro_torch

    print(f"Gbwd source: {repro_torch.__file__}")
    g = torch.Generator(device=dev).manual_seed(6)
    for shape in chip_smoke.FULL.flash_bwd_shapes:
        B, S, Skv, H, KV, hd, causal, window, qo = shape
        q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
        dout = torch.randn((B, S, H, hd), generator=g, device=dev)
        kw = dict(causal=causal, window=window, q_offset=qo)
        out, lse = FA._launch(q, k, v, causal, window, qo, True)
        label = (f"B={B} S={S} Skv={Skv} H={H} KV={KV} hd={hd} causal="
                 f"{causal} window={window} q_offset={qo}")
        calls = 5 if hd > 128 else 20
        dev_ms = profile(f"Gbwd ({label}) bf16",
                         lambda: FA.flash_attention_bwd(q, k, v, out, lse,
                                                        dout, **kw),
                         calls=calls)
        qt, kt, vt, sdpa_kw = chip_smoke._sdpa_inputs(q, k, v, causal,
                                                      window, qo)
        qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                               enable_gqa=KV != H, **sdpa_kw)
        g_lib = dout.transpose(1, 2).bfloat16().contiguous()
        lib_ms = profile(f"  SDPA backward ({label}) bf16",
                         lambda: torch.autograd.grad(o_lib, (qt, kt, vt),
                                                     g_lib,
                                                     retain_graph=True),
                         calls=calls)
        work = FA.bwd_work(B, S, Skv, H, KV, hd, torch.bfloat16, **kw)
        flops = work.ops
        bound, by = chip_smoke._bound(work)
        print(f"  Gbwd ({label}) bf16: device {dev_ms:.4f} ms per call, "
              f"SDPA backward {lib_ms:.4f} ms, bound {bound:.6f} ms ({by}), "
              f"{flops / dev_ms / 1e9:.2f} TFLOP/s useful")


def kernel_ibwd(dev) -> None:
    import repro_torch

    print(f"Ibwd source: {repro_torch.__file__}")
    g = torch.Generator(device=dev).manual_seed(7)
    for B, S, W in chip_smoke.FULL.rglru_bwd_shapes:
        a = 0.7 + 0.299 * torch.rand((B, S, W), generator=g, device=dev)
        h = torch.randn((B, S, W), generator=g, device=dev)
        dh = torch.randn((B, S, W), generator=g, device=dev)
        h0 = torch.randn((B, W), generator=g, device=dev)
        label = f"B={B} S={S} W={W}"
        dev_ms = profile(f"Ibwd ({label})",
                         lambda: RS.rglru_scan_bwd(a, h0, h, dh), calls=50)
        bound = chip_smoke._bound(RS.bwd_work(B, S, W))[0]
        print(f"  Ibwd ({label}): device {dev_ms:.5f} ms per call, bound "
              f"{bound:.6f} ms (bytes), {100 * bound / dev_ms:.1f} % of it")


KERNELS = {"A": kernel_a, "B": kernel_b, "C": kernel_c, "D": kernel_d,
           "E": kernel_e, "F": kernel_f, "G": kernel_g, "H": kernel_h,
           "I": kernel_i, "T": tune_call, "Gbwd": kernel_gbwd,
           "Ibwd": kernel_ibwd, "Hslice": kernel_hslice}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="what to time, comma-separated (A,B,C,D,E,F,G,H,I,T,"
                    "Gbwd,Ibwd,Hslice)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {chip_smoke._card_line()}")
    for name in args.only.split(","):
        KERNELS[name.strip()](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
