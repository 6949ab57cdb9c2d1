#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (nothing is caught: any failure exits non-zero):

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the build of the hand-written CUDA kernels from the
   sources in this checkout;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it plus a windowed and a ``q_offset`` case,
   with kernel, plain and library (``scaled_dot_product_attention``,
   timed as a yardstick only) times;
3. the main path at the full width of smollm-135m: a real-time serving job
   (prefill + sliced decode) admitted by the IOCTL response-time analysis
   and preempting a best-effort batch-prefill job, released back to
   back, on one ``DeviceExecutor``.  epsilon covers the longest slice
   seen with each job alone and with both running together (a
   calibration run as long as the measured one), and the real-time
   job's admitted execution time counts each of its slices at the
   longest it took in either; the measured run then
   needs its 24 real-time completions, MORT <= WCRT, no real-time
   segment waiting for the slice in flight longer than epsilon less its
   1 ms update cost, both kernels launched on the path, and greedy fp32
   tokens equal through the kernels and the plain versions.  Each
   phase's slices are broken down into host, CPU, device,
   garbage-collection and idle time.

It then prints one JSON line of per-kernel numbers and, last, the
``{"ok": true, "device": ...}`` line.  It needs a CUDA card and the rest
of the repository.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# each kernel: its CUDA source and the Pallas call it replaces
SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:138"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/decode_attention.py:130"),
}
# dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
RUN_RELEASES = 24      # real-time releases of the measured run


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------

def phase_environment() -> None:
    import torch
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    seconds = build.build(SOURCES)
    build_s = time.perf_counter() - t0
    for name in SOURCES:
        for line in build.ptxas_reports.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"phase 1 environment: torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"build {build_s:.1f}s "
          + " ".join(f"{k}={v:.1f}s" for k, v in seconds.items()))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _gen(shape, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda",
                       dtype=torch.float32).to(dtype)


def _visible_pairs(sq, sk, causal, window, q_offset) -> int:
    import torch
    rows = torch.arange(sq, device="cuda")[:, None] + q_offset
    cols = torch.arange(sk, device="cuda")[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return int(mask.sum())


def _bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash_attention(b, s, h, hkv, d, dtype, *, causal=True, window=None,
                          q_offset=0, timed=False) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    dname = str(dtype).replace("torch.", "")
    sq, sk = s - q_offset, s
    q = _gen((b, sq, h, d), dtype, 1)
    k = _gen((b, sk, hkv, d), dtype, 2)
    v = _gen((b, sk, hkv, d), dtype, 3)
    opts = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention(q, k, v, **opts)
    want = fa.flash_attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **TOL[dname])
    rec = {"case": f"flash_attention b={b} sq={sq} sk={sk} h={h} hkv={hkv} "
                   f"d={d} {dname} causal={causal} window={window} "
                   f"q_offset={q_offset}",
           "max_abs_err": err, "ok": ok}
    if timed:
        rec["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **opts), 20)
        rec["plain_ms"] = cuda_ms(
            lambda: fa.flash_attention_ref(q, k, v, **opts), 5)
        if window is None and q_offset == 0:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            rec["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        else:
            rec["library_ms"] = None
        elem = q.element_size()
        nbytes = elem * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * b * h * d * _visible_pairs(sq, sk, causal, window,
                                               q_offset)
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops, dname)
    return rec


def check_flash_decode(b, smax, h, hkv, d, dtype, lens, *, window=None,
                       timed=False) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da

    dname = str(dtype).replace("torch.", "")
    q = _gen((b, h, d), dtype, 4)
    kc = _gen((b, smax, hkv, d), dtype, 5)
    vc = _gen((b, smax, hkv, d), dtype, 6)
    cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = da.flash_decode(q, kc, vc, cache_len, window=window)
    want = da.flash_decode_ref(q, kc, vc, cache_len, window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **TOL[dname])
    rec = {"case": f"flash_decode b={b} smax={smax} h={h} hkv={hkv} d={d} "
                   f"{dname} cache_len={list(lens)} window={window}",
           "max_abs_err": err, "ok": ok}
    if timed:
        rec["ms"] = cuda_ms(
            lambda: da.flash_decode(q, kc, vc, cache_len, window=window), 50)
        rec["plain_ms"] = cuda_ms(
            lambda: da.flash_decode_ref(q, kc, vc, cache_len, window=window),
            10)
        cols = torch.arange(smax, device="cuda")[None, :]
        valid = cols < cache_len[:, None]
        if window is not None:
            valid &= cols >= cache_len[:, None] - window
        qt = q[:, :, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        mask = valid[:, None, None, :]
        rec["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 50)
        n_valid = int(valid.sum())
        elem = q.element_size()
        nbytes = elem * (2 * q.numel() + 2 * n_valid * hkv * d) \
            + 4 * cache_len.numel()
        flops = 4 * h * d * n_valid
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops, dname)
    return rec


def phase_kernels() -> dict:
    """Every kernel against its plain version.  Returns the timed record
    of each kernel at its main-path shape."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    h, hkv, d = 9, 3, 64                           # smollm-135m attention
    timed = {}
    recs = []
    for s in (128, 512):
        for dt in (f32, bf16):
            recs.append(check_flash_attention(4, s, h, hkv, d, dt))
    recs.append(check_flash_attention(4, 512, h, hkv, d, bf16, window=96))
    recs.append(check_flash_attention(4, 512, h, hkv, d, bf16, q_offset=384))
    recs.append(check_flash_attention(2, 200, 4, 2, 128, f32, window=50,
                                      q_offset=37))
    recs.append(check_flash_attention(4, 128, h, hkv, d, bf16, timed=True))
    timed["flash_attention"] = check_flash_attention(8, 1024, h, hkv, d, bf16,
                                                     timed=True)
    recs.append(timed["flash_attention"])
    lens_main = (129, 140, 150, 160)               # the main path's decode
    for smax in (1024, 4096):
        for dt in (f32, bf16):
            recs.append(check_flash_decode(4, smax, h, hkv, d, dt,
                                           (1, 333, smax - 100, smax)))
    recs.append(check_flash_decode(4, 1024, h, hkv, d, bf16,
                                   (100, 600, 1000, 1024), window=256))
    recs.append(check_flash_decode(2, 700, 8, 1, 128, f32, (0, 650)))
    timed["flash_decode"] = check_flash_decode(4, 1024, h, hkv, d, bf16,
                                               lens_main, timed=True)
    recs.append(timed["flash_decode"])
    for r in recs:
        times = ""
        if "ms" in r:
            lib = r["library_ms"]
            times = (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                     f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
                     f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
        print(f"  {r['case']}: max_abs_err={r['max_abs_err']:.3g} "
              f"{'ok' if r['ok'] else 'MISMATCH'}{times}")
    bad = [r["case"] for r in recs if not r["ok"]]
    print(f"phase 2 kernels: {len(recs) - len(bad)}/{len(recs)} cases "
          f"within tolerance (fp32 2e-5, bf16 2e-2)")
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return timed


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

class SliceClock:
    """Per-slice times of the main path's dispatches, to tell where a long
    slice spends its time.  For each slice: the wall time ending in a
    device sync, the host time until the step returned (its launches
    enqueued), the launching thread's CPU time in that span, the device
    span between CUDA events recorded around the launches, the Python
    garbage-collection pauses inside the slice, and the idle gap since
    the previous slice of any job ended.

    For each segment it also keeps the preemption delay: from the segment
    op's creation, which the workload does right after the segment's
    runlist update, to the start of its first slice.  That is the wait
    for the slice in flight that epsilon bounds."""

    def __init__(self):
        self.rows = []
        self.delays = []                            # (job, ms)
        self._gc = []                               # (start, end, generation)
        self._gc_t0 = None
        self._ops = itertools.count()
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc.append((self._gc_t0, time.perf_counter(),
                             info["generation"]))
            self._gc_t0 = None

    def wrap(self, job: str, op):
        """``op`` with each step timed (and synchronized) by this clock."""
        import torch
        from repro_torch.core.segments import block_until_ready

        made = time.perf_counter()
        seq = next(self._ops)
        first = []

        def step(carry, i):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            w0, c0 = time.perf_counter(), time.thread_time()
            if not first:
                first.append(w0)
                self.delays.append((job, (w0 - made) * 1e3))
            ev0.record()
            out = op.step(carry, i)
            ev1.record()
            w1, c1 = time.perf_counter(), time.thread_time()
            block_until_ready(out)
            self.rows.append({"job": job, "label": op.label, "op": seq,
                              "i": i, "t0": w0,
                              "t1": time.perf_counter(),
                              "enqueue": (w1 - w0) * 1e3,
                              "cpu": (c1 - c0) * 1e3, "ev": (ev0, ev1)})
            return out
        return dataclasses.replace(op, step=step)

    def take(self) -> tuple:
        """The slices since the last call, with every time in ms, the
        garbage collections since then as (start, end, generation), and
        the preemption delays as (job, ms)."""
        rows, gcs = sorted(self.rows, key=lambda r: r["t0"]), self._gc
        delays = self.delays
        self.rows, self._gc, self.delays = [], [], []
        prev_end = None
        for r in rows:
            ev0, ev1 = r.pop("ev")
            r["device"] = ev0.elapsed_time(ev1)
            r["wall"] = (r["t1"] - r["t0"]) * 1e3
            r["gc"] = sum(max(0.0, min(e, r["t1"]) - max(s, r["t0"]))
                          for s, e, _ in gcs) * 1e3
            r["gap"] = None if prev_end is None \
                else (r["t0"] - prev_end) * 1e3
            prev_end = r["t1"]
        return rows, gcs, delays


def _describe(rows: list, job: str, top: int = 2) -> str:
    """One job's slices: count, median, 99th percentile, the launching
    thread's CPU time over its enqueue time (below 1 when the thread
    waited: for the GIL, or for a core), and the ``top`` longest with the
    parts of each."""
    rs = sorted((r for r in rows if r["job"] == job),
                key=lambda r: -r["wall"])
    if not rs:
        return f"{job}: no slices"
    walls = sorted(r["wall"] for r in rs)
    p99 = walls[max(0, -(-99 * len(walls) // 100) - 1)]
    parts = []
    for r in rs[:top]:
        gap = "-" if r["gap"] is None else f"{r['gap']:.1f}"
        parts.append(f"{r['wall']:.2f} (enqueue {r['enqueue']:.2f} cpu "
                     f"{r['cpu']:.2f} device {r['device']:.2f} gc "
                     f"{r['gc']:.2f} idle-before {gap})")
    on_cpu = sum(r["cpu"] for r in rs) / sum(r["enqueue"] for r in rs)
    return (f"{job}: {len(rs)} slices, median {walls[len(walls) // 2]:.2f} "
            f"p99 {p99:.2f} ms, on-CPU share of the enqueue time "
            f"{on_cpu:.3f}, longest " + ", ".join(parts))


def _worst_profile(prof, rows: list, job: str):
    """``prof`` with the time of each slice raised to the longest that
    slice (same segment label, same index) took among ``job``'s rows."""
    longest = {}
    for r in rows:
        if r["job"] == job:
            key = (r["label"], r["i"])
            longest[key] = max(longest.get(key, 0.0), r["wall"])
    device = [dataclasses.replace(s, slice_ms=[
        max(ms, longest.get((s.label, i), 0.0))
        for i, ms in enumerate(s.slice_ms)]) for s in prof.device]
    return dataclasses.replace(prof, device=device)


def _release_slices_ms(rows: list, job: str, first_label: str) -> list:
    """The summed slice time of each of ``job``'s releases in ``rows``,
    a release beginning with each segment labelled ``first_label``."""
    per_op = {}
    for r in rows:
        if r["job"] == job:
            label, ms = per_op.get(r["op"], (r["label"], 0.0))
            per_op[r["op"]] = (label, ms + r["wall"])
    releases = []
    for _, (label, ms) in sorted(per_op.items()):
        if label == first_label or not releases:
            releases.append(0.0)
        releases[-1] += ms
    return releases


def _run_jobs(infer_wl, batch_wl, period_ms: float, be_period_ms: float,
              releases: int, trace=None):
    """``releases`` releases of the real-time job, with the best-effort job
    released back to back on the same executor until the last one has
    completed; returns the two jobs once both have ended."""
    from repro_torch.sched import DeviceExecutor, RTJob

    ex = DeviceExecutor(policy="ioctl", wait_mode="suspend", trace=trace)
    infer = RTJob("infer", infer_wl.bind(ex), period_s=period_ms / 1e3,
                  priority=50, n_iterations=releases)
    batch_job = RTJob("batch", batch_wl.bind(ex),
                      period_s=be_period_ms / 1e3, priority=0,
                      best_effort=True, n_iterations=10 ** 6)
    batch_job.start(ex)
    time.sleep(0.05)
    infer.start(ex)
    infer.join(releases * period_ms / 1e3 + 120)
    batch_job.stop()
    batch_job.join(120)
    ex.shutdown()
    for job in (infer, batch_job):
        if job._thread.is_alive():
            fail(f"job {job.name} did not finish")
        if job.error is not None:
            raise job.error
    return infer, batch_job


def _greedy(engine, prompts, n):
    engine.prefill_batch(prompts)
    return engine.decode_chunk(n)


def phase_main_path() -> dict:
    """smollm-135m at full width: a real-time serving job preempting a
    best-effort batch-prefill job on one executor, admitted by the IOCTL
    response-time analysis.  Returns the kernels' launches in the run."""
    from unittest import mock

    import torch
    from repro_torch.configs import get
    from repro_torch.core.segments import SegmentedWorkload, SlicedOp
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import InferenceEngine
    from repro_torch.models import transformer
    from repro_torch.sched import (AdmissionController, ExecutorTrace,
                                   JobProfile)

    cfg = get("smollm-135m").config()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    rt = InferenceEngine(cfg, params=params, max_len=1024)
    be = InferenceEngine(cfg, params=params, max_len=1024)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                            device="cuda")
    batch = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen,
                          device="cuda")
    n_decode, be_slices = 32, 4
    clock = SliceClock()

    infer_wl = (SegmentedWorkload("infer")
                .device(lambda: clock.wrap("rt", rt.prefill_segment(prompts)),
                        label="prefill")
                .device(lambda: clock.wrap(
                    "rt", rt.decode_segment(n_decode, slice_tokens=1)),
                        label="decode"))

    def batch_op() -> SlicedOp:
        """One best-effort release: ``be_slices`` batch prefills, one per
        slice (the preemption grain)."""
        return clock.wrap("be", SlicedOp(
            be_slices, lambda: None,
            lambda carry, i: be.prefill_batch(batch),
            lambda logits: logits, label="batch_prefill"))

    batch_wl = SegmentedWorkload("batch").device(batch_op)

    # warm-up: the first launches (kernel loads, allocator growth) are in
    # neither profile
    for wl in (infer_wl, batch_wl):
        wl.profile(reps=1)
    clock.take()
    # measured slice profiles, each job alone (each profile drops its
    # first rep)
    infer_prof = infer_wl.profile(reps=3)
    batch_prof = batch_wl.profile(reps=11)
    alone, alone_gc, _ = clock.take()
    margin = 2.0
    eta = len(infer_prof.device)
    # the best-effort job is released back to back: it keeps the card busy
    # whenever the real-time job does not hold it
    be_period_ms = batch_prof.device[0].exec_ms

    def g_ms(prof) -> float:
        """G of the real-time job: its device segments' time, unmargined."""
        return sum(s.misc_ms + s.exec_ms for s in prof.device)

    def period_for(prof, eps_ms: float) -> float:
        """Requests arrive every period: 1.25 times the single-job WCRT of
        Lemma 4 (C + G* + (eta+1) eps with G* = G + 2 eps eta, C = 0), so
        the job is schedulable and the run stays short."""
        return 1.25 * (g_ms(prof) * margin + (3 * eta + 1) * eps_ms)

    # The longest slice is measured where the jobs run, both on one
    # executor, over as many releases as the measured run: the longest
    # slice grows with the number of slices seen (it is the tail of the
    # host time per slice), and the alone profile sees too few.  epsilon
    # is then set as examples/preemptive_serving.py sets it, over the
    # longest slice seen alone or together.
    alone_max = max(infer_prof.max_slice_ms, batch_prof.max_slice_ms)
    c_infer, c_batch = _run_jobs(infer_wl, batch_wl,
                                 period_for(infer_prof,
                                            1.0 + alone_max * 1.2),
                                 be_period_ms, RUN_RELEASES)
    calib, calib_gc, _ = clock.take()
    calib_max = max(c_infer.stats.max_slice_time or 0.0,
                    c_batch.stats.max_slice_time or 0.0) * 1e3
    max_slice = max(alone_max, calib_max)
    eps_ms = 1.0 + max_slice * 1.2
    # The real-time job's execution time, like epsilon, is taken where the
    # jobs run: each of its slices counts at the longest it took alone or
    # in the calibration.  Its slices are host-bound, and a profile of a
    # few seconds alone can see a host twice as fast as minutes of running
    # do, which the margin alone does not cover (PERF.md, PR 11).
    infer_wcet = _worst_profile(infer_prof, calib, "rt")
    period_ms = period_for(infer_wcet, eps_ms)
    ctl = AdmissionController(policy="ioctl", wait_mode="suspend",
                              n_cpus=1, epsilon_ms=eps_ms)
    dec_rt = ctl.try_admit(JobProfile.from_workload(
        infer_wcet, period_ms=period_ms, priority=50, margin=margin))
    dec_be = ctl.try_admit(JobProfile.from_workload(
        batch_prof, period_ms=be_period_ms, priority=0, best_effort=True,
        margin=1.5))
    if not (dec_rt.accepted and dec_be.accepted):
        fail(f"admission refused: {dict(dec_rt)} {dict(dec_be)}")
    wcrt = dec_rt.wcrt["infer"]

    trace = ExecutorTrace()
    fa.launches.reset()
    da.launches.reset()
    infer, batch_job = _run_jobs(infer_wl, batch_wl, period_ms, be_period_ms,
                                 RUN_RELEASES, trace)
    launches = {"flash_attention": fa.launches.count,
                "flash_decode": da.launches.count}
    run, run_gc, run_delays = clock.take()
    mort_ms = (infer.stats.mort or 0.0) * 1e3
    obs_slice = max(infer.stats.max_slice_time or 0.0,
                    batch_job.stats.max_slice_time or 0.0) * 1e3
    over_eps = sum(1 for r in run if r["wall"] > eps_ms - 1.0)
    rt_delays = sorted(d for job, d in run_delays if job == "rt")
    if not rt_delays:
        fail("no real-time segment ran")
    out = rt.decode_chunk(4)
    ok_out = (out.shape == (4, 4) and bool((out >= 0).all())
              and bool((out < cfg.vocab_size).all()))

    # greedy fp32 tokens: through the kernels, then through the plain
    # versions (the same engine, with the ops pointed at ref)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    eng32 = InferenceEngine(cfg32, max_len=1024, seed=0)
    logits32 = eng32.prefill_batch(prompts)
    finite = bool(torch.isfinite(logits32).all())
    tok_kernel = _greedy(eng32, prompts, 8)
    with mock.patch.object(ops, "attention", ref.attention), \
            mock.patch.object(ops, "decode_attention", ref.decode_attention):
        tok_plain = _greedy(eng32, prompts, 8)
    same = torch.equal(tok_kernel, tok_plain)

    for name, rows, gcs in (
            ("alone (profile)", alone, alone_gc),
            (f"together (calibration, {RUN_RELEASES} releases)", calib,
             calib_gc),
            (f"together (run, {RUN_RELEASES} releases)", run, run_gc)):
        for job in ("rt", "be"):
            print(f"  slices {name}: {_describe(rows, job)}")
        full = [(e - s) * 1e3 for s, e, g in gcs if g == 2]
        print(f"  slices {name}: {len(gcs)} garbage collections, "
              f"{len(full)} of generation 2"
              + (f" (longest {max(full):.2f} ms)" if full else ""))
    prefill_ms = infer_prof.device[0].slice_ms[0]
    decode_ms = sum(infer_prof.device[1].slice_ms) / n_decode
    for name, rows in (("calibration", calib), ("run", run)):
        per = sorted(_release_slices_ms(rows, "rt", "prefill"))
        print(f"  rt slices per release, {name}: {len(per)} releases, "
              f"median {per[len(per) // 2]:.2f} max {per[-1]:.2f} ms")
    resp = sorted(t * 1e3 for t in infer.stats.response_times)
    print(f"  rt G (device segments, unmargined): alone "
          f"{g_ms(infer_prof):.2f} ms, each slice at its longest alone or "
          f"in the calibration {g_ms(infer_wcet):.2f} ms, margin {margin}; "
          f"rt response times in the run: median "
          f"{resp[len(resp) // 2]:.2f} max {resp[-1]:.2f} ms")
    print(f"phase 3 main path: smollm-135m full width (30 layers, "
          f"d_model 576, bf16), rt 4x128 prefill {prefill_ms:.2f} ms, "
          f"decode {decode_ms:.2f} ms/token ({4e3 / decode_ms:.0f} tok/s), "
          f"be 8x1024 prefill slice {batch_prof.max_slice_ms:.2f} ms; "
          f"longest slice alone {alone_max:.2f} ms, together "
          f"{calib_max:.2f} ms, epsilon {eps_ms:.2f} ms; rt completions "
          f"{infer.stats.completions} (period {period_ms:.1f} ms), be "
          f"releases {batch_job.stats.completions}, MORT {mort_ms:.2f} ms "
          f"vs WCRT {wcrt:.2f} ms, real-time preemption delay median "
          f"{rt_delays[len(rt_delays) // 2]:.2f} max {rt_delays[-1]:.2f} ms "
          f"over {len(rt_delays)} segments, longest slice in the run "
          f"{obs_slice:.2f} ms (rt {(infer.stats.max_slice_time or 0) * 1e3:.2f}"
          f", be {(batch_job.stats.max_slice_time or 0) * 1e3:.2f}), "
          f"{over_eps} of {len(run)} slices over epsilon - 1 ms, preempt "
          f"events {len(trace.of('preempt'))}, launches {launches}, fp32 "
          f"greedy kernel==plain {same}")
    if infer.stats.completions != RUN_RELEASES:
        fail(f"{infer.stats.completions} real-time completions, want "
             f"{RUN_RELEASES}")
    if not mort_ms <= wcrt + 1e-6:
        fail(f"MORT {mort_ms} ms exceeds WCRT {wcrt} ms (G alone "
             f"{g_ms(infer_prof):.2f} ms, G admitted "
             f"{g_ms(infer_wcet):.2f} ms x {margin}, epsilon "
             f"{eps_ms:.2f} ms)")
    # The analysis bounds the wait of a real-time segment for the slice in
    # flight by epsilon less the update cost.  This is checked on the wait
    # itself.  The longest slice is reported above: with host-bound
    # slices, the tail of one run's slices can exceed another run's
    # longest slice by more than epsilon's 1.2 when no real-time segment
    # is waiting on it.
    if rt_delays[-1] > eps_ms - 1.0:
        fail(f"a real-time segment waited {rt_delays[-1]:.2f} ms for the "
             f"slice in flight, more than epsilon {eps_ms:.2f} ms less "
             f"the 1 ms update cost: the one-slice preemption bound of the "
             f"analysis did not hold")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was never launched: {launches}")
    if not (ok_out and finite):
        fail("served tokens or logits out of range")
    if not same:
        fail(f"fp32 greedy tokens differ: kernels {tok_kernel.tolist()} "
             f"plain {tok_plain.tolist()}")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a "
             f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_environment()
    timed = phase_kernels()
    launches = phase_main_path()
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
