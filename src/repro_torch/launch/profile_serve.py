"""Where the serving path's time goes: each device segment of the main path
(the real-time job's prefill and decode step, the best-effort job's batch
prefill) timed on the host clock, then traced with ``torch.profiler`` for
its device time, its idle share and its kernels by time.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --reduced --device cpu          # rehearsal of the control flow

``wall_ms`` is the host time of one step ending in a device sync, without
the profiler; ``device_ms`` is the summed duration of the device
activities (kernels, copies) the profiler saw in one step; ``idle`` is
``1 - device_ms / wall_ms``.  A run without device activities (the CPU)
reports them as not measured.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import get
from ..core.segments import block_until_ready
from ..kernels import decode_attention, flash_attention
from ..models import transformer
from .serve import InferenceEngine, resolve_device

_COUNTERS = (flash_attention.launches, decode_attention.launches)


def _time_steps(step, reps: int) -> list:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(step())
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _trace(step, reps: int, device: torch.device) -> dict:
    """Device activities of ``reps`` steps: total ms, count and the
    kernels by time, each per step."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(reps):
            block_until_ready(step())
    by_name = defaultdict(float)
    n = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            n += 1
    if not n:
        return {"device_ms": None, "device_activities": None, "top": []}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": sum(by_name.values()) / reps,
            "device_activities": n / reps,
            "top": [{"name": k[:90], "ms": v / reps} for k, v in top]}


def profile_phase(name: str, step, reps: int, device: torch.device) -> dict:
    for _ in range(2):                                  # warm-up
        block_until_ready(step())
    walls = _time_steps(step, reps)
    for c in _COUNTERS:
        c.reset()
    block_until_ready(step())
    rec = {"phase": name, "wall_ms": statistics.mean(walls),
           "wall_ms_max": max(walls),
           "kernel_launches": {c.name: c.count for c in _COUNTERS}}
    rec.update(_trace(step, reps, device))
    dev = rec["device_ms"]
    rec["idle"] = None if dev is None else 1.0 - dev / rec["wall_ms"]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    entry = get(args.arch)
    cfg = entry.reduced() if args.reduced else entry.config()
    b_rt, s_rt, b_be, s_be = (4, 128, 8, 1024) if not args.reduced \
        else (2, 16, 2, 64)
    max_len = 1024 if not args.reduced else 128
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    rt = InferenceEngine(cfg, params=params, max_len=max_len, device=device)
    be = InferenceEngine(cfg, params=params, max_len=max_len, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b_rt, s_rt), generator=gen,
                            device=device)
    batch = torch.randint(0, cfg.vocab_size, (b_be, s_be), generator=gen,
                          device=device)

    recs = [profile_phase(f"rt_prefill {b_rt}x{s_rt}",
                          lambda: rt.prefill_batch(prompts), args.reps,
                          device)]
    rt.prefill_batch(prompts)
    op = rt.decode_segment(2 * args.reps + 3)           # every step below
    state = {"carry": op.init(), "i": 0}

    def decode_one():
        state["carry"] = op.step(state["carry"], state["i"])
        state["i"] += 1
        return state["carry"]

    recs.append(profile_phase(f"rt_decode_step {b_rt}x1 after {s_rt}",
                              decode_one, args.reps, device))
    recs.append(profile_phase(f"be_prefill {b_be}x{s_be}",
                              lambda: be.prefill_batch(batch), args.reps,
                              device))
    for r in recs:
        dev = ("not measured" if r["device_ms"] is None else
               f"{r['device_ms']:.3f} ms on the device "
               f"({r['device_activities']:.0f} activities, idle "
               f"{r['idle']:.3f})")
        top = ", ".join(f"{k['name'][:40]} {k['ms']:.3f}" for k in r["top"])
        print(f"{r['phase']}: wall {r['wall_ms']:.3f} ms (max "
              f"{r['wall_ms_max']:.3f}), {dev}, launches "
              f"{r['kernel_launches']}; top: {top or 'not measured'}")
    print(json.dumps({"device": str(device), "kind": (
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu"), "config": cfg.name, "phases": recs}))


if __name__ == "__main__":
    main()
