#!/usr/bin/env python3
"""Where one p-BiCGSafe iteration of the PyTorch / CUDA port spends its
time on the card: a ``torch.profiler`` trace of the main path (the
convection-diffusion system in ELL form, fp64, ``substrate="cuda"``),
summed per kernel class and divided by the iterations queued.

    python3 tools/torch_profile.py

Kernel classes: the three hand-written kernels; "scalar" kernels (a grid of
one block: the 0-d coefficient algebra, the freeze selects of the
coefficients and flags); "vector" kernels (every other launch: the freeze
selects of the state vectors and the recurrence tail); copies and sets.
The device's busy share is the union of all device intervals over the
profiled window.  Prints the summary as a JSON line and keeps it, with the
raw trace, under ``build/profile/``; fails when the trace holds no kernel.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OURS = ("fused_dots", "fused_axpy", "spmv_ell")
NX = 108        # the main path of chip_smoke.py: 108**3 = 1,259,712 rows
STEPS = 64      # four 16-step chunks


def classify(event) -> str:
    name = event["name"]
    for ours in OURS:
        if ours in name:
            return ours
    if event.get("cat") != "kernel":
        return "copy/set"
    grid = event.get("args", {}).get("grid", [0, 0, 0])
    return "scalar" if grid[0] * grid[1] * grid[2] == 1 else "vector"


def busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    from repro_torch.core import matrices

    stencil, b, _ = matrices.convection_diffusion(NX, peclet=0.5)
    ell = matrices.stencil_to_ell(stencil)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    solver.solve(b, maxiter=32)                       # warm-up
    solver.stats.update(steps=0, host_reads=0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solver.solve(b, tol=0.0, maxiter=STEPS)   # exactly STEPS steps
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = solver.stats["steps"]

    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "torch_profile_trace.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not any(e["cat"] == "kernel" for e in device):
        print("torch_profile: the trace holds no kernel (device time not "
              "measured)", file=sys.stderr)
        return 1
    classes = {}
    for e in device:
        rec = classes.setdefault(classify(e), {"launches": 0, "us": 0.0})
        rec["launches"] += 1
        rec["us"] += float(e["dur"])
    busy = busy_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in device])
    smi = card_name()
    summary = {
        "card": smi, "torch": torch.__version__, "nx": NX,
        "n": ell.n, "steps": steps, "host_reads": solver.stats["host_reads"],
        "wall_us_per_step": wall_us / steps,
        "device_busy_us_per_step": busy / steps,
        "device_busy_share": busy / wall_us,
        "per_step": {k: {"launches": v["launches"] / steps,
                         "us": v["us"] / steps}
                     for k, v in sorted(classes.items())},
    }
    with open(os.path.join(out_dir, "torch_profile.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"card: {smi}")
    print(f"n={ell.n} steps={steps} wall {summary['wall_us_per_step']:.1f} "
          f"us/step, device busy {summary['device_busy_us_per_step']:.1f} "
          f"us/step (share {summary['device_busy_share']:.3f})")
    for k, v in summary["per_step"].items():
        print(f"  {k:10s} {v['launches']:6.1f} launches/step "
              f"{v['us']:8.1f} us/step")
    print(json.dumps(summary))
    return 0


def card_name() -> str:
    import subprocess
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
