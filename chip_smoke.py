#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from a checkout of the repository, on a machine with one NVIDIA H100.
It exits non-zero, and prints no result, when no GPU is present or the
package is missing.  Phases, any failure of which fails the run:

1. device: the card's name and power limit, the versions, and the kernels'
   build (one ``nvcc`` call into ``build/``) with its time and the
   compiler's register report;
2. kernels: each hand-written kernel (``fused_dots``, ``fused_axpy``,
   ``spmv_ell``) against its plain PyTorch version on the card, in fp64 and
   fp32, at the main path's shape (n = 108**3 = 1,259,712 rows, k = 7),
   with its device time beside the plain version's, one PyTorch library
   call's where there is one, and the HBM bound;
3. main path: p-BiCGSafe and p-BiCGSafe-rr through
   ``repro_torch.make_solver(...).solve(b)`` on ``substrate="cuda"`` for
   the 1,259,712-row convection-diffusion system in ELL form, fp64,
   tol 1e-8: convergence, true residual, solution error, wall time, and
   the kernels' launch counters held against the steps the solver ran;
4. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

NX = 108                    # 108**3 = 1,259,712 rows, about atmosmodd's 1.27 M
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# peak rate outside the tensor cores (H100 SXM data sheet): the kernels do
# plain fp64 / fp32 FMAs
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
# max |kernel - plain| over the result's scale (a dot's sum of |a_i b_i|, a
# vector's max-abs).  fp64: FMA contraction and another summation order move
# the last ulps only.  fp32: the tolerances of tests/test_kernels.py.
TOL = {"float64": {"fused_dots": 1e-12, "fused_axpy": 1e-12,
                   "spmv_ell": 1e-12},
       "float32": {"fused_dots": 2e-5, "fused_axpy": 5e-5, "spmv_ell": 1e-4}}
REPLACES = {"fused_dots": "src/repro/kernels/fused_dots.py:63",
            "fused_axpy": "src/repro/kernels/fused_axpy.py:73",
            "spmv_ell": "src/repro/kernels/spmv_ell.py:45"}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(torch, fn, reps: int = 20, trials: int = 5) -> float:
    """Median device time of one call of ``fn``, in ms.

    A sleep kernel holds the stream while the host queues ``reps`` calls,
    so the events time the calls back to back on the device and not the
    host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-3) * 2e9 * 2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(trials):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, ops, ref, values, cols, dtype) -> dict:
    """Each kernel against its plain version on the card, in ``dtype``."""
    name = str(dtype).replace("torch.", "")
    dev = values.device
    n, k = values.shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn():
        return torch.randn(n, generator=gen, device=dev, dtype=torch.float64
                           ).to(dtype)

    item = torch.empty((), dtype=dtype).element_size()
    out = {}

    # fused_dots: scale of a dot is sum |a_i b_i|
    s, y, r, t, rs = (randn() for _ in range(5))
    got = ops.fused_dots(s, y, r, t, rs)
    want = ref.fused_dots(s, y, r, t, rs)
    scale = ref.fused_dots(*(v.abs() for v in (s, y, r, t, rs)))
    stacked = torch.stack([s, y, r, t, rs])
    out["fused_dots"] = dict(
        err=float(((got - want).abs() / scale).max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.fused_dots(s, y, r, t, rs)),
        plain_ms=device_ms(torch, lambda: ref.fused_dots(s, y, r, t, rs)),
        library_ms=device_ms(torch, lambda: stacked @ stacked.T),
        bound=bound_ms(5 * item * n + 9 * item, 18 * n, name))
    del stacked

    # fused_axpy: scale of an output vector is its max-abs
    from repro_torch.kernels.fused_axpy import IN_ORDER
    vecs = {key: randn() for key in IN_ORDER}
    scal = torch.tensor([0.3, -0.7, 1.1, 0.2], dtype=dtype, device=dev)
    got = ops.fused_axpy(vecs, scal)
    want = ref.fused_axpy(vecs, scal.unbind(0))
    out["fused_axpy"] = dict(
        err=max(float((got[key] - want[key]).abs().max()
                      / want[key].abs().max()) for key in want),
        max_abs_err=max(float((got[key] - want[key]).abs().max())
                        for key in want),
        ms=device_ms(torch, lambda: ops.fused_axpy(vecs, scal)),
        plain_ms=device_ms(torch, lambda: ref.fused_axpy(vecs,
                                                          scal.unbind(0))),
        library_ms=None,
        bound=bound_ms(22 * item * n + 4 * item, 34 * n, name))
    del vecs, got, want

    # spmv_ell on the main path's matrix
    from repro_torch.core.linear_operator import ELLOperator
    op = ELLOperator(values.to(dtype), cols, n)
    x = randn()
    got = ops.spmv_ell(op, x)
    want = ref.spmv_ell(op.values, op.cols, x)
    crow = torch.arange(0, n * k + 1, k, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(crow, cols.reshape(-1).to(torch.int64),
                                  op.values.reshape(-1), size=(n, n))
    out["spmv_ell"] = dict(
        err=float((got - want).abs().max() / want.abs().max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.spmv_ell(op, x)),
        plain_ms=device_ms(torch, lambda: ref.spmv_ell(op.values, op.cols, x)),
        library_ms=device_ms(torch, lambda: csr @ x),
        bound=bound_ms(k * item * n + k * 4 * n + 2 * item * n, 2 * k * n,
                       name))
    for kname, rec in out.items():
        rec["tol"] = TOL[name][kname]
        lib = "none" if rec["library_ms"] is None \
            else f"{rec['library_ms']:.4f}"
        log(f"kernel {kname:10s} {name}: max_rel_err {rec['err']:.3e} "
            f"(tol {rec['tol']:.0e}) kernel_ms {rec['ms']:.4f} "
            f"plain_ms {rec['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {rec['bound'][0]:.4f} ({rec['bound'][1]})")
    return out


def run_main_path(torch, repro_torch, ops, method, ell, stencil, b):
    """One measured solve through the front door, with the launch counters
    set to 0 just before it and read just after."""
    solver = repro_torch.make_solver(method, ell, substrate="cuda")
    solver.solve(b, maxiter=32)                      # warm-up, not counted
    solver.stats.update(steps=0, rr_steps=0, host_reads=0)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(b, tol=1e-8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    it = int(res.iterations)
    true_relres = float(torch.linalg.vector_norm(b - stencil.matvec(res.x))
                        / torch.linalg.vector_norm(b))
    steps, rr_steps = solver.stats["steps"], solver.stats["rr_steps"]
    rec = dict(method=method, iterations=it, converged=bool(res.converged),
               relres=float(res.relres), true_relres=true_relres,
               max_err=float((res.x - 1.0).abs().max()), wall_s=wall,
               ms_per_iteration=wall / max(it, 1) * 1e3, steps=steps,
               rr_steps=rr_steps, host_reads=solver.stats["host_reads"],
               launches=launches)
    log(f"main {method}: {json.dumps(rec)}")
    want = {"fused_dots": steps, "fused_axpy": steps,
            "spmv_ell": 1 + 2 * steps + 4 * rr_steps}
    if not rec["converged"] or true_relres > 1e-6:
        raise SystemExit(f"{method} did not converge: {rec}")
    if launches != want or min(launches.values()) == 0:
        raise SystemExit(f"{method}: launches {launches} != {want}")
    # the steps queued are the iterations, the step that found convergence,
    # and the rest of its chunk
    from repro_torch.core.pipelined_bicgsafe import CHUNK
    if not it + 1 <= steps <= it + CHUNK:
        raise SystemExit(f"{method}: {steps} steps for {it} iterations")
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch
    from repro_torch.core import matrices
    from repro_torch.kernels import _build, ops, ref

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)                        # the card's name and power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    path = _build.library_path()
    if not path.exists():
        report = _build.build(path)
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path.name}")

    # -- 3a. the main path's matrix (built first: phase 2 uses its shape) --
    stencil, b, _ = matrices.convection_diffusion(NX, peclet=0.5,
                                                  dtype=torch.float64)
    ell = matrices.stencil_to_ell(stencil)
    v = torch.randn(ell.n, dtype=torch.float64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    want = stencil.matvec(v)
    for label, got in (("plain", ell.matvec(v)),
                       ("kernel", ops.spmv_ell(ell, v))):
        err = float((got - want).abs().max() / want.abs().max())
        log(f"ELL {label} matvec vs stencil: max_rel_err {err:.3e}")
        if err > 1e-14:
            raise SystemExit(f"ELL {label} matvec disagrees with the stencil")

    # -- 2. kernels against their plain versions ----------------------------
    results = {}
    for dtype in (torch.float64, torch.float32):
        res = check_kernels(torch, ops, ref, ell.values, ell.cols, dtype)
        for kname, rec in res.items():
            if not rec["err"] <= rec["tol"]:
                raise SystemExit(f"{kname} {dtype}: error {rec['err']} above "
                                 f"{rec['tol']}")
        results[str(dtype).replace("torch.", "")] = res
    torch.cuda.empty_cache()

    # -- 3b. the main path ----------------------------------------------------
    runs = [run_main_path(torch, repro_torch, ops, method, ell, stencil, b)
            for method in ("p-bicgsafe", "p-bicgsafe-rr")]
    main, rr = runs
    share = sum(results["float64"][k]["ms"] * main["launches"][k]
                for k in main["launches"]) / (main["wall_s"] * 1e3)
    log(f"main p-bicgsafe: the three kernels' device time is {share:.3f} "
        "of the wall time")

    # -- 4. the kernel table and the result line ------------------------------
    kernels = []
    for kname in ("fused_dots", "fused_axpy", "spmv_ell"):
        r64, r32 = results["float64"][kname], results["float32"][kname]
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/csrc/{kname}.cu",
            replaces=REPLACES[kname], launches=main["launches"][kname],
            max_abs_err=r64["max_abs_err"], ms=r64["ms"],
            plain_ms=r64["plain_ms"], bound_ms=r64["bound"][0],
            bound_by=r64["bound"][1], library_ms=r64["library_ms"],
            passed=True, dtype="float64", max_rel_err=r64["err"],
            tol=r64["tol"], fp32_max_rel_err=r32["err"], fp32_ms=r32["ms"],
            launches_rr=rr["launches"][kname]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
