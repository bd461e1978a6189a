#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from a checkout of the repository, on a machine with one NVIDIA H100.
It exits non-zero, and prints no result, when no GPU is present or the
package is missing.  Phases, any failure of which fails the run:

1. device: the card's name and power limit, the versions, and the kernels'
   build (one ``nvcc`` call into ``build/``) with its time and the
   compiler's register report;
2. kernels: each single-RHS kernel (``fused_dots``, ``fused_axpy``,
   ``spmv_ell``) against its plain PyTorch version on the card, in fp64 and
   fp32, at the main path's shape (n = 108**3 = 1,259,712 rows, k = 7),
   with its device time beside the plain version's, one PyTorch library
   call's where there is one, and the HBM bound;
2b. batched kernels: the same for ``fused_dots_batched``,
   ``fused_axpy_batched`` (fed a mask with frozen columns whose
   coefficients are NaN: their outputs must be their inputs, bit for bit)
   and ``spmv_ell_batched`` at (1,259,712, 8), the width the JAX package's
   service binds;
3. main path: p-BiCGSafe and p-BiCGSafe-rr through
   ``repro_torch.make_solver(...).solve(b)`` on ``substrate="cuda"`` for
   the 1,259,712-row convection-diffusion system in ELL form, fp64,
   tol 1e-8: convergence, true residual, solution error, wall time, and
   the kernels' launch counters held against the steps the solver ran;
3c. batched path: ``solve_many`` of an (n, 8) block on the same system
   (column 0 is b, the others seeded normal vectors; tol 1e-8 for four
   columns, 1e-6 for four): every column converges with a true residual
   within 100x its tol, column 0 within 2 iterations of 3's solve of b,
   and the batched kernels' launch counters match the steps;
4. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Each path is driven with the launch counters set to 0 just before it and
read just after; the kernels' checks and timings are not counted.
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
                   "spmv_ell": 1e-12, "fused_dots_batched": 1e-12,
                   "fused_axpy_batched": 1e-12, "spmv_ell_batched": 1e-12},
       "float32": {"fused_dots": 2e-5, "fused_axpy": 5e-5, "spmv_ell": 1e-4,
                   "fused_dots_batched": 2e-4, "fused_axpy_batched": 5e-5,
                   "spmv_ell_batched": 1e-4}}
REPLACES = {"fused_dots": "src/repro/kernels/fused_dots.py:63",
            "fused_axpy": "src/repro/kernels/fused_axpy.py:73",
            "spmv_ell": "src/repro/kernels/spmv_ell.py:45",
            "fused_dots_batched": "src/repro/kernels/fused_dots.py:110",
            "fused_axpy_batched": "src/repro/kernels/fused_axpy.py:154",
            "spmv_ell_batched": "src/repro/kernels/spmv_ell.py:99"}
SINGLE = ("fused_dots", "fused_axpy", "spmv_ell")
BATCHED = ("fused_dots_batched", "fused_axpy_batched", "spmv_ell_batched")
M = 8                       # columns of the batched path (ServiceConfig.max_batch)


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
    return finish(out, name)


def finish(out: dict, name: str) -> dict:
    """Attach each kernel's tolerance and log its line."""
    for kname, rec in out.items():
        rec["tol"] = TOL[name][kname]
        lib = "none" if rec["library_ms"] is None \
            else f"{rec['library_ms']:.4f}"
        log(f"kernel {kname:18s} {name}: max_rel_err {rec['err']:.3e} "
            f"(tol {rec['tol']:.0e}) kernel_ms {rec['ms']:.4f} "
            f"plain_ms {rec['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {rec['bound'][0]:.4f} ({rec['bound'][1]})")
    return out


def check_batched_kernels(torch, ops, ref, values, cols, dtype) -> dict:
    """Each batched kernel against its plain version on the card, in
    ``dtype``, on (n, M) blocks."""
    name = str(dtype).replace("torch.", "")
    dev = values.device
    n, k = values.shape
    m = M
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    item = torch.empty((), dtype=dtype).element_size()
    out = {}

    # fused_dots_batched: scale of a dot is sum |a_i b_i|; the library
    # yardstick is the per-column Gram of the five blocks, one bmm
    s, y, r, t, rs = (randn(n, m) for _ in range(5))
    got = ops.fused_dots(s, y, r, t, rs)
    want = ref.fused_dots(s, y, r, t, rs)
    scale = ref.fused_dots(*(v.abs() for v in (s, y, r, t, rs)))
    cols_major = torch.stack([s, y, r, t, rs]).permute(2, 0, 1).contiguous()
    gram_t = cols_major.transpose(1, 2)
    out["fused_dots_batched"] = dict(
        err=float(((got - want).abs() / scale).max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.fused_dots(s, y, r, t, rs)),
        plain_ms=device_ms(torch, lambda: ref.fused_dots(s, y, r, t, rs)),
        library_ms=device_ms(torch, lambda: torch.bmm(cols_major, gram_t)),
        bound=bound_ms(5 * item * n * m + 9 * item * m, 18 * n * m, name))
    del cols_major, gram_t, s, y, r, t, rs

    # fused_axpy_batched: every other column frozen with NaN coefficients;
    # the live columns against the plain version (scale: their max-abs),
    # the frozen ones must be their inputs bit for bit.  Timed with every
    # column live, as in most of a solve.
    from repro_torch.kernels.fused_axpy import IN_ORDER, MASKED_OUT
    vecs = {key: randn(n, m) for key in IN_ORDER}
    scal = randn(4, m)
    mask = torch.arange(m, device=dev) % 2 == 0
    scal[:, ~mask] = float("nan")
    got = ops.fused_axpy(vecs, scal, mask)
    want = ref.fused_axpy(vecs, scal.unbind(0), mask)
    for key in MASKED_OUT:
        if not torch.equal(got[key][:, ~mask], vecs[key][:, ~mask]):
            raise SystemExit(f"fused_axpy_batched {name}: frozen columns of "
                             f"{key} are not their inputs")
    live = {key: (got[key][:, mask] - want[key][:, mask]).abs()
            for key in want}
    err = max(float(live[key].max() / want[key][:, mask].abs().max())
              for key in want)
    max_abs = max(float(v.max()) for v in live.values())
    del got, want, live
    scal = randn(4, m)
    every = torch.ones(m, dtype=torch.bool, device=dev)
    out["fused_axpy_batched"] = dict(
        err=err, max_abs_err=max_abs,
        ms=device_ms(torch, lambda: ops.fused_axpy(vecs, scal, every)),
        plain_ms=device_ms(torch, lambda: ref.fused_axpy(
            vecs, scal.unbind(0), every)),
        library_ms=None,
        bound=bound_ms(22 * item * n * m + 4 * item * m + m, 34 * n * m,
                       name))
    del vecs

    # spmv_ell_batched on the main path's matrix; the library yardstick is
    # cuSPARSE's SpMM through a CSR tensor
    from repro_torch.core.linear_operator import ELLOperator
    op = ELLOperator(values.to(dtype), cols, n)
    x = randn(n, m)
    got = ops.spmv_ell(op, x)
    want = ref.spmv_ell(op.values, op.cols, x)
    crow = torch.arange(0, n * k + 1, k, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(crow, cols.reshape(-1).to(torch.int64),
                                  op.values.reshape(-1), size=(n, n))
    out["spmv_ell_batched"] = dict(
        err=float((got - want).abs().max() / want.abs().max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.spmv_ell(op, x)),
        plain_ms=device_ms(torch, lambda: ref.spmv_ell(op.values, op.cols,
                                                       x)),
        library_ms=device_ms(torch, lambda: csr @ x),
        bound=bound_ms(k * item * n + k * 4 * n + 2 * item * n * m,
                       2 * k * n * m, name))
    return finish(out, name)


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
    want = dict.fromkeys(BATCHED, 0)
    want.update(fused_dots=steps, fused_axpy=steps,
                spmv_ell=1 + 2 * steps + 4 * rr_steps)
    if not rec["converged"] or true_relres > 1e-6:
        raise SystemExit(f"{method} did not converge: {rec}")
    if launches != want or min(launches[kn] for kn in SINGLE) == 0:
        raise SystemExit(f"{method}: launches {launches} != {want}")
    # the steps queued are the iterations, the step that found convergence,
    # and the rest of its chunk
    from repro_torch.core.pipelined_bicgsafe import CHUNK
    if not it + 1 <= steps <= it + CHUNK:
        raise SystemExit(f"{method}: {steps} steps for {it} iterations")
    return rec


def run_batched_path(torch, repro_torch, ops, ell, stencil, b, single_it):
    """One measured ``solve_many`` of an (n, M) block through the front
    door, with the launch counters set to 0 just before it and read just
    after."""
    gen = torch.Generator(device=b.device).manual_seed(3)
    B = torch.stack([b] + [torch.randn(b.shape[0], generator=gen,
                                       device=b.device, dtype=b.dtype)
                           for _ in range(M - 1)], dim=1)
    tol = torch.tensor([1e-8] * (M // 2) + [1e-6] * (M - M // 2),
                       dtype=b.dtype, device=b.device)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    solver.solve_many(B, maxiter=32)                 # warm-up, not counted
    solver.stats.update(steps=0, host_reads=0)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve_many(B, tol=tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    its = [int(v) for v in res.iterations]
    true = (torch.linalg.vector_norm(B - stencil.matvec(res.x), dim=0)
            / torch.linalg.vector_norm(B, dim=0))
    steps = solver.stats["steps"]
    rec = dict(m=M, iterations=its, converged=[bool(v) for v in
                                               res.converged],
               tol=[float(v) for v in tol],
               relres=[float(v) for v in res.relres],
               true_relres=[float(v) for v in true], wall_s=wall,
               ms_per_step=wall / steps * 1e3,
               ms_per_iteration=wall / max(its) * 1e3, steps=steps,
               host_reads=solver.stats["host_reads"], launches=launches,
               single_rhs_iterations=single_it)
    log(f"batched solve_many: {json.dumps(rec)}")
    if not all(rec["converged"]):
        raise SystemExit(f"solve_many: a column did not converge: {rec}")
    if bool((true > 100 * tol).any()):
        raise SystemExit(f"solve_many: true residual above 100 x tol: {rec}")
    if abs(its[0] - single_it) > 2:
        raise SystemExit(f"solve_many: column 0 took {its[0]} iterations, "
                         f"the single-RHS solve of b {single_it}")
    want = dict.fromkeys(SINGLE, 0)
    want.update(fused_dots_batched=steps, fused_axpy_batched=steps,
                spmv_ell_batched=1 + 2 * steps)
    if launches != want or steps == 0:
        raise SystemExit(f"solve_many: launches {launches} != {want}")
    # the device time of one step with every column live, queued back to
    # back (no host gaps); over the solve's wall time per step it is the
    # device's busy share
    from repro_torch.core import multirhs
    st0 = solver.init(B, tol=tol)
    body = multirhs._make_body(solver.sub, solver.block_matvec,
                               solver.config)
    rec["device_ms_per_step"] = device_ms(torch, lambda: body(st0))
    rec["busy_share"] = rec["device_ms_per_step"] / rec["ms_per_step"]
    log(f"batched step: {rec['device_ms_per_step']:.4f} ms of device time "
        f"back to back; busy share {rec['busy_share']:.3f}")
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

    # -- 2 and 2b. kernels against their plain versions ----------------------
    results = {}
    for dtype in (torch.float64, torch.float32):
        res = check_kernels(torch, ops, ref, ell.values, ell.cols, dtype)
        torch.cuda.empty_cache()
        res.update(check_batched_kernels(torch, ops, ref, ell.values,
                                         ell.cols, dtype))
        torch.cuda.empty_cache()
        for kname, rec in res.items():
            if not rec["err"] <= rec["tol"]:
                raise SystemExit(f"{kname} {dtype}: error {rec['err']} above "
                                 f"{rec['tol']}")
        results[str(dtype).replace("torch.", "")] = res

    # -- 3b. the main path ----------------------------------------------------
    runs = [run_main_path(torch, repro_torch, ops, method, ell, stencil, b)
            for method in ("p-bicgsafe", "p-bicgsafe-rr")]
    main, rr = runs
    share = sum(results["float64"][k]["ms"] * main["launches"][k]
                for k in SINGLE) / (main["wall_s"] * 1e3)
    log(f"main p-bicgsafe: the three kernels' device time is {share:.3f} "
        "of the wall time")
    torch.cuda.empty_cache()

    # -- 3c. the batched path ------------------------------------------------
    many = run_batched_path(torch, repro_torch, ops, ell, stencil, b,
                            main["iterations"])
    kernel_ms = sum(results["float64"][k]["ms"] * many["launches"][k]
                    for k in BATCHED)
    log(f"batched solve_many: {many['ms_per_step']:.3f} ms per step, "
        f"{many['ms_per_iteration']:.3f} ms per iteration (of the slowest "
        f"column); the three batched kernels' device time is "
        f"{kernel_ms / (many['wall_s'] * 1e3):.3f} of the wall time "
        f"({kernel_ms / many['steps']:.3f} ms per step)")

    # -- 4. the kernel table and the result line ------------------------------
    kernels = []
    for kname in SINGLE + BATCHED:
        r64, r32 = results["float64"][kname], results["float32"][kname]
        extra = (dict(launches_rr=rr["launches"][kname]) if kname in SINGLE
                 else dict(m=M))
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/csrc/{kname}.cu",
            replaces=REPLACES[kname],
            launches=(main if kname in SINGLE else many)["launches"][kname],
            max_abs_err=r64["max_abs_err"], ms=r64["ms"],
            plain_ms=r64["plain_ms"], bound_ms=r64["bound"][0],
            bound_by=r64["bound"][1], library_ms=r64["library_ms"],
            passed=True, dtype="float64", max_rel_err=r64["err"],
            tol=r64["tol"], fp32_max_rel_err=r32["err"], fp32_ms=r32["ms"],
            fp32_plain_ms=r32["plain_ms"],
            fp32_library_ms=r32["library_ms"],
            fp32_bound_ms=r32["bound"][0], **extra))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
