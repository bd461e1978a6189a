#!/usr/bin/env python3
"""Phase 5's engine burst served by two checkouts of the port in turns, on
one card: requests per second of ``SolveEngine.run()`` with tracing off.

    python3 tools/engine_ab.py OLD_SRC NEW_SRC [--order onno] [--reps 3]

``OLD_SRC`` and ``NEW_SRC`` are the ``src`` directories of two checkouts
(for example the parent commit unpacked with ``git archive`` under
``build/``).  Each letter of ``--order`` is one fresh process on that
checkout (``o`` old, ``n`` new), so the default runs old, new, new, old.
A process builds the checkout's kernels, makes ``chip_smoke.py``'s
108**3 convection-diffusion system in ELL form, registers it with
``SolveEngine(ServiceConfig(max_batch=8, chunk=32, substrate="cuda"))``,
warms the engine with 11 requests, then serves the 32-request burst of
phase 5 (``--seed``; tolerances alternating 1e-8 / 1e-6) ``--reps`` times.
Prints one JSON line per process and a summary: each checkout's req/s, its
mean, and the new mean over the old.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

NX = 108
M = 8
CHUNK = 32
REQUESTS = 32
TOLS = (1e-8, 1e-6)
MAXITER = 2000


def child(src: str, reps: int, seed: int, nx: int, device: str) -> None:
    sys.path.insert(0, src)
    import numpy as np
    import torch

    from repro_torch.core import matrices
    from repro_torch.kernels import _build
    from repro_torch.service import ServiceConfig, SolveEngine
    if device == "cuda":
        path = _build.library_path()
        if not path.exists():
            _build.build(path)
        _build.library()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    stencil, _, _ = matrices.convection_diffusion(nx, peclet=0.5,
                                                  dtype=torch.float64,
                                                  device=device)
    ell = matrices.stencil_to_ell(stencil)
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal((REQUESTS, ell.n))
    tols = [TOLS[i % len(TOLS)] for i in range(REQUESTS)]
    eng = SolveEngine(ServiceConfig(max_batch=M, chunk=CHUNK,
                                    substrate="cuda", tol=1e-8,
                                    maxiter=MAXITER, device=device))
    name = eng.register(ell)

    def burst(k):
        for i in range(k):
            eng.submit(name, rhs[i], tol=tols[i])
        sync()
        t0 = time.perf_counter()
        results = eng.run()
        sync()
        return results, time.perf_counter() - t0

    burst(M + 3)                                    # warm: its captures
    rates, chunks = [], []
    for _ in range(reps):
        eng.stats.update(dict.fromkeys(eng.stats, 0))
        results, wall = burst(REQUESTS)
        if sorted(r.status.name for r in results) != ["CONVERGED"] * REQUESTS:
            raise SystemExit("a request of the burst did not converge")
        rates.append(REQUESTS / wall)
        chunks.append(eng.stats["chunks"])
    print("AB " + json.dumps(dict(src=src, requests_per_s=rates,
                                  chunks=chunks)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--order", default="onno")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nx", type=int, default=NX,
                    help="grid points per side (108: phase 5's system)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.old, args.reps, args.seed, args.nx, args.device)
        return 0
    srcs = {"o": os.path.abspath(args.old), "n": os.path.abspath(args.new)}
    got = {"o": [], "n": []}
    for turn in args.order:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), srcs[turn], "-",
             "--child", "--reps", str(args.reps), "--seed", str(args.seed),
             "--nx", str(args.nx), "--device", args.device],
            capture_output=True, text=True, timeout=900)
        lines = [l for l in p.stdout.splitlines() if l.startswith("AB ")]
        if p.returncode or not lines:
            print(f"{turn}: exit {p.returncode}\n{p.stderr[-3000:]}")
            return 1
        rec = json.loads(lines[-1][3:])
        rec["turn"] = turn
        print(json.dumps(rec), flush=True)
        got[turn] += rec["requests_per_s"]
    old, new = statistics.mean(got["o"]), statistics.mean(got["n"])
    print(json.dumps(dict(old_requests_per_s=got["o"],
                          new_requests_per_s=got["n"], old_mean=old,
                          new_mean=new, new_over_old=new / old)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
