#!/usr/bin/env python3
"""The JAX package's seven methods on the system of ``chip_smoke.py``'s
phases 3b and 3f, on the CPU: the reference outcome that phase 3f holds
the port to (iterations, typed status, recurred and true relres).

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_methods.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_methods.py \\
        --nx 64 --methods cgs

The system is ``repro.core.matrices.convection_diffusion(nx, peclet=0.5)``
in fp64 (nx = 108: 1,259,712 rows), solved through ``repro.make_solver(m,
op, substrate="jnp")`` with tol 1e-8 and maxiter 2,000.  One JSON line per
method.  This runs the reference package, not the port; its times are the
CPU's and say nothing of the card.
"""
from __future__ import annotations

import argparse
import json
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=108)
    ap.add_argument("--methods", nargs="*", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import repro
    from repro.core import SolverConfig, matrices

    op, b, _ = matrices.convection_diffusion(args.nx, peclet=0.5)
    for method in args.methods or sorted(repro.SOLVERS):
        t0 = time.perf_counter()
        res = repro.make_solver(method, op, substrate="jnp", config=SolverConfig(
            tol=1e-8, maxiter=2000)).solve(b)
        true = float(jnp.linalg.norm(b - op.matvec(res.x)) / jnp.linalg.norm(b))
        print(json.dumps(dict(
            nx=args.nx, method=method, iterations=int(res.iterations),
            status=repro.SolveStatus(int(res.status)).name,
            breakdown=bool(res.breakdown), relres=float(res.relres),
            true_relres=true, max_err=float(jnp.abs(res.x - 1.0).max()),
            cpu_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
