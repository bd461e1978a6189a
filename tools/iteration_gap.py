"""Iterations of p-BiCGSafe's single-RHS solve against the same right-hand
side's column of a batched solve, in the JAX package and in the port, on
seeded normal right-hand sides (the requests of ``chip_smoke.py``'s phase
5, at a size the CPU takes).

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/iteration_gap.py [--nx 40]

Prints one line per right-hand side and, last, a JSON line with the
largest gap of each package: the two iterations round differently, and
where the residual crosses its tolerance slowly they stop iterations
apart.
"""
import argparse
import json

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nx", type=int, default=40)
    parser.add_argument("--m", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import repro
    import repro_torch
    from repro.core import matrices as JM
    from repro_torch.core import matrices as TM

    jop = JM.convection_diffusion(args.nx, peclet=0.5)[0]
    top = TM.convection_diffusion(args.nx, peclet=0.5, device="cpu")[0]
    ell = TM.stencil_to_ell(top)
    R = np.random.default_rng(args.seed).standard_normal((args.m, top.n))
    tols = [(1e-8, 1e-6)[i % 2] for i in range(args.m)]
    port = repro_torch.make_solver(
        "p-bicgsafe", ell, device="cpu",
        config=repro_torch.SolverConfig(maxiter=2000))
    ref = repro.make_solver("p-bicgsafe", jop,
                            config=repro.core.SolverConfig(maxiter=2000))
    pm = port.solve_many(torch.from_numpy(R.T.copy()),
                         tol=torch.tensor(tols, dtype=torch.float64))
    jm = ref.solve_many(jnp.asarray(R.T), tol=jnp.asarray(tols))
    gaps = {"port": 0, "jax": 0}
    for i in range(args.m):
        p1 = int(port.solve(torch.from_numpy(R[i]), tol=tols[i]).iterations)
        j1 = int(ref.solve(jnp.asarray(R[i]), tol=tols[i]).iterations)
        pb, jb = int(pm.iterations[i]), int(jm.iterations[i])
        gaps["port"] = max(gaps["port"], abs(p1 - pb))
        gaps["jax"] = max(gaps["jax"], abs(j1 - jb))
        print(f"rhs {i} tol {tols[i]:g}: port single {p1} batched {pb}; "
              f"jax single {j1} batched {jb}")
    print(json.dumps(dict(nx=args.nx, m=args.m, seed=args.seed,
                          max_gap=gaps)))


if __name__ == "__main__":
    main()
