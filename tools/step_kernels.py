"""Kernels per step of p-BiCGSafe's solve program on the card, by name:
profiler traces of a 16- and a 48-step solve (tol 0, so no step
converges) on chip_smoke.py's 1,259,712-row system, and their difference
over the 32 steps between them (set-up and result cancel).

    python3 tools/step_kernels.py [SRC]

``SRC`` (default ``src``) is the directory holding ``repro_torch``: point
it at another checkout's ``src`` to compare two versions in one call.
Prints the event categories of both traces, the kernels per step, and
the per-step difference of each kernel name.  A CUDA graph's memcpy nodes
(the program's write-back of its state) run either on the copy engines
(category ``gpu_memcpy``) or as kernels named ``memcpy32_post`` /
``memcpy_post``, as CUDA chooses per graph, so the kernel count per step
moves by about one with it.
"""
import collections
import json
import os
import sys


def main() -> None:
    sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else "src")
    import torch

    import repro_torch
    from repro_torch.core import matrices
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("step_kernels: no CUDA device is available")
    _build.library()
    stencil, b, _ = matrices.convection_diffusion(108, peclet=0.5,
                                                  dtype=torch.float64)
    ell = matrices.stencil_to_ell(stencil)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    solver.solve(b, maxiter=2000)

    def trace(steps):
        def run():
            solver.solve(b, tol=0.0, maxiter=steps)
        run()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        os.makedirs("build/profile", exist_ok=True)
        path = f"build/profile/step_kernels_{steps}_{os.getpid()}.json"
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X"]
        names = collections.Counter(e["name"][:70] for e in events
                                    if e.get("cat") == "kernel")
        cats = collections.Counter(e.get("cat") for e in events)
        return names, cats

    k16, c16 = trace(16)
    k48, c48 = trace(48)
    per_step = (sum(k48.values()) - sum(k16.values())) / 32
    print(json.dumps(dict(categories_16=c16, categories_48=c48,
                          kernels_per_step=per_step,
                          programs=solver.stats["programs"],
                          graphs=solver.stats["graphs"])))
    diff = {k: (k48[k] - k16[k]) / 32 for k in set(k16) | set(k48)}
    for name, d in sorted(diff.items(), key=lambda kv: -kv[1]):
        if d:
            print(f"{d:8.3f}  {name}")


if __name__ == "__main__":
    main()
