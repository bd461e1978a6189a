#!/usr/bin/env python3
"""How often does a solver chunk's CUDA graph capture fail, on the card,
once a one-rank NCCL process group exists, under each capture error mode,
with Python's cyclic garbage collector held off during a capture (as
``repro_torch.core.program`` does) or left on?

    python3 tools/capture_mode_probe.py

Each variant runs in a fresh process: the group and its ``(1,)`` mesh are
made, then the seven methods x REPS fresh sessions each solve the
24**3 convection-diffusion system single-process and on the mesh (their
chunks captured).  A session bound to a mesh and its binding refer to each
other, so each dropped session is left to the collector.  The variant
gives ``torch.cuda.graph`` its capture error mode and, for "collector on",
replaces ``program._collector_held`` by a no-op.  Prints one line per
variant: the failed solves, the collector's runs that fell inside a
capture, and the errors (ROADMAP C17).
"""
import contextlib
import gc
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REPS = 6
METHODS = ("bicgstab", "cgs", "gpbicg", "p-bicgsafe", "p-bicgsafe-rr",
           "p-bicgstab", "ssbicgsafe2")
VARIANTS = tuple(f"{mode}/{gc_}" for mode in ("global", "thread_local",
                                              "relaxed")
                 for gc_ in ("collector held", "collector on"))


def run(variant):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    from repro_torch.core import matrices as TM
    from repro_torch.core import program
    mode, gc_ = variant.split("/")
    real = torch.cuda.graph

    def graph(*args, **kw):
        return real(*args, **dict(kw, capture_error_mode=mode))
    torch.cuda.graph = graph
    capturing, in_capture = [False], [0]
    held = program._collector_held if gc_ == "collector held" \
        else contextlib.nullcontext

    @contextlib.contextmanager
    def marked():
        capturing[0] = True
        try:
            with held():
                yield
        finally:
            capturing[0] = False
    program._collector_held = marked

    def on_gc(phase, info):
        if phase == "start" and capturing[0]:
            in_capture[0] += 1
    gc.callbacks.append(on_gc)
    store = tempfile.mktemp()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("rows",))
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    fails, errors = 0, set()
    for rep in range(REPS):
        for method in METHODS:
            repro_torch.clear_session_cache()
            s = repro_torch.make_solver(method, op, substrate="cuda",
                                        config=repro_torch.SolverConfig(
                                            tol=1e-8 * (1 + rep)))
            try:
                s.solve(b)
                s.on_mesh(mesh).solve(b.reshape(24, 24, 24))
                torch.cuda.synchronize()
            except RuntimeError as exc:     # a failed capture, reported
                fails += 1
                errors.add(str(exc)[-160:])
    print(f"{variant}: {fails} of {REPS * len(METHODS)} sessions failed a "
          f"capture (single-process, then on the mesh); {in_capture[0]} "
          f"collector runs inside a capture; {sorted(errors)}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run(sys.argv[1])
        sys.exit(0)
    for variant in VARIANTS:
        try:
            p = subprocess.run([sys.executable, __file__, variant],
                               capture_output=True, text=True, timeout=300)
            out = [l for l in p.stdout.splitlines()
                   if l.startswith(variant)]
            print(out[-1] if out else f"{variant}: rc {p.returncode} "
                  f"{p.stderr[-1500:]}", flush=True)
        except subprocess.TimeoutExpired:
            print(f"{variant}: timeout", flush=True)
