"""Production-mesh dry run of the paper's own workload: the distributed
pipelined solvers on a large 3-D stencil system (PyTorch port of
``repro.launch.dryrun_solver``).

Default problem: the 2048 x 1024 x 1024 grid (2.15e9 fp64 unknowns), the
7-point ``Stencil7Operator`` x-sharded over every rank of the fake group
(256, or 512 with ``--multi-pod``) through ``core.distributed
.build_stencil_solver``: 8 (or 4) x-planes of 1024 x 1024 a rank, 67.1 MB
a vector; p-BiCGSafe holds the 15 vectors of the paper's Table 3.1.

One iteration is counted, as the JAX record's ``per_iteration``: one step
of the session's program (``pipelined_bicgsafe.prepare_chunked``'s body)
traced in fake mode, not ``solve``, whose stop test reads the device.  The
process is rank 1 of the fake group, a slab with a neighbour on each side,
so its halo is the interior one: per matvec one plane sent and one received
each way.  The record (``experiments/torch_dryrun/<mesh>/solver-<name>
__poisson<nx>x<ny>x<nz>.json``) holds that rank's memory (the state's
bytes, ``vectors`` of them, and the step's peak), its FLOPs and bytes of
one iteration (``per_rank``: the step runs on the local slab) and its
collectives: the paper's one all-reduce an iteration, and the halo's
``send`` / ``recv`` planes.  The substrate is ``"cuda"``, the card's path:
the fused dots and the fused update are ops, counted by their formulas
and by the bytes they write.

  python -m repro_torch.launch.dryrun_solver --solver p-bicgsafe [--multi-pod]
  python -m repro_torch.launch.dryrun_solver --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import SOLVERS, SolverConfig
from repro_torch.core.distributed import build_stencil_solver
from repro_torch.core.linear_operator import Stencil7Operator
from repro_torch.core.pipelined_bicgsafe import prepare_chunked

from .dryrun import OUT, local_bytes
from .flops import Counter
from .mesh import fake_group, mesh_name

#: the fake group's rank the dry run traces as: an interior slab
RANK = 1
#: the card's path (on CPU tensors the ops run their plain versions)
SUBSTRATE = "cuda"


def build_step(solver_name: str, mesh, nx: int, ny: int, nz: int,
               dtype=torch.float64, maxiter: int = 500, device="cpu",
               fake: bool = True):
    """The sharded solve's one iteration on ``mesh`` (a DeviceMesh or a
    process group): ``(step, state, consts, fn)``, ``step(state, consts)``
    the program's body, the state a right-hand side of ones on this rank's
    slab; with ``fake`` the state is made under a fake mode (the ring, the
    halo matvec and the all-reduce are built for real first)."""
    c = torch.tensor([6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0], dtype=dtype,
                     device=device)
    op = Stencil7Operator(c, nx, ny, nz)
    cfg = SolverConfig(tol=1e-8, maxiter=maxiter)
    fn = build_stencil_solver(SOLVERS[solver_name], op, mesh, config=cfg,
                              substrate=SUBSTRATE)
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    with mode:
        # this rank's slab alone (the API's global grid on every rank
        # would be held by the slab's view)
        b = torch.ones(fn.layout.local_shape, dtype=dtype,
                       device=device).reshape(-1)
        body, state, consts = prepare_chunked(
            fn.method, fn.matvec, b, config=cfg, r0_star=None,
            substrate=SUBSTRATE, precond=fn.precond, dot_reduce=fn.reduce)

    def step(st, cs):
        return body(st, cs, False)
    return step, state, consts, fn


def count_steps(step, state, consts, steps: int = 1) -> Dict[str, Any]:
    """Run one iteration (the set-up's state shares storages between its
    vectors; one step gives each its own), then ``steps`` under a
    :class:`~repro_torch.launch.flops.Counter` (fake or real tensors
    alike); returns per iteration ``flops``, ``bytes``, ``dot_bytes`` and
    ``collectives`` (counts, result and wire bytes by kind), and the bytes
    of the state and constants the counted steps start from and the
    peak."""
    state = step(state, consts)
    with Counter(track_memory=True) as c:
        arg = c.hold((state, consts))
        for _ in range(steps):
            state = step(state, consts)
    coll = c.collectives()
    per = {k: v / steps for k, v in c.totals().items()}
    per["collectives"] = {
        "counts": {k: v / steps for k, v in coll["counts"].items()},
        "result_bytes": {k: v / steps
                         for k, v in coll["result_bytes"].items()},
        "wire_bytes": {k: v / steps for k, v in coll["wire_bytes"].items()},
        "total_wire_bytes": coll["total_wire_bytes"] / steps}
    per["argument_size_in_bytes"] = arg
    per["peak_memory_in_bytes"] = c.peak_bytes
    per["state"] = state
    return per


def run_cell(solver_name: str, multi_pod: bool, outdir: Path = OUT,
             nx: int = 2048, ny: int = 1024, nz: int = 1024,
             dtype=torch.float64, maxiter: int = 500, force: bool = False,
             tag: str = "") -> dict:
    name = mesh_name(multi_pod)
    cell = f"solver-{solver_name}{tag}__poisson{nx}x{ny}x{nz}"
    out = Path(outdir) / name / f"{cell}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    out.parent.mkdir(parents=True, exist_ok=True)
    rec: Dict[str, Any] = {"arch": f"solver-{solver_name}{tag}",
                           "shape": f"poisson{nx}x{ny}x{nz}", "mesh": name}
    t0 = time.perf_counter()
    try:
        with fake_group(multi_pod, RANK):
            step, state, consts, fn = build_step(
                solver_name, None, nx, ny, nz, dtype, maxiter)
            with FakeTensorMode(allow_non_fake_inputs=True):
                per = count_steps(step, state, consts)
            layout = fn.layout
        vec = layout.local_shape[0] * ny * nz * dtype.itemsize
        rec.update({
            "status": "ok",
            "trace_s": round(time.perf_counter() - t0, 2),
            "rank": RANK, "shards": layout.shards,
            "local_shape": list(layout.local_shape),
            "memory": {
                "argument_size_in_bytes": per["argument_size_in_bytes"],
                "output_size_in_bytes": local_bytes(per["state"]),
                "peak_memory_in_bytes": per["peak_memory_in_bytes"],
                "vector_bytes": vec,
                "vectors": per["argument_size_in_bytes"] / vec},
            "analytic_global_flops": per["flops"],
            "analytic_global_bytes": per["bytes"],
            "analytic_global_dot_bytes": per["dot_bytes"],
            "per_iteration": True,
            "per_rank": True,
            "collectives": per["collectives"],
        })
        counts = per["collectives"]["counts"]
        print(f"[ok] {name} {cell}: trace {rec['trace_s']:.1f}s state "
              f"{per['argument_size_in_bytes'] / 1e9:.3f} GB "
              f"({rec['memory']['vectors']:.1f} vectors of "
              f"{vec / 1e6:.1f} MB), all-reduces/iter "
              f"{counts.get('all-reduce', 0):g}, sends/iter "
              f"{counts.get('send', 0):g}", flush=True)
    except Exception as e:  # noqa: BLE001 - record the cell, go on
        rec.update(status="error", error=str(e)[-4000:],
                   traceback=traceback.format_exc()[-8000:])
        print(f"[ERR] {name} {cell}: {str(e)[:300]}", flush=True)
    out.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="p-bicgsafe")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nz", type=int, default=1024)
    ap.add_argument("--maxiter", type=int, default=500)
    args = ap.parse_args(argv)

    solvers = list(SOLVERS) if args.all else [args.solver]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    dtype = torch.float32 if args.fp32 else torch.float64
    tag = "-fp32" if args.fp32 else ""
    n_err = 0
    for mp in meshes:
        for s in solvers:
            rec = run_cell(s, mp, Path(args.out), nx=args.nx, ny=args.ny,
                           nz=args.nz, dtype=dtype, maxiter=args.maxiter,
                           force=args.force, tag=tag)
            n_err += rec.get("status") == "error"
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
