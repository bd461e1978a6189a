"""One rank of the port's distributed checks: gloo processes on the CPU.

    python tests/_torch_distributed_child.py RANK WORLD STORE INPUTS OUTDIR
    python tests/_torch_distributed_child.py RANK WORLD STORE INPUTS OUTDIR \
        analysis

Spawned by ``tests/test_torch_distributed.py`` (and, with ``analysis``,
the contract audit's mesh cells, by ``tests/test_torch_analysis.py``),
WORLD processes at once, each with its own RANK; they meet through the
``file://`` store STORE.
INPUTS is an ``.npz`` of the problem (the stencil's coefficients ``c``, the
grid ``shape``, the right-hand side ``b`` and the block ``B``); rank 0
writes what the cases of this world size read to OUTDIR (``arrays.npz``
and ``scalars.json``) for the test to hold against the JAX package.  Every
rank runs every case (the solves are SPMD).  It imports ``repro_torch``
only, never ``jax``.
"""
import json
import os
import sys
import tempfile
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro_torch
from repro_torch import SolverConfig, api
from repro_torch.core import Stencil7Operator, distributed

METHODS = ("p-bicgsafe", "p-bicgsafe-rr", "ssbicgsafe2", "p-bicgstab",
           "bicgstab", "gpbicg", "cgs")
MESHES = {"8": ((8,), ("rows",)), "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CFG = SolverConfig(tol=1e-8, maxiter=2000)


class Run:
    """The case results rank 0 writes: named arrays and scalars."""

    def __init__(self, op, b, B):
        self.op, self.b, self.B = op, b, B
        self.grid = b.reshape(op.nx, op.ny, op.nz)
        self.arrays, self.scalars = {}, {}

    def session(self, method="p-bicgsafe", **kw):
        return repro_torch.make_solver(method, self.op, device="cpu",
                                       config=kw.pop("config", CFG), **kw)

    def keep(self, name, res, layout, batched=False):
        """The case's global ``x`` (gathered through ``layout``, the
        :class:`MeshLayout` of the mesh it was solved on), iterations and
        status."""
        x = layout.gather(res.x)
        self.arrays[name + "/x"] = x.reshape(self.op.n, -1).squeeze(-1) \
            .numpy() if not batched else x.reshape(self.op.n, -1).numpy()
        self.scalars[name] = dict(
            iterations=np.asarray(res.iterations).tolist(),
            converged=np.asarray(res.converged).tolist(),
            status=np.asarray(res.status).tolist())

    def keep_trace(self, name, res):
        """A traced mesh solve's ring (rank 0's), its step count, and
        whether every rank of the world holds the same ring (gathered
        from each)."""
        buf = torch.from_numpy(res.trace.buffer)
        parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, buf)
        self.arrays[name + "/trace"] = res.trace.buffer
        self.scalars[name + "/trace"] = dict(
            steps=res.trace.steps, iterations=int(res.iterations),
            same_on_every_rank=all(
                np.array_equal(p.numpy(), res.trace.buffer, equal_nan=True)
                for p in parts))

    def syncs_per_iteration(self, binding, **solve_kw):
        """Reductions started per step: two solves of 16 and 32 steps
        (tol 0: none stops), the difference over 16."""
        counts = []
        for maxiter in (16, 32):
            binding.syncs.calls = 0
            binding.solve(self.grid, tol=0.0, maxiter=maxiter, **solve_kw)
            counts.append(binding.syncs.calls)
        return (counts[1] - counts[0]) / 16


def world8(run: Run):
    for mname, (shape, names) in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        layout = distributed.MeshLayout(mesh, None, *run.grid.shape)
        for method in METHODS:
            binding = run.session(method).on_mesh(mesh)
            run.keep(f"{mname}/{method}", binding.solve(run.grid), layout)
        if mname in ("8", "4x2"):
            binding = run.session().on_mesh(mesh)
            binding.syncs.shapes.clear()     # the single-RHS solves' (9,)
            B_grid = run.B.reshape(*run.grid.shape, -1)
            run.keep(f"{mname}/many", binding.solve_many(B_grid), layout,
                     batched=True)
            run.scalars[f"{mname}/many/shapes"] = sorted(binding.syncs.shapes)
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("rows",))
    layout = distributed.MeshLayout(mesh, None, *run.grid.shape)
    for method in METHODS:
        run.scalars[f"syncs/{method}"] = run.syncs_per_iteration(
            run.session(method).on_mesh(mesh))
    binding = run.session(substrate="cuda").on_mesh(mesh)
    run.keep("8/p-bicgsafe/cuda", binding.solve(run.grid), layout)
    # guarded against unguarded, the JAX check_guarded_numeric block
    B2 = torch.stack([run.b, 0.5 * run.b], dim=1).reshape(*run.grid.shape, 2)
    for guard in (False, True):
        binding = run.session(
            config=SolverConfig(tol=1e-8, maxiter=2000, guard=guard)
        ).on_mesh(mesh)
        binding.syncs.shapes.clear()
        run.keep(f"guard={guard}", binding.solve_many(B2), layout,
                 batched=True)
        run.scalars[f"guard={guard}/shapes"] = sorted(binding.syncs.shapes)
    for pc in ("block_jacobi", "jacobi"):
        binding = run.session(precond=pc).on_mesh(mesh)
        run.keep(f"precond/{pc}", binding.solve(run.grid), layout)
        run.scalars[f"syncs/precond/{pc}"] = run.syncs_per_iteration(binding)
    # shard_axes: x over "model" only, "data" replicating; and over two of
    # three dimensions, "pod" replicating (a process group per ring)
    for mname, shape, names, axes in (
            ("4x2[model]", (4, 2), ("data", "model"), ("model",)),
            ("2x2x2[data,model]", (2, 2, 2), ("pod", "data", "model"),
             ("data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        layout = distributed.MeshLayout(mesh, axes, *run.grid.shape)
        res = run.session().on_mesh(mesh, shard_axes=axes).solve(run.grid)
        run.keep(f"{mname}/p-bicgsafe", res, layout)
        run.scalars[f"{mname}/shards"] = run.op.nx // res.x.shape[0]


def world4(run: Run):
    for mname, shape, names in (("4", (4,), ("rows",)),
                                ("2x2", (2, 2), ("data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        layout = distributed.MeshLayout(mesh, None, *run.grid.shape)
        for method in METHODS:
            binding = run.session(method).on_mesh(mesh)
            run.keep(f"{mname}/{method}", binding.solve(run.grid), layout)
        if mname == "4":
            run.keep_trace("4/traced", run.session().on_mesh(mesh).solve(
                run.grid, trace=True))


def world2(run: Run):
    group = dist.group.WORLD
    layout = distributed.MeshLayout(group, None, *run.grid.shape)
    for method in METHODS:
        binding = run.session(method).on_mesh(group)
        run.keep(f"2/{method}", binding.solve(run.grid), layout)
    run.keep_trace("2/traced", run.session().on_mesh(group).solve(
        run.grid, trace=True))
    sess = run.session()
    run.scalars["same_binding"] = sess.on_mesh(group) is sess.on_mesh(group)
    odd = Stencil7Operator(run.op.c, run.op.nx - 1, run.op.ny, run.op.nz)
    try:
        repro_torch.make_solver("p-bicgsafe", odd, device="cpu") \
            .on_mesh(group).solve(torch.zeros(odd.nx, odd.ny, odd.nz,
                                              dtype=run.b.dtype))
        run.scalars["indivisible"] = "no error"
    except ValueError as exc:
        run.scalars["indivisible"] = f"ValueError: {exc}"
    run.scalars["order"] = recorded_step(run, group)
    # the free functions of the JAX package's module, deprecated as there
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run.keep("2/free/p-bicgsafe", distributed.distributed_stencil_solve(
            repro_torch.core.pbicgsafe_solve, run.op, run.grid, group,
            config=CFG), layout)
        run.keep("2/free/many", distributed.distributed_stencil_solve_batched(
            run.op, run.B.reshape(*run.grid.shape, -1), group, config=CFG),
            layout, batched=True)
    run.scalars["deprecated"] = sorted({w.category.__name__ for w in caught})
    run.scalars["replicated"] = distributed.replicated_dot_reduce()(
        torch.ones(3, dtype=torch.float64)).tolist()


def recorded_step(run: Run, group):
    """The events of one p-BiCGSafe solve of one step, in order: each
    all-reduce's start and wait, each halo exchange's sends, and each
    halo matvec's end."""
    log = []
    real = (dist.all_reduce, dist.batch_isend_irecv,
            distributed.halo_stencil_matvec)

    class Work:
        def __init__(self, work):
            self.work = work

        def wait(self):
            self.work.wait()
            log.append("reduce_wait")

    def all_reduce(tensor, *a, **kw):
        log.append("reduce_start")
        return Work(real[0](tensor, *a, **kw))

    def batch_isend_irecv(ops):
        log.append("halo_send")
        return real[1](ops)

    def halo_stencil_matvec(*a, **kw):
        out = real[2](*a, **kw)
        log.append("matvec_end")
        return out

    dist.all_reduce, dist.batch_isend_irecv = all_reduce, batch_isend_irecv
    distributed.halo_stencil_matvec = halo_stencil_matvec
    try:
        # a session of its own: its binding takes the recording matvec
        sess = repro_torch.make_solver(
            "p-bicgsafe", run.op, device="cpu",
            config=SolverConfig(tol=1e-8, maxiter=1, record_history=True))
        sess.on_mesh(group).solve(run.grid)
    finally:
        dist.all_reduce, dist.batch_isend_irecv, \
            distributed.halo_stencil_matvec = real
    return log


def world1(run: Run):
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("rows",))
    layout = distributed.MeshLayout(mesh, None, *run.grid.shape)
    for method in METHODS:
        sess = run.session(method)
        single = sess.solve(run.b)
        binding = sess.on_mesh(mesh)
        res = binding.solve(run.grid)
        run.keep(f"1/{method}", res, layout)
        run.scalars[f"1/{method}/bitwise"] = bool(
            torch.equal(res.x.reshape(-1), single.x)
            and int(res.iterations) == int(single.iterations))
    B_grid = run.B.reshape(*run.grid.shape, -1)
    for name, kw in (("many", {}), ("guard", dict(
            config=SolverConfig(tol=1e-8, maxiter=2000, guard=True)))):
        sess = run.session(**kw)
        single = sess.solve_many(run.B)
        res = sess.on_mesh(mesh).solve_many(B_grid)
        run.scalars[f"1/{name}/bitwise"] = bool(
            torch.equal(res.x.reshape(run.B.shape), single.x)
            and torch.equal(res.iterations, single.iterations))
    # traced and profiled mesh solves: bitwise the single-process ones
    sess = run.session()
    binding = sess.on_mesh(mesh)
    single = sess.solve(run.b, trace=True)
    res = binding.solve(run.grid, trace=True)
    run.keep_trace("1/traced", res)
    run.arrays["1/single/trace"] = single.trace.buffer
    with tempfile.TemporaryDirectory() as out:
        profiled = binding.solve(run.grid, profile=out)
        profile_ok = os.path.exists(os.path.join(out, "profile.json"))
    many = binding.solve_many(B_grid, trace=True)
    single_many = sess.solve_many(run.B, trace=True)
    run.scalars["1/refused"] = [
        same_trace(res, single) and torch.equal(res.x.reshape(-1), single.x),
        profile_ok and torch.equal(profiled.x, res.x)
        and sess.last_profile.phase_us["reduce"] > 0,
        same_trace(many, single_many)
        and torch.equal(many.x.reshape(run.B.shape), single_many.x)]
    sess = run.session(precond="block_jacobi")
    single = sess.solve(run.b)
    res = sess.on_mesh(mesh).solve(run.grid)
    run.scalars["1/block_jacobi/bitwise"] = bool(
        torch.equal(res.x.reshape(-1), single.x)
        and int(res.iterations) == int(single.iterations))
    single = sess.solve_many(run.B)
    res = sess.on_mesh(mesh).solve_many(B_grid)
    run.scalars["1/block_jacobi_many/bitwise"] = bool(
        torch.equal(res.x.reshape(run.B.shape), single.x)
        and torch.equal(res.iterations, single.iterations))
    run.scalars["1/eviction"] = evicted_binding(run, mesh)


def same_trace(a, b) -> bool:
    return a.trace.steps == b.trace.steps and np.array_equal(
        a.trace.buffer, b.trace.buffer, equal_nan=True)


def evicted_binding(run: Run, mesh) -> dict:
    """A session evicted by the cache's byte budget releases its own
    programs and keeps its mesh binding's: a rank never rebuilds (and
    warms, collectives included) a mesh program on its own."""
    sess = run.session(config=SolverConfig(tol=1e-8, maxiter=1999))
    binding = sess.on_mesh(mesh)
    sess.solve(run.b)
    binding.solve(run.grid)
    mesh_bytes, programs = binding.nbytes, sess.stats["programs"]
    budget = api._SESSION_CACHE_BYTES
    api._SESSION_CACHE_BYTES = 0
    try:
        run.session("bicgstab").solve(run.b)        # evicts ``sess``
    finally:
        api._SESSION_CACHE_BYTES = budget
    out = dict(own_released=not sess._programs,
               mesh_kept=binding.nbytes == mesh_bytes > 0)
    binding.solve(run.grid)
    out["rebuilt"] = sess.stats["programs"] - programs
    return out


def analysis(run: Run):
    """The contract audit's mesh cells on this world's default group, each
    report as a dict, and a session binding's own ``verify_contracts``."""
    from repro_torch.analysis import run_passes, trace_binding
    from repro_torch.analysis.audit import mesh_cells
    group = dist.group.WORLD
    for kw in mesh_cells():
        rep = run_passes(trace_binding(
            kw["method"], run.op, binding="mesh", substrate=kw["substrate"],
            guard=kw["guard"], precond=kw["precond"], m=3, mesh=group,
            device="cpu"))
        run.scalars[f"analysis/{rep.spec.label}"] = rep.to_dict()
    for method in ("p-bicgsafe", "ssbicgsafe2"):
        rep, = run.session(method).on_mesh(group).verify_contracts()
        run.scalars[f"verify/{method}"] = rep.to_dict()


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, outdir = sys.argv[3:6]
    mode = sys.argv[6] if len(sys.argv) > 6 else None
    torch.set_num_threads(1)            # one thread a rank
    torch.set_num_interop_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        data = np.load(inputs)
        nx, ny, nz = (int(v) for v in data["shape"])
        op = Stencil7Operator(torch.from_numpy(data["c"]), nx, ny, nz)
        run = Run(op, torch.from_numpy(data["b"]),
                  torch.from_numpy(data["B"]))
        if mode == "analysis":
            analysis(run)
        else:
            {8: world8, 4: world4, 2: world2, 1: world1}[world](run)
        if rank == 0:
            os.makedirs(outdir, exist_ok=True)
            np.savez(os.path.join(outdir, "arrays.npz"), **run.arrays)
            with open(os.path.join(outdir, "scalars.json"), "w") as f:
                json.dump(run.scalars, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)        # the other ranks' collectives fail, not hang
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
