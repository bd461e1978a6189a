"""Distributed solver runtime on ``torch.distributed``: halo exchange and
one all-reduce per reduction phase (PyTorch port of
``repro.core.distributed``).

Row-block domain decomposition over a mesh.  The grid's x-dimension is
sharded over *all* mesh dimensions (or ``shard_axes``), flattened
row-major as the JAX package's ``ring_shift`` flattens them: on a
:class:`~torch.distributed.device_mesh.DeviceMesh` that is the order of its
ranks, on a process group (the default one among them) the order of its
group ranks.  Every rank runs the same program (SPMD, as ``shard_map``
does): it holds its own x-slab of every vector, and a neighbour at flat
index -1 / +1 on that ring.

* The matvec (:func:`halo_stencil_matvec`) sends the slab's last x-plane
  forward and its first backward (``isend`` / ``irecv`` in one
  ``batch_isend_irecv``); a missing neighbour gives zeros (Dirichlet).  An
  ``(n_local, m)`` block sends all m columns in one exchange.
* Every inner-product phase of a solver is ONE ``all_reduce(async_op=True)``
  of the stacked partials over the ring's group (:class:`AllReduce`), the
  paper's single global reduction.  The solver bodies start it before the
  iteration's matvec and wait on it after (p-BiCGSafe's dots read none of
  ``A s``), so the collective runs while the halo exchange and the stencil
  do.  On the card the collective is NCCL's and is captured into the
  chunk's CUDA graph like every other step of the loop.

:func:`build_stencil_solver_batched` extends the decomposition to (n, m)
blocks: the block is row-sharded, the halo exchange carries all m columns,
and the one all-reduce per iteration is of the ``(9, m)`` block (``(11,
m)`` guarded), whatever m is.

The right-hand side goes in as the global ``(nx, ny, nz[, m])`` grid on
every rank; each rank takes its own rows.  The result's ``x`` is the
rank's slab ``(nx // shards, ny, nz[, m])`` (the JAX package returns the
sharded global array): :meth:`MeshLayout.gather` assembles the grid.  Its
other fields are derived from all-reduced values and equal on every rank.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..precond.base import PrecondLike, resolve_precond
from ._common import Reducer, SyncCounter
from .linear_operator import Stencil7Operator
from .program import Program
from .substrate import get_substrate
from .types import SolveResult, SolverConfig, derive_config

__all__ = ["AllReduce", "MeshLayout", "check_mesh", "halo_stencil_matvec",
           "build_stencil_solver", "build_stencil_solver_batched",
           "distributed_stencil_solve", "distributed_stencil_solve_batched",
           "replicated_dot_reduce"]


def _shard_local_precond(precond: PrecondLike, c: torch.Tensor,
                         local_shape: Tuple[int, int, int]):
    """Resolve ``precond`` against the LOCAL slab operator.

    A name spec builds from the shard's own ``(nxl, ny, nz)`` stencil
    operator, so every preconditioner is communication-free by
    construction: its tensors describe one slab and its apply reaches no
    other rank (the reductions per iteration are therefore unchanged).
    For ``"jacobi"`` and ``"block_jacobi"`` this is exact (the diagonal is
    constant and z-line blocks never straddle x-slab boundaries); for
    ``"neumann"`` and ``"ssor"`` it is the shard-local (zero-Dirichlet at
    slab boundaries) additive-Schwarz flavour of the global one.

    A :class:`~repro_torch.precond.Preconditioner` instance is passed
    through untouched; its tensors must already be local-slab sized.
    """
    if not isinstance(precond, str):
        return precond
    return resolve_precond(precond, Stencil7Operator(c, *local_shape))


# ---------------------------------------------------------------------------
# the ring and its reduction
# ---------------------------------------------------------------------------

def check_mesh(mesh) -> None:
    """Raise :class:`TypeError` unless ``mesh`` is a DeviceMesh or a
    process group (``None``: the default group)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not (mesh is None or isinstance(mesh, (dist.ProcessGroup,
                                              DeviceMesh))):
        raise TypeError(f"mesh must be a DeviceMesh or a process group; got "
                        f"{type(mesh).__name__}")


def _ring(mesh, shard_axes: Optional[Sequence[str]] = None):
    """This rank's ring: (its global ranks in flat order, the process group
    over them).  ``mesh`` is a DeviceMesh or a process group (``None``:
    the default group)."""
    check_mesh(mesh)
    if mesh is None or isinstance(mesh, dist.ProcessGroup):
        if shard_axes is not None:
            raise ValueError("shard_axes names dimensions of a DeviceMesh; "
                             "a process group has none")
        group = dist.group.WORLD if mesh is None else mesh
        return tuple(dist.get_process_group_ranks(group)), group
    names = tuple(mesh.mesh_dim_names or ())
    axes = names if shard_axes is None else tuple(shard_axes)
    if not axes or any(a not in names for a in axes) \
            or len(set(axes)) != len(axes):
        raise ValueError(f"shard_axes {axes} must name distinct dimensions "
                         f"of the mesh {names}")
    ranks = mesh.mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    # every ring: the shard axes (in the order given) innermost, flattened
    rest = [i for i, a in enumerate(names) if a not in axes]
    order = rest + [names.index(a) for a in axes]
    n_ring = 1
    for a in axes:
        n_ring *= ranks.shape[names.index(a)]
    rings = ranks.permute(order).reshape(-1, n_ring).tolist()
    mine = next(r for r in rings if dist.get_rank() in r)
    if sorted(mine) == sorted(dist.get_process_group_ranks(dist.group.WORLD)):
        return tuple(mine), dist.group.WORLD
    if len(axes) == 1:
        return tuple(mine), mesh.get_group(axes[0])
    # one group per ring; every rank takes part in making each of them
    group, _ = dist.new_subgroups_by_enumeration(rings)
    return tuple(mine), group


class AllReduce(Reducer):
    """The distributed solve's reduction: one ``dist.all_reduce(partials,
    async_op=True)`` (a sum, in place) over ``group`` at the start, the
    work's ``wait()`` at the end."""

    def __init__(self, group=None):
        self.group = group
        super().__init__(self._start, self._wait)

    def _start(self, partials: torch.Tensor):
        partials = partials.contiguous()
        return partials, dist.all_reduce(partials, group=self.group,
                                         async_op=True)

    @staticmethod
    def _wait(handle) -> torch.Tensor:
        partials, work = handle
        work.wait()
        return partials


class MeshLayout:
    """The row-slab decomposition of an ``(nx, ny, nz)`` grid over a mesh.

    Attributes:
      ranks: the ring's global ranks in flat order; ``index`` this rank's
        place on it, ``shards`` its length.
      group: the process group the reductions run over.
      prev / next: the global ranks of the slabs below and above (``None``
        at the ends of the ring: Dirichlet).
      local_shape: ``(nx // shards, ny, nz)``; ``rows`` this rank's slice
        of x-planes.
    """

    def __init__(self, mesh, shard_axes: Optional[Sequence[str]],
                 nx: int, ny: int, nz: int):
        self.ranks, self.group = _ring(mesh, shard_axes)
        self.shards = len(self.ranks)
        if nx % self.shards:
            raise ValueError(f"nx={nx} not divisible by {self.shards} shards")
        self.index = self.ranks.index(dist.get_rank())
        self.prev = self.ranks[self.index - 1] if self.index > 0 else None
        self.next = self.ranks[self.index + 1] \
            if self.index + 1 < self.shards else None
        nxl = nx // self.shards
        self.nx = nx
        self.local_shape = (nxl, ny, nz)
        self.rows = slice(self.index * nxl, (self.index + 1) * nxl)

    def local(self, grid: torch.Tensor, batched: bool = False
              ) -> torch.Tensor:
        """This rank's rows of the global grid ``(nx, ny, nz)`` (``(nx, ny,
        nz, m)`` when ``batched``), flat: ``(n_local,)`` or ``(n_local,
        m)``."""
        want = 4 if batched else 3
        if grid.dim() != want or tuple(grid.shape[:3]) != \
                (self.nx,) + self.local_shape[1:]:
            raise ValueError(
                f"the grid must be ({self.nx}, {self.local_shape[1]}, "
                f"{self.local_shape[2]}{', m' if batched else ''}); got "
                f"{tuple(grid.shape)}")
        slab = grid[self.rows].contiguous()
        return slab.reshape(-1, grid.shape[3]) if batched \
            else slab.reshape(-1)

    def exchange(self, top: torch.Tensor, bot: torch.Tensor):
        """Send ``top`` (the last x-plane) forward and ``bot`` (the first)
        backward; returns the received ``(halo_lo, halo_hi)``, the planes
        ``u[-1]`` of the slab below and ``u[nxl]`` of the slab above, zeros
        where there is none."""
        lo, hi = torch.zeros_like(top), torch.zeros_like(bot)
        ops = []
        if self.next is not None:
            ops += [dist.P2POp(dist.isend, top.contiguous(), self.next),
                    dist.P2POp(dist.irecv, hi, self.next)]
        if self.prev is not None:
            ops += [dist.P2POp(dist.isend, bot.contiguous(), self.prev),
                    dist.P2POp(dist.irecv, lo, self.prev)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return lo, hi

    def gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """The global grid from every rank's slab (one ``all_gather`` over
        the ring's group, put in ring order)."""
        x_local = x_local.contiguous()
        parts = [torch.empty_like(x_local) for _ in self.ranks]
        dist.all_gather(parts, x_local, group=self.group)
        return torch.cat([parts[dist.get_group_rank(self.group, r)]
                          for r in self.ranks], dim=0)


def halo_stencil_matvec(c: torch.Tensor, u_flat: torch.Tensor,
                        layout: MeshLayout) -> torch.Tensor:
    """7-point stencil matvec on the local x-slab with the halo exchange.

    Communication: one plane of ``ny * nz`` (times m) elements to each
    neighbour and one from it, the O(surface) cost that hides the O(1)
    reduction message.  The terms are summed in the order of
    :meth:`Stencil7Operator.matvec`, so one shard computes what the
    single-process operator does, bit for bit.
    """
    nxl, ny, nz = layout.local_shape
    u = u_flat.reshape(nxl, ny, nz, *u_flat.shape[1:])
    halo_lo, halo_hi = layout.exchange(u[-1:], u[:1])
    um = torch.cat([halo_lo, u[:-1]], dim=0)   # u[i-1]
    up = torch.cat([u[1:], halo_hi], dim=0)    # u[i+1]
    zy = torch.zeros_like(u[:, :1])
    vm = torch.cat([zy, u[:, :-1]], dim=1)
    vp = torch.cat([u[:, 1:], zy], dim=1)
    zz = torch.zeros_like(u[:, :, :1])
    wm = torch.cat([zz, u[:, :, :-1]], dim=2)
    wp = torch.cat([u[:, :, 1:], zz], dim=2)
    out = c[0] * u
    out = out + c[1] * um + c[2] * up + c[3] * vm + c[4] * vp \
        + c[5] * wm + c[6] * wp
    return out.reshape(u_flat.shape)


# ---------------------------------------------------------------------------
# distributed solve driver
# ---------------------------------------------------------------------------

def _mesh_parts(op: Stencil7Operator, mesh, shard_axes, precond, syncs):
    """What a built solve holds: the layout, the shard-local
    preconditioner, the halo matvec and the reduction (one all-reduce for
    every dot of a phase, counted by ``syncs`` when given).  One eager
    all-reduce makes the group's communicator now: NCCL cannot make it
    inside a CUDA graph capture."""
    layout = MeshLayout(mesh, shard_axes, op.nx, op.ny, op.nz)
    pc = _shard_local_precond(precond, op.c, layout.local_shape)
    reduce = AllReduce(layout.group)
    reduce(torch.zeros(1, dtype=op.c.dtype, device=op.c.device))
    if syncs is not None:
        reduce = syncs.around(reduce)
    mv = functools.partial(halo_stencil_matvec, op.c, layout=layout)
    return layout, pc, mv, reduce


def _memo(fn: Callable, key, build: Callable[[], Program], stats) -> Program:
    """``fn.programs[key]``, built on its first use (counted in
    ``stats``' ``programs`` and ``traces``, as a session counts)."""
    prog = fn.programs.get(key)
    if prog is None:
        prog = fn.programs[key] = build()
        if stats is not None:
            for name in ("programs", "traces"):
                stats[name] = stats.get(name, 0) + 1
    return prog


def build_stencil_solver(solver: Callable,
                         op: Stencil7Operator,
                         mesh,
                         *,
                         shard_axes: Optional[Sequence[str]] = None,
                         config: SolverConfig = SolverConfig(),
                         substrate="torch",
                         precond: PrecondLike = None,
                         stats: Optional[Dict[str, int]] = None,
                         syncs: Optional[SyncCounter] = None) -> Callable:
    """Build the sharded solve ``fn(b_grid, *, tol=None, maxiter=None) ->
    SolveResult`` of ``solver`` (one of :data:`repro_torch.core.SOLVERS`):
    the ring, the shard-local preconditioner and the halo matvec are made
    once, and ``fn`` memoizes one program per right-hand side's shape and
    dtype in ``fn.programs`` (``tol`` / ``maxiter`` override ``config`` per
    call and run the same program: ``tol`` is a constant buffer of it, as
    in a session).  ``fn``'s ``x`` is this rank's slab; ``fn.layout`` is
    the :class:`MeshLayout`, ``fn.precond`` the local preconditioner;
    ``fn.method``, ``fn.matvec`` (the halo matvec) and ``fn.reduce`` (the
    all-reduce) are what each solve hands
    :func:`~repro_torch.core.pipelined_bicgsafe.prepare_chunked`.

    ``stats`` accumulates ``steps``, ``host_reads``, ``graphs`` and the
    programs built; ``syncs`` counts the all-reduces started (a graph
    replay adds what its capture started).  Every rank builds and calls
    ``fn`` together, and every rank builds its programs at the same call:
    a program's first chunk runs eagerly, collectives included."""
    from . import CHUNKED, SOLVERS
    from .pipelined_bicgsafe import solve_chunked

    names = [k for k, f in SOLVERS.items() if f is solver]
    if not names:
        raise ValueError(f"solver must be one of repro_torch.core.SOLVERS; "
                         f"got {getattr(solver, '__name__', solver)!r}")
    method = CHUNKED[names[0]]
    layout, pc, mv, reduce = _mesh_parts(op, mesh, shard_axes, precond,
                                         syncs)
    counters = () if syncs is None else (syncs,)

    def fn(b_grid, *, tol=None, maxiter=None) -> SolveResult:
        cfg = derive_config(config, tol, maxiter)
        b = layout.local(torch.as_tensor(b_grid, device=op.c.device))
        key = (tuple(b.shape), b.dtype)
        res = solve_chunked(
            method, mv, b, config=cfg, r0_star=None, substrate=substrate,
            precond=pc, dot_reduce=reduce, stats=stats,
            program=lambda step: _memo(fn, key, lambda: Program(
                step, b.device, key, stats=stats, counters=counters),
                stats))
        return res._replace(x=res.x.reshape(layout.local_shape))

    fn.layout, fn.precond, fn.programs = layout, pc, {}
    fn.method, fn.matvec, fn.reduce = method, mv, reduce
    return fn


def distributed_stencil_solve(solver: Callable, op: Stencil7Operator,
                              b_grid, mesh, *,
                              shard_axes: Optional[Sequence[str]] = None,
                              config: SolverConfig = SolverConfig(),
                              substrate="torch",
                              precond: PrecondLike = None) -> SolveResult:
    """Solve the stencil system on ``mesh`` with any solver of
    :data:`repro_torch.core.SOLVERS`; ``b_grid`` is the global ``(nx, ny,
    nz)`` grid.  Deprecated as a direct entry point: it builds the ring,
    the preconditioner and the program on every call;
    ``repro_torch.make_solver(method, op).on_mesh(mesh)`` builds them once."""
    warnings.warn("distributed_stencil_solve is deprecated; use "
                  "repro_torch.make_solver(method, op).on_mesh(mesh)",
                  DeprecationWarning, stacklevel=2)
    return build_stencil_solver(
        solver, op, mesh, shard_axes=shard_axes, config=config,
        substrate=substrate, precond=precond)(b_grid)


def build_stencil_solver_batched(op: Stencil7Operator,
                                 mesh,
                                 *,
                                 shard_axes: Optional[Sequence[str]] = None,
                                 config: SolverConfig = SolverConfig(),
                                 substrate="torch",
                                 precond: PrecondLike = None,
                                 stats: Optional[Dict[str, int]] = None,
                                 syncs: Optional[SyncCounter] = None
                                 ) -> Callable:
    """Build the sharded batched p-BiCGSafe solve ``fn(B_grid, *,
    tol=None, maxiter=None) -> SolveResult`` for any column count m: one
    halo exchange per block matvec carries all m columns, and one
    all-reduce of the ``(9, m)`` partials (``(11, m)`` guarded) per
    iteration.  ``fn.matvec`` is the block halo matvec composed with the
    local M^{-1}, ``fn.prep`` that M^{-1} (``None`` without one),
    ``fn.reduce`` the all-reduce: what each solve builds its state and
    program from.  The rest as in :func:`build_stencil_solver`."""
    from .multirhs import (batched_program, init_state, result_from_state,
                           run_chunks)

    sub = get_substrate(substrate)
    layout, pc, mv, reduce = _mesh_parts(op, mesh, shard_axes, precond,
                                         syncs)
    counters = () if syncs is None else (syncs,)
    # the same bound M^{-1} serves the (n_local, m) block
    papply = None if pc is None else sub.as_precond_apply(pc)
    bmv = mv if papply is None else (lambda X: papply(mv(X)))

    def fn(B_grid, *, tol=None, maxiter=None) -> SolveResult:
        cfg = derive_config(config, tol, maxiter)
        B = layout.local(torch.as_tensor(B_grid, device=op.c.device),
                         batched=True)
        if papply is not None:
            B = papply(B)
        key = (tuple(B.shape), B.dtype)
        # no r0_star: a global shadow block would have to be row-sharded
        # alongside B for the per-shard partial dots to be right; the
        # default (RS = R0, already local) is what the single-RHS driver
        # uses too
        st = init_state(bmv, B, config=cfg, substrate=sub,
                        dot_reduce=reduce)
        prog = _memo(fn, key, lambda: batched_program(
            bmv, cfg, sub, stats, device=B.device, key=key,
            dot_reduce=reduce, counters=counters), stats)
        res = result_from_state(run_chunks(prog, st, cfg.maxiter, stats))
        return res._replace(x=res.x.reshape(*layout.local_shape,
                                            B.shape[1]))

    fn.layout, fn.precond, fn.programs = layout, pc, {}
    fn.matvec, fn.prep, fn.reduce = bmv, papply, reduce
    return fn


def distributed_stencil_solve_batched(op: Stencil7Operator, B_grid, mesh, *,
                                      shard_axes: Optional[Sequence[str]]
                                      = None,
                                      config: SolverConfig = SolverConfig(),
                                      substrate="torch",
                                      precond: PrecondLike = None
                                      ) -> SolveResult:
    """Batched multi-RHS stencil solve sharded over ``mesh``: ``B_grid`` is
    the global ``(nx, ny, nz, m)`` block.  Deprecated as a direct entry
    point: use ``repro_torch.make_solver("p-bicgsafe", op).on_mesh(mesh)
    .solve_many(B_grid)``."""
    warnings.warn("distributed_stencil_solve_batched is deprecated; use "
                  'repro_torch.make_solver("p-bicgsafe", op).on_mesh(mesh)'
                  ".solve_many(B)", DeprecationWarning, stacklevel=2)
    return build_stencil_solver_batched(
        op, mesh, shard_axes=shard_axes, config=config, substrate=substrate,
        precond=precond)(B_grid)


def replicated_dot_reduce(mesh=None,
                          shard_axes: Optional[Sequence[str]] = None
                          ) -> AllReduce:
    """``dot_reduce`` for custom SPMD code: one all-reduce over the ring of
    ``mesh`` (a DeviceMesh, a process group, ``None``: the default
    group)."""
    return AllReduce(_ring(mesh, shard_axes)[1])
