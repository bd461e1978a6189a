"""Trace session bindings into analyzable FX graphs: no solve runs
(counterpart of ``repro.analysis.trace``).

The contract passes are static: they read the FX graph of ONE solver
step, ``step(state, consts, replace)``, the callable a session's
:class:`~repro_torch.core.program.Program` captures as a CUDA graph,
never its outputs.  :func:`trace_binding` builds that step for any cell of
the scenario matrix (method x substrate x binding kind x guard x precond x
mesh) with the library's own set-up (:func:`~repro_torch.core
.pipelined_bicgsafe.prepare_chunked`, :func:`~repro_torch.core.multirhs
.batched_program`, the sharded solves' parts) and traces it with ``make_fx``
in fake mode: the method's ``init`` runs under the same
:class:`FakeTensorMode`, so no kernel and no matvec runs.

Two instrumentation tags mark the local bindings, both identity
``torch.library`` ops that return a clone (so the traced step IS the
production step's dataflow, with one node more per tag):

* every reduction a step starts goes through ``repro_torch::mark_reduce``
  (:data:`TAGGED_REDUCE`, a :class:`~repro_torch.core._common.Reducer`
  whose start marks the partials);
* the operator's matvec output goes through ``repro_torch::mark_matvec``,
  so the overlap pass can ask whether a reduction transitively consumes
  the in-flight matvec.

Being ops, the tags need no marker shape (the JAX package's
``REDUCE_MARK_DIM`` has no counterpart).  Mesh bindings need no tags:
there the reduction IS the binding's all-reduce (``c10d::allreduce_``)
and the halo exchange IS its ``c10d::recv_`` writes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
import torch.utils._pytree as pytree
from torch import Tensor, fx
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from ..core import CHUNKED, SOLVERS
from ..core._common import Reducer
from ..core.linear_operator import Stencil7Operator
from ..core.multirhs import batched_program, init_state
from ..core.pipelined_bicgsafe import prepare_chunked
from ..core.substrate import get_substrate
from ..core.types import SolverConfig, resolve_device
from ..kernels.ops import KERNEL_OPS, NAMESPACE
from .fx_tools import find_op_nodes, op_name
from .report import BindingSpec

__all__ = ["TracedBinding", "trace_binding", "trace_fn", "tag_reduce",
           "tag_matvec", "TAGGED_REDUCE", "mark_reduce", "mark_matvec",
           "MARK_REDUCE", "MARK_MATVEC", "ALLREDUCE", "HALO_RECV",
           "BINDINGS"]

MARK_REDUCE = f"{NAMESPACE}::mark_reduce"
MARK_MATVEC = f"{NAMESPACE}::mark_matvec"
#: the mesh binding's reduction and halo receive
ALLREDUCE = "c10d::allreduce_"
HALO_RECV = "c10d::recv_"
#: the solver kernels' ops (``kernel_backed`` counts them)
KERNELS = frozenset(f"{NAMESPACE}::{k}" for k in KERNEL_OPS)
BINDINGS = ("single", "batched", "open_loop", "mesh")


@torch.library.custom_op(MARK_REDUCE, mutates_args=())
def mark_reduce(partials: Tensor) -> Tensor:
    """Identity tag of a reduction's partial block (a clone)."""
    return partials.clone()


@mark_reduce.register_fake
def _(partials):
    return torch.empty_like(partials)


@torch.library.custom_op(MARK_MATVEC, mutates_args=())
def mark_matvec(y: Tensor) -> Tensor:
    """Identity tag of a matvec's output (a clone)."""
    return y.clone()


@mark_matvec.register_fake
def _(y):
    return torch.empty_like(y)


def tag_reduce(partials: Tensor) -> Tensor:
    """A ``dot_reduce`` that tags the partial block in the graph."""
    return mark_reduce(partials)


#: the tagged reduction a traced step starts (and waits on: the identity)
TAGGED_REDUCE = Reducer(tag_reduce)


def tag_matvec(mv: Callable) -> Callable:
    """Wrap a matvec so its output is tagged in the graph."""
    return lambda x: mark_matvec(mv(x))


@dataclasses.dataclass
class TracedBinding:
    """One traced session binding: the analyzer's input unit."""

    spec: BindingSpec
    gm: fx.GraphModule               # the FX graph of one step

    @property
    def graph(self) -> fx.Graph:
        return self.gm.graph

    def reduce_nodes(self) -> List[fx.Node]:
        """The step's reduction phases: the tagged partials (local
        bindings) or the all-reduces (mesh)."""
        return find_op_nodes(self.graph, ALLREDUCE if self.spec.binding
                             == "mesh" else MARK_REDUCE)

    def matvec_tag_nodes(self) -> List[fx.Node]:
        """The tagged matvec outputs (local bindings only)."""
        return find_op_nodes(self.graph, MARK_MATVEC)

    def halo_nodes(self) -> List[fx.Node]:
        """The halo exchange's receives (mesh bindings only)."""
        return find_op_nodes(self.graph, HALO_RECV)

    def kernel_nodes(self) -> List[fx.Node]:
        """The nodes of the port's solver kernels."""
        return [n for n in self.graph.nodes if op_name(n) in KERNELS]


def fake_mode() -> FakeTensorMode:
    """A fake mode that takes the operator's real tensors as constants."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def trace_fn(fn: Callable, *args, spec: BindingSpec) -> TracedBinding:
    """Trace ``fn(*args)`` (the tensors of ``args`` real or fake) into a
    :class:`TracedBinding`, in fake mode: nothing runs.

    The low-level entry the pass-level tests use to hand-build violating
    steps; :func:`trace_binding` routes everything through it too."""
    leaves = [a for a in pytree.tree_leaves(args)
              if isinstance(a, Tensor)]
    if not any(isinstance(a, FakeTensor) for a in leaves):
        mode = fake_mode()
        args = pytree.tree_map(
            lambda a: mode.from_tensor(a) if isinstance(a, Tensor) else a,
            args)
    gm = make_fx(fn, tracing_mode="fake")(*args)
    return TracedBinding(spec=spec, gm=gm)


def _operator_dim(operator, n: Optional[int]) -> int:
    if n is not None:
        return int(n)
    if hasattr(operator, "shape"):
        return int(operator.shape[0])
    if hasattr(operator, "n"):
        return int(operator.n)
    raise ValueError(
        "cannot infer the operator dimension for tracing; pass n= "
        "(bare-callable operators carry no shape)")


def _float_dtype(operator) -> torch.dtype:
    dtype = getattr(operator, "dtype", None)
    return dtype if isinstance(dtype, torch.dtype) \
        and dtype.is_floating_point else torch.float64


def _precond_kernel_count(pc, sub) -> int:
    """Kernel ops the bound preconditioner is expected to add to the step.
    Only block-Jacobi has a kernel, and only when its blocks vary (nb >
    1): the shared block is one dense matmul by design (policy, not a
    silent fallback)."""
    if pc is None or not getattr(sub, "kernel_backed", False):
        return 0
    from ..precond.block_jacobi import BlockJacobiPreconditioner
    if isinstance(pc, BlockJacobiPreconditioner) \
            and pc.inv_blocks.shape[0] > 1:
        return 1
    return 0


def _resolve_precond_instance(precond, operator):
    """Build a name-spec preconditioner against the REAL operator (the
    traced step gets a tagged matvec closure, which a name spec could not
    build from); instances pass through."""
    if precond is None or not isinstance(precond, str):
        return precond
    from ..precond.base import resolve_precond
    return resolve_precond(precond, operator)


def _mesh_shape(mesh) -> tuple:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh.shape)
    return (dist.get_world_size(mesh),)


def _step_fn(step: Callable) -> Callable:
    """The step as ``make_fx`` traces it: one ordinary iteration."""
    return lambda state, consts: step(state, consts, False)


def trace_binding(method: str,
                  operator,
                  *,
                  binding: str = "single",
                  substrate="torch",
                  precond=None,
                  guard: bool = False,
                  m: int = 3,
                  n: Optional[int] = None,
                  config: Optional[SolverConfig] = None,
                  mesh=None,
                  shard_axes=None,
                  blocked: bool = False,
                  device=None) -> TracedBinding:
    """Trace one scenario-matrix cell: the FX graph of one step.  Tracing
    only, in fake mode: no solve runs.

    Args:
      method: a name from :data:`repro_torch.core.SOLVERS`.
      operator: an operator object (name-spec preconditioners and mesh
        bindings need one) or a bare matvec callable (with ``n=``); its
        tensors lie on ``device``.
      binding: ``"single"`` (the method's ``ChunkedMethod.step``; -rr's
        ordinary, non-replacing step) | ``"batched"`` (the batched
        program's step, :func:`~repro_torch.core.multirhs
        .batched_program`) | ``"open_loop"`` (the service's chunk: the
        same program's step from an open-loop ``init_state``) |
        ``"mesh"`` (the sharded solves, :func:`~repro_torch.core
        .distributed.build_stencil_solver` and ``_batched``; requires a
        :class:`Stencil7Operator` and ``mesh=``, and every rank of it
        calls this together: building the sharded solve makes one
        all-reduce).
      guard: trace with ``SolverConfig.guard``: the (11, m) fused phase on
        the bindings that have one (``spec.guard_effective``).
      precond: ``None`` | name | Preconditioner instance.
      m: the column count of batched / open-loop / mesh bindings.
      blocked: ``operator`` is already an (n, m) -> (n, m) block matvec.
      device: where the fake tensors lie; ``None`` means ``"cuda"``.
    """
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}")
    if binding not in BINDINGS:
        raise ValueError(f"unknown binding kind {binding!r}")
    sub = get_substrate(substrate)
    cfg = config if config is not None else SolverConfig(maxiter=8)
    if guard != cfg.guard:
        cfg = dataclasses.replace(cfg, guard=guard)
    precond_name = precond if isinstance(precond, str) else (
        getattr(precond, "name", None) if precond is not None else None)
    guard_effective = bool(guard) and binding in ("batched", "open_loop",
                                                  "mesh")
    dev = resolve_device(device)
    dtype = _float_dtype(operator)

    if binding == "mesh":
        if mesh is None:
            raise ValueError("binding='mesh' requires mesh=")
        if not isinstance(operator, Stencil7Operator):
            raise TypeError("binding='mesh' requires a Stencil7Operator")
        return _trace_mesh(method, operator, sub, cfg, precond, mesh,
                           shard_axes, m, BindingSpec(
                               method=method, substrate=sub.name,
                               binding="mesh", guard=guard,
                               precond=precond_name, m=m,
                               mesh_shape=_mesh_shape(mesh),
                               guard_effective=guard_effective))

    pc = _resolve_precond_instance(precond, operator)
    dim = _operator_dim(operator, n)
    spec = BindingSpec(method=method, substrate=sub.name, binding=binding,
                       guard=guard, precond=precond_name,
                       m=1 if binding == "single" else m,
                       guard_effective=guard_effective,
                       precond_kernels=_precond_kernel_count(pc, sub))

    if binding == "single":
        if blocked:
            raise ValueError("binding='single' cannot trace a block matvec")
        mv = tag_matvec(sub.as_matvec(operator))
        with fake_mode():
            step, state, consts = prepare_chunked(
                CHUNKED[method], mv, torch.ones(dim, dtype=dtype, device=dev),
                config=cfg, r0_star=None, substrate=sub, precond=pc,
                dot_reduce=TAGGED_REDUCE)
        return trace_fn(_step_fn(step), state, consts, spec=spec)

    # batched / open_loop: the p-BiCGSafe block iteration only
    if method != "p-bicgsafe":
        raise ValueError(
            f"binding={binding!r} runs the batched p-BiCGSafe iteration "
            f"only (got method={method!r})")
    raw = tag_matvec(operator if blocked else sub.as_block_matvec(operator))
    papply = None if pc is None else sub.as_precond_apply(pc)
    bmv = raw if papply is None else (lambda X: papply(raw(X)))
    with fake_mode():
        B = torch.ones((dim, m), dtype=dtype, device=dev)
        B = B if papply is None else papply(B)
        # the open-loop state carries per-column budgets, as
        # LinearSolver.init / the service's admissions build it
        budgets = dict(tol=cfg.tol, maxiter=cfg.maxiter) \
            if binding == "open_loop" else {}
        state = init_state(bmv, B, config=cfg, substrate=sub,
                           dot_reduce=TAGGED_REDUCE, **budgets)
    prog = batched_program(bmv, cfg, sub, device=dev, prep=papply,
                           dot_reduce=TAGGED_REDUCE)
    return trace_fn(_step_fn(prog.step), state, {}, spec=spec)


def _trace_mesh(method, op, sub, cfg, precond, mesh, shard_axes, m,
                spec: BindingSpec) -> TracedBinding:
    """The mesh cell: the sharded solve's own parts (halo matvec, shard-local
    M^{-1}, all-reduce), built for real; the state in fake mode."""
    from ..core.distributed import (build_stencil_solver,
                                    build_stencil_solver_batched)
    dtype = op.c.dtype
    if method == "p-bicgsafe":
        fn = build_stencil_solver_batched(op, mesh, shard_axes=shard_axes,
                                          config=cfg, substrate=sub,
                                          precond=precond)
        with fake_mode():
            B = fn.layout.local(torch.ones((op.nx, op.ny, op.nz, m),
                                           dtype=dtype, device=op.device),
                                batched=True)
            B = B if fn.prep is None else fn.prep(B)
            state = init_state(fn.matvec, B, config=cfg, substrate=sub,
                               dot_reduce=fn.reduce)
        prog = batched_program(fn.matvec, cfg, sub, device=op.device,
                               dot_reduce=fn.reduce)
        return trace_fn(_step_fn(prog.step), state, {}, spec=spec)
    fn = build_stencil_solver(SOLVERS[method], op, mesh,
                              shard_axes=shard_axes, config=cfg,
                              substrate=sub, precond=precond)
    with fake_mode():
        b = fn.layout.local(torch.ones((op.nx, op.ny, op.nz), dtype=dtype,
                                       device=op.device))
        step, state, consts = prepare_chunked(
            fn.method, fn.matvec, b, config=cfg, r0_star=None,
            substrate=sub, precond=fn.precond, dot_reduce=fn.reduce)
    return trace_fn(_step_fn(step), state, consts,
                    spec=dataclasses.replace(spec, m=1))
