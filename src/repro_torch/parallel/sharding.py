"""Logical-axis sharding rules (PyTorch port of ``repro.parallel.sharding``).

Model code annotates tensors with *logical* axis names ("batch", "seq",
"heads", "ff", "experts", "vocab", "fsdp", ...).  A :class:`LogicalMesh`
maps logical names to the named dimensions of a
:class:`~torch.distributed.device_mesh.DeviceMesh`:

    single-pod (16, 16)    ("data", "model")
    multi-pod  (2, 16, 16) ("pod", "data", "model")

Rules (MaxText-style), the JAX package's:
    batch   -> ("pod", "data")   # DP (+pod DP)
    fsdp    -> "data"            # weight shard dim for FSDP/ZeRO
    tensor  -> "model"           # TP dim: heads / ff / experts / vocab
    seq     -> "model"           # sequence parallelism for long KV

A spec (:class:`PartitionSpec`, one entry per tensor dimension: ``None``,
a mesh axis name or a tuple of names) becomes DTensor placements with
:meth:`LogicalMesh.placements`: per mesh dimension ``Shard(d)`` where the
spec puts that axis on tensor dimension ``d``, else ``Replicate()``.  A
tensor dimension on two mesh axes ("batch" on ("pod", "data")) is
``Shard(d)`` on both, the first axis major, as in JAX.

Outside any mesh context, and on a plain (non-DTensor) tensor, every
annotation returns its input as it is, so the single-device paths run the
same code bit for bit.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

_STATE = threading.local()

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tensor": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "seq": ("model",),
    "embed": (),        # d_model of activations: replicated
    "layers": (),
}

Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (whole), a mesh axis name,
    or a tuple of names (the first major); the counterpart of
    ``jax.sharding.PartitionSpec``.  Trailing dimensions past its length
    are whole."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class LogicalMesh:
    """A :class:`DeviceMesh` with named dimensions + logical->physical
    axis rules."""

    def __init__(self, mesh: DeviceMesh,
                 rules: Optional[Dict[str, Tuple[str, ...]]] = None):
        if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names is None:
            raise TypeError("LogicalMesh takes a DeviceMesh with "
                            f"mesh_dim_names, not {mesh!r}")
        self.mesh = mesh
        self.axis_names: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, mesh.shape))
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def axes_for(self, logical: Optional[str]) -> Entry:
        """Physical axes for one logical name, filtered to existing axes."""
        if logical is None:
            return None
        phys = tuple(a for a in self.rules.get(logical, ())
                     if a in self.axis_names)
        if not phys:
            return None
        return phys if len(phys) > 1 else phys[0]

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        return PartitionSpec(*(self.axes_for(l) for l in logical))

    def size(self, logical: str) -> int:
        n = 1
        for a in self.rules.get(logical, ()):
            n *= self.shape.get(a, 1)
        return n

    def placements(self, spec) -> Tuple[Placement, ...]:
        """DTensor placements of ``spec``, one per mesh dimension."""
        out: List[Placement] = [Replicate()] * len(self.axis_names)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [self.axis_names.index(a) for a in axes]
            if idx != sorted(idx):
                # DTensor shards one tensor dimension over several mesh
                # dimensions in the mesh's order: the first named is major
                raise ValueError(f"spec entry {entry!r} must name mesh axes "
                                 f"in the mesh's order {self.axis_names}")
            for i in idx:
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {self.axis_names[i]!r} "
                                     f"appears twice in {spec!r}")
                out[i] = Shard(dim)
        return tuple(out)

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def mesh_group(mesh: DeviceMesh):
    """A process group over every rank of ``mesh``."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    return mesh._flatten().get_group()


def set_mesh(lm: Optional[LogicalMesh]):
    _STATE.mesh = lm


def current_mesh() -> Optional[LogicalMesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(lm: Optional[LogicalMesh]):
    prev = current_mesh()
    set_mesh(lm)
    try:
        yield lm
    finally:
        set_mesh(prev)


@contextlib.contextmanager
def mesh_context(lm: Optional[LogicalMesh]):
    """The context a model runs in on ``lm``'s mesh (nothing with ``None``):
    ``use_mesh(lm)``; plain tensors made inside (a batch, masks,
    positions) taken as replicated DTensors (``implicit_replication``);
    and a backward run on this thread, not on autograd's device threads, so
    that both settings, which are this thread's, hold in the backward and
    in the blocks that remat recomputes there."""
    if lm is None:
        yield None
        return
    with use_mesh(lm), implicit_replication(), \
            torch.autograd.set_multithreading_enabled(False):
        yield lm


def constraint_spec(shape, logical, lm: LogicalMesh) -> PartitionSpec:
    """The spec of ``logical`` names for a tensor of ``shape``: a name whose
    axes do not divide its dimension (or outnumber it) is dropped, and so
    is one on a dimension of size 1 (a decode step's sequence: DTensor
    takes a dimension sharded on a one-rank axis for sharded, and a view
    that folds it away fails)."""
    spec = []
    for dim, l in zip(shape, logical):
        ax = lm.axes_for(l)
        n = lm.size(l)
        spec.append(ax if ax is not None and dim % max(n, 1) == 0
                    and dim >= n and dim > 1 else None)
    return PartitionSpec(*spec)


def logical_constraint(x: torch.Tensor,
                       *logical: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to the placements of its logical names (a
    DTensor's ``redistribute``; the JAX package's
    ``with_sharding_constraint``); as there, the gradient is constrained
    too (the backward redistributes it to ``x``'s placements).  A plain
    tensor, or any tensor with no mesh set, is returned as it is."""
    lm = current_mesh()
    if lm is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(
        lm.mesh, lm.placements(constraint_spec(x.shape, logical, lm)))


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, d) with its sequence whole, its batch on "batch": the
    input of a matmul region (the all-gather of sequence parallelism), and
    its output too, so that the gradient reaches the region's products
    seq-whole.  The rows of a product fold B and S; with B and S sharded on
    two mesh axes that fold is a strided shard, which no product's
    sharding rule takes (and on a 3-D mesh DTensor's search for a plan
    costs tens of seconds a shape)."""
    return logical_constraint(x, "batch", None, "embed")


def write_row(cache: torch.Tensor, dim: int, row: torch.Tensor,
              new: torch.Tensor) -> None:
    """``cache.index_copy_(dim, row, new)``: the rows ``new`` (one along
    ``dim``) written in place at the one-element index ``row``, a device
    tensor the host never reads.  A DTensor cache sharded along ``dim``
    (a decode cache on "seq") is written shard by shard, as GSPMD
    partitions a ``dynamic_update_slice``: each rank writes the row where
    it falls in its own range of rows and writes its row back as it was
    elsewhere, so the cache keeps its placements (DTensor's rule for
    ``index_copy_`` would make the dimension whole and reshard the cache
    in place)."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(dim, row, new)
        return
    mesh, placements = cache.device_mesh, cache.placements
    on = [i for i, p in enumerate(placements) if p.is_shard(dim)]
    new = new.redistribute(mesh, [Replicate() if i in on else p
                                  for i, p in enumerate(placements)])
    local, new = cache.to_local(), new.to_local()
    row = row.full_tensor() if isinstance(row, DTensor) else row
    if not on:
        local.index_copy_(dim, row, new)
        return
    coord = mesh.get_coordinate()
    shard = 0
    for i in on:                       # the first mesh dimension is major
        shard = shard * mesh.size(i) + coord[i]
    n = local.shape[dim]
    at = row - shard * n
    mine = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    local.index_copy_(dim, at, torch.where(
        mine, new, local.index_select(dim, at)))


def splittable(x: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``x`` ready for a view that splits dimension ``dim`` into ``(lead,
    ...)``: aten.view cannot split a DTensor dimension sharded n ways unless
    ``lead`` divides by n, so such a dimension is first made whole (its
    mesh dimensions redistributed to ``Replicate()``).  A plain tensor, or
    one that splits evenly, is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    n = 1
    for i in on:
        n *= mesh.size(i)
    if lead % n == 0:
        return x
    return x.redistribute(mesh, [Replicate() if i in on else p
                                 for i, p in enumerate(x.placements)])


class _ContiguousGrad(torch.autograd.Function):
    """The identity; the gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _contiguous_grads(fn):
    """``fn`` whose tensor arguments' gradients come out contiguous: the
    local gradients of a :func:`shard_map` region become DTensors that
    DTensor's views (the backward of a reshape before the region) read."""
    def run(*args):
        return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor)
                    and a.requires_grad else a for a in args))
    return run


def shard_map(fn, in_logical, out_logical):
    """``fn`` run on each rank's shards where a mesh is set and a DTensor
    is passed (the JAX package's ``shard_map``; PyTorch's ``local_map``):
    each tensor argument is redistributed to the placements of its logical
    names (``None``: passed as it is), ``fn`` computes on the local
    tensors, and each of its outputs is a DTensor placed by its entry of
    ``out_logical``, a list of logical-name tuples, one for each tensor
    ``fn`` returns: a logical name is sharded there as the inputs shard
    it.  The call returns what ``fn`` returns.  For work that
    is independent across the sharded dimensions (attention per batch row
    and head).  An input whole on a mesh axis that another input is
    sharded on (a weight shared by every head) takes from each rank the
    gradient of that rank's share of the work: a partial sum.  Otherwise
    ``fn`` itself."""
    def run(*args):
        lm = current_mesh()
        if lm is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        placed: Dict[str, Entry] = {}
        in_placements = []
        for a, names in zip(args, in_logical):
            if names is None:
                in_placements.append(None)
                continue
            spec = constraint_spec(a.shape, names, lm)
            for n, entry in zip(names, spec):
                if n is not None and entry is not None:
                    placed[n] = entry
            in_placements.append(lm.placements(spec))
        split = {i for pl in in_placements if pl is not None
                 for i, p in enumerate(pl) if p.is_shard()}
        grad_placements = tuple(
            None if pl is None else tuple(
                Partial() if i in split and not p.is_shard() else p
                for i, p in enumerate(pl))
            for pl in in_placements)

        def out(names):
            return lm.placements(PartitionSpec(*(placed.get(n)
                                                 for n in names)))
        out_placements = tuple(out(n) for n in out_logical)
        return local_map(_contiguous_grads(fn), out_placements=out_placements,
                         in_placements=tuple(in_placements),
                         in_grad_placements=grad_placements,
                         device_mesh=lm.mesh, redistribute_inputs=True)(*args)
    return run


class _SplittableGrad(torch.autograd.Function):
    """The identity; the gradient made :func:`splittable`."""

    @staticmethod
    def forward(ctx, x, dim, lead):
        ctx.dim, ctx.lead = dim, lead
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return splittable(grad, ctx.dim, ctx.lead), None, None


def grad_splittable(x: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``x``, the merge of ``(lead, ...)`` into dimension ``dim``, with its
    gradient made :func:`splittable` for the merge's backward (a view that
    splits it back).  A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return _SplittableGrad.apply(x, dim, lead)


class _PlacedGrad(torch.autograd.Function):
    """The identity; the gradient redistributed to the input's
    placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and grad.placements != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a projection's output, (B, S, n)) whose gradient comes back
    with ``x``'s own placements.  Gradients that are partial sums (from a
    :func:`shard_map` region's inputs whole on the model axis, or from a
    product that contracts a model-sharded dimension) may be reduced onto
    the sequence; where the batch leaves each rank more than one row (a
    (2, 16, 16) mesh at B = 256), the fold of batch and sequence into the
    weight gradient's rows is then a strided shard.  A plain tensor is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return _PlacedGrad.apply(x)


def param_spec(path: str, shape: Tuple[int, ...],
               lm: LogicalMesh) -> PartitionSpec:
    """PartitionSpec for a parameter leaf by naming convention (the
    table in :mod:`repro_torch.parallel.param_rules`)."""
    from .param_rules import spec_for_param  # local import to avoid cycle
    return spec_for_param(path, shape, lm)
