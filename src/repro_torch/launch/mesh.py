"""Production meshes (PyTorch port of ``repro.launch.mesh``).

Each is a named :class:`~torch.distributed.device_mesh.DeviceMesh` over the
process group already initialized: a real one (``multihost``, torchrun,
one rank per card) or, for the dry run, a fake one
(:func:`init_fake_group`).  Functions, never module-level constants:
importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the production mesh: 16 x 16 ("data",
    "model"), 256 ranks, or 2 x 16 x 16 ("pod", "data", "model"), 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """Initialize the default process group as ``torch.distributed``'s fake
    backend (``torch.testing._internal.distributed.fake_pg``): every
    collective returns at once and moves nothing, so one process traces as
    rank ``rank`` of ``world_size``.  Process-wide state: tear it down with
    ``dist.destroy_process_group()``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


@contextlib.contextmanager
def fake_group(multi_pod: bool, rank: int = 0):
    """The production mesh's fake group (:func:`init_fake_group`, as
    ``rank``) for the block, destroyed after it; a group of that size
    already up is used as it is."""
    shape, _ = production_shape(multi_pod)
    world = 1
    for s in shape:
        world *= s
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks is "
                               f"up; the {mesh_name(multi_pod)} mesh needs "
                               f"{world}")
        yield
        return
    init_fake_group(world, rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, names, device_type: Optional[str]) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialize one first (a real "
                           "one, or launch.mesh.init_fake_group)")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def _device_type() -> str:
    """The group's device: ``"cuda"`` on NCCL, else ``"cpu"``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape, names = production_shape(multi_pod)
    return _mesh(shape, names, device_type)


def solver_mesh_shape(n: int, axes: Sequence[str] = ("data", "model")):
    """The JAX package's fold of n devices into ``axes``: one axis of n, or
    the largest power-of-two split n = d * m with d >= m."""
    if len(axes) == 1:
        return (n,)
    m = 1
    while (m * 2) ** 2 <= n:
        m *= 2
    return (n // m, m)


def make_solver_mesh(n_devices: Optional[int] = None, *,
                     axes=("data", "model"),
                     device_type: Optional[str] = None) -> DeviceMesh:
    """Mesh for the distributed solver: the group's ranks folded into
    ``axes`` (row-major) as :func:`solver_mesh_shape` folds them."""
    n = n_devices or dist.get_world_size()
    shape = solver_mesh_shape(n, axes)
    return _mesh(shape, tuple(axes)[:len(shape)], device_type)


def make_multirhs_mesh(n_devices: Optional[int] = None, *,
                       device_type: Optional[str] = None) -> DeviceMesh:
    """Mesh for sharded batched (multi-RHS) solves: one flat ``rows`` axis
    over every rank; the (n, m) block is row-sharded over it and its one
    (9, m) all-reduce a step runs over exactly this axis."""
    n = n_devices or dist.get_world_size()
    return _mesh((n,), ("rows",), device_type)
