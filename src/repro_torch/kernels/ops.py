"""Public wrappers of the port's CUDA kernels (counterpart of
``repro.kernels.ops``).

Each wrapper checks its operands (device, float32/float64, shapes,
contiguity) and dispatches on the device they lie on: on a CUDA tensor it
launches the hand-written kernel (or raises), on a CPU tensor it runs the
plain version in :mod:`repro_torch.kernels.ref`.  There is no fallback from
the kernel to the plain version.  Each takes single-RHS ``(n,)`` vectors
or multi-RHS ``(n, m)`` row-major blocks, and an ``(n, m)`` block goes to
the batched kernel, as in the JAX package's ``ops``.

These are the backing of the ``"cuda"`` compute substrate
(:mod:`repro_torch.core.substrate`).  ``LAUNCHES`` counts the kernel
launches (the CPU path counts nothing).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref
from ._build import LAUNCHES, reset_launches
from .fused_axpy import IN_ORDER, fused_axpy_batched_cuda, fused_axpy_cuda
from .fused_dots import fused_dots_batched_cuda, fused_dots_cuda
from .spmv_ell import spmv_ell_batched_cuda, spmv_ell_cuda

__all__ = ["fused_dots", "fused_axpy", "spmv_ell", "LAUNCHES",
           "reset_launches"]


def _check_vectors(name: str, vecs: dict):
    """Check that ``vecs`` are contiguous float32/float64 ``(n,)`` vectors
    or ``(n, m)`` blocks of one shape, type and device (``"cpu"`` or
    ``"cuda"``); returns the tensor of the first entry as the reference."""
    first = next(iter(vecs.values()))
    for key, v in vecs.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor, got "
                            f"{type(v).__name__}")
        if v.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: {key} has dtype {v.dtype}; the kernel "
                            "takes float32 or float64")
        if v.dim() not in (1, 2):
            raise ValueError(f"{name}: {key} must be 1-D (n,) or 2-D (n, m), "
                             f"got shape {tuple(v.shape)}")
        if v.shape != first.shape or v.dtype != first.dtype \
                or v.device != first.device:
            raise ValueError(
                f"{name}: {key} is {tuple(v.shape)} {v.dtype} on {v.device}, "
                f"unlike {tuple(first.shape)} {first.dtype} on {first.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return first


def fused_dots(s, y, r, t, rs) -> torch.Tensor:
    """The 9 fused inner products ``[s·s, y·y, s·y, s·r, y·r, rs·r, rs·s,
    rs·t, r·r]``: ``(9,)`` for ``(n,)`` vectors, ``(9, m)`` per-column dots
    for ``(n, m)`` blocks."""
    v = _check_vectors("fused_dots", dict(s=s, y=y, r=r, t=t, rs=rs))
    if not v.is_cuda:
        return ref.fused_dots(s, y, r, t, rs)
    if v.dim() == 2:
        return fused_dots_batched_cuda(s, y, r, t, rs)
    return fused_dots_cuda(s, y, r, t, rs)


def _coefficients(scalars, v: torch.Tensor) -> torch.Tensor:
    """``(alpha, beta, zeta, eta)`` as one contiguous tensor of ``v``'s type
    and device: ``(4,)`` for vectors, ``(4, m)`` for ``(n, m)`` blocks (a
    scalar coefficient goes to every column)."""
    if isinstance(scalars, torch.Tensor):
        scal = scalars.to(device=v.device, dtype=v.dtype)
    else:
        scal = torch.stack([torch.as_tensor(c, dtype=v.dtype, device=v.device)
                            .expand(v.shape[1:]) for c in scalars])
    want = (4,) + tuple(v.shape[1:])
    if v.dim() == 1:
        scal = scal.reshape(-1)
    if tuple(scal.shape) != want:
        raise ValueError(f"fused_axpy: expected 4 scalars (alpha, beta, "
                         f"zeta, eta) of shape {want}, got shape "
                         f"{tuple(scal.shape)}")
    return scal.contiguous()


def fused_axpy(vecs: Dict[str, torch.Tensor], scalars,
               mask=None) -> Dict[str, torch.Tensor]:
    """p-BiCGSafe fused vector-update phase (Alg. 3.1 lines 23-32).

    ``vecs``: the 12 vectors or ``(n, m)`` blocks of ``IN_ORDER``;
    ``scalars``: ``(alpha, beta, zeta, eta)``, as 0-d (or, for blocks,
    ``(m,)`` per-column) tensors, numbers, or one ``(4,)`` (``(4, m)``)
    tensor.  ``mask``: blocks only, an optional ``(m,)`` bool; a column
    where it is False is frozen in the kernel (every output of
    ``MASKED_OUT`` is its input).  Returns the 10 updated vectors or
    blocks of ``OUT_ORDER``.
    """
    missing = set(IN_ORDER) - set(vecs)
    if missing:
        raise KeyError(f"fused_axpy: missing vectors {sorted(missing)}")
    v = _check_vectors("fused_axpy", {k: vecs[k] for k in IN_ORDER})
    scal = _coefficients(scalars, v)
    if v.dim() == 1:
        if mask is not None:
            raise ValueError("fused_axpy: mask is a multi-RHS (column) "
                             "concept; it needs (n, m) blocks")
        if v.is_cuda:
            return fused_axpy_cuda(vecs, scal)
        return ref.fused_axpy(vecs, scal.unbind(0))
    if mask is not None:
        mask = torch.as_tensor(mask, device=v.device).to(torch.bool)
        if tuple(mask.shape) != (v.shape[1],):
            raise ValueError(f"fused_axpy: mask must be ({v.shape[1]},), "
                             f"got shape {tuple(mask.shape)}")
        mask = mask.contiguous()
    if v.is_cuda:
        return fused_axpy_batched_cuda(vecs, scal, mask)
    return ref.fused_axpy(vecs, scal.unbind(0), mask)


def spmv_ell(op, x) -> torch.Tensor:
    """ELL SpMV ``y = A x`` for an :class:`~repro_torch.core.linear_operator
    .ELLOperator` and an ``(n,)`` ``x`` or an ``(n, m)`` block (the block
    kernel reads the matrix once for all m columns).  Any ELL matrix goes
    to the kernel on the card: unlike the TPU kernels it has no band
    limit."""
    _check_vectors("spmv_ell", {"x": x})
    values, cols = op.values, op.cols
    if values.dtype != x.dtype or values.device != x.device \
            or x.shape[0] != op.n:
        raise ValueError(
            f"spmv_ell: x is {tuple(x.shape)} {x.dtype} on {x.device}; the "
            f"operator is ({op.n},) {values.dtype} on {values.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"spmv_ell: cols must be int32, got {cols.dtype}")
    if not (values.is_contiguous() and cols.is_contiguous()):
        raise ValueError("spmv_ell: values and cols must be contiguous")
    if not x.is_cuda:
        return ref.spmv_ell(values, cols, x)
    if x.dim() == 2:
        return spmv_ell_batched_cuda(values, cols, x)
    return spmv_ell_cuda(values, cols, x)
