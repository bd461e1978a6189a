"""Public wrappers of the port's CUDA kernels (counterpart of
``repro.kernels.ops``).

Each wrapper checks its operands (device, float32/float64, shapes,
contiguity) and dispatches on the device they lie on: on a CUDA tensor it
launches the hand-written kernel (or raises), on a CPU tensor it runs the
plain version in :mod:`repro_torch.kernels.ref`.  There is no fallback from
the kernel to the plain version.

These are the backing of the ``"cuda"`` compute substrate
(:mod:`repro_torch.core.substrate`).  ``LAUNCHES`` counts the kernel
launches (the CPU path counts nothing).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref
from ._build import LAUNCHES, reset_launches
from .fused_axpy import IN_ORDER, fused_axpy_cuda
from .fused_dots import fused_dots_cuda
from .spmv_ell import spmv_ell_cuda

__all__ = ["fused_dots", "fused_axpy", "spmv_ell", "LAUNCHES",
           "reset_launches"]


def _check_vectors(name: str, vecs: dict):
    """Check that ``vecs`` are contiguous 1-D float32/float64 tensors of one
    length, type and device (``"cpu"`` or ``"cuda"``); returns the tensor
    of the first entry as the reference."""
    first = next(iter(vecs.values()))
    for key, v in vecs.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor, got "
                            f"{type(v).__name__}")
        if v.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: {key} has dtype {v.dtype}; the kernel "
                            "takes float32 or float64")
        if v.dim() != 1:
            raise ValueError(f"{name}: {key} must be 1-D, got shape "
                             f"{tuple(v.shape)}")
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
    rs·t, r·r]`` of 1-D ``(n,)`` vectors, as a ``(9,)`` tensor."""
    v = _check_vectors("fused_dots", dict(s=s, y=y, r=r, t=t, rs=rs))
    if v.is_cuda:
        return fused_dots_cuda(s, y, r, t, rs)
    return ref.fused_dots(s, y, r, t, rs)


def fused_axpy(vecs: Dict[str, torch.Tensor], scalars) -> Dict[str, torch.Tensor]:
    """p-BiCGSafe fused vector-update phase (Alg. 3.1 lines 23-32).

    ``vecs``: the 12 vectors of ``IN_ORDER``; ``scalars``: ``(alpha, beta,
    zeta, eta)`` as 0-d tensors, numbers or one ``(4,)`` tensor.  Returns
    the 10 updated vectors of ``OUT_ORDER``.
    """
    missing = set(IN_ORDER) - set(vecs)
    if missing:
        raise KeyError(f"fused_axpy: missing vectors {sorted(missing)}")
    v = _check_vectors("fused_axpy", {k: vecs[k] for k in IN_ORDER})
    if isinstance(scalars, torch.Tensor):
        scal = scalars.to(device=v.device, dtype=v.dtype).reshape(-1)
    else:
        scal = torch.stack([torch.as_tensor(c, dtype=v.dtype, device=v.device)
                            for c in scalars])
    if scal.shape != (4,):
        raise ValueError(f"fused_axpy: expected 4 scalars (alpha, beta, "
                         f"zeta, eta), got shape {tuple(scal.shape)}")
    if v.is_cuda:
        return fused_axpy_cuda(vecs, scal.contiguous())
    return ref.fused_axpy(vecs, scal.unbind(0))


def spmv_ell(op, x) -> torch.Tensor:
    """ELL SpMV ``y = A x`` for an :class:`~repro_torch.core.linear_operator
    .ELLOperator` and a 1-D ``x``.  Any ELL matrix goes to the kernel on the
    card: unlike the TPU kernel it has no band limit."""
    _check_vectors("spmv_ell", {"x": x})
    values, cols = op.values, op.cols
    if values.dtype != x.dtype or values.device != x.device \
            or x.shape != (op.n,):
        raise ValueError(
            f"spmv_ell: x is {tuple(x.shape)} {x.dtype} on {x.device}; the "
            f"operator is ({op.n},) {values.dtype} on {values.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"spmv_ell: cols must be int32, got {cols.dtype}")
    if not (values.is_contiguous() and cols.is_contiguous()):
        raise ValueError("spmv_ell: values and cols must be contiguous")
    if x.is_cuda:
        return spmv_ell_cuda(values, cols, x)
    return ref.spmv_ell(values, cols, x)
