"""Compute substrate: who runs the solver's hot-loop phases (PyTorch port
of ``repro.core.substrate``).

* ``dots(pairs)``      — stacked inner products (one reduction phase),
* ``bicgsafe_dots``    — the fused 9-dot phase of p-BiCGSafe,
* ``axpy_phase``       — the blocked vector-update phase,
* ``as_matvec(op)``    — operator -> matvec dispatch (SpMV),
* ``as_block_matvec(op)`` — operator -> ``(n, m)`` block matvec dispatch.

Every phase takes ``(n,)`` vectors or ``(n, m)`` multi-RHS blocks.

Two substrates run the same iteration body:

* ``"torch"`` — plain PyTorch (the counterpart of ``"jnp"``).
* ``"cuda"``  — the hand-written CUDA kernels of :mod:`repro_torch.kernels`
  (the counterpart of ``"pallas"``): ``fused_dots``, ``fused_axpy`` and
  ``spmv_ell``, each with a batched kernel for ``(n, m)`` blocks.  On CPU
  tensors those wrappers run their plain versions, so the same substrate
  runs in the CPU tests.  Unlike ``"pallas"`` it sends every
  :class:`ELLOperator` to the SpMV kernels, banded or not.

Either way the dot phase reads only ``{s, y, r, t_prev, rs}``: it has no
dependency on the iteration's in-flight matvec ``A s``.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import torch

from ..kernels import ops, ref
from . import linear_operator
from ._common import local_dots

BICGSAFE_DOT_PAIRS = (
    ("s", "s"), ("y", "y"), ("s", "y"), ("s", "r"), ("y", "r"),
    ("rs", "r"), ("rs", "s"), ("rs", "t"), ("r", "r"))


class Substrate:
    """Strategy object for the solver hot-loop phases."""

    name = "abstract"
    #: True when the substrate executes the hand-written CUDA kernels
    kernel_backed = False

    def dots(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
             ) -> torch.Tensor:
        """Stacked inner products <a,b> per pair: (k,), or (k, m) for
        (n, m) blocks."""
        return local_dots(pairs)

    def bicgsafe_dots(self, s, y, r, t_prev, rs) -> torch.Tensor:
        """The 9-dot fused phase of p-BiCGSafe; reads ONLY
        {s, y, r, t_prev, rs}.  Returns (9,), or (9, m) for (n, m)
        blocks."""
        raise NotImplementedError

    def axpy_phase(self, vecs: dict, scalars, mask=None) -> dict:
        """p-BiCGSafe's blocked vector-update phase (Alg. 3.1 lines 23-32).

        vecs: dict with r,p,u,t,y,z,s,l,g,w,x,As; scalars: (alpha, beta,
        zeta, eta).  Returns dict with the primed p,o,u,q,w,t,z,y,x,r.
        Multi-RHS: (n, m) blocks, (m,) coefficients, and an optional (m,)
        bool ``mask``: a frozen column keeps its inputs (``MASKED_OUT``).
        """
        raise NotImplementedError

    def as_matvec(self, op):
        """Operator / matrix / callable -> matvec callable."""
        return linear_operator.as_matvec(op)

    def as_block_matvec(self, op):
        """Operator -> block matvec ``(n, m) -> (n, m)``: the operator's own
        2-D matvec (a bare callable is lifted column by column)."""
        return linear_operator.as_block_matvec(op)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class TorchSubstrate(Substrate):
    """Plain PyTorch: the reference path."""

    name = "torch"

    def bicgsafe_dots(self, s, y, r, t_prev, rs):
        v = dict(s=s, y=y, r=r, t=t_prev, rs=rs)
        return local_dots([(v[a], v[b]) for a, b in BICGSAFE_DOT_PAIRS])

    def axpy_phase(self, vecs, scalars, mask=None):
        return ref.fused_axpy(vecs, scalars, mask)


class CudaSubstrate(Substrate):
    """Hand-written CUDA kernels: the fused 9-dot phase, the fused update
    phase and the ELL SpMV each run as one kernel pass on the card."""

    name = "cuda"
    kernel_backed = True

    def bicgsafe_dots(self, s, y, r, t_prev, rs):
        return ops.fused_dots(s, y, r, t_prev, rs)

    def axpy_phase(self, vecs, scalars, mask=None):
        return ops.fused_axpy(vecs, scalars, mask)

    def as_matvec(self, op):
        if isinstance(op, linear_operator.ELLOperator):
            return functools.partial(ops.spmv_ell, op)
        return linear_operator.as_matvec(op)

    def as_block_matvec(self, op):
        # ops.spmv_ell takes (n, m) blocks to the block kernel, which reads
        # values/cols once for all m columns (not a loop over columns)
        if isinstance(op, linear_operator.ELLOperator):
            return functools.partial(ops.spmv_ell, op)
        return linear_operator.as_block_matvec(op)


SUBSTRATES = {
    "torch": TorchSubstrate(),
    "cuda": CudaSubstrate(),
}

SubstrateLike = Union[str, Substrate, None]


def get_substrate(spec: SubstrateLike) -> Substrate:
    """Resolve a substrate name / instance / None (-> ``"torch"``)."""
    if spec is None:
        return SUBSTRATES["torch"]
    if isinstance(spec, Substrate):
        return spec
    try:
        return SUBSTRATES[spec]
    except KeyError:
        raise ValueError(
            f"unknown substrate {spec!r}; expected one of "
            f"{sorted(SUBSTRATES)} or a Substrate instance") from None
