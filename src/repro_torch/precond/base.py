"""Preconditioner API: fixed linear M^{-1} operators for the Krylov core
(PyTorch port of ``repro.precond.base``).

Left preconditioning throughout: a solver handed ``precond=`` solves

    M^{-1} A x = M^{-1} b

so the preconditioned residual norm is what ``relres``/``tol`` measure;
the returned ``x`` solves the original system.  Every preconditioner here
is a *fixed linear* operator, as the pipelined solvers' recurred A-images
(q, w, l, g, s) assume the operator does not change between iterations.

The solvers take the operator and the preconditioner separately and
compose them (``M^{-1} ∘ A``) themselves:

* substrate dispatch — ``sub.as_matvec(op)`` / ``sub.as_block_matvec(op)``
  still see the operator, so an ELL operator reaches the SpMV kernels on
  ``"cuda"``, and the M^{-1}-apply is bound by the substrate too
  (:meth:`repro_torch.core.substrate.Substrate.as_precond_apply`): the
  block-Jacobi kernels on ``"cuda"``;
* communication hiding — the apply joins the in-flight matvec, and the
  fused dot phase still reads only ``{s, y, r, t_prev, rs}``: no edge to
  the composite's output (``tests/test_torch_precond.py`` records it);
* synchronization count — no preconditioner computes an inner product.

``precond=`` takes a :class:`Preconditioner` or a name from
:data:`PRECONDITIONERS`; a name is built from the operator (its
``diagonal()`` / structure), so it needs an operator object, not a bare
matvec callable.  A built preconditioner joins a session's cache key by
its own tensors (:func:`repro_torch.api.operator_fingerprint`).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch


class Preconditioner:
    """Abstract fixed linear M^{-1}; subclasses are frozen dataclasses of
    tensors on one device.

    ``apply(x)`` is the plain PyTorch version and takes ``(n,)`` vectors
    and ``(n, m)`` column blocks alike.  ``bind(sub)`` returns the
    substrate-routed apply: the base class returns :meth:`apply`;
    block-Jacobi binds its kernels when ``sub.kernel_backed``, Neumann runs
    its series on the substrate's (block) matvec.
    """

    name = "abstract"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def bind(self, sub) -> Callable[[torch.Tensor], torch.Tensor]:
        return self.apply

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


def _factories():
    # lazy: the factory modules import this one
    from .block_jacobi import block_jacobi
    from .jacobi import jacobi
    from .polynomial import neumann
    from .ssor import ssor
    return {"jacobi": jacobi, "block_jacobi": block_jacobi,
            "neumann": neumann, "ssor": ssor}


#: registry names accepted by ``precond=`` (each built by ``f(op)``)
PRECONDITIONERS = ("jacobi", "block_jacobi", "neumann", "ssor")

PrecondLike = Union[None, str, Preconditioner]


def validate_precond_spec(spec: PrecondLike, op) -> None:
    """Validate a precond spec without building it (cheap, eager); the
    checks and messages are the JAX package's."""
    if spec is None or isinstance(spec, Preconditioner):
        return
    if isinstance(spec, str):
        if spec not in PRECONDITIONERS:
            raise ValueError(
                f"unknown preconditioner {spec!r}; expected one of "
                f"{sorted(PRECONDITIONERS)} or a Preconditioner instance")
        if not hasattr(op, "diagonal"):
            raise TypeError(
                f"precond={spec!r} must be built from an operator object "
                "with .diagonal(); got a bare matvec callable — pass the "
                "operator itself, or construct the preconditioner "
                "explicitly (repro_torch.precond.jacobi(op) etc.)")
        return
    raise TypeError(f"precond must be None, a name, or a Preconditioner; "
                    f"got {type(spec).__name__}")


def resolve_precond(spec: PrecondLike, op) -> Optional[Preconditioner]:
    """Resolve a precond spec: None / instance / registry name (built from
    ``op``, which must be an operator object)."""
    validate_precond_spec(spec, op)
    if spec is None or isinstance(spec, Preconditioner):
        return spec
    return _factories()[spec](op)


def preconditioned_system(sub, op, b: torch.Tensor, precond: PrecondLike
                          ) -> Tuple[Callable, torch.Tensor]:
    """(matvec', b') of the left-preconditioned single-RHS system:
    ``matvec' = M^{-1} ∘ A`` with A from ``sub.as_matvec(op)`` and the
    apply from ``sub.as_precond_apply``, and ``b' = M^{-1} b``."""
    mv = sub.as_matvec(op)
    pc = resolve_precond(precond, op)
    if pc is None:
        return mv, b
    papply = sub.as_precond_apply(pc)
    return (lambda x: papply(mv(x))), papply(b)


def wrap_block_preconditioned(sub, bmv: Callable, B: torch.Tensor,
                              precond: PrecondLike, op
                              ) -> Tuple[Callable, torch.Tensor]:
    """Block (multi-RHS) analogue of :func:`preconditioned_system`: ``bmv``
    is the ``(n, m) -> (n, m)`` block matvec; the bound apply takes the
    column block as it is."""
    pc = resolve_precond(precond, op)
    if pc is None:
        return bmv, B
    papply = sub.as_precond_apply(pc)
    return (lambda x: papply(bmv(x))), papply(B)


def preconditioned_matvec(op, precond) -> Callable:
    """``M^{-1} ∘ A`` as a bare callable (the plain apply; prefer
    ``precond=`` on a solver, which routes the apply through the
    substrate)."""
    from ..core.linear_operator import as_matvec
    mv = as_matvec(op)
    if precond is None:
        return mv
    return lambda x: precond.apply(mv(x))
