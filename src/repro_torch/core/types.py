"""Common types for the Krylov solver core (PyTorch port of
``repro.core.types``).

Every solver in :mod:`repro_torch.core` returns a :class:`SolveResult` and
accepts a :class:`SolverConfig` with the same fields and defaults as the
JAX package.  :class:`SolveStatus` keeps the same int codes so a status can
live in a device tensor and convert to the enum at the host boundary.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, NamedTuple

import torch


class SolveStatus(enum.IntEnum):
    """Typed outcome of a solve; the codes equal the JAX package's."""

    RUNNING = 0
    CONVERGED = 1
    MAXITER = 2
    BREAKDOWN = 3        # generic pivot/denominator underflow
    BREAKDOWN_RHO = 4    # beta denominator zeta_{i-1} * f_{i-1} (rho ratio)
    BREAKDOWN_ALPHA = 5  # alpha denominator g + beta * h
    BREAKDOWN_OMEGA = 6  # zeta/eta denominator a*b - c^2 (omega analogue)
    NONFINITE = 7        # NaN/Inf detected in the iteration state
    STAGNATION = 8       # residual stopped improving; recovery exhausted
    DEADLINE = 9         # service wall-clock budget expired

    @property
    def is_failure(self) -> bool:
        return self >= SolveStatus.BREAKDOWN

    @property
    def is_terminal(self) -> bool:
        return self != SolveStatus.RUNNING


def classify_status(converged: torch.Tensor, breakdown: torch.Tensor,
                    relres: torch.Tensor) -> torch.Tensor:
    """Coarse device-side status from a solver's final flags:
    CONVERGED / BREAKDOWN / NONFINITE / MAXITER, as an int32 tensor."""
    s = torch.where(converged, SolveStatus.CONVERGED.value,
                    SolveStatus.MAXITER.value)
    s = torch.where(breakdown & ~converged, SolveStatus.BREAKDOWN.value, s)
    s = torch.where(~torch.isfinite(relres) & ~converged,
                    SolveStatus.NONFINITE.value, s)
    return s.to(torch.int32)


#: Channel layout of the on-device iteration-trace ring buffer
#: (``SolverConfig.trace_cap``; see :mod:`repro_torch.observe`), the JAX
#: package's.  Every channel is a value the fused reduction phase already
#: computes: the trace is written and never read by the iteration, so
#: recording adds no host read and no dependency edge to the in-flight
#: matvec.
TRACE_CHANNELS = ("iteration", "relres", "rho_denom", "alpha_denom",
                  "omega_denom", "drift", "status")


class SolveResult(NamedTuple):
    """Result of an iterative solve (the fields of the JAX package's).

    Attributes:
      x: approximate solution vector.
      iterations: number of iterations executed (int32 0-d tensor).
      relres: final relative residual norm ||r_i|| / ||r_0|| (recurred).
      converged: bool 0-d tensor — relres <= tol within maxiter.
      breakdown: bool 0-d tensor — a pivot/denominator underflowed.
      residual_history: (maxiter+1,) relative residuals (NaN past
        ``iterations``) when ``SolverConfig.record_history`` is set,
        otherwise a (0,) tensor.
      status: int32 :class:`SolveStatus` code.
      trace: ``None``, or with ``SolverConfig.trace_cap`` the ring's
        payload ``{"buffer": (cap, C[, m]) tensor, "steps": rows written}``
        (the session front door wraps it as a :class:`repro_torch.observe
        .ConvergenceTrace`).
    """

    x: torch.Tensor
    iterations: torch.Tensor
    relres: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor
    residual_history: torch.Tensor
    status: Any = None
    trace: Any = None


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for a solve; fields and defaults as in the JAX
    package (see ``repro.core.types.SolverConfig`` for each field).
    ``trace_cap > 0`` carries a ring of the last ``trace_cap`` iterations'
    :data:`TRACE_CHANNELS` through the loop state.
    """

    tol: float = 1e-8
    maxiter: int = 10_000
    record_history: bool = False
    rr_epoch: int = 100
    rr_maxiter: int = 10_000
    breakdown_eps: float = 0.0  # 0 → use dtype-scaled default
    guard: bool = False
    stagnation_window: int = 0
    drift_scale: float = 0.0  # 0 → 1.0 (bound reaches the abs tolerance)
    trace_cap: int = 0  # 0 → no iteration tracing

    def breakdown_threshold(self, dtype) -> float:
        if self.breakdown_eps:
            return self.breakdown_eps
        return float(torch.finfo(dtype).tiny) * 1e4

    def drift_threshold(self, dtype) -> float:
        """With ``guard``: the drift monitor trips once the accumulated
        rounding bound exceeds this times ``tol * ||r_0||``."""
        del dtype
        return self.drift_scale if self.drift_scale else 1.0


# A matvec is any callable Tensor -> Tensor preserving shape/dtype.
MatVec = Callable[[torch.Tensor], torch.Tensor]

# A user's reduction hook, the JAX package's signature: the stacked local
# dot partials of one reduction phase -> their global values.  Inside the
# port a reduction is a start and a wait (:class:`repro_torch.core._common
# .Reducer`), so a collective can run while the iteration's matvec does.
DotReduce = Callable[[torch.Tensor], torch.Tensor]


def identity_reduce(partials: torch.Tensor) -> torch.Tensor:
    return partials


def derive_config(config: SolverConfig, tol=None, maxiter=None
                  ) -> SolverConfig:
    """``config`` with a call's ``tol`` / ``maxiter`` overrides."""
    if tol is not None:
        config = dataclasses.replace(config, tol=float(tol))
    if maxiter is not None:
        config = dataclasses.replace(config, maxiter=int(maxiter))
    return config


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device with no GPU present raises:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def per_column(value, m: int, dtype, *, name: str = "tol",
               device=None) -> torch.Tensor:
    """Broadcast a per-solve setting (``tol``, ``maxiter``) to a per-column
    ``(m,)`` vector: a scalar goes to all m columns, an ``(m,)`` vector is
    taken as it is, anything else raises (a ``(k,)`` vector of the wrong
    length would hand tolerances to the wrong right-hand sides)."""
    arr = torch.as_tensor(value, dtype=dtype, device=device)
    if arr.dim() == 0:
        return arr.expand(m).clone()
    if tuple(arr.shape) != (m,):
        raise ValueError(
            f"per-column {name} must be a scalar or shape ({m},); "
            f"got shape {tuple(arr.shape)}")
    return arr


def history_init(cfg: SolverConfig, dtype, device) -> torch.Tensor:
    if cfg.record_history:
        return torch.full((cfg.maxiter + 1,), float("nan"), dtype=dtype,
                          device=device)
    return torch.zeros((0,), dtype=dtype, device=device)


def history_update(hist: torch.Tensor, i: torch.Tensor, relres: torch.Tensor,
                   cfg: SolverConfig, active: torch.Tensor) -> torch.Tensor:
    """Write ``relres`` at slot ``i`` in place (device index, no host
    read); a frozen step (``active`` false) keeps the old slot."""
    if not cfg.record_history:
        return hist
    idx = i.to(torch.int64).reshape(1)
    val = torch.where(active, relres.to(hist.dtype).reshape(1),
                      hist.index_select(0, idx))
    hist.index_copy_(0, idx, val)
    return hist


def trace_init(cfg: SolverConfig, dtype, device, m=None) -> torch.Tensor:
    """A fresh NaN-filled iteration-trace ring: ``(cap, C)`` for a
    single-RHS solve, ``(cap, C, m)`` batched (``C = len(TRACE_CHANNELS)``).
    Call only when ``cfg.trace_cap > 0``."""
    shape = (cfg.trace_cap, len(TRACE_CHANNELS)) + (() if m is None else (m,))
    return torch.full(shape, float("nan"), dtype=dtype, device=device)


def trace_record(buf: torch.Tensor, i: torch.Tensor, channels,
                 active: torch.Tensor) -> torch.Tensor:
    """Write one row of ``channels`` (matching :data:`TRACE_CHANNELS`; 0-d
    tensors, or ``(m,)`` batched) at ring slot ``i % cap``, in place, with
    a device index (no host read); a step with ``active`` false (a 0-d
    bool: one queued after the state stopped) keeps the old slot."""
    idx = torch.remainder(i.to(torch.int64), buf.shape[0]).reshape(1)
    row = torch.stack([c.to(buf.dtype) for c in channels]).unsqueeze(0)
    buf.index_copy_(0, idx, torch.where(active, row,
                                        buf.index_select(0, idx)))
    return buf
