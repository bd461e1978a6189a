"""Fault injection for chaos-testing guarded solves (PyTorch port of
``repro.resilience.inject``).

Deterministic, host-controlled faults:

* :class:`ChunkFaultInjector` — the GuardedSolver's test hook: NaN written
  into chosen columns of the live state, and simulated kernel failures,
  fired at chosen chunk boundaries;
* :func:`nan_columns` — poison chosen columns of a state field;
* :func:`near_singular_dense` — a dense operator with a controlled
  smallest singular value, built in numpy with the JAX package's random
  calls, so its matrix equals the JAX package's bit for bit;
* :func:`orthogonal_shadow` — a shadow residual orthogonal to r0 (zero
  initial rho: the BREAKDOWN_RHO scenario).

The service's virtual clock and block corruption (``TickingClock``,
``corrupt_engine_block``) belong to the service, which is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..core.linear_operator import DenseOperator


class SimulatedKernelFailure(RuntimeError):
    """Stand-in for a kernel launch or execution failure: the
    GuardedSolver's degradation path treats it as a failure of the
    ``"cuda"`` kernels (rebuild on ``"torch"``, go on from the same
    state)."""


def nan_columns(state: dict, cols: Sequence[int], field: str = "r") -> dict:
    """``state`` with NaN written into ``cols`` of ``field`` (a poisoned
    residual column, by default); the guarded (11, m) phase's probe finds
    it on the next iteration."""
    arr = state[field]
    mask = torch.zeros(arr.shape[-1], dtype=torch.bool, device=arr.device)
    mask[list(cols)] = True
    out = dict(state)
    out[field] = torch.where(mask, float("nan"), arr)
    return out


class ChunkFaultInjector:
    """Deterministic fault schedule over a guarded solve's chunk loop.

    Args:
      nan_at: ``{chunk_index: columns}`` — before that chunk runs, NaN is
        written into those columns of ``field``.
      fail_at: chunk indices at which a :class:`SimulatedKernelFailure` is
        raised (once each: the retried chunk proceeds).
      field: the state field to poison (default the residual ``"r"``).

    An instance is a callable ``(chunk_index, state) -> state``, the
    signature of ``GuardedSolver.inject``.
    """

    def __init__(self, nan_at: Optional[Dict[int, Sequence[int]]] = None,
                 fail_at: Iterable[int] = (), field: str = "r"):
        self.nan_at = {int(k): tuple(v) for k, v in (nan_at or {}).items()}
        self.fail_at = set(int(k) for k in fail_at)
        self.field = field
        self.fired: list = []

    def __call__(self, chunk_index: int, state: dict) -> dict:
        if chunk_index in self.fail_at:
            self.fail_at.discard(chunk_index)
            self.fired.append(("kernel_failure", chunk_index))
            raise SimulatedKernelFailure(
                f"injected kernel failure at chunk {chunk_index}")
        cols = self.nan_at.pop(chunk_index, None)
        if cols:
            self.fired.append(("nan", chunk_index, cols))
            state = nan_columns(state, cols, self.field)
        return state


def near_singular_dense(n: int, *, sigma_min: float = 1e-14, seed: int = 0,
                        dtype=torch.float64, device=None) -> DenseOperator:
    """A :class:`DenseOperator` whose smallest singular value is
    ``sigma_min``: ``U diag(s) V^T`` from a seeded random orthogonal pair,
    with the spectrum spread over [1, 2] but for one tiny value."""
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.linspace(1.0, 2.0, n)
    s[0] = sigma_min
    a = (q1 * s) @ q2.T
    return DenseOperator(torch.as_tensor(a, device=device).to(dtype))


def orthogonal_shadow(r0: torch.Tensor) -> torch.Tensor:
    """A shadow residual orthogonal to ``r0`` up to round-off (pair it
    with an explicit ``breakdown_eps`` such as 1e-12): zero initial
    ``rho = (r0*, r0)`` makes the first denominators degenerate."""
    v = torch.ones_like(r0)
    proj = torch.dot(r0, v) / torch.dot(r0, r0)
    shadow = v - proj * r0
    # degenerate case (r0 parallel to ones): a coordinate swap
    alt = torch.zeros_like(r0)
    alt[0] = 1.0
    alt[1] -= 1.0
    use_alt = torch.sqrt(torch.dot(shadow, shadow)) == 0
    return torch.where(use_alt, alt, shadow)
