"""Typed view over the on-device iteration-trace ring buffer (PyTorch
port of ``repro.observe.trace``; its JSON loads in either package).

Solvers running with ``SolverConfig.trace_cap > 0`` carry a
``(cap, C[, m])`` ring buffer in their loop state and return it as the
raw payload ``SolveResult.trace = {"buffer": ..., "steps": int32}``
(see :data:`repro_torch.core.types.TRACE_CHANNELS` for the channel
layout).  That shape is deliberately dumb: it must live in a program's
state buffers, written in place on the device.  :class:`ConvergenceTrace`
is the host boundary: it materializes the buffer ONCE (one
device-to-host copy, and only when the caller asked for a trace), unrolls
the ring into
chronological order, and answers the questions an operator actually
asks — how did relres fall, which denominator collapsed first, when did
drift start growing.

The ring keeps the LAST ``cap`` iterations: slot ``i % cap`` holds
iteration ``i``, so with ``steps`` total iterations the valid rows are
``steps - min(steps, cap) .. steps - 1`` in slot order
``(steps - k + j) % cap``.  Batched buffers additionally repeat a
frozen column's last row every *global* iteration (the batched body
steps all m columns in lockstep) — :meth:`per_iteration` collapses
those plateaus using the iteration channel.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from ..core.types import TRACE_CHANNELS, SolveStatus

_CH = {name: i for i, name in enumerate(TRACE_CHANNELS)}


class ConvergenceTrace:
    """Chronological per-iteration trace of one solve (or one block).

    Attributes:
      buffer: the raw ``(cap, C)`` or ``(cap, C, m)`` ring buffer
        (host numpy; NaN rows are never-written or splice-reset slots).
      steps: total iterations the traced loop executed (the ring holds
        the last ``min(steps, cap)`` of them).
      channels: channel-name tuple (:data:`~repro_torch.core.types
        .TRACE_CHANNELS`).
    """

    channels = TRACE_CHANNELS

    def __init__(self, buffer, steps: int):
        self.buffer = np.asarray(buffer)
        if self.buffer.ndim not in (2, 3) \
                or self.buffer.shape[1] != len(TRACE_CHANNELS):
            raise ValueError(
                f"trace buffer must be (cap, {len(TRACE_CHANNELS)}[, m]); "
                f"got shape {self.buffer.shape}")
        self.steps = int(steps)

    # -- shape ------------------------------------------------------------
    @property
    def cap(self) -> int:
        return self.buffer.shape[0]

    @property
    def batched(self) -> bool:
        return self.buffer.ndim == 3

    @property
    def m(self) -> Optional[int]:
        return self.buffer.shape[2] if self.batched else None

    def __len__(self) -> int:
        return min(self.steps, self.cap)

    def column(self, j: int) -> "ConvergenceTrace":
        """The single-column view of a batched trace."""
        if not self.batched:
            raise ValueError("column() on a single-RHS trace")
        return ConvergenceTrace(self.buffer[:, :, j], self.steps)

    # -- chronological views ----------------------------------------------
    def rows(self) -> np.ndarray:
        """Valid rows in chronological order: ``(k, C[, m])`` with
        ``k = min(steps, cap)`` (the last k iterations)."""
        k = len(self)
        slots = (np.arange(self.steps - k, self.steps) % self.cap
                 if k else np.zeros((0,), np.int64))
        return self.buffer[slots]

    def channel(self, name: str) -> np.ndarray:
        """One channel's chronological values: ``(k[, m])``."""
        return self.rows()[:, _CH[name]]

    def per_iteration(self) -> np.ndarray:
        """Chronological ``(k', C)`` rows, one per *advanced* iteration.

        Single-RHS view only (take :meth:`column` first for a batched
        trace).  Drops NaN rows (never-written / splice-reset slots) and
        collapses consecutive rows whose iteration channel did not
        advance — the frozen-column plateau a batched lockstep body
        writes after a column converges.
        """
        if self.batched:
            raise ValueError(
                "per_iteration() needs a single column; use .column(j)")
        rows = self.rows()
        if not rows.size:
            return rows
        rows = rows[np.isfinite(rows[:, _CH["iteration"]])]
        if not rows.size:
            return rows
        it = rows[:, _CH["iteration"]]
        keep = np.ones(len(rows), bool)
        keep[1:] = it[1:] != it[:-1]
        return rows[keep]

    # -- summaries --------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Host-friendly digest of a single-column trace."""
        rows = self.per_iteration()
        if not rows.size:
            return {"iterations": 0, "recorded": 0, "final_relres": None,
                    "min_relres": None, "status": None}
        last = rows[-1]
        relres = rows[:, _CH["relres"]]
        code = int(last[_CH["status"]])
        try:
            status = SolveStatus(code).name
        except ValueError:
            status = str(code)
        return {
            "iterations": int(last[_CH["iteration"]]),
            "recorded": int(len(rows)),
            "final_relres": float(last[_CH["relres"]]),
            "min_relres": float(np.nanmin(relres)),
            "status": status,
            "final_drift": float(last[_CH["drift"]]),
        }

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        """JSON-able payload (NaN encoded as None) for the report CLI."""
        buf = self.buffer.astype(np.float64)
        nested = np.where(np.isfinite(buf), buf, None).tolist()
        return {"schema": "repro.observe/convergence-trace/v1",
                "channels": list(self.channels), "steps": self.steps,
                "buffer": nested}

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "ConvergenceTrace":
        buf = np.asarray(
            [[[np.nan if v is None else v for v in
               (col if isinstance(col, list) else [col])]
              for col in row] for row in data["buffer"]], np.float64)
        if not any(isinstance(col, list)
                   for row in data["buffer"] for col in row):
            buf = buf[:, :, 0]
        return cls(buf, int(data["steps"]))

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)

    def __repr__(self):
        shape = f"m={self.m}, " if self.batched else ""
        return (f"<ConvergenceTrace {shape}cap={self.cap} "
                f"steps={self.steps} recorded={len(self)}>")


def wrap_trace(payload) -> Optional[ConvergenceTrace]:
    """Wrap a ``SolveResult.trace`` payload at the host boundary.

    ``None`` passes through (tracing off); an already-wrapped trace
    passes through; the solver's ``{"buffer", "steps"}`` dict of device
    tensors becomes a :class:`ConvergenceTrace` (this is the one
    device-to-host copy of the buffer).
    """
    if payload is None or isinstance(payload, ConvergenceTrace):
        return payload
    buf = payload["buffer"]
    if hasattr(buf, "detach"):
        buf = buf.detach().cpu().numpy()
    return ConvergenceTrace(buf, int(payload["steps"]))
