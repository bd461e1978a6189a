"""Recovery steps over the guarded batched p-BiCGSafe state (PyTorch port
of ``repro.resilience.recover``).

Both are plain functions of the state dict of
:mod:`repro_torch.core.multirhs`; :class:`repro_torch.resilience
.GuardedSolver` applies them at chunk boundaries to the columns its policy
selects.  Both are masked: the other columns pass through bit for bit, so
recovering one column never moves its neighbours.

``replace_columns`` is the on-trigger form of p-BiCGSafe-rr's reset (Alg.
4.1): recompute ``r`` and every recurred A-image from true matvecs, fired by
the in-flight drift bound instead of a fixed ``rr_epoch``.
``restart_columns`` re-seeds the Krylov space from the current iterate
after a typed breakdown: a fresh solve with ``x0 = x_current`` (non-finite
entries set to 0 first).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.multirhs import _guard_init
from ..core.multirhs import _masked as _select


def replace_columns(bmv: Callable, state: dict, mask: torch.Tensor,
                    B: torch.Tensor) -> dict:
    """Residual replacement of the masked columns:

        r = b - A x,  s = A r,  l = A t,  g = A y,  w = A u

    from true matvecs (5 block matvecs on the whole block); ``p, u, t, y,
    z`` and ``x`` are exact either way.  Resets the columns' drift and
    counts the event in ``replacements``.  ``B`` is the right-hand-side
    block the state was built from (the state does not carry it)."""
    mask = mask.to(torch.bool)
    r_true = B.to(state["r"].dtype) - bmv(state["x"])
    out = dict(state)
    out["r"] = _select(mask, r_true, state["r"])
    out["s"] = _select(mask, bmv(r_true), state["s"])
    out["l"] = _select(mask, bmv(state["t"]), state["l"])
    out["g"] = _select(mask, bmv(state["y"]), state["g"])
    out["w"] = _select(mask, bmv(state["u"]), state["w"])
    out["drift"] = _select(mask, torch.zeros_like(state["drift"]),
                           state["drift"])
    out["drift_flag"] = state["drift_flag"] & ~mask
    out["replacements"] = _select(mask, state["replacements"] + 1,
                                  state["replacements"])
    return out


def restart_columns(bmv: Callable, state: dict, mask: torch.Tensor,
                    B: torch.Tensor) -> dict:
    """Restart the masked columns from their current iterate (2 block
    matvecs): ``r0 = b - A x0`` becomes the residual and the fresh shadow,
    the auxiliary vectors and coefficient carries reset, the iteration
    count restarts (the driver bounds the total work).  ``norm_r0`` is
    kept, so relres stays comparable across the restart; a column whose
    restarted residual is already below its tolerance is converged on the
    spot.  Counts the event in ``restarts``."""
    mask = mask.to(torch.bool)
    m = mask.shape[0]
    x = state["x"]
    x_safe = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    r0 = B.to(x.dtype) - bmv(x_safe)
    # only the masked columns' r0 matters; keep the rest numerically inert
    r0 = torch.where(mask, r0, torch.zeros_like(r0))
    s0 = bmv(r0)
    norm_new = torch.sqrt((r0 * r0).sum(0))
    relres_new = (norm_new / state["norm_r0"]).to(state["relres"].dtype)
    conv_new = relres_new <= state["tol"]

    zero = torch.zeros_like(state["r"])
    out = dict(state)
    out["x"] = _select(mask, x_safe, x)
    out["r"] = _select(mask, r0, state["r"])
    out["s"] = _select(mask, s0, state["s"])
    out["rs"] = _select(mask, r0, state["rs"])
    for k in ("p", "u", "t", "y", "z", "w", "l", "g"):
        out[k] = _select(mask, zero, state[k])
    out["alpha"] = _select(mask, torch.zeros_like(state["alpha"]),
                           state["alpha"])
    out["zeta"] = _select(mask, torch.ones_like(state["zeta"]), state["zeta"])
    out["f"] = _select(mask, torch.ones_like(state["f"]), state["f"])
    out["iterations"] = _select(mask, torch.zeros_like(state["iterations"]),
                                state["iterations"])
    out["relres"] = _select(mask, relres_new, state["relres"])
    out["converged"] = _select(mask, conv_new, state["converged"])
    out["breakdown"] = state["breakdown"] & ~mask
    # _guard_init stamps CONVERGED where conv_new and RUNNING elsewhere:
    # the restart's status too
    fresh = _guard_init(m, state["drift"].dtype, conv_new)
    for k in ("status", "drift", "drift_flag", "stall", "best_relres",
              "stagnant"):
        out[k] = _select(mask, fresh[k], state[k])
    out["restarts"] = _select(mask, state["restarts"] + 1, state["restarts"])
    return out
