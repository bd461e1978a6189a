"""Newton-Krylov optimizer: the paper's solver as a training feature
(PyTorch port of ``repro.optim.newton_krylov``).

Each step solves the damped Gauss-Newton system

    (J'J + lambda I) delta = -g          (GGN = J' H_CE J via JVP / VJP)

with **p-BiCGSafe** (paper Alg. 3.1) as the inner linear solver, matrix-free
over the flattened parameter vector, then takes the best of four scaled
steps (1, 0.3, 0.1, 0: monotone descent).

The flat vector.  ``params`` is an ``nn.Module`` or a mapping of tensors;
its leaves are laid end to end in the JAX package's ``ravel_pytree`` order
(a mapping's sorted keys; a :class:`~repro_torch.models.Transformer`'s
parameters by their JAX tree path, a stacked leaf's layers in turn; any
other module in ``named_parameters`` order), so a flat vector of either
package is the other's.  Inside the step the leaves are views of one flat
vector, split and reshaped, and the model runs on them through
``torch.func.functional_call``.

The GGN matvec is ``torch.func.jvp`` and then the pullback of one
``torch.func.vjp``: the linearization point is fixed for the whole solve,
so the logits, their softmax and the pullback are taken once, before the
solve, and each matvec runs one forward-mode pass and one backward pass.
The CE-Hessian product accumulates in ``acc_dtype`` (f64 when the
parameters are f64): a downcast there makes the operator nonlinear at the
rounding level, which breaks p-BiCGSafe's recurrences.

The inner solve is ``cfg.solver`` (default the port's
:func:`~repro_torch.core.pipelined_bicgsafe.pbicgsafe_solve` on its
default ``"torch"`` substrate); ``functools.partial(pbicgsafe_solve,
substrate="cuda")`` runs its fused dots and update phase as the CUDA
kernels.  It runs the eager program (:func:`repro_torch.core.program
._eager_chunks`), on the card too, and never a captured CUDA graph:

* a graph gains nothing here: a solver step is two GGN matvecs, each a
  forward-mode and a backward pass through the model (18.6 ms at phi3's
  width, depth 1, on an H100), against the host's launches of the step's
  other kernels;
* a capture costs what the card does not have: its warm-up runs the chunk
  on a scratch copy of the state beside the program's own buffers, two
  more copies of 11 vectors of the parameters' size (at phi3's width and
  depth 1, 310 M unknowns, the capture's warm-up ran out of the H100's 80
  GB);
* the pullback, taken once before the solve on the caller's stream, runs
  its backward on that stream, which a capture on the program's side stream
  may not wait on ("operation would make the legacy stream depend on a
  capturing blocking stream", on an H100 with torch 2.11).

A module's parameters are updated in place, as a ``torch.optim`` step
updates them; a mapping gets a new mapping back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Tuple, Union

import torch
from torch import nn

from repro_torch.core.pipelined_bicgsafe import pbicgsafe_solve
from repro_torch.core.program import _eager_chunks
from repro_torch.core.types import SolverConfig
from repro_torch.models.transformer import Transformer, param_path

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class NewtonKrylovConfig:
    lr: float = 1.0
    damping: float = 1e-2
    trust_radius: float = 1.0      # cap on ||delta|| (LM-style safeguard
    #                                against near-null-space amplification)
    inner_tol: float = 1e-3
    inner_maxiter: int = 20
    solver: Callable = pbicgsafe_solve


class _Bound(nn.Module):
    """``fn(module, batch)`` as a module's forward, so that
    ``functional_call`` runs it on other tensors than the parameters."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, batch):
        return self.fn(self.module, batch)


@dataclasses.dataclass
class Raveled:
    """The leaves of ``params`` as one flat vector: ``flat`` (a copy),
    ``names`` in its order, ``unravel(flat) -> {name: view}`` and
    ``call(fn, tensors, batch)``, ``fn`` run on ``tensors`` in the
    parameters' place."""

    params: Params
    names: List[str]
    flat: torch.Tensor
    shapes: List[torch.Size]
    dtypes: List[torch.dtype]

    @property
    def sizes(self) -> List[int]:
        return [s.numel() for s in self.shapes]

    def unravel(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: t.view(shape).to(dt) for k, t, shape, dt in zip(
            self.names, flat.split(self.sizes), self.shapes, self.dtypes)}

    def call(self, fn: Callable, tensors: Dict[str, torch.Tensor], batch):
        if isinstance(self.params, nn.Module):
            return torch.func.functional_call(
                _Bound(self.params, fn),
                {f"module.{k}": t for k, t in tensors.items()}, (batch,))
        return fn(tensors, batch)


def _leaves(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        if isinstance(params, Transformer):
            return {k: named[k] for k in sorted(named, key=param_path)}
        return named
    return {k: params[k] for k in sorted(params)}


def ravel(params: Params) -> Raveled:
    """``params``'s leaves end to end, in the JAX package's order (see the
    module's docstring), promoted to one dtype as ``ravel_pytree`` does."""
    leaves = _leaves(params)
    dtype = leaves[next(iter(leaves))].dtype
    for t in leaves.values():
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.detach().reshape(-1).to(dtype)
                      for t in leaves.values()])
    return Raveled(params, list(leaves), flat,
                   [t.shape for t in leaves.values()],
                   [t.dtype for t in leaves.values()])


def _ggn_matvec(logits_fn: Callable, rv: Raveled, batch, damping: float):
    def logits_of(flat):
        return rv.call(logits_fn, rv.unravel(flat), batch)

    flat0 = rv.flat
    acc_dtype = torch.promote_types(flat0.dtype, torch.float32)
    logits, pullback = torch.func.vjp(logits_of, flat0)
    p = torch.softmax(logits.detach().to(acc_dtype), dim=-1)

    def matvec(v: torch.Tensor) -> torch.Tensor:
        _, jv = torch.func.jvp(logits_of, (flat0,), (v,))    # (B..., V)
        hjv = p * jv.to(acc_dtype)
        hjv = hjv - p * hjv.sum(dim=-1, keepdim=True)
        n_rows = hjv.numel() // hjv.shape[-1]
        hjv = (hjv / n_rows).to(jv.dtype)
        (jt_hjv,) = pullback(hjv)
        return jt_hjv + damping * v

    return matvec


def make_ggn_matvec(loss_logits_fn: Callable, params: Params, batch,
                    damping: float):
    """``loss_logits_fn(params, batch) -> (B..., V)`` logits for CE loss.

    Returns ``(matvec, flat0, unravel)``: ``matvec`` over the flat
    parameter vector computes ``(J' H_CE J + damping I) v`` with ``H_CE =
    diag(p) - p p'``."""
    rv = ravel(params)
    return _ggn_matvec(loss_logits_fn, rv, batch, damping), rv.flat, \
        rv.unravel


def newton_krylov_step(loss_fn_: Callable, logits_fn: Callable,
                       params: Params, batch, cfg: NewtonKrylovConfig,
                       dot_reduce=None) -> Tuple[Any, Dict[str, Any]]:
    """One truncated Gauss-Newton step: ``(new_params, metrics)``, the
    metrics 0-d tensors (no host read).  A module is updated in place and
    returned; a mapping gets a new mapping."""
    rv = ravel(params)
    flat0 = rv.flat
    g_flat, loss = torch.func.grad_and_value(
        lambda f: rv.call(loss_fn_, rv.unravel(f), batch))(flat0)
    matvec = _ggn_matvec(logits_fn, rv, batch, cfg.damping)

    with _eager_chunks():                    # see the module's docstring
        res = cfg.solver(
            matvec, -g_flat,
            config=SolverConfig(tol=cfg.inner_tol,
                                maxiter=cfg.inner_maxiter),
            dot_reduce=dot_reduce)
    dnorm = torch.linalg.vector_norm(res.x)
    step_flat = res.x * torch.clamp(
        cfg.trust_radius / torch.clamp(dnorm, min=1e-12), max=1.0)

    # backtracking line search (incl. 0 fallback => monotone descent); the
    # update in f32 and cast back, per leaf in the JAX package, elementwise
    # here on the flat vector
    def flat_at(t):
        delta = (step_flat * t).to(flat0.dtype)
        return (flat0.float() + cfg.lr * delta.float()).to(flat0.dtype)

    ts = torch.tensor([1.0, 0.3, 0.1, 0.0], device=flat0.device,
                      dtype=torch.promote_types(step_flat.dtype,
                                                torch.float32))
    with torch.no_grad():
        losses = torch.stack([
            rv.call(loss_fn_, rv.unravel(flat_at(t)), batch).detach()
            for t in ts])
        best = torch.argmin(losses)
        new = rv.unravel(flat_at(ts[best]))
        if isinstance(params, nn.Module):
            named = dict(params.named_parameters())
            for k, t in new.items():
                named[k].copy_(t)
            new_params = params
        else:
            new_params = new
    metrics = {"loss": loss.detach(), "inner_iters": res.iterations,
               "inner_relres": res.relres,
               "inner_converged": res.converged,
               "step_scale": ts[best], "new_loss": losses[best]}
    return new_params, metrics
