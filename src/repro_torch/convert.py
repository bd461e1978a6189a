"""Operators from numpy arrays: the way the JAX package's operators (or any
other source) are carried into the port, so both packages can be handed
the same matrix.

    op = operator_from_numpy("ell", {"values": v, "cols": c, "n": n},
                             device="cuda", dtype=torch.float64)

Kinds and their arrays:

* ``"dense"``    — ``a``;
* ``"csr"``      — ``data``, ``indices``, ``row_ids``, ``n``;
* ``"ell"``      — ``values``, ``cols``, ``n``;
* ``"stencil7"`` — ``c``, ``nx``, ``ny``, ``nz``.

Float arrays take ``dtype`` (``None`` keeps theirs); index arrays become
int32.

Preconditioners are carried over the same way, from the arrays of a built
one:

    pc = preconditioner_from_numpy("block_jacobi",
                                   {"inv_blocks": np.asarray(jpc.inv_blocks)},
                                   device="cuda")

* ``"jacobi"``       — ``inv_diag``;
* ``"block_jacobi"`` — ``inv_blocks``;
* ``"neumann"``      — ``inv_diag``, ``degree``, ``omega``, and the port's
  operator as ``op=``;
* ``"ssor"``         — ``c``, ``nx``, ``ny``, ``nz``, ``omega``, ``terms``.

An LM's weights are carried over from the JAX package's parameter tree,
its leaves as float numpy arrays (the per-layer leaves stacked on a leading
``L`` axis, as ``repro.models.init_params`` makes them):

    model = lm_params_from_numpy(cfg, tree, device="cuda")

A bf16 leaf passed as ``np.asarray(leaf.astype(jnp.float32))`` is exact,
so the port's bf16 weights equal the JAX package's bit for bit.

A whole training state is carried over the same way, from the JAX
package's ``{"params", "opt": {"m", "v", "count"}, "clip"}`` as numpy
(8-bit moments as objects with ``codes`` and ``scales``, the clip state as
``(prev_norm, initialized)``):

    state = train_state_from_numpy(cfg, jax_state, state_dtype="f32",
                                   device="cuda")
    model, opt, clip = state["params"], state["opt"], state["clip"]
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.linear_operator import (CSROperator, DenseOperator, ELLOperator,
                                   Stencil7Operator)
from .core.types import resolve_device
from .models import ModelConfig, Transformer
from .precond import (BlockJacobiPreconditioner, JacobiPreconditioner,
                      NeumannPreconditioner, SSORPreconditioner)

KINDS = {
    "dense": ("a",),
    "csr": ("data", "indices", "row_ids", "n"),
    "ell": ("values", "cols", "n"),
    "stencil7": ("c", "nx", "ny", "nz"),
}

PRECOND_KINDS = {
    "jacobi": ("inv_diag",),
    "block_jacobi": ("inv_blocks",),
    "neumann": ("inv_diag", "degree", "omega"),
    "ssor": ("c", "nx", "ny", "nz", "omega", "terms"),
}


def _checked(kinds: Mapping, what: str, kind: str, arrays: Mapping):
    if kind not in kinds:
        raise ValueError(f"unknown {what} kind {kind!r}; expected one of "
                         f"{sorted(kinds)}")
    missing = set(kinds[kind]) - set(arrays)
    if missing:
        raise KeyError(f"{kind} {what} needs {sorted(missing)}")


def _float(arrays: Mapping, name: str, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)


def operator_from_numpy(kind: str, arrays: Mapping, *, device=None,
                        dtype=None):
    """Build the port's operator of ``kind`` from numpy arrays."""
    _checked(KINDS, "operator", kind, arrays)
    device = resolve_device(device)

    def fl(name):
        return _float(arrays, name, device, dtype)

    def ix(name):
        return torch.tensor(np.asarray(arrays[name], dtype=np.int32),
                            device=device)

    if kind == "dense":
        return DenseOperator(fl("a"))
    if kind == "csr":
        return CSROperator(fl("data"), ix("indices"), ix("row_ids"),
                           int(arrays["n"]))
    if kind == "ell":
        return ELLOperator(fl("values").contiguous(),
                           ix("cols").contiguous(), int(arrays["n"]))
    return Stencil7Operator(fl("c"), int(arrays["nx"]), int(arrays["ny"]),
                            int(arrays["nz"]))


def preconditioner_from_numpy(kind: str, arrays: Mapping, *, op=None,
                              device=None, dtype=None):
    """Build the port's preconditioner of ``kind`` from numpy arrays (and,
    for ``"neumann"``, the port's operator ``op``, whose matvecs its series
    runs)."""
    _checked(PRECOND_KINDS, "preconditioner", kind, arrays)
    device = resolve_device(device)

    def fl(name):
        return _float(arrays, name, device, dtype).contiguous()

    if kind == "jacobi":
        return JacobiPreconditioner(fl("inv_diag"))
    if kind == "block_jacobi":
        return BlockJacobiPreconditioner(fl("inv_blocks"))
    if kind == "neumann":
        if op is None:
            raise TypeError("a neumann preconditioner needs its operator: "
                            "pass op=")
        return NeumannPreconditioner(op, fl("inv_diag"),
                                     int(arrays["degree"]),
                                     float(arrays["omega"]))
    return SSORPreconditioner(fl("c"), int(arrays["nx"]), int(arrays["ny"]),
                              int(arrays["nz"]), float(arrays["omega"]),
                              int(arrays["terms"]))


#: leaves the JAX package draws in f32 whatever ``cfg.param_dtype``
F32_LEAVES = ("router", "router_bias")


def lm_params_from_numpy(cfg: ModelConfig, params: Mapping[str, Any], *,
                         device=None, dtype=None) -> Transformer:
    """The port's :class:`~repro_torch.models.Transformer` for ``cfg`` with
    the weights of the JAX package's tree ``params`` (nested dicts of float
    arrays; ``layers`` stacked on a leading ``L`` axis), cast to ``dtype``
    (``None``: ``cfg.param_dtype``) on ``device`` (``None`` means
    ``"cuda"``).  The MoE router's leaves (``F32_LEAVES``) stay in f32 at
    least, as the JAX package keeps them whatever its ``param_dtype``."""
    device = resolve_device(device)
    dtype = cfg.param_dtype if dtype is None else dtype
    wide = torch.promote_types(dtype, torch.float32)

    def tensor(a, name: str = "") -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=device).to(
            wide if name in F32_LEAVES else dtype)

    def layer(tree, i: int, name: str = ""):
        if isinstance(tree, Mapping):
            return {k: layer(v, i, k) for k, v in tree.items()}
        return tensor(np.asarray(tree)[i], name)

    stacked = params["layers"]
    n = len(np.asarray(stacked["ln1"]))
    if n != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree has {n} layers, the config "
                         f"{cfg.n_layers}")
    tree = {k: tensor(params[k]) for k in ("embed", "final_norm", "lm_head")
            if k in params}
    tree["layers"] = [layer(stacked, i) for i in range(n)]
    return Transformer(cfg, tree)


def _moment(leaf, dtype, device):
    if hasattr(leaf, "codes"):                  # an 8-bit moment
        from .optim.eightbit import Q8
        return Q8(torch.tensor(np.asarray(leaf.codes, dtype=np.int8),
                               device=device),
                  torch.tensor(np.asarray(leaf.scales, dtype=np.float32),
                               device=device))
    return torch.tensor(np.asarray(leaf), device=device).to(dtype)


def train_state_from_numpy(cfg: ModelConfig, state: Mapping[str, Any], *,
                           state_dtype: str = "f32", device=None,
                           dtype=None) -> dict:
    """The port's training state from the JAX package's ``state`` (numpy
    leaves, the layout of its checkpoints): ``{"params": Transformer,
    "opt": {"m", "v", "count"}, "clip": PipelinedClipState}`` on
    ``device`` (``None`` means ``"cuda"``).  The weights as
    :func:`lm_params_from_numpy` carries them (``dtype``), the moments in
    ``state_dtype`` (``"f32"``, ``"bf16"``, or ``"i8"`` from 8-bit
    leaves) for every leaf, the MoE router's included (the JAX package's
    moments follow its ``state_dtype``, not the parameter's dtype), keyed
    by the model's parameter names."""
    from .models.transformer import params_from_tree
    from .optim.clipping import PipelinedClipState
    if state_dtype not in ("f32", "bf16", "i8"):
        raise ValueError(f"state_dtype must be f32 | bf16 | i8, not "
                         f"{state_dtype!r}")
    device = resolve_device(device)
    model = lm_params_from_numpy(cfg, state["params"], device=device,
                                 dtype=dtype)
    names = [k for k, _ in model.named_parameters()]
    mdt = torch.bfloat16 if state_dtype == "bf16" else torch.float32
    opt = state["opt"]
    moments = {key: {k: _moment(v, mdt, device) for k, v in
                     params_from_tree(opt[key], names).items()}
               for key in ("m", "v")}
    prev, init = state["clip"]
    return {"params": model,
            "opt": dict(moments, count=torch.tensor(
                np.asarray(opt["count"]), dtype=torch.int32,
                device=device)),
            "clip": PipelinedClipState(
                torch.tensor(np.asarray(prev), dtype=torch.float32,
                             device=device),
                torch.tensor(np.asarray(init), dtype=torch.bool,
                             device=device))}
