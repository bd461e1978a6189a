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
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.linear_operator import (CSROperator, DenseOperator, ELLOperator,
                                   Stencil7Operator)
from .core.types import resolve_device

KINDS = {
    "dense": ("a",),
    "csr": ("data", "indices", "row_ids", "n"),
    "ell": ("values", "cols", "n"),
    "stencil7": ("c", "nx", "ny", "nz"),
}


def operator_from_numpy(kind: str, arrays: Mapping, *, device=None,
                        dtype=None):
    """Build the port's operator of ``kind`` from numpy arrays."""
    if kind not in KINDS:
        raise ValueError(f"unknown operator kind {kind!r}; expected one of "
                         f"{sorted(KINDS)}")
    missing = set(KINDS[kind]) - set(arrays)
    if missing:
        raise KeyError(f"{kind} operator needs {sorted(missing)}")
    device = resolve_device(device)

    def fl(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=device)

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
