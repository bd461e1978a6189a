"""Typed findings and reports for the contract analyzer (the port's own
copy of ``repro.analysis.report``).

A :class:`ContractReport` is the unit the analyzer emits: one traced
session binding (method x substrate x binding kind x guard x precond x
mesh), with one :class:`Finding` per contract pass that ran.  A finding
carries FX provenance, the node(s) the pass anchored its verdict on (the
op and its output shapes), so a violation points at the offending op,
not just at a boolean.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .fx_tools import op_name

#: finding statuses
OK = "ok"
VIOLATION = "violation"
SKIPPED = "skipped"


def node_provenance(node, limit: int = 120) -> str:
    """One-line provenance for an FX node: its op and output shapes, e.g.
    ``repro_torch::mark_reduce -> float64[9, 3]``."""
    val = node.meta.get("val")
    outs = ", ".join(f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
                     for v in (val if isinstance(val, (list, tuple))
                               else [val]) if isinstance(v, torch.Tensor))
    s = f"{op_name(node) or node.target} -> {outs}"
    return s if len(s) <= limit else s[:limit - 3] + "..."


@dataclasses.dataclass(frozen=True)
class Finding:
    """Outcome of ONE contract pass over ONE traced binding."""

    contract: str
    status: str                       # "ok" | "violation" | "skipped"
    detail: str = ""
    provenance: Tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return self.status != VIOLATION

    def to_dict(self) -> Dict:
        return {"contract": self.contract, "status": self.status,
                "detail": self.detail, "provenance": list(self.provenance)}


@dataclasses.dataclass(frozen=True)
class BindingSpec:
    """What was traced: the coordinates of one cell of the scenario
    matrix.  ``guard_effective`` records whether ``guard=True`` actually
    widens the fused phase on this binding (only the batched/open-loop/
    mesh p-BiCGSafe paths carry health rows; single-RHS solvers ignore
    the flag); passes key their (9 vs 11) expectations on it."""

    method: str
    substrate: str
    binding: str                      # single | batched | open_loop | mesh
    guard: bool = False
    precond: Optional[str] = None
    m: int = 1
    mesh_shape: Optional[Tuple[int, ...]] = None
    guard_effective: bool = False
    #: extra kernel ops the bound preconditioner is expected to add to the
    #: step (set at trace time from the RESOLVED instance: block-Jacobi's
    #: apply kernel only engages when nb > 1; the shared-block nb == 1
    #: case is one dense matmul by design, not a silent fallback)
    precond_kernels: int = 0

    @property
    def label(self) -> str:
        bits = [self.method, self.substrate, self.binding]
        if self.guard:
            bits.append("guard")
        if self.precond:
            bits.append(str(self.precond))
        if self.mesh_shape:
            bits.append("mesh" + "x".join(map(str, self.mesh_shape)))
        return "/".join(bits)

    def to_dict(self) -> Dict:
        return {"method": self.method, "substrate": self.substrate,
                "binding": self.binding, "guard": self.guard,
                "precond": self.precond, "m": self.m,
                "mesh_shape": (None if self.mesh_shape is None
                               else list(self.mesh_shape)),
                "guard_effective": self.guard_effective,
                "precond_kernels": self.precond_kernels}


@dataclasses.dataclass(frozen=True)
class ContractReport:
    """All contract findings for one traced binding."""

    spec: BindingSpec
    findings: Tuple[Finding, ...]

    @property
    def ok(self) -> bool:
        return all(f.ok for f in self.findings)

    @property
    def violations(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.status == VIOLATION)

    def finding(self, contract: str) -> Optional[Finding]:
        for f in self.findings:
            if f.contract == contract:
                return f
        return None

    def to_dict(self) -> Dict:
        return {"binding": self.spec.to_dict(),
                "ok": self.ok,
                "findings": [f.to_dict() for f in self.findings]}


_STATUS_CELL = {OK: "pass", VIOLATION: "FAIL", SKIPPED: "-"}


def format_table(reports: Sequence[ContractReport],
                 contracts: Optional[Sequence[str]] = None) -> str:
    """Human-readable contract table: one row per binding, one column
    per contract pass (``pass`` / ``FAIL`` / ``-`` for not-applicable)."""
    if contracts is None:
        seen: List[str] = []
        for r in reports:
            for f in r.findings:
                if f.contract not in seen:
                    seen.append(f.contract)
        contracts = seen
    headers = ["binding"] + list(contracts)
    rows = []
    for r in reports:
        row = [r.spec.label]
        for c in contracts:
            f = r.finding(c)
            row.append(_STATUS_CELL.get(f.status, "?") if f else "-")
        rows.append(row)
    widths = [max(len(h), *(len(row[i]) for row in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*row) for row in rows]
    return "\n".join(lines)
