"""The binding-matrix audit: statically prove the contracts everywhere
(counterpart of ``repro.analysis.audit``).

``run_audit`` sweeps every cell of the matrix (all 7 methods x {torch,
cuda} x {guard on/off} x {precond on/off}, the open-loop service chunk,
and a mesh smoke) through :func:`~repro_torch.analysis.trace
.trace_binding` and the contract passes, then compares each finding with
the paper's expected outcome for that cell.  Everything is TRACED in fake
mode, never executed: no solve runs, no kernel launches.

The baseline methods are the audit's negative controls: BiCGStab / CGS /
GPBi-CG *should* fail ``one_reduction_per_iteration`` and
``overlap_edge_free``; that differential is the paper's claim, and an
analyzer that cannot see it proves nothing.  The audit therefore fails on
DEVIATIONS from the expected matrix (a pipelined method regressing to two
reductions, OR a baseline suddenly "passing", which would mean the probe
lost its anchor), not on expected violations.

The cell list is derived from the scenario registry (:func:`audit_specs`,
:mod:`repro_torch.scenarios.cells`): the dense acceptance matrix plus one
row per registered scenario, whose operator is built through its plugin
and whose plugin's ``contract_overrides`` are merged over the expected
matrix.

Artifact: ``experiments/torch_contract_audit.json`` (schema
``repro_torch.analysis/contract_audit/v1``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from ..core.linear_operator import Stencil7Operator
from ..core.types import resolve_device
from .passes import _KERNEL_PHASES, run_passes
from .report import OK, SKIPPED, VIOLATION, BindingSpec, ContractReport
from .trace import trace_binding

__all__ = ["ARTIFACT_SCHEMA", "METHOD_ORDER", "SUBSTRATE_ORDER",
           "expected_outcomes", "audit_specs", "audit_operator",
           "mesh_cells", "one_rank_group", "run_audit", "audit_table"]

ARTIFACT_SCHEMA = "repro_torch.analysis/contract_audit/v1"

#: audit row order: the paper's methods first, then the baselines
METHOD_ORDER = ("p-bicgsafe", "p-bicgsafe-rr", "ssbicgsafe2",
                "p-bicgstab", "bicgstab", "gpbicg", "cgs")

#: methods whose single fused phase ALSO hides behind the matvec
PIPELINED = frozenset({"p-bicgsafe", "p-bicgsafe-rr"})
#: methods with the one fused (9[, m]) reduction phase per iteration
FUSED = PIPELINED | frozenset({"ssbicgsafe2"})

SUBSTRATE_ORDER = ("torch", "cuda")


def expected_outcomes(spec: BindingSpec) -> Dict[str, str]:
    """The paper-expected status of every contract for one cell.

    Pipelined BiCGSafe methods satisfy the full contract set; sequential
    ssBiCGSafe2 fuses the dots but its reduction consumes the matvec (one
    sync, no hiding); the BiCGStab/GPBi-CG family keeps 2-3 scattered
    reductions: the negative controls.
    """
    exp = {}
    exp["one_reduction_per_iteration"] = \
        OK if spec.method in FUSED else VIOLATION
    # a one-rank mesh has no halo receives: every reduction is trivially
    # edge-free there, even for the sequential methods
    trivial_mesh = spec.binding == "mesh" and spec.mesh_shape is not None \
        and all(d == 1 for d in spec.mesh_shape)
    exp["overlap_edge_free"] = \
        OK if (spec.method in PIPELINED or trivial_mesh) else VIOLATION
    exp["single_psum_sharded"] = SKIPPED if spec.binding != "mesh" else (
        OK if spec.method in FUSED else VIOLATION)
    exp["kernel_backed"] = OK if (spec.substrate == "cuda"
                                  and spec.method in _KERNEL_PHASES) \
        else SKIPPED
    exp["dtype_flow"] = OK
    return exp


def audit_operator(nx: int = 8, ny: int = 6, nz: int = 6,
                   dtype=torch.float64, device="cpu") -> Stencil7Operator:
    """The JAX audit's non-symmetric convection-diffusion stencil, built
    directly (no eager operator application)."""
    c = torch.tensor([6.5, -1.5, -1.0, -1.25, -1.0, -1.0, -1.0],
                     dtype=dtype, device=device)
    return Stencil7Operator(c, nx, ny, nz)


def audit_specs(quick: bool = False) -> List[dict]:
    """The trace_binding kwargs of every audit cell, derived from the
    scenario registry (:func:`repro_torch.scenarios.cells.contract_cells`).

    The dense acceptance matrix (60 cells quick, 116 full: 7 methods x 2
    substrates x guard x precond + open-loop; full mode widens the
    preconditioner axis to the kernel-dispatching ones), then one row per
    REGISTERED scenario (quick mode: the quick-flagged ones; no mesh
    scenario), carrying its operator class and its plugin's
    expected-outcome overrides: a new scenario, or a new operator-class
    plugin, lands under the contract audit by registration alone.
    """
    # lazy both ways: neither package imports the other at module scope
    from ..scenarios import contract_cells
    return contract_cells(quick=quick)


def mesh_cells() -> List[dict]:
    """Mesh smoke cells (the sharded solves; the all-reduce count does
    not depend on the mesh's size, so any rank count proves it)."""
    return [
        dict(method="p-bicgsafe", binding="mesh", substrate="torch",
             guard=False, precond=None),
        dict(method="p-bicgsafe", binding="mesh", substrate="torch",
             guard=True, precond=None),
        # shard-local preconditioning must add ZERO collectives
        dict(method="p-bicgsafe", binding="mesh", substrate="torch",
             guard=False, precond="jacobi"),
        dict(method="ssbicgsafe2", binding="mesh", substrate="torch",
             guard=False, precond=None),
        dict(method="bicgstab", binding="mesh", substrate="torch",
             guard=False, precond=None),
    ]


def _ring_size(mesh) -> int:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return mesh.size()
    return dist.get_world_size(mesh)


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """The default process group for the mesh smoke: the one already made
    (every rank then runs the audit together), else a one-rank group in
    this process, NCCL on the card and gloo on the CPU, over an in-memory
    store, for the length of the ``with``."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def run_audit(quick: bool = False,
              mesh_smoke: bool = True,
              contracts: Optional[Sequence[str]] = None,
              device=None,
              mesh=None) -> dict:
    """Sweep the matrix; return the artifact dict (schema
    ``repro_torch.analysis/contract_audit/v1``).  ``artifact["ok"]`` is
    False iff any cell deviated from :func:`expected_outcomes`.

    ``device`` (``None``: ``"cuda"``) is where the traced steps' fake
    tensors and the operator lie.  ``mesh`` (a DeviceMesh or a process
    group, every rank calling together) gets the 5 mesh smoke cells;
    without one, ``mesh_smoke`` runs them on :func:`one_rank_group`."""
    dev = resolve_device(device)
    op = audit_operator(device=dev)
    cells = audit_specs(quick=quick)
    reports: List[ContractReport] = []
    records: List[dict] = []
    deviations: List[dict] = []

    def run_cell(kw, operator, mesh=None):
        # registry-driven rows build their operator through the scenario
        # plugin (an unregistered class fails loudly there) and merge the
        # plugin's declared expected-outcome deltas
        if kw.get("operator_class"):
            from ..scenarios import build_problem
            operator = build_problem(kw["operator_class"], device=dev,
                                     **(kw.get("operator_params") or {}))[0]
        tb = trace_binding(kw["method"], operator, binding=kw["binding"],
                           substrate=kw["substrate"], guard=kw["guard"],
                           precond=kw["precond"], m=3, mesh=mesh,
                           device=dev)
        rep = run_passes(tb, names=contracts)
        exp = expected_outcomes(tb.spec)
        exp.update(kw.get("expected") or {})
        devs = []
        for f in rep.findings:
            want = exp.get(f.contract)
            if want is not None and f.status != want:
                devs.append({"binding": tb.spec.label,
                             "scenario": kw.get("scenario"),
                             "contract": f.contract,
                             "expected": want, "actual": f.status,
                             "detail": f.detail})
        reports.append(rep)
        deviations.extend(devs)
        rec = rep.to_dict()
        if kw.get("scenario"):
            rec["scenario"] = kw["scenario"]
            rec["operator_class"] = kw["operator_class"]
        rec["expected"] = {f.contract: exp.get(f.contract)
                           for f in rep.findings}
        rec["deviations"] = devs
        records.append(rec)

    for kw in cells:
        run_cell(kw, op)
    n_mesh, n_ranks = 0, 1
    if mesh is not None or mesh_smoke:
        with (contextlib.nullcontext(mesh) if mesh is not None
              else one_rank_group(dev)) as group:
            n_ranks = _ring_size(group)
            # x-slab sharding needs nx % ranks == 0; 8 covers 1/2/4/8
            nx = 8 if 8 % n_ranks == 0 else 8 * n_ranks
            mop = audit_operator(nx=nx, device=dev)
            for kw in mesh_cells():
                run_cell(kw, mop, mesh=group)
                n_mesh += 1

    # the method x substrate contract matrix (aggregated over guard /
    # precond cells; a disagreement inside one aggregate cell surfaces as
    # "mixed", itself a deviation signal)
    contract_names: List[str] = []
    for r in reports:
        for f in r.findings:
            if f.contract not in contract_names:
                contract_names.append(f.contract)
    matrix: Dict[str, Dict[str, str]] = {}
    for r in reports:
        if r.spec.binding == "mesh":
            continue
        cell = matrix.setdefault(f"{r.spec.method}/{r.spec.substrate}", {})
        for f in r.findings:
            prev = cell.get(f.contract)
            cell[f.contract] = f.status if prev in (None, f.status) \
                else "mixed"

    return {
        "schema": ARTIFACT_SCHEMA,
        "torch_version": torch.__version__.split("+")[0],
        "device": dev.type,
        "quick": bool(quick),
        "n_devices": n_ranks,
        "n_cells": len(reports),
        "n_mesh_cells": n_mesh,
        "n_scenario_cells": sum(1 for c in cells if c.get("scenario")),
        "methods": list(METHOD_ORDER),
        "substrates": list(SUBSTRATE_ORDER),
        "contracts": contract_names,
        "matrix": matrix,
        "reports": records,
        "deviations": deviations,
        "ok": not deviations,
    }


def audit_table(artifact: dict) -> str:
    """Render the human-readable contract table for an audit artifact."""
    lines = ["contract matrix (method/substrate, aggregated over "
             "guard x precond cells):", ""]
    contracts = artifact["contracts"]
    cellmap = {OK: "pass", VIOLATION: "FAIL", SKIPPED: "-",
               "mixed": "MIXED"}
    headers = ["method/substrate"] + contracts
    rows = []
    for key, cell in artifact["matrix"].items():
        rows.append([key] + [cellmap.get(cell.get(c, SKIPPED), "?")
                             for c in contracts])
    widths = [max(len(h), *(len(r[i]) for r in rows))
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines.append(fmt.format(*headers))
    lines.append(fmt.format(*("-" * w for w in widths)))
    lines += [fmt.format(*r) for r in rows]
    lines.append("")
    lines.append(f"{artifact['n_cells']} cells traced "
                 f"({artifact['n_mesh_cells']} mesh, "
                 f"{artifact['n_devices']} rank(s), on "
                 f"{artifact['device']}); "
                 + ("all outcomes match the paper-expected matrix"
                    if artifact["ok"] else
                    f"{len(artifact['deviations'])} DEVIATION(S) from "
                    "the expected matrix"))
    for d in artifact["deviations"]:
        lines.append(f"  !! {d['binding']}: {d['contract']} expected "
                     f"{d['expected']}, got {d['actual']} — {d['detail']}")
    return "\n".join(lines)
