"""The contract-audit cell list, derived from the registries (PyTorch port
of ``repro.scenarios.cells``).

:func:`repro_torch.analysis.audit.audit_specs` delegates here: the audit's
cell list is the dense acceptance matrix (every method x substrate x guard
x precond + the open-loop chunk, unchanged, so the expected-outcome matrix
and its negative controls stay anchored) PLUS one contract row per
registered scenario.  Registering a scenario therefore puts its exact
binding coordinates, operator class included, under the paper's
communication contracts, with the plugin's ``contract_overrides`` merged
over the expected matrix.

The audit's constants are imported lazily (the audit imports this module
lazily too; neither package costs the other at import time).
"""
from __future__ import annotations

from typing import List

from .registry import scenarios

__all__ = ["matrix_cells", "scenario_cells", "contract_cells"]


def matrix_cells(quick: bool = False) -> List[dict]:
    """The dense acceptance matrix: 7 methods x 2 substrates x guard x
    precond + the open-loop chunk (60 cells quick, with precond in (None,
    "jacobi")); full mode widens the preconditioner axis to "ssor" and
    "block_jacobi" (116 cells)."""
    from ..analysis.audit import METHOD_ORDER, SUBSTRATE_ORDER
    preconds = (None, "jacobi") if quick \
        else (None, "jacobi", "ssor", "block_jacobi")
    cells: List[dict] = []
    for method in METHOD_ORDER:
        binding = "batched" if method == "p-bicgsafe" else "single"
        for substrate in SUBSTRATE_ORDER:
            for guard in (False, True):
                for precond in preconds:
                    cells.append(dict(method=method, binding=binding,
                                      substrate=substrate, guard=guard,
                                      precond=precond))
    # the service's open-loop chunk program (p-BiCGSafe only)
    for substrate in SUBSTRATE_ORDER:
        for guard in (False, True):
            cells.append(dict(method="p-bicgsafe", binding="open_loop",
                              substrate=substrate, guard=guard,
                              precond=None))
    return cells


def scenario_cells(quick: bool = False) -> List[dict]:
    """One audit cell per registered scenario (quick mode keeps the
    quick-flagged ones).  Mesh-binding scenarios are left out: the audit's
    mesh smoke owns the sharded cells, whose operator extents must divide
    by the ring's size."""
    return [sc.contract_cell() for sc in scenarios(quick=quick)
            if sc.resolved_binding() != "mesh"]


def contract_cells(quick: bool = False) -> List[dict]:
    """Everything the audit traces (but the mesh smoke): the dense
    acceptance matrix, then the per-scenario rows."""
    return matrix_cells(quick=quick) + scenario_cells(quick=quick)
