"""One-command matrix sweep: materialize, run, verify, consolidate (PyTorch
port of ``repro.scenarios.sweep``).

``run_sweep`` takes a subset of the registered scenarios and, per cell:

1. builds the operator through its plugin on the sweep's device (cached
   per spec content and device),
2. binds the session via :func:`repro_torch.api.make_solver` (the
   content-keyed cache: scenarios sharing an operator share programs),
3. runs the solve through the binding the scenario declares (single /
   batched / open-loop chunks / sharded mesh; the mesh on a one-rank
   process group, gloo on the CPU and NCCL on the card, unless a mesh is
   given),
4. judges the solution with the plugin's verification oracle (true-residual
   recomputation by default; the complex-residual check for the Helmholtz
   class),
5. traces the cell through the :mod:`repro_torch.analysis` contract passes
   (fake mode: nothing runs) and compares the findings with the
   expected-outcome matrix (with the plugin's declared deltas merged in).

The result is ONE consolidated, schema-stamped artifact
(``experiments/torch_scenario_sweep.json``).
"""
from __future__ import annotations

import contextlib
import json
import time
from datetime import datetime, timezone
from typing import List, Optional, Sequence

import torch

from ..core.types import resolve_device
from .registry import (_host, build_problem, get_operator_class,
                       resolve_scenario)
from .registry import scenarios as registered_scenarios
from .types import Scenario, ScenarioError

__all__ = ["run_cell", "run_sweep", "write_artifact", "sweep_table",
           "ARTIFACT_SCHEMA", "DEFAULT_OUT"]

ARTIFACT_SCHEMA = "repro_torch.scenarios/scenario_sweep/v1"
DEFAULT_OUT = "experiments/torch_scenario_sweep.json"


def _rhs_block(b: torch.Tensor, m: int) -> torch.Tensor:
    """Column 0 is the unit-solution rhs (the oracle's x_true anchor); the
    rest are seeded normal vectors, drawn on the host from
    ``torch.Generator().manual_seed(7)`` (the same columns on every
    device)."""
    if m == 1:
        return b[:, None]
    gen = torch.Generator().manual_seed(7)
    cols = [b] + [torch.randn(b.shape, generator=gen, dtype=b.dtype)
                  .to(b.device) for _ in range(m - 1)]
    return torch.stack(cols, dim=1)


def _solve_cell(sc: Scenario, problem, device, mesh):
    """Bind and run one scenario; returns (X, B, result) with X/B as (n, m)
    numpy arrays."""
    op, b, _ = problem
    binding = sc.resolved_binding()
    solver = sc.bind(device)
    if binding == "single":
        res = solver.solve(b)
        X, B = _host(res.x)[:, None], _host(b)[:, None]
    elif binding == "batched":
        B_dev = _rhs_block(b, sc.batch)
        res = solver.solve_many(B_dev)
        X, B = _host(res.x), _host(B_dev)
    elif binding == "open_loop":
        B_dev = _rhs_block(b, sc.batch)
        st = solver.init(B_dev)
        st = solver.step_chunk(st, sc.maxiter)
        res = solver.result(st)
        X, B = _host(res.x), _host(B_dev)
    elif binding == "mesh":
        dsolver = solver.on_mesh(mesh)
        try:
            res = dsolver.solve(b.reshape(op.nx, op.ny, op.nz))
        finally:
            dsolver.release()       # its programs hold the process group
        X, B = _host(res.x).reshape(-1)[:, None], _host(b)[:, None]
    else:                               # pragma: no cover - validated
        raise ScenarioError(f"unhandled binding {binding!r}")
    return X, B, res


def _mesh_context(sc: Scenario, device: torch.device, mesh):
    """``mesh`` when one is given; else, for a mesh scenario, a one-rank
    process group for the length of a ``with`` (gloo on the CPU, NCCL on
    the card: :func:`repro_torch.analysis.audit.one_rank_group`)."""
    if mesh is not None or sc.resolved_binding() != "mesh":
        return contextlib.nullcontext(mesh)
    from ..analysis.audit import one_rank_group
    return one_rank_group(device)


def _check_contracts(sc: Scenario, problem, mesh=None, device=None) -> dict:
    """Trace this cell through the contract passes and diff against the
    expected-outcome matrix + the plugin's declared deltas."""
    from ..analysis import run_passes, trace_binding
    from ..analysis.audit import expected_outcomes
    cell = sc.contract_cell()
    dev = resolve_device(device)
    with _mesh_context(sc, dev, mesh) as group:
        tb = trace_binding(cell["method"], problem[0],
                           binding=cell["binding"],
                           substrate=cell["substrate"], guard=cell["guard"],
                           precond=cell["precond"], m=3, mesh=group,
                           device=dev)
    rep = run_passes(tb)
    exp = expected_outcomes(tb.spec)
    exp.update(cell["expected"])
    deviations = [
        {"contract": f.contract, "expected": exp[f.contract],
         "actual": f.status, "detail": f.detail}
        for f in rep.findings
        if f.contract in exp and f.status != exp[f.contract]]
    return {"ok": not deviations, "deviations": deviations}


def run_cell(sc: Scenario, contracts: bool = True, device=None,
             mesh=None) -> dict:
    """Run ONE scenario end to end on ``device`` (``None``: the card);
    returns its artifact record.  A mesh scenario runs on ``mesh`` (a
    DeviceMesh or process group), else on a one-rank group made here."""
    sc = resolve_scenario(sc)
    dev = resolve_device(device)
    plugin = get_operator_class(sc.operator.cls)
    problem = build_problem(sc.operator, device=dev)
    with _mesh_context(sc, dev, mesh) as group:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        X, B, res = _solve_cell(sc, problem, dev, group)
        wall_ms = (time.perf_counter() - t0) * 1e3
        oracle = plugin.oracle(problem, B, X, sc.tol)
        rec = {
            "scenario": sc.name,
            "operator": sc.operator.to_dict(),
            "method": sc.method, "substrate": sc.substrate,
            "precond": sc.precond, "binding": sc.resolved_binding(),
            "guard": bool(sc.guard), "recovery": bool(sc.recovery),
            "tags": list(sc.tags),
            "n": int(problem[0].shape[0]), "m": int(X.shape[1]),
            "converged": bool(_host(res.converged).all()),
            "iterations": int(_host(res.iterations).max()),
            "oracle": oracle,
            "wall_ms": round(wall_ms, 2),
        }
        if contracts:
            rec["contracts"] = _check_contracts(sc, problem, group, dev)
    return rec


def run_sweep(quick: bool = False,
              only: Optional[Sequence[str]] = None,
              tags: Optional[Sequence[str]] = None,
              contracts: bool = True,
              select: Optional[List[Scenario]] = None,
              device=None,
              mesh=None) -> dict:
    """Sweep a registered subset of the matrix into one artifact dict, on
    ``device`` (``None``: the card).

    ``only`` selects scenarios by name (unknown names raise
    :class:`ScenarioError` with the registered list), ``tags`` filters by
    tag, ``quick`` keeps the CI-sized cells; ``select`` bypasses the
    registry with an explicit scenario list.  ``mesh`` (a DeviceMesh or
    process group) runs the mesh scenarios; without one they run on a
    one-rank group made for the cell.
    """
    dev = resolve_device(device)
    if select is not None:
        chosen = [resolve_scenario(s) for s in select]
    elif only:
        chosen = [resolve_scenario(name) for name in only]
    else:
        chosen = registered_scenarios(
            quick=quick, tags=tuple(tags) if tags else None)
    if not chosen:
        raise ScenarioError("no scenarios selected (registry empty or "
                            "filters matched nothing)")

    t0 = time.perf_counter()
    cells = [run_cell(sc, contracts=contracts, device=dev, mesh=mesh)
             for sc in chosen]
    wall_s = time.perf_counter() - t0

    n_oracle_ok = sum(c["oracle"]["ok"] for c in cells)
    n_contracts_ok = sum(c.get("contracts", {}).get("ok", True)
                         for c in cells)
    return {
        "schema": ARTIFACT_SCHEMA,
        "generated_at": datetime.now(timezone.utc).isoformat(),
        "torch_version": torch.__version__.split("+")[0],
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev)
        if dev.type == "cuda" else "cpu",
        "quick": bool(quick),
        "n_devices": 1,             # the mesh scenarios' ring
        "contracts_checked": bool(contracts),
        "summary": {
            "n_cells": len(cells),
            "n_converged": sum(c["converged"] for c in cells),
            "n_oracle_ok": n_oracle_ok,
            "n_contracts_ok": n_contracts_ok,
            "wall_s": round(wall_s, 2),
        },
        "claims": {
            "all_converged": all(c["converged"] for c in cells),
            "all_oracle_ok": n_oracle_ok == len(cells),
            "all_contracts_ok": n_contracts_ok == len(cells),
        },
        "cells": cells,
    }


def write_artifact(art: dict, out: str = DEFAULT_OUT) -> str:
    import os
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(art, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


def sweep_table(art: dict) -> str:
    """Human summary of one sweep artifact."""
    headers = ["scenario", "operator", "method", "sub", "pc", "m",
               "iters", "conv", "oracle", "contracts", "ms"]
    rows = []
    for c in art["cells"]:
        rows.append([
            c["scenario"], c["operator"]["cls"], c["method"],
            c["substrate"], c["precond"] or "-", c["m"],
            c["iterations"], "y" if c["converged"] else "N",
            "ok" if c["oracle"]["ok"] else "FAIL",
            ("ok" if c["contracts"]["ok"] else "DEVIATION")
            if "contracts" in c else "-",
            c["wall_ms"],
        ])
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(headers)]
    lines = ["  ".join(str(h).ljust(w) for h, w in zip(headers, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(str(v).ljust(w) for v, w in zip(r, widths))
              for r in rows]
    s = art["summary"]
    lines.append("")
    lines.append(f"{s['n_cells']} cells on {art['device']}: "
                 f"{s['n_converged']} converged, "
                 f"{s['n_oracle_ok']} oracle-verified, "
                 f"{s['n_contracts_ok']} contract-clean "
                 f"({s['wall_s']}s)")
    return "\n".join(lines)
