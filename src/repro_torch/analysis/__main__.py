"""``python -m repro_torch.analysis audit`` — the contract audit CLI.

Sweeps the binding matrix through the contract passes (tracing in fake
mode: no solve runs), prints the contract table, writes
``experiments/torch_contract_audit.json`` and exits 1 when any cell
deviates from the paper-expected matrix, 2 on bad input.  The mesh smoke
runs on a one-rank process group made in this process (gloo on the CPU,
NCCL on the card).

The cell list is derived from the scenario registry
(:mod:`repro_torch.scenarios`): every registered scenario contributes one
contract row on top of the dense acceptance matrix, and ``--scenarios
FILE`` registers extra scenario dicts for this run.  Scenario problems (an
unregistered operator class, an unknown preconditioner) exit with a
one-line message (exit code 2), never a traceback.

    PYTHONPATH=src python -m repro_torch.analysis audit --device cpu
    PYTHONPATH=src python -m repro_torch.analysis audit      # the card
"""
import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)
    audit_p = sub.add_parser(
        "audit", help="statically verify the contract matrix")
    audit_p.add_argument("--quick", action="store_true",
                         help="core matrix only: skip the ssor and "
                         "block_jacobi cells")
    audit_p.add_argument("--out",
                         default="experiments/torch_contract_audit.json",
                         help="artifact path (default: %(default)s)")
    audit_p.add_argument("--no-mesh", action="store_true",
                         help="skip the mesh smoke cells")
    audit_p.add_argument("--device", default=None,
                         help="where the traced tensors lie (default: "
                         "cuda; cpu on a machine without a GPU)")
    audit_p.add_argument("--scenarios", default=None, metavar="FILE",
                         help="JSON file with extra scenario dicts to "
                         "register before the audit (each becomes one "
                         "contract row)")
    args = ap.parse_args(argv)

    import torch
    from .audit import audit_table, run_audit
    try:
        device = torch.device("cuda" if args.device is None
                              else args.device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError("no CUDA device is available; pass "
                             "--device cpu")
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from ..scenarios import ScenarioError
    try:
        if args.scenarios:
            from ..scenarios.__main__ import _register_file
            _register_file(args.scenarios)
        artifact = run_audit(quick=args.quick, mesh_smoke=not args.no_mesh,
                             device=device)
    except ScenarioError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = args.out
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True)
            f.write("\n")
    print(audit_table(artifact))
    if out:
        print(f"\nartifact: {out}")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
