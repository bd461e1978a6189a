"""``python -m repro_torch.scenarios`` — the scenario CLI (PyTorch port of
``python -m repro.scenarios``).

``sweep`` materializes a registered subset of the scenario matrix into
solver sessions on ``--device`` (default: the card), runs every cell,
verifies the solutions against the operator plugins' oracles, checks the
communication contracts statically, and writes ONE consolidated artifact
(``experiments/torch_scenario_sweep.json``).  ``--scenarios FILE``
registers extra scenario dicts first.  ``list`` prints the registry.

    PYTHONPATH=src python -m repro_torch.scenarios sweep --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios sweep      # the card

Scenario/registry errors exit with a one-line message (exit code 2), never
a traceback.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenarios")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sweep_p = sub.add_parser(
        "sweep", help="run a subset of the scenario matrix and emit "
        "one consolidated artifact")
    sweep_p.add_argument("--quick", action="store_true",
                         help="CI-sized subset (quick-flagged scenarios)")
    sweep_p.add_argument("--only", default=None,
                         help="comma-separated scenario names")
    sweep_p.add_argument("--tags", default=None,
                         help="comma-separated tag filter")
    sweep_p.add_argument("--out", default=None,
                         help="artifact path (default: "
                         "experiments/torch_scenario_sweep.json)")
    sweep_p.add_argument("--no-contracts", action="store_true",
                         help="skip the static contract checks")
    sweep_p.add_argument("--scenarios", default=None, metavar="FILE",
                         help="JSON file with extra scenario dicts to "
                         "register before sweeping")
    sweep_p.add_argument("--device", default=None,
                         help="where the problems and solves lie "
                         "(default: cuda; cpu on a machine without a GPU)")

    sub.add_parser("list", help="print registered scenarios and "
                   "operator classes")
    args = ap.parse_args(argv)

    from repro_torch.scenarios import (ScenarioError, get_operator_class,
                                       operator_class_names, scenarios)

    try:
        if args.cmd == "list":
            print("registered scenarios:")
            for sc in scenarios():
                print(f"  {sc.name:<28} {sc.operator}  "
                      f"method={sc.method} substrate={sc.substrate} "
                      f"precond={sc.precond} batch={sc.batch}"
                      f"{'' if sc.quick else '  [full]'}")
            print("\noperator classes:")
            for name in operator_class_names():
                print(f"  {name:<22} {get_operator_class(name).description}")
            return 0

        device = _device(args.device)
        if args.scenarios:
            _register_file(args.scenarios)
        from repro_torch.scenarios.sweep import (DEFAULT_OUT, run_sweep,
                                                 sweep_table, write_artifact)
        art = run_sweep(
            quick=args.quick,
            only=args.only.split(",") if args.only else None,
            tags=args.tags.split(",") if args.tags else None,
            contracts=not args.no_contracts, device=device)
        out = write_artifact(art, args.out or DEFAULT_OUT)
        print(sweep_table(art))
        print(f"\nartifact: {out}")
        ok = art["claims"]["all_oracle_ok"] and \
            art["claims"]["all_contracts_ok"]
        return 0 if ok else 1
    except ScenarioError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _device(spec):
    """``--device`` as a torch device (``None``: the card); a device this
    machine lacks is a :class:`ScenarioError`."""
    import torch

    from repro_torch.scenarios import ScenarioError
    try:
        device = torch.device("cuda" if spec is None else spec)
    except RuntimeError as e:
        raise ScenarioError(str(e)) from None
    if device.type not in ("cpu", "cuda"):
        raise ScenarioError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ScenarioError("no CUDA device is available; pass "
                            "--device cpu")
    return device


def _register_file(path: str) -> None:
    """Register the scenario dicts of a JSON file (one dict or a list)."""
    import json

    from repro_torch.scenarios import (Scenario, ScenarioError,
                                       register_scenario)
    try:
        with open(path) as f:
            entries = json.load(f)
    except OSError as e:
        raise ScenarioError(f"cannot read scenario file {path!r}: {e}") \
            from None
    except json.JSONDecodeError as e:
        raise ScenarioError(
            f"scenario file {path!r} is not valid JSON: {e}") from None
    if isinstance(entries, dict):
        entries = [entries]
    for d in entries:
        register_scenario(Scenario.from_dict(d))


if __name__ == "__main__":
    sys.exit(main())
