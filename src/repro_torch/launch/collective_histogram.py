"""Per-shape collective histogram of one dry-run cell (PyTorch port of
``repro.launch.collective_histogram``): the result bytes of one rank's
collectives by (kind, shape), as DTensor issues them in the cell's fake
trace (:class:`repro_torch.launch.flops.Counter`), largest first.

  PYTHONPATH=src python -m repro_torch.launch.collective_histogram \\
      --arch qwen1.5-110b --shape train_4k
"""
from __future__ import annotations

import argparse

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.parallel import LogicalMesh

from .dryrun import build_cell
from .flops import Counter
from .mesh import fake_group, make_production_mesh


def histogram(arch: str, shape: str, multi_pod: bool = False,
              overrides=None) -> dict:
    """``{(kind, shape): result bytes}`` of one rank's collectives in the
    cell's step (on the initialized fake group, or one made for it)."""
    with fake_group(multi_pod):
        lm = LogicalMesh(make_production_mesh(multi_pod=multi_pod))
        with FakeTensorMode(allow_non_fake_inputs=True):
            cell = build_cell(arch, shape, multi_pod, overrides, lm=lm)
            with Counter() as c:
                cell.fn()
    return dict(c.by_shape)


def _value(v: str):
    if v in ("True", "False"):
        return v == "True"
    return int(v) if v.isdigit() else v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. remat=dots)")
    args = ap.parse_args(argv)

    overrides = dict((kv.split("=", 1)[0], _value(kv.split("=", 1)[1]))
                     for kv in args.set)
    hist = histogram(args.arch, args.shape, args.multi_pod, overrides)
    total = sum(hist.values())
    print(f"{args.arch} {args.shape}: total collective result bytes "
          f"{total:.3e} (one rank)")
    for (kind, shp), b in sorted(hist.items(), key=lambda kv: -kv[1])[
            :args.top]:
        print(f"  {b:12.3e}  {b / max(total, 1) * 100:5.1f}%  {kind:20s} "
              f"{list(shp)}")


if __name__ == "__main__":
    main()
