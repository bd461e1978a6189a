"""Time the grouped-product kernel of one checkout at deepseek-v3's
shapes: ``wi`` (K 7,168, N 2,048) and ``wo`` (K 2,048, N 7,168) over 256
experts of seeded weights in each of ``--dtypes`` (bf16 by default), at
each of ``--rows`` (a prefill's 32,768 and a decode step's 32 by
default), through chip_smoke.py's ``check_grouped_kernel`` (checked
against the plain version, timed beside the bound, the plain loop,
``torch._grouped_mm`` and each tile of the dtype's route in turns);
prints the compiler's register and spill report of the grouped kernels
and one ``AB <label> {...}`` line of ms.

    python3 tools/grouped_ab.py ROOT LABEL
    python3 tools/grouped_ab.py ROOT LABEL --dtypes float32 float64 \\
        --rows 8 32 2048 8192 32768
    python3 tools/grouped_ab.py ROOT LABEL --tiles 128x256 192x192 \\
        --rows 8 32 2048 8192 32768

ROOT is a checkout (this one, or another unpacked under ``build/``); run
two checkouts in turns on the card (a b b a) to compare them in one call:
the f32 / f64 route of a parent against this one's, for instance.  With
``--tiles`` (this checkout's ``grouped_mm_cuda(..., tile=)``) it instead
times the named tiles of the bf16 route in turns (a b b a) at each of
``--rows`` for ``wi`` and ``wo``, each checked against the plain version
and bitwise on a repeat, with the bytes each moves from L2 into the SMs
(its tiles' loads, counted from the routing) and ``torch._grouped_mm``
beside them.
"""
import argparse
import json
import math
import os
import statistics
import sys

SHAPES = {"wi": (7168, 2048), "wo": (2048, 7168)}
EXPERTS = 256


def l2_bytes(sizes, K, N, tile):
    """The bytes a tile's blocks load from L2 for a routing of group sizes
    (the x rows each tile loads in 64-row boxes, once per column slab, and
    the weights of each tile's slab), bf16."""
    bm, bn = map(int, tile.split("x"))
    slabs = math.ceil(N / bn)
    rows = tiles = 0
    for s in sizes:
        for t in range(math.ceil(s / bm)):
            rows += 64 * math.ceil(min(bm, s - t * bm) / 64)
            tiles += 1
    return 2 * (slabs * rows * K + tiles * K * N)


def ab_tiles(torch, cs, names, rows_list, label, out):
    from repro_torch.kernels import grouped_mm
    g = torch.Generator(device="cuda").manual_seed(0)
    for key, (K, N) in SHAPES.items():
        w = (torch.randn(EXPERTS, K, N, generator=g, device="cuda")
             / K ** 0.5).bfloat16()
        for R in rows_list:
            sizes = cs.grouped_sizes(torch, R, EXPERTS, 20)
            offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                                 torch.cumsum(sizes, 0)]).cuda()
            x = torch.randn(R, K, generator=g, device="cuda").bfloat16()
            want = grouped_mm.plain(x, w, offsets).float()
            calls = {name: (lambda name=name: grouped_mm.grouped_mm_cuda(
                x, w, offsets, tile=name)) for name in names}
            rec = {}
            for name, call in calls.items():
                y1, y2 = call(), call()
                rec[name] = dict(
                    err=float((y1.float() - want).abs().max()
                              / want.abs().max()),
                    bitwise=bool(torch.equal(y1, y2)), ms=[],
                    l2_gb=l2_bytes(sizes.tolist(), K, N, name) / 1e9)
                del y1, y2
            for name in names + names[::-1]:
                rec[name]["ms"].append(cs.device_ms(torch, calls[name],
                                                    reps=10, trials=3))
            for r in rec.values():
                r["ms"] = statistics.median(r["ms"])
            ends = offsets[1:].to(torch.int32)
            lib = cs.device_ms(torch, lambda: torch._grouped_mm(
                x, w, offs=ends), reps=10, trials=3)
            hit = int((sizes > 0).sum())
            bound = cs.bound_ms(2 * (R * K + hit * K * N + R * N),
                                2.0 * R * K * N, "bfloat16")
            tile = grouped_mm.wgmma_tile(R, EXPERTS)
            print(f"{label} {key} R {R:,} (tile {tile}): "
                  + "; ".join(f"{s} {r['ms']:.4f} ms err {r['err']:.2e} "
                              f"bitwise {r['bitwise']} L2 {r['l2_gb']:.2f} "
                              f"GB" for s, r in rec.items())
                  + f"; torch._grouped_mm {lib:.4f}; bound {bound[0]:.4f} "
                  f"({bound[1]}) [{cs.card()}]", flush=True)
            out[f"{key}_{R}"] = dict(tiles=rec, library_ms=lib,
                                     bound_ms=bound[0], tile=tile)
            del x, want, offsets
        del w
        torch.cuda.empty_cache()


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("label")
    ap.add_argument("--tiles", nargs="*", default=None,
                    help="tiles of the bf16 route, timed in turns")
    ap.add_argument("--rows", nargs="*", type=int, default=None,
                    help="rows of each product (default: 32,768 and 32; "
                    "with --tiles 32, 2,048, 8,192 and 32,768)")
    ap.add_argument("--dtypes", nargs="*", default=["bfloat16"],
                    help="dtypes of the weights, without --tiles")
    args = ap.parse_args(argv)
    root, label = os.path.abspath(args.root), args.label
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    lines = _build.build(_build.library_path()).splitlines()
    for i, line in enumerate(lines):
        if "grouped" in line and "Compiling" in line:
            print(label, line.split("'")[1][:60], lines[i + 2].strip(),
                  lines[i + 3].strip())
    _build.library()
    out = {}
    with torch.inference_mode():
        if args.tiles:
            ab_tiles(torch, cs, args.tiles,
                     args.rows or [32, 2048, 8192, 32768], label, out)
        else:
            g = torch.Generator(device="cuda").manual_seed(0)
            for dtype in args.dtypes:
                dt = getattr(torch, dtype)
                for key, (K, N) in SHAPES.items():
                    w = torch.randn(EXPERTS, K, N, generator=g, device="cuda",
                                    dtype=torch.float64 if dt == torch.float64
                                    else torch.float32).div_(K ** 0.5).to(dt)
                    for R in args.rows or [32768, 32]:
                        rec = cs.check_grouped_kernel(
                            torch, ops, w, R, f"{label} {dtype} {key}",
                            seed=20)
                        out[f"{dtype}_{key}_{R}"] = rec["ms"]
                        # each tile of the route ("routes" in an older
                        # checkout's record)
                        for name, r in rec.get(
                                "tiles", rec.get("routes", {})).items():
                            out[f"{dtype}_{key}_{R}_{name}"] = r["ms"]
                    del w
                    torch.cuda.empty_cache()
    print("AB", label, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
