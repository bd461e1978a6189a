"""Time the grouped-product kernel of one checkout at deepseek-v3's
shapes: ``wi`` (K 7,168, N 2,048) and ``wo`` (K 2,048, N 7,168) over 256
experts of seeded bf16 weights, at a prefill's 32,768 rows and a decode
step's 32, through chip_smoke.py's ``check_grouped_kernel`` (checked
against the plain version, timed beside the bound); prints the compiler's
register and spill report of the kernel and one ``AB <label> {...}`` line
of ms.

    python3 tools/grouped_ab.py ROOT LABEL

ROOT is a checkout (this one, or another unpacked under ``build/``); run
two checkouts in turns on the card (a b b a) to compare them in one call.
"""
import json
import os
import sys


def main(argv) -> int:
    root, label = os.path.abspath(argv[0]), argv[1]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    lines = _build.build(_build.library_path()).splitlines()
    for i, line in enumerate(lines):
        if "grouped" in line and "Compiling" in line:
            print(label, lines[i + 2].strip(), lines[i + 3].strip())
    _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.inference_mode():
        for key, (K, N) in (("wi", (7168, 2048)), ("wo", (2048, 7168))):
            w = (torch.randn(256, K, N, generator=g, device="cuda")
                 / K ** 0.5).bfloat16()
            for shape, R in (("prefill", 32768), ("decode", 32)):
                rec = cs.check_grouped_kernel(torch, ops, w, R,
                                              f"{label} {shape} {key}",
                                              seed=20)
                out[f"{shape}_{key}"] = rec["ms"]
            del w
            torch.cuda.empty_cache()
    print("AB", label, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
