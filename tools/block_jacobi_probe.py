#!/usr/bin/env python3
"""What holds the batched block-Jacobi apply's bulk route back on the card:
the kernel timed beside two copies of it with parts taken out.

    python3 tools/block_jacobi_probe.py

From ``src/repro_torch/csrc/block_jacobi_apply_batched.cu`` it builds, one
``nvcc`` each and all at once, under ``build/probe/``:

* ``kernel``: the source as it is;
* ``no_arith``: the same pipeline with the products taken out (every loop
  over k or j runs no step): the bulk copies, the barriers and Y's stores
  (of zeros);
* ``copies``: the consumers only wait on each stage and release it: the
  bulk copies and the barriers, no store.

and times each (``chip_smoke.device_ms``) at the solver's shape, (nb, bs,
m) = (19,683, 64, 8), in fp64 and fp32, in turns (kernel, no_arith,
copies, copies, no_arith, kernel), beside one ``torch.bmm`` of the same
operands; the kernel's result is held to the plain version (1e-12 / 5e-5
of |B| |X|).  Prints one JSON line: the medians in ms and the bytes each
moves over its time.  A source edit that the probe's cuts no longer match
fails here, loudly.  Needs one GPU.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CU = os.path.join(SRC, "repro_torch", "csrc", "block_jacobi_apply_batched.cu")
ERRORS = os.path.join(SRC, "repro_torch", "csrc", "errors.cu")
OUT = os.path.join(ROOT, "build", "probe")
NB, BS, M = 19_683, 64, 8
TOL = {"float64": 1e-12, "float32": 5e-5}
BULK = 1                        # the C launcher's number for route "bulk"

# (text in the source, its replacement): every loop over k (fp64) or j
# (fp32) runs no step
NO_ARITH = [("      for (int k0 = 0; k0 < bs; k0 += 32) {",
             "      for (int k0 = 0; k0 < 0; k0 += 32) {"),
            ("      for (int j = 0; j < bs; j += kV) {",
             "      for (int j = 0; j < 0; j += kV) {")]
# the consumers skip consume_mma() / consume(), arrive and move on
COPIES = [("    if constexpr (sizeof(T) == 8)\n      consume_mma",
           "    if (true) {\n    } else if constexpr (sizeof(T) == 8)\n"
           "      consume_mma")]


def cut(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"probe: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(torch_build, variants: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [torch_build.nvcc(), *torch_build.FLAGS, "-shared", "-o", so, cu,
             ERRORS], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe: nvcc failed on {name}:\n{text}")
        lib = ctypes.CDLL(so)
        sig = torch_build._SIGNATURES["repro_block_jacobi_apply_batched"]
        for suffix in ("f64", "f32"):
            fn = getattr(lib, f"repro_block_jacobi_apply_batched_{suffix}")
            fn.argtypes, fn.restype = sig, ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, SRC]
    import chip_smoke
    from repro_torch.kernels import _build, ref

    with open(CU) as fh:
        text = fh.read()
    libs = build(_build, {"kernel": text, "no_arith": cut(text, NO_ARITH),
                          "copies": cut(text, COPIES)})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks = torch.randn(NB, BS, BS, generator=gen, device="cuda",
                         dtype=torch.float64)
    out = {"card": card, "shape": [NB, BS, M]}
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        inv = blocks.to(dtype)
        x = torch.randn(NB * BS, M, generator=gen, device="cuda",
                        dtype=torch.float64).to(dtype)
        y = torch.empty_like(x)
        item = x.element_size()
        nbytes = {"kernel": (NB * BS * BS + 2 * NB * BS * M) * item,
                  "no_arith": (NB * BS * BS + 2 * NB * BS * M) * item,
                  "copies": (NB * BS * BS + NB * BS * M) * item}

        def call(lib):
            fn = getattr(lib, "repro_block_jacobi_apply_batched_"
                         + ("f64" if dtype == torch.float64 else "f32"))
            err = fn(inv.data_ptr(), x.data_ptr(), y.data_ptr(), NB, BS, M,
                     BULK, stream)
            if err != 0:
                raise SystemExit(f"probe: CUDA error {err}")

        call(libs["kernel"])
        torch.cuda.synchronize()
        scale = ref.block_jacobi_apply(inv.abs(), x.abs())
        err = float(((y - ref.block_jacobi_apply(inv, x)).abs()
                     / scale).max())
        if not err <= TOL[name]:
            raise SystemExit(f"probe: kernel {name} error {err}")
        times = {k: [] for k in libs}
        for k in ("kernel", "no_arith", "copies", "copies", "no_arith",
                  "kernel"):
            times[k].append(chip_smoke.device_ms(
                torch, lambda: call(libs[k])))
        xb = x.view(NB, BS, M)
        bmm = chip_smoke.device_ms(torch, lambda: torch.bmm(inv, xb))
        rec = {"max_rel_err": err, "bmm_ms": bmm,
               "bmm_tb_s": nbytes["kernel"] / bmm / 1e9}
        for k, ts in times.items():
            ms = statistics.median(ts)
            rec[f"{k}_ms"] = ms
            rec[f"{k}_tb_s"] = nbytes[k] / ms / 1e9
        out[name] = rec
        print(f"probe {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec.items() if k.endswith("_ms")),
            flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
