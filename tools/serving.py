"""Phases 2d (its cases at qwen3-8b's, llama4-scout's, whisper-tiny's and
qwen2-vl-72b's prefill shapes), 4 (qwen3-8b served at full width), 4b
(llama4-scout served at full width, depth 12), 4c (deepseek-v3 served at
full width, depth 2, with the grouped kernel's checks), 4e (zamba2-1.2b
served at full width and depth) and 4f (xlstm-350m served at full width
and depth), which launch no kernel of the port, 4g (whisper-tiny served at
full width and depth, its decoder prefill on the flash kernel) and 4h
(qwen2-vl-72b served at full width, depth 32, its prefill on the flash
kernel at G = 8) of chip_smoke.py alone, after the kernels' build (skipped
when only 4e or 4f run); then the card tests that a pytest -k expression
selects, if one is given.

    python3 tools/serving.py [4] [4b] [4c] [4e] [4f] [4g] [4h] [-k EXPR]

With no phase named, 4, 4b and 4c run, in that order, each model freed
before the next; 2d runs when 4, 4b, 4g or 4h does, its cases those of
the phases named.  Run on the card from the root
of a checkout (about three minutes of command, plus the tests)."""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402


def main(argv) -> int:
    expr = None
    if "-k" in argv:
        i = argv.index("-k")
        expr, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    phases = argv or ["4", "4b", "4c"]
    cs.log(cs.card())
    if set(phases) - {"4e", "4f"}:
        t0 = time.perf_counter()
        _build.build(_build.library_path())
        _build.library()
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
    cases = []
    if "4" in phases:
        cases += [(cs.FLASH_SHAPE, True, "bfloat16"),
                  (cs.FLASH_SHAPE, True, "float32")]
    if "4b" in phases:
        cases += [(cs.FLASH_SHAPE_MOE, True, "bfloat16")]
    if "4g" in phases:
        cases += [(cs.FLASH_SHAPE_AUDIO, True, "bfloat16"),
                  (cs.FLASH_SHAPE_AUDIO, True, "float32")]
    if "4h" in phases:
        cases += [(cs.FLASH_SHAPE_VLM, True, "bfloat16"),
                  (cs.FLASH_SHAPE_VLM, True, "float32")]
    cs.FLASH_CASES = tuple(cases)
    if cases:
        t = time.perf_counter()
        flash = cs.check_flash_kernel(torch, ops, ref)
        cs.log(f"2d {time.perf_counter() - t:.1f} s")
    if "4" in phases:
        t = time.perf_counter()
        cs.run_serving_path(torch, ops,
                            flash[(cs.FLASH_SHAPE, True, "bfloat16")]["ms"],
                            flash[(cs.FLASH_SHAPE, True, "float32")]["ms"])
        cs.log(f"4 {time.perf_counter() - t:.1f} s")
    if "4b" in phases:
        t = time.perf_counter()
        cs.run_moe_serving_path(
            torch, ops, flash[(cs.FLASH_SHAPE_MOE, True, "bfloat16")]["ms"])
        cs.log(f"4b {time.perf_counter() - t:.1f} s")
    if "4c" in phases:
        t = time.perf_counter()
        cs.run_mla_serving_path(torch, ops)
        cs.log(f"4c {time.perf_counter() - t:.1f} s")
    if "4e" in phases:
        t = time.perf_counter()
        cs.run_hybrid_serving_path(torch, ops)
        cs.log(f"4e {time.perf_counter() - t:.1f} s")
    if "4f" in phases:
        t = time.perf_counter()
        cs.run_xlstm_serving_path(torch, ops)
        cs.log(f"4f {time.perf_counter() - t:.1f} s")
    if "4g" in phases:
        t = time.perf_counter()
        cs.run_whisper_serving_path(
            torch, ops, flash[(cs.FLASH_SHAPE_AUDIO, True, "bfloat16")]["ms"])
        cs.log(f"4g {time.perf_counter() - t:.1f} s")
    if "4h" in phases:
        t = time.perf_counter()
        cs.run_vlm_serving_path(
            torch, ops, flash[(cs.FLASH_SHAPE_VLM, True, "bfloat16")]["ms"])
        cs.log(f"4h {time.perf_counter() - t:.1f} s")
    if expr is None:
        return 0
    return subprocess.call([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                            "-k", expr, "tests/test_torch_cuda.py"],
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
