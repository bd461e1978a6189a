"""Phases 2d (its bf16 cases at qwen3-8b's and llama4-scout's prefill
shapes) and 4b (llama4-scout served at full width, depth 12) of
chip_smoke.py alone, after the kernels' build; then the card tests that a
pytest -k expression on the command line selects, if one is given.

    python3 tools/moe_serving.py ["moe or flash_kernel_matches"]

Run on the card from the root of a checkout (about a minute of command,
plus the tests)."""
import os, subprocess, sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch
import chip_smoke as cs
from repro_torch.kernels import _build, ops, ref
cs.log(cs.card())
t0 = time.perf_counter(); _build.build(_build.library_path()); _build.library()
cs.log(f"build {time.perf_counter() - t0:.1f}")
cs.FLASH_CASES = ((cs.FLASH_SHAPE, True, "bfloat16"),
                  (cs.FLASH_SHAPE_MOE, True, "bfloat16"))
t = time.perf_counter()
flash = cs.check_flash_kernel(torch, ops, ref)
cs.log(f"2d {time.perf_counter() - t:.1f}s"); t = time.perf_counter()
moe = cs.run_moe_serving_path(torch, ops,
                              flash[(cs.FLASH_SHAPE_MOE, True, "bfloat16")]["ms"])
cs.log(f"4b {time.perf_counter() - t:.1f}s")
if len(sys.argv) > 1:
    rc = subprocess.call([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                          "-k", sys.argv[1], "tests/test_torch_cuda.py"],
                         env=dict(os.environ, PYTHONPATH="src"))
    sys.exit(rc)
