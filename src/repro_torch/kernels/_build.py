"""Build, load and launch the port's CUDA kernels.

The sources in ``src/repro_torch/csrc/*.cu`` have a plain C interface.  At
first use one ``nvcc`` call compiles them for ``sm_90a`` into a shared
library under the repository's ``build/`` directory; the library is named by
a digest of the sources and flags, so an edited source never loads a stale
build.  ``ctypes`` binds it: every pointer and the stream go through
``c_void_p`` (a bare Python int would be cut to 32 bits).

Nothing here runs at import: the CPU tests import every module of the port,
and this machine may have no ``nvcc``.

``LAUNCHES`` counts the launches of each kernel.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "fused_dots": 0, "fused_axpy": 0, "spmv_ell": 0,
    "fused_dots_batched": 0, "fused_axpy_batched": 0, "spmv_ell_batched": 0}

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # s, y, r, t, rs, n, partials, nblocks, out, stream
    "repro_fused_dots": [_VP] * 5 + [_I64, _VP, ctypes.c_int, _VP, _VP],
    # ins[12], outs[10], scalars, n, stream
    "repro_fused_axpy": [ctypes.POINTER(_VP), ctypes.POINTER(_VP), _VP, _I64,
                         _VP],
    # values, cols, x, y, n, k, stream
    "repro_spmv_ell": [_VP] * 4 + [_I64, ctypes.c_int, _VP],
    # s, y, r, t, rs, n, m, width, partials, nblocks, out, stream
    "repro_fused_dots_batched": [_VP] * 5 + [_I64, ctypes.c_int, ctypes.c_int,
                                             _VP, ctypes.c_int, _VP, _VP],
    # ins[12], outs[10], scalars (4, m), mask (m,) or null, n, m, stream
    "repro_fused_axpy_batched": [ctypes.POINTER(_VP), ctypes.POINTER(_VP),
                                 _VP, _VP, _I64, ctypes.c_int, _VP],
    # values, cols, x, y, n, m, k, stream
    "repro_spmv_ell_batched": [_VP] * 4 + [_I64, ctypes.c_int, ctypes.c_int,
                                           _VP],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default place, else ``nvcc`` on the PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) \
            + [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def nvcc_command(out: Path) -> List[str]:
    return [nvcc(), *FLAGS, "-o", str(out), *map(str, sources())]


def build(out: Path) -> str:
    """Compile every source into ``out`` with one ``nvcc`` call; returns the
    compiler's report (registers and spills per kernel)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for stem, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{stem}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, fn, *args) -> None:
    """Call a C launcher, count the launch, and raise on a CUDA error (a
    refused launch never runs, and a later synchronize would not say so)."""
    err = fn(*args)
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    LAUNCHES[name] += 1
