#!/usr/bin/env python3
"""What dispatching the solver kernels through ``torch.library`` costs the
host, on one card: three dispatches of the same CUDA launchers, in turns in
one process.

    python3 tools/op_dispatch_ab.py [--rounds 4] [--calls 400]

* ``direct``: each wrapper calls its launcher itself (the port before its
  kernels were ops);
* ``library``: the port's ops (:data:`repro_torch.kernels.ops.KERNEL_OPS`,
  defined with ``torch.library.Library``, a kernel for the CUDA key);
* ``custom_op``: the same kernels as ``torch.library.custom_op`` ops
  (namespace ``repro_torch_ab``), whose calls go through Python wrappers
  (autograd, an aliasing check) around the kernel.

Each wrapper of :mod:`repro_torch.kernels.ops` calls its op through a
module global, which the tool points at each dispatch in turn.  Per
round and dispatch: the host's microseconds per call of ``fused_dots``,
``fused_axpy`` and ``spmv_ell`` on 3b's shapes (n = 108**3, fp64), timed
while a sleep kernel holds the stream so no call waits for the device; and
the ms per iteration of 3b's ``solve(b)`` through the eager chunk.  Prints
one JSON line per round and the medians, with the card's name and power
limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX = 108


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def dispatches(torch, ops):
    """name -> the op globals of :mod:`ops` for each dispatch."""
    from repro_torch.kernels.fused_axpy import IN_ORDER, OUT_ORDER
    from repro_torch.kernels.fused_dots import (fused_dots_batched_cuda,
                                                fused_dots_cuda)
    from repro_torch.kernels.fused_axpy import (fused_axpy_batched_cuda,
                                                fused_axpy_cuda)
    from repro_torch.kernels.spmv_ell import (spmv_ell_batched_cuda,
                                              spmv_ell_cuda)

    def dots(s, y, r, t, rs):
        return ops._dots_cuda(fused_dots_cuda, fused_dots_batched_cuda, s,
                              (s, y, r, t, rs))

    def axpy(vecs, scal, mask):
        named = dict(zip(IN_ORDER, vecs))
        out = fused_axpy_cuda(named, scal) if vecs[0].dim() == 1 \
            else fused_axpy_batched_cuda(named, scal, mask)
        return [out[k] for k in OUT_ORDER]

    def spmv(values, cols, x):
        return spmv_ell_batched_cuda(values, cols, x) if x.dim() == 2 \
            else spmv_ell_cuda(values, cols, x)

    Tensor = torch.Tensor

    @torch.library.custom_op("repro_torch_ab::dots", mutates_args=(),
                             device_types="cuda")
    def ab_dots(s: Tensor, y: Tensor, r: Tensor, t: Tensor,
                rs: Tensor) -> Tensor:
        return dots(s, y, r, t, rs)

    @torch.library.custom_op("repro_torch_ab::axpy", mutates_args=(),
                             device_types="cuda")
    def ab_axpy(vecs: List[Tensor], scal: Tensor,
                mask: Optional[Tensor]) -> List[Tensor]:
        return axpy(vecs, scal, mask)

    @torch.library.custom_op("repro_torch_ab::spmv", mutates_args=(),
                             device_types="cuda")
    def ab_spmv(values: Tensor, cols: Tensor, x: Tensor) -> Tensor:
        return spmv(values, cols, x)

    return {
        "direct": dict(_fused_dots_op=dots, _fused_axpy_op=axpy,
                       _spmv_ell_op=spmv),
        "library": dict(_fused_dots_op=ops._fused_dots_op,
                        _fused_axpy_op=ops._fused_axpy_op,
                        _spmv_ell_op=ops._spmv_ell_op),
        "custom_op": dict(_fused_dots_op=ab_dots, _fused_axpy_op=ab_axpy,
                          _spmv_ell_op=ab_spmv)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=400)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import repro_torch
    from repro_torch.core import matrices
    from repro_torch.core.program import _eager_chunks
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused_axpy import IN_ORDER
    _build.library()
    kinds = dispatches(torch, ops)
    stencil, b, _ = matrices.convection_diffusion(NX, peclet=0.5,
                                                  dtype=torch.float64)
    ell = matrices.stencil_to_ell(stencil)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    vecs = {k: torch.rand(ell.n, dtype=torch.float64, device="cuda")
            for k in IN_ORDER}
    scal = torch.rand(4, dtype=torch.float64, device="cuda")
    calls = {
        "fused_dots": lambda: ops.fused_dots(*(vecs[k] for k in "syrtp")),
        "fused_axpy": lambda: ops.fused_axpy(vecs, scal),
        "spmv_ell": lambda: ops.spmv_ell(ell, vecs["x"]),
    }

    def host_us(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e9))          # holds the stream ~1 s
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        us = (time.perf_counter() - t0) / args.calls * 1e6
        torch.cuda.synchronize()
        return us

    def eager_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _eager_chunks():
            res = solver.solve(b, tol=1e-8, maxiter=2000)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / int(res.iterations)

    got = {k: {"eager_ms": [], **{c: [] for c in calls}} for k in kinds}
    order = list(kinds)
    for rnd in range(args.rounds + 1):
        seq = order if rnd % 2 else order[::-1]
        for kind in seq:
            for name, fn in kinds[kind].items():
                setattr(ops, name, fn)
            rec = {c: host_us(fn) for c, fn in calls.items()}
            rec["eager_ms"] = eager_ms()
            if rnd == 0:
                continue                     # warm-up round
            for key, v in rec.items():
                got[kind][key].append(v)
            print(json.dumps(dict(round=rnd, dispatch=kind, **rec)),
                  flush=True)
    print(json.dumps(dict(card=card(), medians={
        kind: {k: statistics.median(v) for k, v in rec.items()}
        for kind, rec in got.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
