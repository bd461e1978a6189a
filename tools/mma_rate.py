#!/usr/bin/env python3
"""The rate of ``mma.sync`` alone on one card: the ceiling of a kernel
built on it, such as the fp32 flash kernel's three TF32 products or the
grouped product's f32 and f64 route.

    python3 tools/mma_rate.py [--iters N]

Compiles (``nvcc``, the port's flags) a kernel whose every warp issues
``mma.sync`` into 8 independent accumulators, ``--iters`` times, with
operands in registers and nothing else in the loop, and launches it with
128 threads a block at 1, 2 and 4 blocks an SM (2 blocks of 4 warps is
the flash kernels' occupancy).  Prints, per shape (m16n8k8 tf32 -> f32,
m16n8k16 bf16 -> f32 and m16n8k16 f64) and occupancy, the TFLOP/s from
CUDA events (the median of 5 timed launches after a warm-up) and its
share of the card's dense tensor-core rate (495 TFLOP/s TF32, 989 bf16,
67 f64), with the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT = os.path.join(ROOT, "build", "mma_rate")
PEAK = {"tf32": 495e12, "bf16": 989e12, "f64": 67e12}

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool TF32>
__global__ void __launch_bounds__(128) mma_loop(float* out, int iters) {
  const uint32_t lane = threadIdx.x & 31;
  uint32_t a[4] = {0x3f800000u + lane, 0x3f000000u + lane,
                   0x3e800000u + lane, 0x3e000000u + lane};
  if (!TF32)                             // bf16 pairs near 1
    for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u + lane;
  const uint32_t b0 = a[0] ^ 0x10u, b1 = a[1] ^ 0x20u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(128) dmma_loop(float* out, int iters) {
  const double lane = (double)(threadIdx.x & 31);
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = 1.0 + lane / 64 + i / 1024.0;
  for (int i = 0; i < 4; ++i) b[i] = 1.0 - lane / 128 - i / 2048.0;
  double c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
          "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
          : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
          : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
            "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
            "d"(b[2]), "d"(b[3]));
  }
  double s = 0.0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (float)s;
}

// kind 1: TF32, 0: bf16, 2: f64
extern "C" int mma_rate_launch(int kind, float* out, int blocks, int iters,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 1)
    mma_loop<true><<<blocks, 128, 0, st>>>(out, iters);
  else if (kind == 0)
    mma_loop<false><<<blocks, 128, 0, st>>>(out, iters);
  else
    dmma_loop<<<blocks, 128, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=16384)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "mma_rate.cu"), os.path.join(OUT, "mma_rate.so")
    with open(cu, "w") as fh:
        fh.write(SOURCE)
    subprocess.run([_build.nvcc(), *_build.FLAGS, "-shared", "-o", so, cu],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).mma_rate_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, tf32, k in (("tf32", 1, 8), ("bf16", 0, 16), ("f64", 2, 16)):
        for per_sm in (1, 2, 4):
            blocks = sms * per_sm
            out = torch.empty(blocks * 128, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                err = fn(tf32, out.data_ptr(), blocks, args.iters, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            flops = blocks * 4 * args.iters * 8 * 2 * 16 * 8 * k
            rate = flops / statistics.median(times)
            cs.log(json.dumps(dict(
                mma=f"m16n8k{k} {kind}", blocks_per_sm=per_sm,
                warps_per_scheduler=per_sm, tflops=rate / 1e12,
                share_of_dense_rate=rate / PEAK[kind], card=cs.card())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
