"""CUDA kernels: causal (or full) GQA flash attention, forward.

Counterparts of ``repro/kernels/flash_attention.py:flash_attention_pallas``,
one route per dtype, fixed, both on the tensor cores with ``mma.sync``
fed by a ``cp.async`` ring: bfloat16 goes to
``src/repro_torch/csrc/flash_attention_mma.cu`` (bf16 -> f32), float32 to
``src/repro_torch/csrc/flash_attention.cu`` (3xTF32: each operand split
into two TF32 parts, three TF32 products summed in f32, about 21 bits a
product, within fp32's 2e-5 per output row).  q and o are ``(B, H, S,
hd)`` and k and v ``(B, K, S, hd)`` as logical shapes with ``H = K * G``
(query head h reads KV head ``h // G``), any strides on the first three
axes and a contiguous last one, so the model's ``(B, S, H, hd)`` tensors
go in as transposed views, without a copy.  The scores, the softmax and the sums are f32 and the output is
stored in q's dtype, as the TPU kernel does; the bf16 route rounds the
probabilities to bf16 before the product with V.  ``hd`` up to 128; any S
(a ragged last tile is bounds-checked, where the TPU kernel asserts that
its tiles divide S).  Call it through
:func:`repro_torch.kernels.ops.flash_attention`, which checks the operands
and dispatches by device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "flash_attention"
MAX_HEAD_DIM = 128     # kMaxHd in both sources
DTYPES = (torch.float32, torch.bfloat16)


def _bhs_strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q, k, v, out, *, scale: float,
                         causal: bool) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands, writing ``out`` (q's
    logical shape and dtype); returns ``out``."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    strides = (ctypes.c_int64 * 12)(*(
        _bhs_strides(q) + _bhs_strides(k) + _bhs_strides(v)
        + _bhs_strides(out)))
    lib = _build.library()
    fn = lib.repro_flash_attention_bf16 if q.dtype == torch.bfloat16 \
        else lib.repro_flash_attention_f32
    _build.launch(NAME, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, H, K, S, hd, strides, float(scale),
                  int(bool(causal)),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
