"""DTensor sharding strategies for the models' ops that DTensor has none
for, registered when :mod:`repro_torch.parallel` is imported.  Most take
their operands whole (``Replicate()`` on every mesh dimension, the inputs
redistributed to it) and give a whole result; flash attention may also
run on each rank's batch rows or KV heads, and ``bmm`` with an f32 output
takes ``bmm``'s own placements."""
from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels import ops as _kops  # noqa: F401  defines grouped_mm


def _whole(n_inputs: int):
    return [([Replicate()], [Replicate()] * n_inputs)]


@register_sharding(torch.ops.aten.log_sigmoid_forward.default)
def _log_sigmoid_forward(x):
    # the sLSTM's gates (F.logsigmoid) in a decode step: the output and
    # its buffer, both whole
    return [([Replicate(), Replicate()], [Replicate()])]


@register_sharding(torch.ops.aten.log_sigmoid_backward.default)
def _log_sigmoid_backward(grad_output, x, buffer):
    # the mLSTM's forget gate (F.logsigmoid) in the backward
    return _whole(3)


@register_sharding(torch.ops.repro_torch.grouped_mm.default)
def _grouped_mm(x, w, offsets):
    # the MoE sort dispatch's grouped product (and its input gradient)
    return _whole(3)


@register_sharding(torch.ops.repro_torch.grouped_mm_weight_grad.default)
def _grouped_mm_weight_grad(x, dy, offsets):
    # its weight gradient: the plain loop reads the offsets to the host,
    # which it may on the whole local tensors
    return _whole(3)


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_attention(qg, k, v, scale, causal):
    # qg (B, S, K, G, hd), k / v (B, S, K, hd) -> (B, S, K * G * hd): whole,
    # by batch rows, or by KV heads (the output's last dimension in K
    # chunks of G * hd)
    return [([p], [p, p, p, None, None])
            for p in (Replicate(), Shard(0), Shard(2))]


@register_sharding(torch.ops.aten.bmm.dtype)
def _bmm_dtype(x, y, out_dtype):
    # bf16 operands summed into an f32 output (the MLA decode's scores on
    # the card): bmm's placements, by batch, by the rows of x, by the
    # columns of y, or a partial sum over a sharded contraction
    return [([Replicate()], [Replicate(), Replicate(), None]),
            ([Shard(0)], [Shard(0), Shard(0), None]),
            ([Shard(1)], [Shard(1), Replicate(), None]),
            ([Shard(2)], [Replicate(), Shard(2), None]),
            ([Partial()], [Shard(2), Shard(1), None])]
