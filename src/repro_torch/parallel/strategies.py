"""DTensor sharding strategies for the models' ops that DTensor has none
for, registered when :mod:`repro_torch.parallel` is imported.  Each takes
its operands whole (``Replicate()`` on every mesh dimension, the inputs
redistributed to it) and gives a whole result."""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels import ops as _kops  # noqa: F401  defines grouped_mm


def _whole(n_inputs: int):
    return [([Replicate()], [Replicate()] * n_inputs)]


@register_sharding(torch.ops.aten.log_sigmoid_backward.default)
def _log_sigmoid_backward(grad_output, x, buffer):
    # the mLSTM's forget gate (F.logsigmoid) in the backward
    return _whole(3)


@register_sharding(torch.ops.repro_torch.grouped_mm.default)
def _grouped_mm(x, w, offsets):
    # the MoE sort dispatch's grouped product (and its input gradient)
    return _whole(3)
