"""Analytic FLOP, byte and collective counting by running a function under a
dispatch mode (PyTorch port of ``repro.launch.flops``).

The JAX package walks the jaxpr; here every aten op a call dispatches is
seen once, as it runs, so a Python loop (layers, the sLSTM's tokens) is
counted by running it, and autograd's backward and the recompute of
checkpointed blocks are counted as they run.  Pass ``meta`` or fake
tensors (``FakeTensorMode``) and nothing is allocated; pass real ones and
the same counts come from a real run.  The definitions are the JAX
package's (``src/repro/launch/flops.py:59-103``):

``flops``      every product exactly: the aten products through
               ``torch.utils.flop_counter``'s formulas (2 M N K a matmul,
               convolutions, SDPA), the port's own ops through the formulas
               registered below; plus, for each other op whose output is at
               least 2^16 bytes, half its output bytes;
``dot_bytes``  operands plus results of every product;
``bytes``      ``dot_bytes`` plus, for each other op whose output is at least
               2^16 bytes, its inputs and outputs.

Views move no bytes and are not counted.  The port's ops: ``flash_attention``
4 B H hd times the score positions it computes (S^2, or S (S + 1) / 2
causal: row i sees i + 1 keys, the convention of ``chip_smoke.py``'s hand
counts), ``grouped_mm`` and its weight gradient 2 R K N; the solver
kernels' products: the fused dots 2 n m a dot, the ELL SpMV 2 n k m, the
block-Jacobi apply 2 nb bs^2 m.  Two quirks of the
JAX counter make its figure lower (ROADMAP C34): ``jax.lax.ragged_dot`` counts
0 and a ``pallas_call`` is counted once, not once per grid cell.

:class:`Counter` also sees collectives (``c10d`` and the functional
collectives DTensor's redistributions issue; on a DTensor op it steps aside
so that its local ops and collectives come through, as
``torch.distributed.tensor.debug.CommDebugMode`` does, which counts them
but gives no bytes) with the wire-byte ring factors of
``repro.analysis.hlo.collective_stats``, and, with ``track_memory``, the
peak of the bytes of live storages.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Dict, Iterable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.kernels import ops as _kops  # noqa: F401  defines the ops

#: outputs at least this big count as memory traffic (the JAX package's)
BIG_OUTPUT = 2 ** 16

_PORT = torch.ops.repro_torch


@register_flop_formula(_PORT.flash_attention)
def _flash_flop(qg_shape, k_shape, v_shape, scale, causal, *args,
                **kwargs) -> int:
    B, S, K, G, hd = qg_shape
    positions = S * (S + 1) // 2 if causal else S * S
    return 4 * B * K * G * hd * positions


@register_flop_formula([_PORT.grouped_mm, _PORT.grouped_mm_weight_grad])
def _grouped_flop(x_shape, other_shape, offsets_shape, *args,
                  **kwargs) -> int:
    # grouped_mm: x (R, K), w (E, K, N); the weight gradient: x (R, K),
    # dy (R, N): 2 R K N either way
    return 2 * x_shape[0] * x_shape[1] * other_shape[-1]


@register_flop_formula([_PORT.fused_dots, _PORT.fused_dots_health])
def _dots_flop(s_shape, *args, out_val=None, **kwargs) -> int:
    # 9 inner products (10 with the health row's x.x; its probe sum is no
    # product) of (n,) vectors or per column of (n, m) blocks
    n = 1
    for d in s_shape:
        n *= d
    return 2 * n * (9 if len(args) == 4 else 10)


@register_flop_formula(_PORT.spmv_ell)
def _spmv_flop(values_shape, cols_shape, x_shape, *args, **kwargs) -> int:
    m = x_shape[1] if len(x_shape) == 2 else 1
    return 2 * values_shape[0] * values_shape[1] * m


@register_flop_formula(_PORT.block_jacobi_apply)
def _block_jacobi_flop(blocks_shape, x_shape, *args, **kwargs) -> int:
    nb, bs, _ = blocks_shape
    m = x_shape[1] if len(x_shape) == 2 else 1
    return 2 * nb * bs * bs * m


#: the collectives by aten name -> the JAX package's kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "send", "recv_": "recv",
}
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd", "_dtensor")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> Iterable[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_size(args, default: int) -> int:
    """The size of the process group a collective names: a group object, a
    group name, or a ``group_size`` int among its arguments."""
    for a in tree_leaves(args):
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    return ints[0] if ints else default


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes one rank puts on the wire, by ring algorithm
    (``repro.analysis.hlo.collective_stats``'s factors; ``result_bytes`` of
    a reduce-scatter is the scattered shard, a send's the plane sent)."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "send":
        return float(result_bytes)
    return 0.0                                       # recv: the sender's


#: DTensor runs each op once more on global-shape fake tensors to learn its
#: output's shape (``ShardingPropagator``); nothing runs there
_PROPAGATION = "_propagate_tensor_meta_non_cached"


def _in_sharding_propagation() -> bool:
    frame = sys._getframe(2)
    for _ in range(48):
        if frame is None:
            return False
        if frame.f_code.co_name == _PROPAGATION:
            return True
        frame = frame.f_back
    return False


class Counter(TorchDispatchMode):
    """Counts what runs inside it: ``flops``, ``bytes``, ``dot_bytes``
    (the module's definitions), ``collectives`` (``counts``,
    ``result_bytes`` and ``wire_bytes`` by kind, ``total_wire_bytes``, and
    ``by_shape``: result bytes by (kind, shape)); with ``track_memory``, ``peak_bytes``, the most bytes of storages alive
    at once, counting those of :meth:`hold` (the arguments) from the
    start.  On a DTensor op it returns ``NotImplemented``: DTensor runs it
    on the local shards, whose ops and collectives come back here, so on a
    mesh the counts are one rank's."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.dot_bytes = 0.0
        self.counts: Dict[str, int] = defaultdict(int)
        self.result_bytes: Dict[str, int] = defaultdict(int)
        self.wire: Dict[str, float] = defaultdict(float)
        self.by_shape: Dict[tuple, int] = defaultdict(int)
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, list] = {}

    # -- memory ---------------------------------------------------------
    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live; returns their bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._track(t._local_tensor if isinstance(t, DTensor) else t)
        return self.live_bytes - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    # -- the dispatch ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) \
                and not _in_sharding_propagation():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        if ns == "prim":
            return
        packet = func._overloadpacket
        name = packet.__name__
        outs = _tensors(out)
        if self.track_memory and not func.is_view:
            for t in outs:
                self._track(t)
        if ns in _COMM_NAMESPACES:
            kind = _KINDS.get(name)
            if kind is not None:
                self._collective(kind, args, outs)
            return
        if func.is_view:
            return
        out_b = sum(_nbytes(t) for t in outs)
        if packet in flop_registry:
            # an overload with an output dtype (``bmm.dtype``: bf16 products
            # summed into f32) takes its packet's formula on the operands
            flops = flop_registry[packet](
                *(a for a in args if not isinstance(a, torch.dtype)),
                **{k: v for k, v in kwargs.items() if k != "out_dtype"},
                out_val=out)
            io = out_b + sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.flops += flops
            self.bytes += io
            self.dot_bytes += io
        elif out_b >= BIG_OUTPUT:
            in_b = sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.flops += out_b / 2
            self.bytes += out_b + in_b

    def _collective(self, kind: str, args, outs) -> None:
        if kind in ("send", "recv"):
            sent = _tensors(args)                   # the plane's buffer
            size = sum(_nbytes(t) for t in sent)
            shape = tuple(sent[0].shape) if sent else ()
        else:
            size = sum(_nbytes(t) for t in outs)
            shape = tuple(outs[0].shape) if outs else ()
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.counts[kind] += 1
        self.result_bytes[kind] += size
        self.wire[kind] += wire_bytes(kind, size, _group_size(args, world))
        self.by_shape[(kind, shape)] += size

    # -- the record -----------------------------------------------------
    def totals(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes": self.bytes,
                "dot_bytes": self.dot_bytes}

    def collectives(self) -> Dict:
        return {"counts": dict(self.counts),
                "result_bytes": dict(self.result_bytes),
                "wire_bytes": dict(self.wire),
                "total_wire_bytes": sum(self.wire.values())}


def count_fn(fn, *args, **kwargs) -> Dict[str, float]:
    """``{"flops", "bytes", "dot_bytes"}`` of one call ``fn(*args,
    **kwargs)``, counted as it runs (pass ``meta`` or fake tensors to
    allocate nothing)."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.totals()
