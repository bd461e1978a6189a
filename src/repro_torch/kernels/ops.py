"""Public wrappers of the port's CUDA kernels (counterpart of
``repro.kernels.ops``).

Each wrapper checks its operands (device, dtype, shapes, contiguity) and
dispatches on the device they lie on: on a CUDA tensor it launches the
hand-written kernel (or raises), on a CPU tensor it runs the plain version
in :mod:`repro_torch.kernels.ref`.  There is no fallback from the kernel to
the plain version.  The solver kernels' wrappers take float32/float64
single-RHS ``(n,)`` vectors or multi-RHS ``(n, m)`` row-major blocks, and an
``(n, m)`` block goes to the batched kernel, as in the JAX package's
``ops``; the dots wrappers send an ``(n, 1)`` block, an ``(n,)`` vector in
memory, to the single-vector kernel, which is the faster of the two on one
column.  :func:`flash_attention` takes float32/bfloat16 tensors in the
model stack's layout, :func:`grouped_mm` the MoE sort dispatch's sorted
rows, its experts' weights and their row offsets.

The solver wrappers are the backing of the ``"cuda"`` compute substrate
(:mod:`repro_torch.core.substrate`), :func:`flash_attention` that of the
model stack's prefill (:mod:`repro_torch.models.attention`),
:func:`grouped_mm` that of the dropless MoE dispatch
(:mod:`repro_torch.models.moe`).  ``LAUNCHES``
counts the kernel launches (the CPU path counts nothing).

Behind each solver wrapper's checks, the dispatch is one
``torch.library`` op of the ``repro_torch`` namespace (:data:`KERNEL_OPS`):
its CPU kernel is the plain version, its CUDA kernel the launch, its fake
kernel the output shapes.  An FX graph of a solver step
(:mod:`repro_torch.analysis`) therefore holds one node per kernel call, on
the CPU too, where the plain PyTorch a silent fallback would run shows as
aten nodes instead.  The shared block-Jacobi apply (``nb == 1``) is no
kernel, and no op.  ``flash_attention`` and ``grouped_mm`` are ops of
the same namespace, outside :data:`KERNEL_OPS`, each with a fake kernel
(in fake mode a traced MoE decode step shows no host read);
``grouped_mm`` has a derivative (:func:`_grouped_mm_backward`), whose
weight gradient is the op ``grouped_mm_weight_grad``.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import grouped_mm as _grouped
from . import ref
from ._build import LAUNCHES, reset_launches
from .flash_attention import DTYPES as FLASH_DTYPES
from .flash_attention import MAX_HEAD_DIM, flash_attention_cuda
from .fused_axpy import (IN_ORDER, OUT_ORDER, fused_axpy_batched_cuda,
                         fused_axpy_cuda)
from .fused_dots import (NDOTS, NDOTS_HEALTH, fused_dots_batched_cuda,
                         fused_dots_cuda, fused_dots_health_batched_cuda,
                         fused_dots_health_cuda)
from .precond_apply import (block_jacobi_apply_batched_cuda,
                            block_jacobi_apply_cuda)
from .spmv_ell import spmv_ell_batched_cuda, spmv_ell_cuda

__all__ = ["fused_dots", "fused_dots_health", "fused_axpy", "spmv_ell",
           "block_jacobi_apply", "flash_attention", "grouped_mm", "LAUNCHES",
           "reset_launches", "NAMESPACE", "KERNEL_OPS"]

#: the ``torch.library`` namespace of the port's ops
NAMESPACE = "repro_torch"
#: the solver kernels' ops, ``torch.ops.repro_torch.<name>``
KERNEL_OPS = ("fused_dots", "fused_dots_health", "fused_axpy", "spmv_ell",
              "block_jacobi_apply")


def _check_vectors(name: str, vecs: dict):
    """Check that ``vecs`` are contiguous float32/float64 ``(n,)`` vectors
    or ``(n, m)`` blocks of one shape, type and device (``"cpu"`` or
    ``"cuda"``); returns the tensor of the first entry as the reference."""
    first = next(iter(vecs.values()))
    for key, v in vecs.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor, got "
                            f"{type(v).__name__}")
        if v.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: {key} has dtype {v.dtype}; the kernel "
                            "takes float32 or float64")
        if v.dim() not in (1, 2):
            raise ValueError(f"{name}: {key} must be 1-D (n,) or 2-D (n, m), "
                             f"got shape {tuple(v.shape)}")
        if v.shape != first.shape or v.dtype != first.dtype \
                or v.device != first.device:
            raise ValueError(
                f"{name}: {key} is {tuple(v.shape)} {v.dtype} on {v.device}, "
                f"unlike {tuple(first.shape)} {first.dtype} on {first.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return first


def _dots_cuda(single, batched, v: torch.Tensor, operands) -> torch.Tensor:
    """Launch a dots kernel on CUDA operands: the batched one on an
    ``(n, m)`` block with m > 1, else the single-vector one (an ``(n, 1)``
    block viewed as its one column, the result given its column back)."""
    if v.dim() == 2 and v.shape[1] > 1:
        return batched(*operands)
    out = single(*(a.view(-1) for a in operands))
    return out if v.dim() == 1 else out.view(-1, 1)


# -- the ops: checked operands in, each output a fresh tensor -----------------
#
# Defined with ``torch.library.Library`` and a kernel for the CPU and the CUDA
# dispatch keys alone: the dispatcher calls the kernel directly.  The
# ``torch.library.custom_op`` form of the same ops wraps each call in Python
# (autograd, an aliasing check), which costs the host more a call
# (``tools/op_dispatch_ab.py`` times both on the card).  No output aliases
# an input: the plain versions and the launchers return fresh tensors (a
# frozen column of the masked update is selected by ``torch.where``, never
# returned as given).

_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def _define(name: str, schema: str, cpu, cuda, fake):
    """Define the op ``repro_torch::<name>`` with its CPU kernel (the plain
    version), CUDA kernel (the launch) and fake kernel (the shapes), and
    return its overload."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _dots_kernel(s, y, r, t, rs):
    return _dots_cuda(fused_dots_cuda, fused_dots_batched_cuda, s,
                      (s, y, r, t, rs))


def _dots_health_kernel(s, y, r, t, rs, x):
    return _dots_cuda(fused_dots_health_cuda, fused_dots_health_batched_cuda,
                      s, (s, y, r, t, rs, x))


def _axpy_plain(vecs, scal, mask):
    out = ref.fused_axpy(dict(zip(IN_ORDER, vecs)), scal.unbind(0), mask)
    return [out[k] for k in OUT_ORDER]


def _axpy_kernel(vecs, scal, mask):
    named = dict(zip(IN_ORDER, vecs))
    out = fused_axpy_cuda(named, scal) if vecs[0].dim() == 1 \
        else fused_axpy_batched_cuda(named, scal, mask)
    return [out[k] for k in OUT_ORDER]


def _spmv_kernel(values, cols, x):
    if x.dim() == 2:
        return spmv_ell_batched_cuda(values, cols, x)
    return spmv_ell_cuda(values, cols, x)


def _block_jacobi_kernel(inv_blocks, x):
    if x.dim() == 2:
        return block_jacobi_apply_batched_cuda(inv_blocks, x)
    return block_jacobi_apply_cuda(inv_blocks, x)


_fused_dots_op = _define(
    "fused_dots", "(Tensor s, Tensor y, Tensor r, Tensor t, Tensor rs) "
    "-> Tensor", ref.fused_dots, _dots_kernel,
    lambda s, *_: s.new_empty((NDOTS,) + tuple(s.shape[1:])))
_fused_dots_health_op = _define(
    "fused_dots_health", "(Tensor s, Tensor y, Tensor r, Tensor t, "
    "Tensor rs, Tensor x) -> Tensor", ref.fused_dots_health,
    _dots_health_kernel,
    lambda s, *_: s.new_empty((NDOTS_HEALTH,) + tuple(s.shape[1:])))
_fused_axpy_op = _define(
    "fused_axpy", "(Tensor[] vecs, Tensor scal, Tensor? mask) -> Tensor[]",
    _axpy_plain, _axpy_kernel,
    lambda vecs, scal, mask: [torch.empty_like(vecs[0]) for _ in OUT_ORDER])
_spmv_ell_op = _define(
    "spmv_ell", "(Tensor values, Tensor cols, Tensor x) -> Tensor",
    ref.spmv_ell, _spmv_kernel,
    lambda values, cols, x: x.new_empty((values.shape[0],)
                                        + tuple(x.shape[1:])))
_block_jacobi_apply_op = _define(
    "block_jacobi_apply", "(Tensor inv_blocks, Tensor x) -> Tensor",
    ref.block_jacobi_apply, _block_jacobi_kernel,
    lambda inv_blocks, x: torch.empty_like(x))
_grouped_mm_op = _define(
    "grouped_mm", "(Tensor x, Tensor w, Tensor offsets) -> Tensor",
    _grouped.plain, _grouped.grouped_mm_cuda,
    lambda x, w, offsets: x.new_empty((x.shape[0], w.shape[2])))
# the weight gradient, an op of its own so that a DTensor (a whole-operand
# rule, :mod:`repro_torch.parallel.strategies`) and fake mode reach it whole:
# its plain loop reads the offsets to the host, which only a local tensor
# allows; its fake kernel takes E from the offsets' shape
_grouped_mm_weight_grad_op = _define(
    "grouped_mm_weight_grad", "(Tensor x, Tensor dy, Tensor offsets) -> "
    "Tensor", _grouped.weight_grad, _grouped.weight_grad,
    lambda x, dy, offsets: x.new_empty((offsets.shape[0] - 1, x.shape[1],
                                        dy.shape[1])))


def _flash_layout(qg, k, v):
    """``(q (B, H, S, hd), k, v (B, K, S, hd))`` views of the model
    stack's layout, and ``(B, S, H, hd)``."""
    B, S, K, G, hd = qg.shape
    q = qg.view(B, S, K * G, hd).transpose(1, 2)
    return q, k.transpose(1, 2), v.transpose(1, 2), (B, S, K * G, hd)


def _flash_plain(qg, k, v, scale, causal):
    q, kk, vv, (B, S, H, hd) = _flash_layout(qg, k, v)
    o = ref.flash_attention(q, kk, vv, scale=scale, causal=causal)
    return o.transpose(1, 2).reshape(B, S, H * hd)


def _flash_kernel(qg, k, v, scale, causal):
    q, kk, vv, (B, S, H, hd) = _flash_layout(qg, k, v)
    out = torch.empty((B, S, H, hd), dtype=qg.dtype, device=qg.device)
    flash_attention_cuda(q, kk, vv, out.transpose(1, 2), scale=scale,
                         causal=causal)
    return out.view(B, S, H * hd)


# flash attention as an op: a DTensor reaches its kernel through a sharding
# rule (:mod:`repro_torch.parallel.strategies`), fake mode through its fake
# kernel, and the dry run's counter through its FLOP formula
# (:mod:`repro_torch.launch.flops`)
_flash_attention_op = _define(
    "flash_attention", "(Tensor qg, Tensor k, Tensor v, float scale, "
    "bool causal) -> Tensor", _flash_plain, _flash_kernel,
    lambda qg, k, v, scale, causal: qg.new_empty(
        (qg.shape[0], qg.shape[1], qg.shape[2] * qg.shape[3] * qg.shape[4])))


def _grouped_mm_setup(ctx, inputs, output):
    x, w, offsets = inputs
    ctx.save_for_backward(x, w, offsets)


def _grouped_mm_backward(ctx, dy):
    """``dx`` is the grouped product of ``dy`` with each ``w[e]^T`` (the
    kernel on the card), ``dw[e] = x_e^T dy_e`` the op
    ``grouped_mm_weight_grad`` (plain PyTorch over the groups on either
    device, :func:`~repro_torch.kernels.grouped_mm.weight_grad`); the
    offsets have none."""
    x, w, offsets = ctx.saved_tensors
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = _grouped_mm_op(dy.contiguous(),
                            w.transpose(1, 2).contiguous(), offsets)
    if ctx.needs_input_grad[1]:
        dw = _grouped_mm_weight_grad_op(x, dy.contiguous(), offsets)
    return dx, dw, None


torch.library.register_autograd(f"{NAMESPACE}::grouped_mm",
                                _grouped_mm_backward,
                                setup_context=_grouped_mm_setup, lib=_LIB)


# -- the wrappers: the checks, then the op ------------------------------------

def fused_dots(s, y, r, t, rs) -> torch.Tensor:
    """The 9 fused inner products ``[s·s, y·y, s·y, s·r, y·r, rs·r, rs·s,
    rs·t, r·r]``: ``(9,)`` for ``(n,)`` vectors, ``(9, m)`` per-column dots
    for ``(n, m)`` blocks."""
    _check_vectors("fused_dots", dict(s=s, y=y, r=r, t=t, rs=rs))
    return _fused_dots_op(s, y, r, t, rs)


def fused_dots_health(s, y, r, t, rs, x) -> torch.Tensor:
    """The guarded reduction phase: the 9 dots of :func:`fused_dots`, then
    ``x·x`` and the NaN/Inf probe ``Σ(s+y+t+rs+x)``: ``(11,)`` for
    ``(n,)`` vectors, ``(11, m)`` per column for ``(n, m)`` blocks.  A NaN
    or Inf in any operand of a column makes its row 10 non-finite."""
    _check_vectors("fused_dots_health",
                   dict(s=s, y=y, r=r, t=t, rs=rs, x=x))
    return _fused_dots_health_op(s, y, r, t, rs, x)


def _coefficients(scalars, v: torch.Tensor) -> torch.Tensor:
    """``(alpha, beta, zeta, eta)`` as one contiguous tensor of ``v``'s type
    and device: ``(4,)`` for vectors, ``(4, m)`` for ``(n, m)`` blocks (a
    scalar coefficient goes to every column)."""
    if isinstance(scalars, torch.Tensor):
        scal = scalars.to(device=v.device, dtype=v.dtype)
    else:
        scal = torch.stack([torch.as_tensor(c, dtype=v.dtype, device=v.device)
                            .expand(v.shape[1:]) for c in scalars])
    want = (4,) + tuple(v.shape[1:])
    if v.dim() == 1:
        scal = scal.reshape(-1)
    if tuple(scal.shape) != want:
        raise ValueError(f"fused_axpy: expected 4 scalars (alpha, beta, "
                         f"zeta, eta) of shape {want}, got shape "
                         f"{tuple(scal.shape)}")
    return scal.contiguous()


def fused_axpy(vecs: Dict[str, torch.Tensor], scalars,
               mask=None) -> Dict[str, torch.Tensor]:
    """p-BiCGSafe fused vector-update phase (Alg. 3.1 lines 23-32).

    ``vecs``: the 12 vectors or ``(n, m)`` blocks of ``IN_ORDER``;
    ``scalars``: ``(alpha, beta, zeta, eta)``, as 0-d (or, for blocks,
    ``(m,)`` per-column) tensors, numbers, or one ``(4,)`` (``(4, m)``)
    tensor.  ``mask``: blocks only, an optional ``(m,)`` bool; a column
    where it is False is frozen in the kernel (every output of
    ``MASKED_OUT`` is its input).  Returns the 10 updated vectors or
    blocks of ``OUT_ORDER``.
    """
    missing = set(IN_ORDER) - set(vecs)
    if missing:
        raise KeyError(f"fused_axpy: missing vectors {sorted(missing)}")
    v = _check_vectors("fused_axpy", {k: vecs[k] for k in IN_ORDER})
    scal = _coefficients(scalars, v)
    if v.dim() == 1 and mask is not None:
        raise ValueError("fused_axpy: mask is a multi-RHS (column) "
                         "concept; it needs (n, m) blocks")
    if mask is not None:
        mask = torch.as_tensor(mask, device=v.device).to(torch.bool)
        if tuple(mask.shape) != (v.shape[1],):
            raise ValueError(f"fused_axpy: mask must be ({v.shape[1]},), "
                             f"got shape {tuple(mask.shape)}")
        mask = mask.contiguous()
    out = _fused_axpy_op([vecs[k] for k in IN_ORDER], scal, mask)
    return dict(zip(OUT_ORDER, out))


def spmv_ell(op, x) -> torch.Tensor:
    """ELL SpMV ``y = A x`` for an :class:`~repro_torch.core.linear_operator
    .ELLOperator` and an ``(n,)`` ``x`` or an ``(n, m)`` block (the block
    kernel reads the matrix once for all m columns).  Any ELL matrix goes
    to the kernel on the card: unlike the TPU kernels it has no band
    limit."""
    _check_vectors("spmv_ell", {"x": x})
    values, cols = op.values, op.cols
    if values.dtype != x.dtype or values.device != x.device \
            or x.shape[0] != op.n:
        raise ValueError(
            f"spmv_ell: x is {tuple(x.shape)} {x.dtype} on {x.device}; the "
            f"operator is ({op.n},) {values.dtype} on {values.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"spmv_ell: cols must be int32, got {cols.dtype}")
    if not (values.is_contiguous() and cols.is_contiguous()):
        raise ValueError("spmv_ell: values and cols must be contiguous")
    return _spmv_ell_op(values, cols, x)


def block_jacobi_apply(inv_blocks, x) -> torch.Tensor:
    """Block-Jacobi ``M^{-1}`` apply ``y_g = B_g x_g`` over the pre-inverted
    ``(nb, bs, bs)`` diagonal blocks, for an ``(n,)`` ``x`` or an ``(n, m)``
    block (the batched kernel reads each block once for all m columns).

    The shared block (``nb == 1``, every row block the same: constant-
    coefficient stencils) is one ``torch.matmul`` on either device, as the
    JAX package sends it to one dense product; every ``nb >= 2`` goes to
    the kernels on the card."""
    _check_vectors("block_jacobi_apply", {"x": x})
    if not isinstance(inv_blocks, torch.Tensor):
        raise TypeError(f"block_jacobi_apply: inv_blocks must be a tensor, "
                        f"got {type(inv_blocks).__name__}")
    if inv_blocks.dim() != 3 or inv_blocks.shape[1] != inv_blocks.shape[2] \
            or inv_blocks.shape[0] == 0 or inv_blocks.shape[1] == 0:
        raise ValueError(f"block_jacobi_apply: inv_blocks must be (nb, bs, "
                         f"bs), got shape {tuple(inv_blocks.shape)}")
    if inv_blocks.dtype != x.dtype or inv_blocks.device != x.device:
        raise ValueError(
            f"block_jacobi_apply: x is {x.dtype} on {x.device}, inv_blocks "
            f"{inv_blocks.dtype} on {inv_blocks.device}")
    if not inv_blocks.is_contiguous():
        raise ValueError("block_jacobi_apply: inv_blocks must be contiguous")
    nb, bs, _ = inv_blocks.shape
    n = x.shape[0]
    if n % bs or (nb > 1 and n != nb * bs):
        raise ValueError(
            f"block_jacobi_apply: x has {n} rows; the blocks cover "
            f"{'a multiple of ' if nb == 1 else ''}{nb * bs}")
    if nb == 1:
        return ref.block_jacobi_apply(inv_blocks, x)
    return _block_jacobi_apply_op(inv_blocks, x)


def flash_attention(qg, k, v, *, scale: float,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention in the model stack's layout: ``qg`` ``(B, S, K, G,
    hd)`` (query head ``k * G + g``), ``k`` / ``v`` ``(B, S, K, hd)``, all
    contiguous, one dtype (float32 or bfloat16) and device; returns ``(B,
    S, K * G * hd)`` in qg's dtype.  Causal unless ``causal=False``.  On
    the card it is the hand-written kernel (``hd`` up to 128), which reads
    the G query heads of a KV head from the one KV head: K/V are not
    repeated."""
    for key, t in (("qg", qg), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {key} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype not in FLASH_DTYPES:
            raise TypeError(f"flash_attention: {key} has dtype {t.dtype}; "
                            "the kernel takes float32 or bfloat16")
        if t.dtype != qg.dtype or t.device != qg.device:
            raise ValueError(
                f"flash_attention: {key} is {t.dtype} on {t.device}, qg "
                f"{qg.dtype} on {qg.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {key} must be contiguous")
    if qg.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: expected qg (B, S, K, G, hd) and k, v (B, S, "
            f"K, hd), got {tuple(qg.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    B, S, K, G, hd = qg.shape
    if tuple(k.shape) != (B, S, K, hd):
        raise ValueError(f"flash_attention: k, v must be {(B, S, K, hd)}, "
                         f"got {tuple(k.shape)}")
    if qg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {qg.device}")
    if qg.is_cuda and hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} above the "
                         f"kernel's {MAX_HEAD_DIM}")
    return _flash_attention_op(qg, k, v, float(scale), bool(causal))


def grouped_mm(x, w, offsets) -> torch.Tensor:
    """The grouped product of the dropless MoE dispatch: rows
    ``offsets[e]:offsets[e + 1]`` of ``x`` ``(R, K)`` times ``w[e]`` (``w``
    ``(E, K, N)``), the sums in f32, the result ``(R, N)`` in x's dtype.
    ``offsets`` is an ``(E + 1,)`` int64 tensor rising from 0 to R on x's
    device; the wrapper never reads it, so a call makes no host read on the
    card.  On the card the operands are bfloat16 with K and N multiples of
    8, float32 or float64 (the hand-written kernels, the route by
    :func:`~repro_torch.kernels.grouped_mm.route`; any other dtype
    raises); on the CPU any float type (the plain version, which checks
    the offsets)."""
    for key, t in (("x", x), ("w", w), ("offsets", offsets)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"grouped_mm: {key} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.device != x.device:
            raise ValueError(f"grouped_mm: {key} lies on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_mm: {key} must be contiguous")
    if x.dim() != 2 or w.dim() != 3 or offsets.dim() != 1 \
            or w.shape[1] != x.shape[1] or offsets.shape[0] != w.shape[0] + 1:
        raise ValueError(
            f"grouped_mm: expected x (R, K), w (E, K, N) and offsets (E + 1,)"
            f", got {tuple(x.shape)}, {tuple(w.shape)}, "
            f"{tuple(offsets.shape)}")
    if offsets.dtype != torch.int64:
        raise TypeError(f"grouped_mm: offsets must be int64, got "
                        f"{offsets.dtype}")
    if not (x.is_floating_point() and w.dtype == x.dtype):
        raise TypeError(f"grouped_mm: x and w must share a float dtype, got "
                        f"{x.dtype} and {w.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_mm: unsupported device {x.device}")
    if x.is_cuda:
        R, K = x.shape
        E, N = w.shape[0], w.shape[2]
        route = _grouped.route(x.dtype)               # raises for float16
        if route == "wgmma" and (K % _grouped.ALIGN or N % _grouped.ALIGN):
            raise ValueError(
                f"grouped_mm: the bf16 kernel needs K and N multiples of "
                f"{_grouped.ALIGN}, got K = {K}, N = {N}")
        if -(-R // _grouped.tile_rows(route, R, E)) + min(E, R) > \
                _grouped.MAX_TILES:
            raise ValueError(f"grouped_mm: {R} rows over {E} groups are more "
                             f"tiles than the kernel's grid holds "
                             f"({_grouped.MAX_TILES})")
    return _grouped_mm_op(x, w, offsets)
