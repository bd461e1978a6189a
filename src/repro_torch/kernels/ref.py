"""Plain PyTorch versions of the CUDA kernels (PyTorch port of
``repro.kernels.ref``).

Each is the kernel's oracle on the card and the port's path on the CPU.
The solver kernels' versions take a single right-hand side ``(n,)`` or a
block of them ``(n, m)``, as the JAX package's oracles do.
"""
from __future__ import annotations

import torch

from .fused_axpy import MASKED_OUT

#: (a, b) operand pairs of the 9 fused dots, in output order
DOT_PAIRS = (("s", "s"), ("y", "y"), ("s", "y"), ("s", "r"), ("y", "r"),
             ("rs", "r"), ("rs", "s"), ("rs", "t"), ("r", "r"))


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """``promote(dtype, float32)``: the type every kernel accumulates in."""
    return torch.promote_types(dtype, torch.float32)


def fused_dots(s, y, r, t, rs) -> torch.Tensor:
    """The 9 inner products of ssBiCGSafe2/p-BiCGSafe's single reduction
    phase: [a,b,c,d,e,f,g,h,rr] (paper Alg. 3.1 lines 7-8): ``(9,)`` for
    ``(n,)`` vectors, ``(9, m)`` per-column dots for ``(n, m)`` blocks."""
    v = dict(s=s, y=y, r=r, t=t, rs=rs)
    acc = acc_dtype(s.dtype)
    return torch.stack([(v[a] * v[b]).sum(0, dtype=acc)
                        for a, b in DOT_PAIRS])


def fused_dots_health(s, y, r, t, rs, x) -> torch.Tensor:
    """The guarded reduction phase: the 9 rows of :func:`fused_dots`, then
    row 9 ``x·x`` (the drift bound's ``||x||^2``) and row 10 the NaN/Inf
    probe ``Σ((((s + y) + t) + rs) + x)``: ``(11,)`` for ``(n,)`` vectors,
    ``(11, m)`` per column for ``(n, m)`` blocks.  ``x`` is the previous
    iterate, so the phase still reads nothing of the in-flight ``A s``."""
    acc = acc_dtype(s.dtype)
    health = torch.stack([(x * x).sum(0, dtype=acc),
                          (s + y + t + rs + x).sum(0, dtype=acc)])
    return torch.cat([fused_dots(s, y, r, t, rs), health])


def spmv_ell(values, cols, x) -> torch.Tensor:
    """ELLPACK SpMV: y[i] = sum_j values[i,j] * x[cols[i,j]]; an ``(n, m)``
    ``x`` has each column multiplied on its own."""
    if x.dim() == 2:
        return torch.einsum("rk,rkm->rm", values, x[cols])
    return (values * x[cols]).sum(dim=1)


def block_jacobi_apply(inv_blocks, x) -> torch.Tensor:
    """Block-Jacobi apply: y_g = inv_blocks[g] @ x_g per row block.

    ``inv_blocks`` is (nb, bs, bs), or (1, bs, bs) for one block shared
    by every row block (constant-coefficient stencils).  ``x`` may be an
    (n,) vector or an (n, m) multi-RHS block; n == (n // bs) * bs.
    """
    nb, bs, _ = inv_blocks.shape
    n = x.shape[0]
    g = n // bs
    if x.dim() == 2:
        xb = x.reshape(g, bs, x.shape[1])
        if nb == 1:
            y = torch.matmul(inv_blocks[0], xb)
        else:
            y = torch.einsum("gij,gjm->gim", inv_blocks, xb)
        return y.reshape(x.shape).contiguous()
    xb = x.reshape(g, bs)
    if nb == 1:
        y = xb @ inv_blocks[0].T
    else:
        y = torch.einsum("gij,gj->gi", inv_blocks, xb)
    return y.reshape(n).contiguous()


def fused_axpy(vecs: dict, scalars, mask=None) -> dict:
    """The fused vector-update phase of p-BiCGSafe (Alg. 3.1 lines 23-32).

    vecs: dict with r,p,u,t,y,z,s,l,g,w,x,As   scalars: (alpha,beta,zeta,eta)
    Returns dict with p,o,u,q,w,t,z,y,x,r (primed values).

    Column-batched: ``(n, m)`` blocks with ``(m,)`` per-column scalars.
    ``mask`` (optional ``(m,)`` bool, multi-RHS only): a frozen column
    (``mask`` False) keeps its input for every output of ``MASKED_OUT``;
    ``o`` and ``q`` are always fresh.  The mask selects, it does not blend:
    a frozen column's coefficients may be NaN.
    """
    al, be, ze, et = scalars
    r, p, u, t, y, z = (vecs[k] for k in "rputyz")
    s, l, g, w, x, As = (vecs[k] for k in ("s", "l", "g", "w", "x", "As"))
    p2 = r + be * (p - u)
    o = s + be * t
    u2 = ze * o + et * (y + be * u)
    q = As + be * l
    w2 = ze * q + et * (g + be * w)
    t2 = o - w2
    z2 = ze * r + et * z - al * u2
    y2 = ze * s + et * y - al * w2
    x2 = x + al * p2 + z2
    r2 = r - al * o - y2
    out = {"p": p2, "o": o, "u": u2, "q": q, "w": w2, "t": t2,
           "z": z2, "y": y2, "x": x2, "r": r2}
    if mask is not None:
        for k in MASKED_OUT:
            out[k] = torch.where(mask, out[k], vecs[k])
    return out


def flash_attention(q, k, v, scale: float, causal: bool = True):
    """Attention with an f32 softmax.  q: ``(B, H, S, hd)``, k/v: ``(B, K,
    S, hd)``, GQA with ``G = H // K`` (query head h reads KV head
    ``h // G``); the output is ``(B, H, S, hd)`` in q's dtype."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    qg = q.reshape(B, K, G, S, hd)
    logits = torch.einsum("bkgsh,bkth->bkgst", qg.float(), k.float()) * scale
    if causal:
        idx = torch.arange(S, device=q.device)
        mask = idx[:, None] >= idx[None, :]
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,bkth->bkgsh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)
