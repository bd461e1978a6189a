"""xLSTM blocks (Beck et al. 2024): the mLSTM (matrix memory, chunkwise
parallel) and the sLSTM (scalar memory, sequential), the SSM family
(PyTorch port of ``repro.models.xlstm``).

The mLSTM prefill is the chunkwise form: within a chunk of 256 tokens the
attention-like form under the stabilised exponential-gate decay matrix,
across chunks the stabilised ``(C, n, m)`` carried, so no ``(S, S)`` matrix
is made.  Unlike Mamba2's carry, the carry's stabiliser ``m`` enters every
position's stabiliser of the next chunk, so the chunks run in turn, each as
the reference's scan body.  A length that is not a multiple of 256 runs as
one chunk of its length, as in the reference (its ``(B, S, S, H)`` f32
terms grow with S squared).  The decode is the O(1) recurrence on the
``(hd, hd)`` matrix memory.

The sLSTM runs over time one token after another (the reference's
``lax.scan``): here a Python loop, which launches each step's kernels per
token; per-head block-diagonal recurrent weights, exponential input and
sigmoid-forget gating, then a gated GELU FFN (the tanh approximation, as
``jax.nn.gelu``'s default).

The casts are the reference's: the projections and the gates' pre-sums in
the activations' dtype, ``k`` scaled by ``hd ** -0.5`` before its f32
cast, the sLSTM's recurrent ``h`` cast to that dtype before ``w_r``; the
states f32, the stabilisers starting at ``-1e30``; the mLSTM's output
divided by ``max(|den|, exp(-m))``.  Parameters are a mapping of tensors in
the JAX package's layout (``x @ W``), all in ``cfg.param_dtype``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import (grad_splittable, seq_whole,
                                           shard_map, splittable)

from .common import ModelConfig, dense_init, rms_norm

Params = Mapping[str, torch.Tensor]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm_params(generator: torch.Generator,
                      cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, H = cfg.d_model, cfg.n_heads
    dp = 2 * d                      # up-projection factor 2 (xLSTM paper)
    pdt, dev = cfg.param_dtype, generator.device
    g = generator
    return {
        "w_up": dense_init(g, (d, 2 * dp), pdt),                 # x, gate
        "wq": dense_init(g, (dp, dp), pdt),
        "wk": dense_init(g, (dp, dp), pdt),
        "wv": dense_init(g, (dp, dp), pdt),
        "w_if": dense_init(g, (dp, 2 * H), pdt),                 # i, f gates
        "b_if": torch.cat([torch.zeros(H, device=dev),
                           torch.full((H,), 3.0, device=dev)]).to(pdt),
        "norm": torch.ones(dp, dtype=pdt, device=dev),
        "norm_in": torch.ones(d, dtype=pdt, device=dev),
        "w_down": dense_init(g, (dp, d), pdt),
    }


def _mlstm_in(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The normed input's projections: ``(q, k, v)`` (B, S, H, hd) in
    ``x.dtype`` (``k`` scaled), the gates ``(i, log f)`` (B, S, H) f32 and
    the output gate's input, (B, S, 2 d)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    # a matmul region: its input (and _mlstm_out's output) seq-whole
    x = seq_whole(rms_norm(p["norm_in"], x, cfg.norm_eps))
    up = x @ p["w_up"].to(x.dtype)
    xin, gate = up.chunk(2, dim=-1)
    hd = xin.shape[-1] // H
    q, k, v = (splittable(xin @ p[w].to(x.dtype), -1, H).reshape(B, S, H, hd)
               for w in ("wq", "wk", "wv"))
    k = k / (hd ** 0.5)
    gates = (xin @ p["w_if"].to(x.dtype) + p["b_if"].to(x.dtype)).float()
    return q, k, v, gates[..., :H], F.logsigmoid(gates[..., H:]), gate


def _mlstm_out(p: Params, y: torch.Tensor, gate: torch.Tensor,
               cfg: ModelConfig):
    y = rms_norm(p["norm"], y, cfg.norm_eps) * F.silu(gate)
    return seq_whole(y @ p["w_down"].to(y.dtype))


def _mlstm_chunk(carry, qi, ki, vi, ii, fi):
    """One chunk of the reference's scan: ``(new carry, y (B, Q, H, hd))``,
    every input f32."""
    C, n, mc = carry                # (B,H,hd,hd), (B,H,hd), (B,H)
    Q = qi.shape[1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=qi.device).tril()
    lf = torch.cumsum(fi, dim=1)                         # (B,Q,H)
    total = lf[:, -1]                                    # (B,H)
    # intra-chunk exponents b[t, j] = lf_t - lf_j + i_j  (j <= t)
    bmat = lf[:, :, None, :] - lf[:, None, :, :] + ii[:, None, :, :]
    bmat = torch.where(tri[None, :, :, None], bmat, NEG_INF)
    a_t = lf + mc[:, None, :]                            # the carry's exponent
    m_t = torch.maximum(bmat.amax(dim=2), a_t)           # (B,Q,H)
    dstab = torch.exp(bmat - m_t[:, :, None, :])
    scores = torch.einsum("bthd,bjhd->btjh", qi, ki) * dstab
    num = torch.einsum("btjh,bjhd->bthd", scores, vi)
    den = scores.sum(dim=2)                              # (B,Q,H)
    cw = torch.exp(a_t - m_t)                            # the carry's weight
    num = num + cw[..., None] * torch.einsum("bthd,bhdv->bthv", qi, C)
    den = den + cw * torch.einsum("bthd,bhd->bth", qi, n)
    y = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the carry, stabilised at m_new
    wj = total[:, None] - lf + ii                        # (B,Q,H)
    m_new = torch.maximum(mc + total, wj.amax(dim=1))
    ew = torch.exp(wj - m_new[:, None])
    kv = torch.einsum("bjhd,bjhv->bhdv", ew[..., None] * ki, vi)
    ksum = torch.einsum("bjh,bjhd->bhd", ew, ki)
    decay = torch.exp(mc + total - m_new)
    C2 = C * decay[..., None, None] + kv
    n2 = n * decay[..., None] + ksum
    return (C2, n2, m_new), y


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 256, return_state: bool = False):
    """Chunkwise-parallel mLSTM.  x: (B, S, d) -> (B, S, d) [, the final
    state ``{"c" (B, H, hd, hd), "n" (B, H, hd), "m" (B, H)}``, f32]."""
    B, S, _ = x.shape
    q, k, v, ig, log_f, gate = _mlstm_in(p, x, cfg)
    H, hd = q.shape[2], q.shape[3]
    if S % chunk:
        chunk = S                 # the reference's rule: a single chunk
    q, k, v = q.float(), k.float(), v.float()
    carry = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device),
             torch.zeros((B, H, hd), dtype=torch.float32, device=x.device),
             torch.full((B, H), NEG_INF, dtype=torch.float32,
                        device=x.device))
    ys = []
    for c in range(0, S, chunk):
        sl = slice(c, c + chunk)
        carry, y = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                ig[:, sl], log_f[:, sl])
        ys.append(y)
    y = grad_splittable(torch.cat(ys, 1).reshape(B, S, H * hd), -1, H
                        ).to(x.dtype)
    out = _mlstm_out(p, y, gate, cfg)
    if return_state:
        return out, {"c": carry[0], "n": carry[1], "m": carry[2]}
    return out


def mlstm_init_state(cfg: ModelConfig, batch: int, *,
                     device=None) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    hd = 2 * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), NEG_INF, **f32)}


def mlstm_decode(p: Params, x: torch.Tensor, state: Mapping[str, torch.Tensor],
                 cfg: ModelConfig):
    """The recurrent mLSTM step.  x: (B, 1, d) -> ``(y (B, 1, d), {"c",
    "n", "m"})``, the new state in fresh tensors."""
    B = x.shape[0]
    q, k, v, ig, log_f, gate = _mlstm_in(p, x, cfg)
    H, hd = q.shape[2], q.shape[3]
    q, k, v = (a.reshape(B, H, hd).float() for a in (q, k, v))
    ig, log_f = ig[:, 0], log_f[:, 0]                    # (B,H)
    m_new = torch.maximum(log_f + state["m"], ig)
    fs = torch.exp(log_f + state["m"] - m_new)
    is_ = torch.exp(ig - m_new)
    c = state["c"] * fs[..., None, None] + is_[..., None, None] \
        * torch.einsum("bhk,bhv->bhkv", k, v)
    n = state["n"] * fs[..., None] + is_[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, c)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, H * hd).to(x.dtype)
    return _mlstm_out(p, y, gate, cfg), {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_params(generator: torch.Generator,
                      cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    ff = int(d * 4 / 3 / 64) * 64 * 2 or 2 * d
    pdt, dev = cfg.param_dtype, generator.device
    g = generator
    return {
        # the input projections of the gates (z, i, f, o)
        "w_x": dense_init(g, (d, 4 * d), pdt),
        # block-diagonal recurrent weights per head: (H, hd, 4 hd)
        "w_r": dense_init(g, (H, hd, 4 * hd), pdt, fan_in=hd),
        "bias": torch.zeros(4 * d, dtype=pdt, device=dev),
        "norm": torch.ones(d, dtype=pdt, device=dev),
        "norm_in": torch.ones(d, dtype=pdt, device=dev),
        "w_up": dense_init(g, (d, ff), pdt),
        "w_down": dense_init(g, (ff // 2, d), pdt, fan_in=ff // 2),
    }


def _slstm_zero_state(shape, device) -> Dict[str, torch.Tensor]:
    """The sLSTM's state before the first token: ``c``, ``n``, ``h`` zero,
    ``m`` at -inf, each of ``shape`` (B, H, hd) f32."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, **f32),
            "m": torch.full(shape, NEG_INF, **f32)}


def slstm_init_state(cfg: ModelConfig, batch: int, *,
                     device=None) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    return _slstm_zero_state((batch, H, cfg.d_model // H), device)


def _slstm_cell(xt: torch.Tensor, w_r: torch.Tensor, bias: torch.Tensor,
                st: Mapping[str, torch.Tensor]):
    """One sLSTM time step.  xt: (B, H, 4 hd), the input's projection;
    the block-diagonal ``w_r`` (H, hd, 4 hd) and ``bias`` (H, 4 hd) already
    in ``xt.dtype``."""
    rec = torch.einsum("bhk,hkg->bhg", st["h"].to(xt.dtype), w_r)
    tot = (xt + rec + bias).float()                      # (B,H,4*hd)
    z, i, f, o = tot.chunk(4, dim=-1)                    # each (B,H,hd)
    log_f = F.logsigmoid(f)
    m_new = torch.maximum(log_f + st["m"], i)
    fs = torch.exp(log_f + st["m"] - m_new)
    is_ = torch.exp(i - m_new)
    c = fs * st["c"] + is_ * torch.tanh(z)
    n = fs * st["n"] + is_
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_scan(xg: torch.Tensor, w_r: torch.Tensor, bias: torch.Tensor,
                *state: torch.Tensor):
    """The sLSTM's steps over xg (B, S, H, 4 hd) from ``state``, its ``(c,
    n, h, m)`` (B, H, hd) f32 (:func:`_slstm_zero_state` if none is
    given): ``(hs (B, S, H, hd), c, n, h, m)``, f32.  ``w_r`` and ``bias``
    are cast to xg's dtype once, not at every step."""
    B, S, H, g = xg.shape
    w_r, bias = w_r.to(xg.dtype), bias.to(xg.dtype)
    st = dict(zip("cnhm", state)) if state else \
        _slstm_zero_state((B, H, g // 4), xg.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(xg[:, t], w_r, bias, st)
        hs.append(st["h"])
    return torch.stack(hs, 1), st["c"], st["n"], st["h"], st["m"]


def _slstm_steps(p: Params, xg: torch.Tensor, cfg: ModelConfig,
                 state=None):
    """:func:`_slstm_scan` of the projection ``xg`` (B, S, 4 d) and the
    block's weights.  On a mesh each rank runs the steps of its own batch
    rows (and heads, where the model axis divides them): the recurrence is
    independent across both, and a token loop of DTensor ops would meet,
    in the merges of batch, head and width dimensions, strided shards that
    no op takes."""
    B, S, _ = xg.shape
    H = cfg.n_heads
    hd = cfg.d_model // H
    xg = splittable(xg, -1, H).reshape(B, S, H, 4 * hd)
    bh, st = ("batch", None, "heads", None), ("batch", "heads", None)
    state = () if state is None else tuple(state[k] for k in "cnhm")
    hs, c, n, h, m = shard_map(
        _slstm_scan,
        (bh, ("heads", None, None), ("heads", None)) + (st,) * len(state),
        [bh, st, st, st, st])(xg, p["w_r"], p["bias"].reshape(H, 4 * hd),
                              *state)
    return hs, {"c": c, "n": n, "h": h, "m": m}


def _slstm_ffn(p: Params, h: torch.Tensor, cfg: ModelConfig):
    y = rms_norm(p["norm"], h, cfg.norm_eps)
    a, b = (y @ p["w_up"].to(y.dtype)).chunk(2, dim=-1)
    return seq_whole((F.gelu(a, approximate="tanh") * b)
                     @ p["w_down"].to(y.dtype))


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """The sLSTM over time, token after token, then its gated FFN.  x: (B,
    S, d) -> (B, S, d) [, the final state ``{"c", "n", "h", "m"}``, each
    (B, H, hd) f32]."""
    B, S, d = x.shape
    # a matmul region: its input (and _slstm_ffn's output) seq-whole
    x = seq_whole(rms_norm(p["norm_in"], x, cfg.norm_eps))
    hs, st = _slstm_steps(p, x @ p["w_x"].to(x.dtype), cfg)
    y = grad_splittable(hs.reshape(B, S, d), -1, cfg.n_heads).to(x.dtype)
    out = _slstm_ffn(p, y, cfg)
    if return_state:
        return out, st
    return out


def slstm_decode(p: Params, x: torch.Tensor, state: Mapping[str, torch.Tensor],
                 cfg: ModelConfig):
    """One sLSTM step.  x: (B, 1, d) -> ``(y (B, 1, d), {"c", "n", "h",
    "m"})``, the new state in fresh tensors."""
    B = x.shape[0]
    x = rms_norm(p["norm_in"], x, cfg.norm_eps)
    hs, st = _slstm_steps(p, x @ p["w_x"].to(x.dtype), cfg, state)
    y = hs.reshape(B, 1, cfg.d_model).to(x.dtype)
    return _slstm_ffn(p, y, cfg), st


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _parameter_dict(params: Params) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t) for k, t in params.items()})


class MLSTM(nn.Module):
    """One mLSTM block; ``p`` holds ``w_up, wq, wk, wv, w_if, b_if, norm,
    norm_in, w_down`` (the JAX package's layout)."""

    def __init__(self, params: Params):
        super().__init__()
        self.p = _parameter_dict(params)

    def forward(self, x, cfg: ModelConfig, return_state: bool = False):
        return mlstm_forward(self.p, x, cfg, return_state=return_state)

    def decode(self, x, state: Mapping[str, torch.Tensor], cfg: ModelConfig):
        return mlstm_decode(self.p, x, state, cfg)


class SLSTM(nn.Module):
    """One sLSTM block; ``p`` holds ``w_x, w_r, bias, norm, norm_in, w_up,
    w_down``."""

    def __init__(self, params: Params):
        super().__init__()
        self.p = _parameter_dict(params)

    def forward(self, x, cfg: ModelConfig, return_state: bool = False):
        return slstm_forward(self.p, x, cfg, return_state=return_state)

    def decode(self, x, state: Mapping[str, torch.Tensor], cfg: ModelConfig):
        return slstm_decode(self.p, x, state, cfg)


class XLSTMPair(nn.Module):
    """One unit of the stack: ``x + slstm(x)``, then ``+ mlstm(.)``; its
    children are named as the JAX package's ``layers`` tree, so that
    ``layers.3.slstm.p.w_x`` is that tree's ``("layers", "slstm", "w_x")``
    at stacked index 3."""

    def __init__(self, params: Mapping):
        super().__init__()
        self.slstm = SLSTM(params["slstm"])
        self.mlstm = MLSTM(params["mlstm"])

    def forward(self, x, cfg: ModelConfig):
        x = x + self.slstm(x, cfg)
        return x + self.mlstm(x, cfg)
