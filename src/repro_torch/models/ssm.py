"""Mamba2 (SSD) block: the chunked state-space duality algorithm (PyTorch
port of ``repro.models.ssm``).

The prefill runs the SSD chunked algorithm (Mamba-2 paper §6): within a
chunk the attention-like form under cumulative-decay masks, across chunks
the ``(H, P, N)`` state carried.  The decode is the O(1) recurrence.  State
``h_t = a_t h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D x_t``, with
``a_t = exp(dt_t A_h)`` (a scalar per head).

Parameters are a mapping of tensors in the JAX package's layout (``x @
W``); ``a_log``, ``dt_bias`` and ``d_skip`` are f32 whatever
``cfg.param_dtype``, as the JAX package draws them.  The SSD runs in f32,
the projections and the depthwise conv in the activations' dtype (the
conv as the reference's sum of shifted products, in the prefill and the
decode alike).  The JAX ``lax.scan`` over chunks is sequential in its
carry only: here the intra-chunk scores, ``y_intra`` and each chunk's
contribution to the carry are computed for every chunk at once, ``(B,
nc, Q, Q, H)`` f32, and a Python loop runs over the nc carries alone.

A sequence whose length is not a multiple of ``chunk`` (256) runs as one
chunk of its length, as in the reference, so that rounding follows it.
That chunk's ``(B, S, S, H)`` f32 temporaries grow with S squared: at B =
4, S = 4,088 and 64 heads one is 17 GB.  Long prompts should be multiples
of 256.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dense_init, rms_norm

Params = Mapping[str, torch.Tensor]

#: the leaves drawn in f32 whatever ``cfg.param_dtype``
F32_LEAVES = ("a_log", "dt_bias", "d_skip")


def init_mamba2_params(generator: torch.Generator,
                       cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, din, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_ssm_heads
    conv_dim = din + 2 * ns
    pdt, dev = cfg.param_dtype, generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # in_proj -> [z (din), x (din), B (ns), C (ns), dt (H)]
        "w_in": dense_init(generator, (d, 2 * din + 2 * ns + H), pdt),
        "conv_w": dense_init(generator, (cfg.ssm_conv, conv_dim), pdt,
                             fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros(conv_dim, dtype=pdt, device=dev),
        "a_log": torch.zeros(H, **f32),                 # A = -exp(a_log)
        "dt_bias": torch.full((H,), -2.0, **f32),       # softplus ~ 0.12
        "d_skip": torch.ones(H, **f32),
        "norm": torch.ones(din, dtype=pdt, device=dev),
        "norm_in": torch.ones(d, dtype=pdt, device=dev),
        "w_out": dense_init(generator, (din, d), pdt),
    }


def _split_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    din, ns, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    zxbcdt = x @ p["w_in"].to(x.dtype)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * ns]
    dt = zxbcdt[..., -H:]
    return z, xbc, dt


def _causal_conv(p: Params, xbc: torch.Tensor, cfg: ModelConfig,
                 conv_state=None):
    """Depthwise causal conv, k = ``cfg.ssm_conv``.  xbc: (B, S, conv_dim);
    ``conv_state`` the last k - 1 inputs before it (zeros when ``None``).
    Returns ``(silu(conv + b), the last k - 1 inputs)``."""
    k = cfg.ssm_conv
    w = p["conv_w"].to(xbc.dtype)                         # (k, conv_dim)
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)                    # (B, k-1, conv_dim)
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(k))
    out = F.silu(out + p["conv_b"].to(xbc.dtype))
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return out, new_state


def _softplus_dt(dt: torch.Tensor, p: Params) -> torch.Tensor:
    return F.softplus(dt.float() + p["dt_bias"])


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   chunk: int = 256, return_state: bool = False):
    """Train / prefill SSD.  x: (B, S, d) -> (B, S, d) [, the final state
    ``{"h": (B, H, P, N) f32, "conv": (B, k - 1, d_inner + 2 N)}``]."""
    B, S, _ = x.shape
    din, ns, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = din // H
    x = rms_norm(p["norm_in"], x, cfg.norm_eps)
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(p, xbc, cfg)
    xs = xbc[..., :din].reshape(B, S, H, P)
    Bm = xbc[..., din:din + ns]                           # (B, S, N)
    Cm = xbc[..., din + ns:]                              # (B, S, N)

    dtp = _softplus_dt(dt, p)                             # (B, S, H)
    A = -torch.exp(p["a_log"])                            # (H,)
    log_a = dtp * A                                       # (B, S, H) <= 0

    if S % chunk:
        chunk = S                 # the reference's rule: a single chunk
    nc, Q = S // chunk, chunk
    xc = xs.reshape(B, nc, Q, H, P).float()
    bc = Bm.reshape(B, nc, Q, ns).float()
    cc = Cm.reshape(B, nc, Q, ns).float()
    dtc = dtp.reshape(B, nc, Q, H)
    cum = torch.cumsum(log_a.reshape(B, nc, Q, H), dim=2)  # (B, nc, Q, H)
    total = cum[:, :, -1]                                 # (B, nc, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # intra: scores[t, j] = (C_t . B_j) exp(cum_t - cum_j) dt_j, j <= t
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)          # (B, nc, Q, Q)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    scores = torch.where(tri[:, :, None], torch.exp(decay), 0.0) \
        * cb[..., None] * dtc[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)
    # each chunk's own term of the carry: sum_j exp(total - cum_j) dt_j B_j x_j
    wj = torch.exp(total[:, :, None] - cum) * dtc         # (B, nc, Q, H)
    own = torch.einsum("bcqh,bcqn,bcqhp->bchpn", wj, bc, xc)
    # the carry, chunk by chunk: h' = exp(total) h + own
    h = torch.zeros((B, H, P, ns), dtype=torch.float32, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + own[:, c]
    # inter: y_t += C_t (exp(cum_t) h_carry)
    y = y + torch.einsum("bcqn,bchpn->bcqhp", cc, torch.stack(starts, 1)) \
        * torch.exp(cum)[..., None]
    y = y.reshape(B, S, H, P) + p["d_skip"][:, None] * xs.float()
    y = y.reshape(B, S, din).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    if return_state:
        return out, {"h": h, "conv": conv_state}
    return out


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                      device=None) -> Dict[str, torch.Tensor]:
    """A zero state: ``h`` (batch, H, P, N) f32 and ``conv`` (batch, k - 1,
    d_inner + 2 N) in ``dtype``."""
    H, ns = cfg.n_ssm_heads, cfg.ssm_state
    return {
        "h": torch.zeros((batch, H, cfg.d_inner // H, ns),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * ns),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p: Params, x: torch.Tensor, state: Mapping[str, torch.Tensor],
                  cfg: ModelConfig):
    """Single-token recurrence.  x: (B, 1, d) -> ``(y (B, 1, d), {"h",
    "conv"})``, the new state in fresh tensors."""
    B = x.shape[0]
    din, ns, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = din // H
    x = rms_norm(p["norm_in"], x, cfg.norm_eps)
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(p, xbc, cfg, conv_state=state["conv"])
    xs = xbc[:, 0, :din].reshape(B, H, P)
    Bm = xbc[:, 0, din:din + ns].float()
    Cm = xbc[:, 0, din + ns:].float()
    dtp = _softplus_dt(dt[:, 0], p)                       # (B, H)
    a = torch.exp(dtp * -torch.exp(p["a_log"]))           # (B, H)
    h = state["h"] * a[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtp, Bm, xs.float())
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + p["d_skip"][:, None] * xs.float()
    y = y.reshape(B, 1, din).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype), {"h": h, "conv": conv_state}


class Mamba2(nn.Module):
    """One Mamba2 layer; ``p`` holds ``w_in, conv_w, conv_b, a_log,
    dt_bias, d_skip, norm, norm_in, w_out`` (the JAX package's layout)."""

    def __init__(self, params: Params):
        super().__init__()
        self.p = nn.ParameterDict({k: nn.Parameter(t)
                                   for k, t in params.items()})

    def forward(self, x, cfg: ModelConfig, return_state: bool = False):
        return mamba2_forward(self.p, x, cfg, return_state=return_state)

    def decode(self, x, state: Mapping[str, torch.Tensor], cfg: ModelConfig):
        return mamba2_decode(self.p, x, state, cfg)
