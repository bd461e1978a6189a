"""Feed-forward blocks (PyTorch port of ``repro.models.moe``): the SwiGLU
MLP of the dense family, whisper's GELU MLP and the Mixture-of-Experts
MLP.

MoE routing: a softmax over the router's logits in f32; the optional
aux-loss-free bias (DeepSeek-V3) moves the *selection* only, the weights
come from the scores; a Switch-style load-balance loss is returned beside
the output.  Two dispatch implementations, as in the JAX package:

* ``"gather"``: capacity-slot dispatch.  Tokens are split into
  ``moe_groups`` groups; each (token, k) gets a slot in its (group,
  expert) capacity from a stable sort of the (group, expert) key, an
  inverse map (slot -> token) is built by a scatter, and the experts'
  inputs are a gather.  A token past its expert's capacity is dropped.
  Every shape is fixed by the config and the token count, so the path reads
  nothing back to the host (a decode step stays free of synchronisation).
* ``"sort"``: dropless.  The (token, k) pairs are sorted by expert and
  each expert's rows are one group of a grouped product whose offsets are
  counted on the device: the JAX package's ``jax.lax.ragged_dot``, here
  :func:`repro_torch.kernels.ops.grouped_mm` (a hand-written kernel on the
  card, the plain loop over the groups on the CPU).  Nothing is read to
  the host, so a decode step of a sort config captures as one CUDA graph,
  and the k contributions of a token are summed in a fixed order.

The gather dispatch's expert products are ``torch.einsum`` (plain array
code in the JAX package too: ``moe.py`` has no Pallas kernel).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops

from .common import ModelConfig, dense_init

Params = Mapping[str, torch.Tensor]

MOE_IMPLS = ("gather", "sort")


def init_moe_params(generator: torch.Generator,
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The router in f32 whatever ``cfg.param_dtype`` (as the JAX package
    draws it), the experts' ``(E, d, ff)`` / ``(E, ff, d)`` weights scaled
    by their own fan-in, and the shared experts' as one MLP of width
    ``ff * moe_shared_experts``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    pdt, dev = cfg.param_dtype, generator.device
    p = {
        "router": dense_init(generator, (d, E), torch.float32),
        "router_bias": torch.zeros(E, dtype=torch.float32, device=dev),
        "wi": dense_init(generator, (E, d, ff), pdt, fan_in=d),
        "wg": dense_init(generator, (E, d, ff), pdt, fan_in=d),
        "wo": dense_init(generator, (E, ff, d), pdt, fan_in=ff),
    }
    if cfg.moe_shared_experts:
        sf = ff * cfg.moe_shared_experts
        p["shared_wi"] = dense_init(generator, (d, sf), pdt)
        p["shared_wg"] = dense_init(generator, (d, sf), pdt)
        p["shared_wo"] = dense_init(generator, (sf, d), pdt)
    return p


def _route(p: Params, xf: torch.Tensor, cfg: ModelConfig):
    """xf: (N, d) -> ``(probs (N, k), experts (N, k), aux_loss)``."""
    # the router rounded to the activations' dtype, the product summed in
    # f32: the JAX package's bf16 einsum with preferred_element_type f32
    logits = xf.float() @ p["router"].to(xf.dtype).float()       # (N, E)
    scores = torch.softmax(logits, dim=-1)
    select = scores + p["router_bias"][None, :]       # the selection only
    # jax.lax.top_k: descending, ties to the lower index (a stable sort)
    experts = torch.sort(select, dim=-1, descending=True,
                         stable=True).indices[:, :cfg.moe_top_k]
    probs = torch.gather(scores, -1, experts)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss E * sum_e f_e * p_e, f_e from the
    # first choice only
    E, N = cfg.moe_experts, xf.shape[0]
    counts = torch.zeros(E, dtype=torch.float32, device=xf.device)
    counts = counts.index_add(0, experts[:, 0],
                              torch.ones(N, dtype=torch.float32,
                                         device=xf.device))
    density = counts / N
    mean_probs = scores.mean(dim=0)
    aux = E * torch.sum(density * mean_probs) * cfg.moe_aux_loss_coef
    return probs, experts, aux


def _expert_ffn(wi, wg, wo, xin: torch.Tensor, dtype) -> torch.Tensor:
    """xin: (E, C, d) -> (E, C, d); SwiGLU per expert."""
    h = torch.einsum("ecd,edf->ecf", xin, wi.to(dtype))
    g = torch.einsum("ecd,edf->ecf", xin, wg.to(dtype))
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, wo.to(dtype))


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
            impl: str = "gather") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ``(y (B, S, d), aux_loss)``.  ``impl`` is
    ``"gather"`` or ``"sort"``; anything else raises ``ValueError`` (the
    JAX package takes gather for any other string)."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl must be gather | sort, not {impl!r}")
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    probs, experts, aux = _route(p, xf, cfg)
    if impl == "sort":
        y = _moe_sort(p, xf, probs, experts, cfg)
    else:
        y = _moe_gather(p, xf, probs, experts, cfg)
    if cfg.moe_shared_experts:
        h = xf @ p["shared_wi"].to(x.dtype)
        g = xf @ p["shared_wg"].to(x.dtype)
        y = y + (F.silu(g) * h) @ p["shared_wo"].to(x.dtype)
    return y.reshape(B, S, d), aux


def capacity(N: int, cfg: ModelConfig) -> Tuple[int, int, int]:
    """The gather dispatch's ``(G, n, C)`` for N tokens: ``moe_groups``
    halved until it divides N, ``n = N // G`` tokens a group, and ``C``
    slots per (group, expert), the JAX package's arithmetic exactly."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    G = max(1, cfg.moe_groups)
    while N % G:
        G //= 2
    n = N // G
    C = int(max(4, cfg.moe_capacity_factor * n * k / E))
    return G, n, min(C, n * k)


def slots(experts: torch.Tensor, cfg: ModelConfig):
    """The slot of each (token, k) in its (group, expert) capacity.
    experts: (N, k) -> ``(eidx (G, n, k), keep (G, n, k))``: ``eidx`` the
    flat (expert, slot) id, the sentinel ``E * C`` where the token is
    dropped (``keep`` false)."""
    N, k = experts.shape
    E = cfg.moe_experts
    G, n, C = capacity(N, cfg)
    dev = experts.device
    N_k = N * k
    # rank within the (group, expert) run of a stable sort of the key:
    # O(N k) memory, no (N k, E) one-hot
    iota = torch.arange(N_k, device=dev)
    key = (iota // (n * k)) * E + experts.reshape(-1)
    order = torch.argsort(key, stable=True)
    # counted on the device (torch.bincount reads its maximum to the host)
    counts = torch.zeros(G * E, dtype=torch.int64, device=dev)
    counts = counts.index_add(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    rank = iota - starts[key[order]]
    pos = torch.empty_like(rank).scatter_(0, order, rank).reshape(G, n, k)
    keep = pos < C
    eidx = torch.where(keep, experts.reshape(G, n, k) * C + pos, E * C)
    return eidx, keep


def _moe_gather(p: Params, xf: torch.Tensor, probs: torch.Tensor,
                experts: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Index dispatch with capacity (see the module docstring)."""
    N, d = xf.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    G, n, C = capacity(N, cfg)
    dev = xf.device
    eidx, keep = slots(experts, cfg)
    xg = xf.reshape(G, n, d)
    pg = probs.reshape(G, n, k)

    # inverse map (G, E C + 1): slot -> source token (n: the zero row);
    # every dropped token writes the sentinel column E C, which is thrown
    # away, so the order of those duplicate writes does not matter
    g_idx = torch.arange(G, device=dev)[:, None]                # (G, 1)
    ginv = torch.full((G, E * C + 1), n, dtype=torch.int64, device=dev)
    ginv[g_idx[:, :, None].expand(G, n, k), eidx] = \
        torch.arange(n, device=dev)[None, :, None].expand(G, n, k)
    inv = ginv[:, :E * C]                                       # (G, E C)

    xgp = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    # indexed with broadcast (G, 1) x (G, E C) indices: no (G, E C, d)
    # index tensor as torch.gather would want
    xin = xgp[g_idx, inv].reshape(G, E, C, d)
    h = torch.einsum("gecd,edf->gecf", xin, p["wi"].to(xf.dtype))
    g_ = torch.einsum("gecd,edf->gecf", xin, p["wg"].to(xf.dtype))
    yout = torch.einsum("gecf,efd->gecd", F.silu(g_) * h,
                        p["wo"].to(xf.dtype))
    yflat = yout.reshape(G, E * C, d)

    # combine: one k at a time, accumulated in the activations' dtype
    y = xf.new_zeros(G, n, d)
    for kk in range(k):
        idx = torch.clamp(eidx[:, :, kk], max=E * C - 1)
        gk = (pg[:, :, kk] * keep[:, :, kk]).to(xf.dtype)
        y = y + yflat[g_idx, idx] * gk[..., None]
    return y.reshape(N, d)


def _moe_sort(p: Params, xf: torch.Tensor, probs: torch.Tensor,
              experts: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dropless dispatch: the (token, k) pairs sorted by expert, each
    expert's rows one group of the grouped product (three launches, as the
    JAX package's three ``ragged_dot``s), the group offsets on the device."""
    N, d = xf.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    expert_flat = experts.reshape(-1)                           # (N k,)
    order = torch.argsort(expert_flat, stable=True)
    xin = xf[order // k]                                        # sorted
    # counted on the device (torch.bincount reads its maximum to the host)
    sizes = torch.zeros(E, dtype=torch.int64, device=xf.device).index_add(
        0, expert_flat, torch.ones_like(expert_flat))
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    wi, wg, wo = (p[w].to(xf.dtype) for w in ("wi", "wg", "wo"))
    h = kops.grouped_mm(xin, wi, offsets)
    g = kops.grouped_mm(xin, wg, offsets)
    yo = kops.grouped_mm(F.silu(g) * h, wo, offsets)
    # combine: each pair's row of the sorted stream through the inverse
    # permutation, one k at a time in the activations' dtype; a fixed order
    # (an index_add of the k rows would sum them by atomics on the card)
    where = torch.empty_like(order).scatter_(
        0, order, torch.arange(N * k, device=xf.device)).reshape(N, k)
    gates = probs.to(xf.dtype)
    y = xf.new_zeros(N, d)
    for kk in range(k):
        y = y + yo[where[:, kk]] * gates[:, kk, None]
    return y


class MoEFFN(nn.Module):
    """The MoE MLP of one block; ``p`` holds ``router``, ``router_bias``
    (f32), ``wi``, ``wg``, ``wo`` and, with shared experts,
    ``shared_wi``, ``shared_wg``, ``shared_wo``.  Returns ``(y, aux)``."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.p = nn.ParameterDict({k: nn.Parameter(t)
                                   for k, t in params.items()})

    def forward(self, x, cfg: ModelConfig):
        return moe_ffn(self.p, x, cfg, impl=cfg.moe_impl)


def dense_ffn_init(generator: torch.Generator, cfg: ModelConfig,
                   d_ff: int = 0) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": dense_init(generator, (d, ff), cfg.param_dtype),
        "wg": dense_init(generator, (d, ff), cfg.param_dtype),
        "wo": dense_init(generator, (ff, d), cfg.param_dtype),
    }


def dense_ffn(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``(silu(x @ wg) * (x @ wi)) @ wo``."""
    h = x @ p["wi"].to(x.dtype)
    g = x @ p["wg"].to(x.dtype)
    return (F.silu(g) * h) @ p["wo"].to(x.dtype)


def gelu_ffn_init(generator: torch.Generator,
                  cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, ff, pdt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    dev = generator.device
    return {
        "wi": dense_init(generator, (d, ff), pdt),
        "bi": torch.zeros(ff, dtype=pdt, device=dev),
        "wo": dense_init(generator, (ff, d), pdt),
        "bo": torch.zeros(d, dtype=pdt, device=dev),
    }


def gelu_ffn(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """GELU MLP (whisper): ``gelu(x @ wi + bi) @ wo + bo``, the GELU's tanh
    form (``jax.nn.gelu``'s default; the exact erf form differs by about
    1e-3)."""
    h = F.gelu(x @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype),
               approximate="tanh")
    return h @ p["wo"].to(x.dtype) + p["bo"].to(x.dtype)
