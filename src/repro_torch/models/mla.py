"""Multi-head Latent Attention, DeepSeek-V2/V3 (PyTorch port of
``repro.models.mla``).

Queries and KV are low-rank compressed; K/V are rebuilt from a shared
latent ``c_kv`` (``kv_lora_rank`` wide) plus one RoPE key stream shared by
every head.  The prefill (:func:`mla_attention`) rebuilds K/V and runs
causal attention in plain PyTorch, as the JAX package does (it never sends
MLA to its flash kernel).  Decode (:func:`mla_decode`) runs in the
*absorbed* form against the latent cache, ``kv_lora_rank +
qk_rope_head_dim`` wide a token: the query is taken into latent space
through ``W_uk``, scored against the cached latents, the values summed in
latent space and projected once through ``W_uv``.

The decode follows the capture rule of the serving engine's decode
program: ``cache_len`` is an int or a 0-d device tensor the host never
reads, the new latent rows are written into the caches in place
(``index_copy_`` at a one-element index), the mask compares on the device,
and bf16 scores are summed in f32 without a copy of the cache on the card
(``bmm`` with an f32 output; the CPU upcasts).  Parameters keep the JAX
package's names and layout (``x @ W``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Union

import torch

from repro_torch.parallel.sharding import (grad_placed, shard_map, splittable,
                                           write_row)

from .attention import NEG_INF, _cache_row
from .common import ModelConfig, apply_rope, dense_init, rms_norm

Params = Mapping[str, torch.Tensor]


def init_mla_params(generator: torch.Generator,
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    pdt, dev = cfg.param_dtype, generator.device
    return {
        "wdq": dense_init(generator, (d, qr), pdt),
        "q_norm": torch.ones(qr, dtype=pdt, device=dev),
        "wuq": dense_init(generator, (qr, H * (dn + dr)), pdt),
        "wdkv": dense_init(generator, (d, kvr + dr), pdt),
        "kv_norm": torch.ones(kvr, dtype=pdt, device=dev),
        "wuk": dense_init(generator, (kvr, H * dn), pdt),
        "wuv": dense_init(generator, (kvr, H * dv), pdt),
        "wo": dense_init(generator, (H * dv, d), pdt),
    }


def _compress(p: Params, x: torch.Tensor, cfg: ModelConfig, positions):
    """x: (B, S, d) -> ``(q_nope (B, S, H, dn), q_rope (B, S, H, dr), c_kv
    (B, S, kvr), k_rope (B, S, dr))``; the rope stream is one head shared
    by all."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = rms_norm(p["q_norm"], grad_placed(x @ p["wdq"].to(x.dtype)),
                  cfg.norm_eps)
    q = splittable(cq @ p["wuq"].to(x.dtype), -1, H).reshape(B, S, H, -1)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv_full = x @ p["wdkv"].to(x.dtype)
    c_kv = rms_norm(p["kv_norm"], ckv_full[..., :kvr], cfg.norm_eps)
    k_rope = ckv_full[..., kvr:][:, :, None, :]
    if positions is not None:
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def mla_attention(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, q_block: int = 1024,
                  return_cache: bool = False):
    """Prefill / train MLA: K/V rebuilt from the latent, causal attention
    with scale ``1 / sqrt(dn + dr)``, the scores and softmax in f32 and the
    probabilities in x's dtype for the product with V.  Above ``q_block``
    query rows it runs one block of rows at a time (the JAX package's
    ``lax.scan``).  With ``return_cache`` also ``(c_kv, k_rope)``: what
    the latent cache stores."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(dn + dr)
    q_nope, q_rope, c_kv, k_rope = _compress(p, x, cfg, positions)
    k_nope = splittable(c_kv @ p["wuk"].to(x.dtype), -1, H).reshape(
        B, S, H, dn).float()
    v = splittable(c_kv @ p["wuv"].to(x.dtype), -1, H).reshape(B, S, H, dv)
    # the rope key, shared by every head, given to each head: a region's
    # input whole on an axis its heads are sharded on would get a partial
    # gradient from each rank
    kr = k_rope.float()[:, :, None, :].expand(B, S, H, dr)
    col = torch.arange(S, device=x.device)
    # on a mesh each rank scores its own batch rows and heads, as the dense
    # attention does (models/attention.py _sdpa_block): DTensor's sharding
    # propagation finds no plan for these einsums once batch and heads fold
    # into one dimension sharded on two mesh axes (a (16, 16) mesh)
    bh = ("batch", None, "heads", None)
    local = shard_map(functools.partial(_mla_block, scale=scale,
                                        dtype=x.dtype),
                      (bh, bh, None, None, bh, bh, bh), [bh])

    def block_attn(qn, qr, rows):
        return local(qn, qr, rows, col, k_nope, kr, v)

    if S <= q_block:
        o = block_attn(q_nope, q_rope, col)
    else:
        if S % q_block:
            raise ValueError(f"S={S} not divisible by q_block={q_block}")
        o = torch.cat([block_attn(q_nope[:, i:i + q_block],
                                  q_rope[:, i:i + q_block],
                                  col[i:i + q_block])
                       for i in range(0, S, q_block)], dim=1)
    out = o.reshape(B, S, H * dv) @ p["wo"].to(x.dtype)
    if return_cache:
        return out, (c_kv, k_rope)
    return out


def _mla_block(qn, qr, rows, col, k_nope, kr, v, scale: float, dtype):
    """One block of query rows against every key: f32 scores and softmax,
    the probabilities in ``dtype`` for the product with v."""
    lg = torch.einsum("bskh,btkh->bkst", qn.float(), k_nope)
    lg = lg + torch.einsum("bskh,btkh->bkst", qr.float(), kr)
    lg = lg * scale
    lg = torch.where(rows[:, None] >= col[None, :], lg, NEG_INF)
    pr = torch.softmax(lg, dim=-1).to(dtype)
    return torch.einsum("bkst,btkh->bskh", pr, v)


def _latent_scores(q: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """``(B, H, T)`` f32 scores of q ``(B, H, c)`` against a ``(B, T, c)``
    cache, the products summed in f32 as the JAX package's
    ``preferred_element_type=jnp.float32`` sums them: a bf16 cache on the
    card is read as it lies (one ``bmm`` with an f32 output); elsewhere
    both are upcast (the products of bf16 values are exact in f32)."""
    if cache.dtype == torch.float32 or not cache.is_cuda:
        return torch.bmm(q.float(), cache.float().transpose(1, 2))
    return torch.bmm(q.to(cache.dtype), cache.transpose(1, 2),
                     out_dtype=torch.float32)


def mla_decode(p: Params, x: torch.Tensor, position: torch.Tensor,
               ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
               cache_len: Union[int, torch.Tensor], cfg: ModelConfig):
    """Absorbed-form MLA decode against the latent cache: ``ckv_cache``
    ``(B, T, kv_lora_rank)``, ``krope_cache`` ``(B, T, qk_rope_head_dim)``.
    The new token's latent rows are written into both at ``cache_len`` in
    place (the JAX package returns updated copies); scores ``(W_uk^T
    q_nope) . c + q_rope . k_rope`` over the rows up to ``cache_len``,
    values in latent space, then ``W_uv`` and ``wo``.  Returns ``(y (B, 1,
    d), ckv_cache, krope_cache)``.  x: (B, 1, d); position: (B,) or (B,
    1)."""
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    T = ckv_cache.shape[1]
    scale = 1.0 / math.sqrt(dn + dr)
    positions = position[:, None] if position.dim() == 1 else position
    q_nope, q_rope, c_new, krope_new = _compress(p, x, cfg, positions)
    row = _cache_row(cache_len, x.device)
    write_row(ckv_cache, 1, row, c_new.to(ckv_cache.dtype))
    write_row(krope_cache, 1, row,
              krope_new.to(krope_cache.dtype))

    # absorb: q_eff[b, h, :] = q_nope[b, h] @ W_uk[h] (a latent-space query)
    wuk = p["wuk"].to(x.dtype).reshape(kvr, H, dn)
    q_eff = torch.einsum("bskh,ckh->bskc", q_nope, wuk).reshape(B, H, kvr)
    ckv = ckv_cache.to(x.dtype)
    lg = _latent_scores(q_eff, ckv)
    lg = lg + _latent_scores(q_rope.reshape(B, H, dr),
                             krope_cache.to(x.dtype))
    lg = lg * scale
    valid = torch.arange(T, device=x.device) <= row
    lg = torch.where(valid, lg, NEG_INF)
    pr = torch.softmax(lg, dim=-1).to(x.dtype)                 # (B, H, T)
    o_lat = torch.bmm(pr, ckv)                                 # (B, H, kvr)
    wuv = p["wuv"].to(x.dtype).reshape(kvr, H, dv)
    o = torch.einsum("bkc,ckh->bkh", o_lat, wuv).reshape(B, 1, H * dv)
    y = o @ p["wo"].to(x.dtype)
    return y, ckv_cache, krope_cache
