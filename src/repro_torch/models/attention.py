"""GQA/MHA attention: prefill and cached decode (PyTorch port of
``repro.models.attention``).

Parameters are a mapping of tensors in the JAX package's layout (``x @
W``: ``wq`` is ``(d, H * hd)``), so weights carry across as copies.  Three
prefill branches, chosen as the JAX package chooses them: the flash kernel
(``cfg.use_flash_kernel``, causal self-attention, no sliding window, ``S
>= 256``), one block of plain attention (``S <= q_block``), and plain
attention chunked over query blocks.  The plain branches are einsums and a
softmax, never a library attention call: nothing on the path stands in for
the kernel.  Cross-attention (whisper) takes its K/V from ``x_kv`` and
rotates nothing; RoPE is applied only where ``positions`` are given (the
JAX package passes none in whisper's prefill, but rotates q, and a
self-attention's new k, at its decode: ROADMAP C29).  With
``cfg.mrope_sections`` (qwen2-vl) the rotation is M-RoPE at ``(B, S, 3)``
(t, h, w) positions; a decode step's ``(B, 1)`` position is taken on all
three streams, as the JAX package takes it.  The flash branch has no derivative,
in either package: with gradients enabled it runs through an autograd
function whose backward and forward-mode rule raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops as kops

from .common import (ModelConfig, apply_mrope, apply_rope, dense_init,
                     rms_norm)

Params = Mapping[str, torch.Tensor]

NEG_INF = -1e30


def init_attention_params(generator: torch.Generator,
                          cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    hd = cfg.hd
    H, K, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    dev = generator.device
    p = {
        "wq": dense_init(generator, (d, H * hd), cfg.param_dtype),
        "wk": dense_init(generator, (d, K * hd), cfg.param_dtype),
        "wv": dense_init(generator, (d, K * hd), cfg.param_dtype),
        "wo": dense_init(generator, (H * hd, d), cfg.param_dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd, dtype=cfg.param_dtype, device=dev)
        p["bk"] = torch.zeros(K * hd, dtype=cfg.param_dtype, device=dev)
        p["bv"] = torch.zeros(K * hd, dtype=cfg.param_dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=cfg.param_dtype, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=cfg.param_dtype, device=dev)
    return p


def _project(p: Params, x: torch.Tensor, key: str, heads: int,
             cfg: ModelConfig) -> torch.Tensor:
    y = x @ p["w" + key].to(x.dtype)
    if cfg.qkv_bias:
        y = y + p["b" + key].to(x.dtype)
    return y.reshape(*x.shape[:2], heads, cfg.hd)


def _rotate(t: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """RoPE at ``(B, S)`` positions, or with ``cfg.mrope_sections``
    M-RoPE at ``(B, S, 3)`` ones."""
    if cfg.mrope_sections is not None:
        return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(t, positions, cfg.rope_theta)


def _project_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    """``(B, S, H, hd)`` queries of x, rotated at ``positions`` unless
    ``None``."""
    q = _project(p, x, "q", cfg.n_heads, cfg)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    return q if positions is None else _rotate(q, positions, cfg)


def _project_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, T, K, hd)`` keys and values of x, the keys rotated at
    ``positions`` unless ``None``."""
    k = _project(p, x, "k", cfg.n_kv_heads, cfg)
    v = _project(p, x, "v", cfg.n_kv_heads, cfg)
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if positions is not None:
        k = _rotate(k, positions, cfg)
    return k, v


NO_FLASH_DERIVATIVE = (
    "the flash-attention kernel has no derivative (nor has the JAX "
    "package's): train with use_flash_kernel=False, the plain branch the "
    "JAX trainer takes")


class _FlashNoDerivative(torch.autograd.Function):
    """The flash kernel where autograd may look: its values as they are,
    and a clear error instead of a derivative.  Neither package's kernel
    has one (the JAX trainer never runs it), so a backward or a forward-mode
    derivative through it raises; training takes the plain branch
    (``use_flash_kernel=False``)."""

    @staticmethod
    def forward(qg, k, v, scale):
        return kops.flash_attention(qg, k, v, scale=scale, causal=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(NO_FLASH_DERIVATIVE)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(NO_FLASH_DERIVATIVE)


def _sdpa_block(q, k, v, mask: Optional[torch.Tensor], scale: float):
    """q: (B, Sq, H, hd), k/v: (B, T, H, hd) (KV repeated to H heads).
    The scores and the softmax in f32, the probabilities cast back to q's
    dtype for the product with v, as in the JAX package."""
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + torch.where(mask, 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _causal_mask(rows: torch.Tensor, cols: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    mask = rows[:, None] >= cols[None, :]
    if cfg.sliding_window:
        mask &= rows[:, None] - cols[None, :] < cfg.sliding_window
    return mask


def multihead_attention(p: Params, x: torch.Tensor,
                        positions: Optional[torch.Tensor], cfg: ModelConfig,
                        *, causal: bool = True,
                        x_kv: Optional[torch.Tensor] = None,
                        q_block: int = 1024, return_kv: bool = False):
    """Attention over a sequence (prefill, encoder, cross).  x: (B, S, d);
    positions: (B, S) (M-RoPE: (B, S, 3)), or ``None`` for no RoPE;
    ``x_kv`` (B, T, d): the sequence the keys and values come from
    (cross-attention, never rotated), x itself by default.  With ``return_kv`` also the un-repeated
    ``(k, v)``, each ``(B, T, K, hd)``: what the decode cache stores."""
    cross = x_kv is not None
    x_kv = x if x_kv is None else x_kv
    B, S, _ = x.shape
    T = x_kv.shape[1]
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    rope = None if cross else positions
    q = _project_q(p, x, cfg, rope)
    k, v = _project_kv(p, x_kv, cfg, rope)

    if cfg.use_flash_kernel and causal and not cross \
            and cfg.sliding_window == 0 and S == T and S >= 256:
        # the kernel reads query head h's KV from head h // G: no repeat
        qg = q.reshape(B, S, K, G, hd)
        if torch.is_grad_enabled():
            o = _FlashNoDerivative.apply(qg, k, v, scale)
        else:
            o = kops.flash_attention(qg, k, v, scale=scale, causal=True)
    else:
        kr = k.repeat_interleave(G, dim=2) if G > 1 else k
        vr = v.repeat_interleave(G, dim=2) if G > 1 else v
        cols = torch.arange(T, device=x.device)
        if S <= q_block:
            mask = _causal_mask(cols, cols, cfg) if causal and S == T \
                else None
            o = _sdpa_block(q, kr, vr, mask, scale)
        else:
            # q-block chunking: the (S x S) score matrix never exists
            if S % q_block:
                raise ValueError(f"S={S} not divisible by q_block={q_block}")
            blocks = []
            for i in range(S // q_block):
                rows = torch.arange(i * q_block, (i + 1) * q_block,
                                    device=x.device)
                mask = _causal_mask(rows, cols, cfg) if causal else None
                blocks.append(_sdpa_block(
                    q[:, i * q_block:(i + 1) * q_block], kr, vr, mask, scale))
            o = torch.cat(blocks, dim=1)
        o = o.reshape(B, S, H * hd)
    out = o @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def _cache_row(cache_len: Union[int, torch.Tensor],
                device) -> torch.Tensor:
    """``cache_len`` as a one-element int64 tensor on ``device``: a view of
    a tensor ``cache_len`` (the host never reads it), a fill for an int."""
    if isinstance(cache_len, torch.Tensor):
        return cache_len.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), cache_len, dtype=torch.int64, device=device)


def _decode_scores(qg: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """``(B, K, G, 1, T)`` f32 scores of qg ``(B, 1, K, G, hd)`` against a
    ``(B, T, K, hd)`` cache, the products summed in f32 as the JAX
    package's ``preferred_element_type=jnp.float32`` sums them.  A bf16
    cache on the card is read as it lies (one ``bmm`` with an f32 output
    per batch row, over strided views); the CPU has no such ``bmm``, so
    there the cache is copied to f32 (the products of bf16 values are
    exact in f32 either way)."""
    B, _, K, G, hd = qg.shape
    if k_cache.dtype == torch.float32 or not k_cache.is_cuda:
        return torch.einsum("bskgh,btkh->bkgst", qg.float(), k_cache.float())
    q = qg.to(k_cache.dtype).reshape(B, K, G, hd)
    kt = k_cache.permute(0, 2, 3, 1)                        # (B, K, hd, T)
    return torch.stack([torch.bmm(q[b], kt[b], out_dtype=torch.float32)
                        for b in range(B)])[:, :, :, None]


def decode_attention(p: Params, x: torch.Tensor, position: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], cfg: ModelConfig,
                     *, update_cache: bool = True):
    """Single-token decode against a (B, T, K, hd) KV cache, rows up to
    ``cache_len`` valid.

    ``cache_len`` is an int or a 0-d integer tensor, which stays on the
    device: with ``update_cache`` the new token's K/V are written into the
    caches at that row in place by an index tensor (the JAX package returns
    updated copies), and the mask compares with it on the device.  Without
    it (whisper's cross-attention against the encoder's K/V) nothing is
    written, and the K/V the JAX package projects from x and drops are not
    computed; q is rotated at ``position`` all the same, as the JAX
    package rotates it (ROADMAP C29).  Returns ``(y, k_cache, v_cache)`` as
    the JAX package does.  x: (B, 1, d); position: (B,) or (B, 1), with
    M-RoPE also (B, 1, 3); a (B, 1) one is taken on all three streams."""
    B = x.shape[0]
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // K
    T = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    positions = position[:, None] if position.dim() == 1 else position
    if cfg.mrope_sections is not None and positions.dim() == 2:
        positions = positions[..., None].expand(*positions.shape, 3)
    q = _project_q(p, x, cfg, positions)
    row = _cache_row(cache_len, x.device)
    if update_cache:
        k_new, v_new = _project_kv(p, x, cfg, positions)
        k_cache.index_copy_(1, row, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, row, v_new.to(v_cache.dtype))

    qg = q.reshape(B, 1, K, G, hd)
    logits = _decode_scores(qg, k_cache.to(x.dtype)) * scale
    t_idx = torch.arange(T, device=x.device)
    valid = t_idx <= row
    if cfg.sliding_window:
        valid &= t_idx > row - cfg.sliding_window
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkh->bskgh", probs, v_cache.to(x.dtype))
    y = o.reshape(B, 1, H * hd) @ p["wo"].to(x.dtype)
    return y, k_cache, v_cache
