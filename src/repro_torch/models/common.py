"""Model-stack common pieces: config, norms, RoPE, init (PyTorch port of
``repro.models.common``).

The config has the JAX package's fields and defaults, so its architecture
files carry over as they are; the dtypes are ``torch`` dtypes.  Every
family of the JAX package runs in the port: the dense and MoE decoder
families (MLA and MTP included), the hybrid, the SSM (xLSTM), the audio
(whisper's encoder-decoder) and the VLM (qwen2-vl's M-RoPE,
:func:`apply_mrope`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes every assigned architecture (unused fields 0/None)."""

    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None   # qwen2-vl
    sliding_window: int = 0        # 0 -> full attention
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE
    moe_experts: int = 0           # 0 -> dense mlp
    moe_top_k: int = 1
    moe_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_groups: int = 1
    moe_impl: str = "gather"       # gather | sort
    # MTP (deepseek multi-token prediction)
    use_mtp: bool = False
    mtp_loss_weight: float = 0.3
    # SSM (mamba2 / zamba2)
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0             # 0 -> d_inner // 64
    hybrid_shared_period: int = 6
    # xLSTM
    xlstm_slstm_every: int = 2
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # VLM / audio stubs: frontend provides embeddings directly
    frontend_stub: bool = False
    # numerics / partitioning
    dtype: Any = torch.bfloat16    # activation/compute dtype
    param_dtype: Any = torch.bfloat16
    remat: str = "full"            # none | full | dots (training: loss_fn)
    use_flash_kernel: bool = False # the CUDA flash-attention kernel
    seq_shard_attn: bool = True    # the cache's mesh layout (cache_logical_axes)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# initializers (the JAX package's scales; a torch.Generator gives other
# numbers than a jax.random key, so weights are carried across with
# repro_torch.convert.lm_params_from_numpy where both must agree)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(1, fan))
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(dt)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (the biased variance), cast
    back to x's dtype, as the JAX package's."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def _device_constant(maxsize=None):
    """``functools.lru_cache`` for a function that copies a constant to a
    device, except under a fake mode (the dry run, a fake-mode trace),
    where the tensor made is that mode's and is not kept for another."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            if torch._guards.detect_fake_mode() is not None:
                return fn(*args)
            return cached(*args)
        get.cache_clear = cached.cache_clear
        return get
    return wrap


@_device_constant()
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    # copied to the device once: a copy from host memory per call would
    # make the host wait for the device at every layer; made outside
    # inference mode, so that every caller may use it
    with torch.inference_mode(False):
        return torch.as_tensor(rope_freqs(head_dim, theta),
                               dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    frequencies are computed in fp64 and cast to f32, the angles are f32
    positions times f32 frequencies, as in the JAX package."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    return _rotate_angles(x, positions.float()[..., None] * freqs)


def _rotate_angles(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) rotated by the f32 angles ``ang`` (..., S, hd/2),
    the halves of its last axis as the real and imaginary parts, in f32,
    cast back to x's dtype."""
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@_device_constant()
def _mrope_slots_on(sections: Tuple[int, ...],
                    device: torch.device) -> torch.Tensor:
    # each frequency slot's position stream, copied to the device once (as
    # _rope_freqs_on), so that a decode step reads nothing on the host
    with torch.inference_mode(False):
        return torch.as_tensor(np.repeat(np.arange(len(sections)), sections),
                               dtype=torch.int64, device=device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): x (..., S, H, hd), positions (..., S, 3)
    = the (t, h, w) ids; the hd/2 frequency slots are split into
    ``sections`` (sum = hd/2), each rotated by its own position stream.
    The angles are f32 positions times f32 frequencies, as in
    :func:`apply_rope`, so with t = h = w the two agree bit for bit."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} sum to "
                         f"{sum(sections)}, not hd / 2 = {hd // 2}")
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    slots = _mrope_slots_on(tuple(sections), x.device)
    pos = positions.float().index_select(-1, slots)          # (..., S, hd/2)
    return _rotate_angles(x, pos * freqs)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Whisper-style sinusoidal embeddings (n, d), f32: sines in the even
    columns, cosines in the odd ones."""
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    out = np.zeros((n, d), dtype=np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


@_device_constant(maxsize=8)
def sinusoidal_on(n: int, d: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """:func:`sinusoidal_positions` rounded to ``dtype`` on ``device``,
    copied there once per shape (made outside inference mode, so that
    every caller may use it)."""
    with torch.inference_mode(False):
        return torch.as_tensor(sinusoidal_positions(n, d)).to(
            device=device, dtype=dtype)
