"""The LM, dense, MoE, hybrid, SSM, audio and VLM families (PyTorch port
of ``repro.models.transformer``).

A :class:`Transformer` module of :class:`DecoderBlock` modules, each with an
:class:`Attention` (with ``cfg.use_mla`` an :class:`MLA`) and a
:class:`DenseFFN` submodule (``mlp``), or with ``cfg.moe_experts`` a
:class:`~repro_torch.models.moe.MoEFFN` (``moe``); with ``cfg.use_mtp``
also DeepSeek-V3's multi-token-prediction block (:class:`MTP`, ``mtp``),
which only ``loss_fn`` runs.  The hybrid family (zamba2) has a
:class:`~repro_torch.models.ssm.Mamba2` module per layer and one
:class:`SharedBlock` (``shared_attn``: attention and a SwiGLU MLP) applied
before the Mamba2 block of every ``cfg.hybrid_shared_period``-th layer.
The SSM family (xLSTM) has ``cfg.n_layers // 2``
:class:`~repro_torch.models.xlstm.XLSTMPair` modules, an sLSTM and an
mLSTM block each, and no attention.  The audio family (whisper) has two
stacks of :class:`AudioBlock` modules, ``enc_layers`` (LayerNorm,
bidirectional self-attention, LayerNorm, GELU MLP) over the frame
embeddings plus sinusoidal positions, closed by a LayerNorm
(``enc_final_s``, ``enc_final_b``), and ``dec_layers`` (causal
self-attention, cross-attention ``xattn`` against the encoder's output, GELU
MLP) over the token embeddings plus the learned ``dec_pos_embed``; its
head is ``final_norm`` as an RMSNorm and the tied embedding, as the JAX
package's.  The VLM family (qwen2-vl) is the dense stack with M-RoPE
(``cfg.mrope_sections``): ``forward`` and ``prefill_step`` read
``batch["positions"]`` ``(B, S, 3)``, the (t, h, w) ids (``arange(S)`` on
all three streams by default), and splice ``batch["patch_embeds"]``
``(B, P, d)`` in over rows 1 to P, the start clamped to ``S - P`` as
``jax.lax.dynamic_update_slice`` clamps it (ROADMAP C31); its cache and
decode are the dense family's, a step's position ``cache_len`` on all
three streams (C32).
Weights keep the JAX package's layout (``x @ W``), so a JAX parameter tree
carries across as a copy (:func:`repro_torch.convert.lm_params_from_numpy`).
The entry points keep the JAX package's functional signatures, with the
module as ``params``:

* ``init_params(cfg, generator)``                        a :class:`Transformer`
* ``forward(params, cfg, batch)``                        ``(logits (B,S,V), aux)``
* ``prefill_step(params, cfg, batch)``                   ``(logits, cache)``
* ``loss_fn(params, cfg, batch)``                        ``(loss, metrics)``
* ``init_cache(cfg, batch, max_len, enc_len=, device=)`` ``{"k", "v"}`` / ``{"ckv", "krope"}`` / hybrid / SSM / audio
* ``decode_step(params, cfg, cache, tokens, cache_len, enc_len=)`` ``(logits (B,1,V), cache)``

The cache is ``{"k", "v"}``, each ``(L, B, T, K, hd)``, and with MLA the
latent cache ``{"ckv", "krope"}``, ``(L, B, T, kv_lora_rank)`` and ``(L, B,
T, qk_rope_head_dim)``; a decode step writes the new token's rows into it
in place.  The hybrid cache is ``{"ssm_h" (L, B, H, P, N) f32, "ssm_conv"
(L, B, k - 1, d_inner + 2 N), "attn_k", "attn_v" (npts, B, W, K, hd)}``,
one ring per application of the shared block (``npts = ceil(L /
period)``), ``W = min(max_len, sliding_window)`` rows wide: a decode step
writes row ``min(cache_len, W - 1)``, and once ``cache_len >= W`` first
rolls each ring left by one, on the device, as the reference does
(``repro.models.transformer.decode_step``); so with ``max_len`` under the
window the ring narrows attention to ``max_len`` tokens (ROADMAP C27, which
the serving engine refuses).  The SSM cache is the recurrent state of
every pair, stacked on a leading ``n_layers // 2`` axis, all f32 and with
no sequence axis: the sLSTM's ``{"s_c", "s_n", "s_h", "s_m"}``, each
``(np, B, H, d / H)``, and the mLSTM's ``{"m_c" (np, B, H, hd, hd), "m_n"
(np, B, H, hd), "m_m" (np, B, H)}`` (hd = 2 d / H); a decode step
overwrites it in place and never reads ``cache_len``.  The audio cache is
``{"k", "v"}`` of the decoder's self-attention, each ``(L, B, T, K, hd)``,
and the encoder's K/V of every decoder layer, ``{"cross_k", "cross_v"}``,
each ``(L, B, T_enc, K, hd)``, which a decode step reads (rows under
``enc_len``) and never writes.  Whisper's prefill applies no RoPE, its
decode rotates q and the new k at ``cache_len`` (the JAX package's
behaviour, kept: ROADMAP C29).  Layers run in a
Python loop (the JAX package's ``lax.scan``).  The JAX package's sharding
constraints stand at its call sites (:func:`repro_torch.parallel.
logical_constraint`): on a mesh they redistribute the DTensor activations
of a training step, and on one device, or on plain tensors, they return
their input as it is.  ``forward`` sums the MoE layers'
load-balance losses into its ``aux``; the prefill and decode steps drop
them.  MLA outside the MoE family raises ``NotImplementedError`` (the JAX
package cannot decode it, ROADMAP C25).

The weights are trainable parameters; serving runs under
``torch.inference_mode()``, which records nothing for them.  With
gradients enabled, ``forward`` wraps each block as ``cfg.remat`` asks, the
port of the JAX package's ``jax.checkpoint``: ``"full"`` recomputes the
block in the backward (``torch.utils.checkpoint``, non-reentrant),
``"dots"`` saves the projections' matmul outputs and recomputes the rest
(selective checkpointing, as ``dots_with_no_batch_dims_saveable``),
``"none"`` keeps every activation.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.types import resolve_device
from repro_torch.parallel import logical_constraint as shard
from repro_torch.parallel.sharding import seq_whole as _seq_whole

from .attention import (decode_attention, init_attention_params,
                        multihead_attention)
from .common import (ModelConfig, dense_init, embed_init, layer_norm,
                     rms_norm, sinusoidal_on)
from .mla import init_mla_params, mla_attention, mla_decode
from .moe import (MoEFFN, dense_ffn, dense_ffn_init, gelu_ffn, gelu_ffn_init,
                  init_moe_params)
from .ssm import Mamba2, init_mamba2_params, mamba2_init_state
from .xlstm import (XLSTMPair, init_mlstm_params, init_slstm_params,
                    mlstm_init_state, slstm_init_state)

#: the families the port runs (every family of the JAX package)
FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
#: the rows of whisper's learned decoder position table (the JAX package
#: sizes it for its decode_32k cell; a decode past it reads the last row,
#: where the JAX gather clamps, and the engine refuses such a max_len)
DEC_POSITIONS = 32768


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run,
    and for MLA outside the MoE family."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the families {FAMILIES}, not "
            f"{cfg.family!r}")
    if cfg.use_mla and cfg.family != "moe":
        raise NotImplementedError(
            f"{cfg.name}: MLA runs in the MoE family only: the JAX package "
            f"gives a {cfg.family} config with MLA a {{k, v}} cache that its "
            "decode step cannot read (ROADMAP C25)")


#: the stacked entries of the JAX package's trees: the decoder's layers, or
#: the audio family's encoder and decoder stacks
STACKS = ("layers", "enc_layers", "dec_layers")


def param_path(name: str) -> Tuple[Tuple[str, ...], int]:
    """The JAX package's tree path of the port's parameter ``name`` and its
    layer (-1 outside the stacks, ``STACKS``): ``"layers.3.attn.p.wq"`` is
    ``(("layers", "attn", "wq"), 3)``, ``"dec_layers.1.xattn.p.wk"``
    ``(("dec_layers", "xattn", "wk"), 1)``.  Names sorted by it are in the
    JAX package's leaf order (sorted keys, a stacked leaf's layers in
    turn)."""
    parts = [p for p in name.split(".") if p != "p"]
    if parts[0] in STACKS:
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), -1


def _stack(values):
    first = values[0]
    if isinstance(first, tuple):           # a NamedTuple leaf (Q8): by field
        return type(first)(*(torch.stack(f) for f in zip(*values)))
    return torch.stack(values)


def params_tree(named: Mapping[str, object]) -> Dict:
    """Values keyed by the port's parameter names (tensors, or NamedTuples
    of tensors such as 8-bit moments) as the JAX package's tree: nested
    dicts, each per-layer leaf stacked on a leading ``L`` axis."""
    by_path: Dict[Tuple[str, ...], Dict[int, object]] = {}
    for name, value in named.items():
        path, layer = param_path(name)
        by_path.setdefault(path, {})[layer] = value
    tree: Dict = {}
    for path, layers in by_path.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = layers[-1] if -1 in layers else _stack(
            [layers[i] for i in range(len(layers))])
    return tree


def params_from_tree(tree: Mapping, names) -> Dict[str, object]:
    """The inverse of :func:`params_tree` for the parameter ``names``: each
    name's leaf, a stacked leaf indexed at its layer (field by field for a
    NamedTuple leaf)."""
    out = {}
    for name in names:
        path, layer = param_path(name)
        node = tree
        for key in path:
            node = node[key]
        if layer >= 0:
            node = type(node)(*(f[layer] for f in node)) \
                if isinstance(node, tuple) else node[layer]
        out[name] = node
    return out


def _parameter_dict(params: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t) for k, t in params.items()})


class Attention(nn.Module):
    """Self-attention of one block; ``p`` holds ``wq, wk, wv, wo`` (and
    ``bq, bk, bv`` with ``qkv_bias``, ``q_norm, k_norm`` with
    ``qk_norm``)."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.p = _parameter_dict(params)

    def forward(self, x, positions, cfg: ModelConfig, **kw):
        return multihead_attention(self.p, x, positions, cfg, **kw)

    def decode(self, x, position, k_cache, v_cache,
               cache_len: Union[int, torch.Tensor], cfg: ModelConfig,
               update_cache: bool = True):
        return decode_attention(self.p, x, position, k_cache, v_cache,
                                cache_len, cfg, update_cache=update_cache)


class MLA(nn.Module):
    """Multi-head latent attention of one block (:mod:`.mla`); ``p`` holds
    ``wdq, q_norm, wuq, wdkv, kv_norm, wuk, wuv, wo``.  The counterpart of
    :class:`Attention`: ``forward`` is the prefill (causal), ``decode`` the
    absorbed step against the latent cache."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.p = _parameter_dict(params)

    def forward(self, x, positions, cfg: ModelConfig, *, causal: bool = True,
                return_kv: bool = False):
        if not causal:
            raise ValueError("MLA attention is causal")
        return mla_attention(self.p, x, positions, cfg,
                             return_cache=return_kv)

    def decode(self, x, position, ckv_cache, krope_cache,
               cache_len: Union[int, torch.Tensor], cfg: ModelConfig):
        return mla_decode(self.p, x, position, ckv_cache, krope_cache,
                          cache_len, cfg)


class DenseFFN(nn.Module):
    """The SwiGLU MLP of one block; ``p`` holds ``wi, wg, wo``."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.p = _parameter_dict(params)

    def forward(self, x):
        return dense_ffn(self.p, x)


class GeluFFN(nn.Module):
    """Whisper's GELU MLP of one block; ``p`` holds ``wi, bi, wo, bo``."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.p = _parameter_dict(params)

    def forward(self, x):
        return gelu_ffn(self.p, x)


class AudioBlock(nn.Module):
    """Whisper's pre-LayerNorm block.  An encoder block (no ``xattn``):
    ``x + attn(ln1(x))``, bidirectional, then ``+ mlp(ln2(.))``.  A decoder
    block: ``x + attn(ln1(x))``, causal, then ``+ xattn(lnx(.), enc)``
    against the encoder's output, then ``+ mlp(ln2(.))``.  Each LayerNorm
    is a scale ``*_s`` and a bias ``*_b``; no attention is rotated in the
    prefill (the JAX package passes no positions)."""

    def __init__(self, params: Mapping):
        super().__init__()
        names = ("ln1", "lnx", "ln2") if "xattn" in params else ("ln1", "ln2")
        for n in names:
            setattr(self, n + "_s", nn.Parameter(params[n + "_s"]))
            setattr(self, n + "_b", nn.Parameter(params[n + "_b"]))
        self.attn = Attention(params["attn"])
        self.xattn = Attention(params["xattn"]) if "xattn" in params \
            else None
        self.mlp = GeluFFN(params["mlp"])

    def _ln(self, n: str, x):
        # the input of a matmul region, seq-whole on a mesh (the decoder's
        # tokens come in seq-sharded; rows that fold a batch and a sequence
        # sharded on two mesh axes are a strided shard no product takes)
        return _seq_whole(layer_norm(getattr(self, n + "_s"),
                                     getattr(self, n + "_b"), x))

    def forward(self, x, cfg: ModelConfig, enc=None, return_kv: bool = False):
        """The encoder block with ``enc=None``, else the decoder block
        against ``enc``.  With ``return_kv`` (decoder) also ``(k, v,
        cross_k, cross_v)``, each ``(B, S or T_enc, K, hd)``."""
        a = self.attn(self._ln("ln1", x), None, cfg, causal=enc is not None,
                      return_kv=return_kv)
        a, kv = a if return_kv else (a, ())
        x = x + _seq_whole(a)
        if enc is not None:
            c = self.xattn(self._ln("lnx", x), None, cfg, causal=False,
                           x_kv=enc, return_kv=return_kv)
            c, xkv = c if return_kv else (c, ())
            x = x + _seq_whole(c)
            kv = tuple(kv) + tuple(xkv)
        x = x + _seq_whole(self.mlp(self._ln("ln2", x)))
        return (x, kv) if return_kv else x

    def decode(self, x, position, k_cache, v_cache, cross_k, cross_v,
               cache_len: Union[int, torch.Tensor],
               enc_last: Union[int, torch.Tensor], cfg: ModelConfig):
        """One token of a decoder block: its K/V written into the self
        caches at ``cache_len`` in place, the cross caches read at rows up
        to ``enc_last`` and left as they are."""
        a, _, _ = self.attn.decode(self._ln("ln1", x), position, k_cache,
                                   v_cache, cache_len, cfg)
        x = x + a
        c, _, _ = self.xattn.decode(self._ln("lnx", x), position, cross_k,
                                    cross_v, enc_last, cfg,
                                    update_cache=False)
        x = x + c
        return x + self.mlp(self._ln("ln2", x))


class DecoderBlock(nn.Module):
    """Pre-norm block: ``x + attn(ln1(x))``, then ``+ ffn(ln2(.))``, the
    ffn a dense ``mlp`` or a ``moe``.  ``forward`` returns ``(x, aux)``
    (``(x, aux, kv)`` with ``return_kv``), aux the MoE's load-balance loss
    or ``None`` for a dense block.  ``mla``: the attention is an
    :class:`MLA`, its ``kv`` the latent rows ``(c_kv, k_rope)``."""

    def __init__(self, params: Mapping, mla: bool = False):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"])
        self.ln2 = nn.Parameter(params["ln2"])
        self.attn = (MLA if mla else Attention)(params["attn"])
        if "moe" in params:
            self.moe = MoEFFN(params["moe"])
        else:
            self.mlp = DenseFFN(params["mlp"])

    def ffn(self, x, cfg: ModelConfig):
        """``(y, aux)`` of the block's feed-forward on ``ln2(x)``."""
        h = _seq_whole(rms_norm(self.ln2, x, cfg.norm_eps))
        if hasattr(self, "moe"):
            return self.moe(h, cfg)
        return self.mlp(h), None

    def forward(self, x, positions, cfg: ModelConfig,
                return_kv: bool = False):
        # on a mesh (the JAX package's constraints): training keeps the
        # residual stream seq-sharded and all-gathers the sequence before
        # each matmul region (Megatron-style sequence parallelism); the
        # prefill (return_kv) keeps it whole throughout
        seq = None if return_kv else "seq"
        hn = _seq_whole(rms_norm(self.ln1, x, cfg.norm_eps))
        a = self.attn(hn, positions, cfg, causal=True, return_kv=return_kv)
        a, kv = a if return_kv else (a, None)
        x = shard(x + _seq_whole(a), "batch", seq, "embed")
        f, aux = self.ffn(x, cfg)
        x = shard(x + _seq_whole(f), "batch", seq, "embed")
        return (x, aux, kv) if return_kv else (x, aux)

    def decode(self, x, position, k_cache, v_cache,
               cache_len: Union[int, torch.Tensor], cfg: ModelConfig):
        """One token against the block's two caches (K and V, or MLA's
        latent and rope rows), written in place."""
        a, _, _ = self.attn.decode(rms_norm(self.ln1, x, cfg.norm_eps),
                                   position, k_cache, v_cache, cache_len, cfg)
        x = x + a
        return x + self.ffn(x, cfg)[0]


class MTP(nn.Module):
    """DeepSeek-V3's multi-token prediction, depth 1: ``proj (2 d, d)``,
    the norms ``ln_h`` and ``ln_e`` and one decoder ``block``, unstacked
    (the JAX package's ``params["mtp"]``)."""

    def __init__(self, params: Mapping, mla: bool = False):
        super().__init__()
        self.proj = nn.Parameter(params["proj"])
        self.ln_h = nn.Parameter(params["ln_h"])
        self.ln_e = nn.Parameter(params["ln_e"])
        self.block = DecoderBlock(params["block"], mla=mla)


class SharedBlock(nn.Module):
    """The hybrid family's shared block (the JAX package's
    ``params["shared_attn"]``): ``x + attn(ln(x))``, then ``+ mlp(ln2(.))``,
    the attention causal under ``cfg.sliding_window``, the MLP SwiGLU."""

    def __init__(self, params: Mapping):
        super().__init__()
        self.ln = nn.Parameter(params["ln"])
        self.attn = Attention(params["attn"])
        self.ln2 = nn.Parameter(params["ln2"])
        self.mlp = DenseFFN(params["mlp"])

    def _mlp(self, x, cfg: ModelConfig):
        return x + _seq_whole(self.mlp(_seq_whole(
            rms_norm(self.ln2, x, cfg.norm_eps))))

    def forward(self, x, positions, cfg: ModelConfig,
                return_kv: bool = False):
        """``x`` after the block, with ``return_kv`` also the attention's
        ``(k, v)``, each ``(B, S, K, hd)``."""
        a = self.attn(_seq_whole(rms_norm(self.ln, x, cfg.norm_eps)),
                      positions, cfg, causal=True, return_kv=return_kv)
        a, kv = a if return_kv else (a, None)
        x = self._mlp(x + _seq_whole(a), cfg)
        return (x, kv) if return_kv else x

    def decode(self, x, position, k_ring, v_ring,
               wpos: Union[int, torch.Tensor], cfg: ModelConfig):
        """One token against one application's rings, its K/V written at
        row ``wpos`` in place."""
        a, _, _ = self.attn.decode(rms_norm(self.ln, x, cfg.norm_eps),
                                   position, k_ring, v_ring, wpos, cfg)
        return self._mlp(x + a, cfg)


class Transformer(nn.Module):
    """The decoder LM.  ``params`` is the JAX package's tree with the
    stacked ``layers`` given as a list of per-layer trees: ``embed (V,
    d)``, ``final_norm (d,)``, ``lm_head (d, V)`` (absent with
    ``tie_embeddings``), per layer ``ln1``, ``ln2``, ``attn`` and
    ``mlp`` (``moe`` with ``cfg.moe_experts``), and ``mtp`` where the tree
    has it.  In the hybrid family each layer's tree is a Mamba2 layer's
    and ``shared_attn`` the shared block's (``ln``, ``attn``, ``ln2``,
    ``mlp``); in the SSM family ``layers`` holds ``n_layers // 2`` pairs,
    each ``{"slstm", "mlstm"}``; the audio family has no ``layers`` but
    ``enc_layers`` and ``dec_layers`` (each a list of :class:`AudioBlock`
    trees), ``enc_final_s``, ``enc_final_b`` and ``dec_pos_embed``
    (``(DEC_POSITIONS, d)``)."""

    def __init__(self, cfg: ModelConfig, params: Mapping):
        super().__init__()
        check_supported(cfg)
        for key, n in layer_stacks(cfg).items():
            if len(params[key]) != n:
                raise ValueError(f"{cfg.name}: {len(params[key])} {key} "
                                 f"given, the config has {n}")
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = None if cfg.tie_embeddings \
            else nn.Parameter(params["lm_head"])
        if cfg.family == "audio":
            self.enc_layers = nn.ModuleList(AudioBlock(lp)
                                            for lp in params["enc_layers"])
            self.dec_layers = nn.ModuleList(AudioBlock(lp)
                                            for lp in params["dec_layers"])
            for key in ("enc_final_s", "enc_final_b", "dec_pos_embed"):
                setattr(self, key, nn.Parameter(params[key]))
        elif cfg.family == "hybrid":
            self.layers = nn.ModuleList(Mamba2(lp) for lp in params["layers"])
            self.shared_attn = SharedBlock(params["shared_attn"])
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(XLSTMPair(lp)
                                        for lp in params["layers"])
        else:
            self.layers = nn.ModuleList(DecoderBlock(lp, mla=cfg.use_mla)
                                        for lp in params["layers"])
        self.mtp = MTP(params["mtp"], mla=cfg.use_mla) \
            if "mtp" in params else None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, self.cfg, {"tokens": tokens})[0]


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Transformer:
    """A :class:`Transformer` with the JAX package's initial scales, drawn
    from ``generator`` on its device."""
    check_supported(cfg)            # before drawing the weights
    g, dev, pdt = generator, generator.device, cfg.param_dtype

    def ones(n):
        return torch.ones(n, dtype=pdt, device=dev)

    tree: Dict = {"embed": embed_init(g, (cfg.vocab_size, cfg.d_model), pdt),
                  "final_norm": ones(cfg.d_model)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(g, (cfg.d_model, cfg.vocab_size), pdt)
    def block():
        attn = init_mla_params if cfg.use_mla else init_attention_params
        layer = {"ln1": ones(cfg.d_model), "ln2": ones(cfg.d_model),
                 "attn": attn(g, cfg)}
        if cfg.moe_experts:
            layer["moe"] = init_moe_params(g, cfg)
        else:
            layer["mlp"] = dense_ffn_init(g, cfg)
        return layer

    if cfg.family == "hybrid":
        tree["layers"] = [init_mamba2_params(g, cfg)
                          for _ in range(cfg.n_layers)]
        tree["shared_attn"] = {"ln": ones(cfg.d_model),
                               "attn": init_attention_params(g, cfg),
                               "ln2": ones(cfg.d_model),
                               "mlp": dense_ffn_init(g, cfg)}
        return Transformer(cfg, tree)
    if cfg.family == "ssm":
        tree["layers"] = [{"slstm": init_slstm_params(g, cfg),
                           "mlstm": init_mlstm_params(g, cfg)}
                          for _ in range(stacked_layers(cfg))]
        return Transformer(cfg, tree)
    if cfg.family == "audio":
        def norms(*names):
            out = {}
            for n in names:
                out[n + "_s"] = ones(cfg.d_model)
                out[n + "_b"] = torch.zeros(cfg.d_model, dtype=pdt,
                                            device=dev)
            return out

        tree["enc_layers"] = [dict(norms("ln1", "ln2"),
                                   attn=init_attention_params(g, cfg),
                                   mlp=gelu_ffn_init(g, cfg))
                              for _ in range(cfg.n_encoder_layers)]
        tree["dec_layers"] = [dict(norms("ln1", "lnx", "ln2"),
                                   attn=init_attention_params(g, cfg),
                                   xattn=init_attention_params(g, cfg),
                                   mlp=gelu_ffn_init(g, cfg))
                              for _ in range(cfg.n_layers)]
        tree.update(norms("enc_final"))
        tree["dec_pos_embed"] = embed_init(g, (DEC_POSITIONS, cfg.d_model),
                                           pdt)
        return Transformer(cfg, tree)
    tree["layers"] = [block() for _ in range(cfg.n_layers)]
    if cfg.use_mtp:
        tree["mtp"] = {"proj": dense_init(g, (2 * cfg.d_model, cfg.d_model),
                                          pdt),
                       "block": block(), "ln_h": ones(cfg.d_model),
                       "ln_e": ones(cfg.d_model)}
    return Transformer(cfg, tree)


def layer_stacks(cfg: ModelConfig) -> Dict[str, int]:
    """Each stack of the JAX package's tree and its entries: ``{"layers":
    stacked_layers(cfg)}``, or in the audio family ``{"enc_layers":
    n_encoder_layers, "dec_layers": n_layers}``."""
    if cfg.family == "audio":
        return {"enc_layers": cfg.n_encoder_layers,
                "dec_layers": cfg.n_layers}
    return {"layers": stacked_layers(cfg)}


def stacked_layers(cfg: ModelConfig) -> int:
    """The entries of the stacked ``layers``: ``cfg.n_layers``, or in the
    SSM family its ``n_layers // 2`` sLSTM + mLSTM pairs."""
    if cfg.family == "ssm":
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: an xLSTM stack is of pairs; "
                             f"n_layers {cfg.n_layers} is odd")
        return cfg.n_layers // 2
    return cfg.n_layers


def _lm_head(params: Transformer, cfg: ModelConfig, x: torch.Tensor):
    x = _seq_whole(rms_norm(params.final_norm, x, cfg.norm_eps))
    if cfg.tie_embeddings:
        w = params.embed.to(x.dtype).T
    else:
        w = params.lm_head.to(x.dtype)
    return shard(x @ w, "batch", None, "vocab")


def _embed_tokens(params: Transformer, cfg: ModelConfig, tokens):
    return shard(params.embed[tokens.long()].to(cfg.dtype),
                 "batch", "seq", "embed")


def _positions(cfg: ModelConfig, B: int, S: int, device) -> torch.Tensor:
    """``arange(S)`` for each row, ``(B, S)``; with M-RoPE on all three
    streams, ``(B, S, 3)``."""
    pos = torch.arange(S, device=device)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        return pos[..., None].expand(B, S, 3)
    return pos


def _batch_positions(cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
                     B: int, S: int, device) -> torch.Tensor:
    """With M-RoPE ``batch["positions"]`` ``(B, S, 3)`` where given (the
    JAX package reads it only then), else :func:`_positions`."""
    given = batch.get("positions") if cfg.mrope_sections is not None \
        else None
    if given is None:
        return _positions(cfg, B, S, device)
    if tuple(given.shape) != (B, S, 3):
        raise ValueError(f"{cfg.name}: M-RoPE positions must be (B, S, 3) = "
                         f"{(B, S, 3)}, got {tuple(given.shape)}")
    return given.to(device)


def _splice_patches(cfg: ModelConfig, x: torch.Tensor,
                    batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The VLM's ``batch["patch_embeds"]`` ``(B, P, d)`` written over rows
    1 to P of the embedded prompt x ``(B, S, d)``, in x's dtype, as the
    reference's ``jax.lax.dynamic_update_slice(x, pe, (0, 1, 0))``: a start
    that would run past row S - 1 is clamped to ``S - P`` (an S-row ``pe``
    lands at row 0; ROADMAP C31).  More than S rows are refused (the
    reference fails on the shapes)."""
    pe = batch.get("patch_embeds") if cfg.family == "vlm" else None
    if pe is None:
        return x
    B, S, d = x.shape
    if pe.dim() != 3 or pe.shape[0] != B or pe.shape[2] != d:
        raise ValueError(f"{cfg.name}: patch_embeds must be (B, P, d) with "
                         f"B = {B}, d = {d}, got {tuple(pe.shape)}")
    P = pe.shape[1]
    if P > S:
        raise ValueError(f"{cfg.name}: {P} patch_embeds rows do not fit in "
                         f"a prompt of {S} tokens")
    start = min(1, S - P)
    return torch.cat([x[:, :start], pe.to(device=x.device, dtype=x.dtype),
                      x[:, start + P:]], dim=1)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    # the projections (x @ W, no batch dimension) are aten.mm; the
    # attention's batched products (bmm) and everything else is recomputed
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(block: nn.Module, cfg: ModelConfig):
    """``block`` as ``cfg.remat`` asks, where gradients are enabled."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none | full | dots, not "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, block, use_reentrant=False, **kw)


def _hybrid_block(layer: Mamba2, shared, x, positions, cfg: ModelConfig):
    if shared is not None:
        x = shared(x, positions, cfg)
    return shard(x + layer(x, cfg), "batch", "seq", "embed")


def _run_hybrid_stack(params: Transformer, cfg: ModelConfig, x, positions):
    """The Mamba2 layers, the shared block before every ``period``-th; each
    layer (with its shared block) one unit of ``cfg.remat``."""
    period = cfg.hybrid_shared_period
    block = _maybe_remat(_hybrid_block, cfg)
    for i, layer in enumerate(params.layers):
        shared = params.shared_attn if i % period == 0 else None
        x = block(layer, shared, x, positions, cfg)
    return x


def _run_ssm_stack(params: Transformer, cfg: ModelConfig, x):
    """The sLSTM + mLSTM pairs, each one unit of ``cfg.remat``."""
    for pair in params.layers:
        x = shard(_maybe_remat(pair, cfg)(x, cfg), "batch", "seq", "embed")
    return x


def _whisper_encode(params: Transformer, cfg: ModelConfig,
                    frames: torch.Tensor) -> torch.Tensor:
    """The encoder over ``frames`` (B, T, d) plus sinusoidal positions
    (both in ``cfg.dtype``), each block one unit of ``cfg.remat``, then the
    final LayerNorm."""
    B, T, d = frames.shape
    x = frames.to(cfg.dtype) + sinusoidal_on(T, d, cfg.dtype,
                                             frames.device)[None]
    for block in params.enc_layers:
        x = _maybe_remat(block, cfg)(x, cfg)
    return layer_norm(params.enc_final_s, params.enc_final_b, x)


def _whisper_decoder_input(params: Transformer, cfg: ModelConfig, tokens):
    """The token embeddings plus the learned positions ``dec_pos_embed[:S]``."""
    x = _embed_tokens(params, cfg, tokens)
    return x + params.dec_pos_embed[:tokens.shape[1]][None].to(x.dtype)


def forward(params: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logits (B, S, V), aux_loss)``: the sum of the MoE
    layers' load-balance losses (0 in the other families).  The audio
    family reads ``batch["frames"]`` (B, T, d) too, the VLM
    ``batch["patch_embeds"]`` and ``batch["positions"]`` (the module's
    docstring)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cfg.family == "audio":
        enc = _whisper_encode(params, cfg, batch["frames"])
        x = _whisper_decoder_input(params, cfg, tokens)
        for block in params.dec_layers:
            x = _maybe_remat(block, cfg)(x, cfg, enc)
        return _lm_head(params, cfg, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    x = _splice_patches(cfg, _embed_tokens(params, cfg, tokens), batch)
    positions = _batch_positions(cfg, batch, B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        return _lm_head(params, cfg, _run_hybrid_stack(params, cfg, x,
                                                       positions)), aux
    if cfg.family == "ssm":
        return _lm_head(params, cfg, _run_ssm_stack(params, cfg, x)), aux
    for block in params.layers:
        x, a = _maybe_remat(block, cfg)(x, positions, cfg)
        if a is not None:
            aux = aux + a
    return _lm_head(params, cfg, x), aux


def prefill_step(params: Transformer, cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor]):
    """Forward pass that also returns the decode cache built from the
    prompt: ``(logits (B, S, V), {"k", "v"})``, each ``(L, B, S, K, hd)``,
    or with MLA ``{"ckv", "krope"}``, ``(L, B, S, kv_lora_rank)`` and
    ``(L, B, S, qk_rope_head_dim)`` (the serving engine pads it to its max
    length).  The hybrid, SSM and audio families' caches are described in
    the module's docstring; the hybrid's rings hold the last ``min(S,
    sliding_window)`` rows of each application of the shared block, the
    SSM's state is each pair's after the prompt, the audio's cross K/V the
    ``T`` rows of the encoder's output over ``batch["frames"]`` (B, T,
    d).  The VLM reads its batch as ``forward`` does."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cfg.family == "audio":
        return _whisper_prefill(params, cfg, tokens, batch["frames"])
    x = _splice_patches(cfg, _embed_tokens(params, cfg, tokens), batch)
    positions = _batch_positions(cfg, batch, B, S, x.device)
    if cfg.family == "hybrid":
        return _hybrid_prefill(params, cfg, x, positions)
    if cfg.family == "ssm":
        return _ssm_prefill(params, cfg, x)
    ks, vs = [], []
    for block in params.layers:
        x, _, (k, v) = block(x, positions, cfg, return_kv=True)
        ks.append(k)
        vs.append(v)
    k1, k2 = cache_keys(cfg)
    cache = {k1: torch.stack(ks), k2: torch.stack(vs)}
    return _lm_head(params, cfg, x), cache


def _whisper_prefill(params: Transformer, cfg: ModelConfig, tokens, frames):
    enc = _whisper_encode(params, cfg, frames)
    x = _whisper_decoder_input(params, cfg, tokens)
    rows = []
    for block in params.dec_layers:
        x, kv = block(x, cfg, enc, return_kv=True)
        rows.append(kv)
    return _lm_head(params, cfg, x), {key: torch.stack(r) for key, r in
                                      zip(AUDIO_CACHE, zip(*rows))}


def _hybrid_prefill(params: Transformer, cfg: ModelConfig, x, positions):
    S = x.shape[1]
    W = cache_rows(cfg, S)
    period = cfg.hybrid_shared_period
    cache = {"ssm_h": [], "ssm_conv": [], "attn_k": [], "attn_v": []}
    for i, layer in enumerate(params.layers):
        if i % period == 0:
            x, (k, v) = params.shared_attn(x, positions, cfg, return_kv=True)
            cache["attn_k"].append(k[:, -W:])
            cache["attn_v"].append(v[:, -W:])
        m, state = layer(x, cfg, return_state=True)
        x = shard(x + m, "batch", "seq", "embed")
        cache["ssm_h"].append(state["h"])
        cache["ssm_conv"].append(state["conv"])
    return _lm_head(params, cfg, x), {key: torch.stack(rows)
                                      for key, rows in cache.items()}


#: the SSM cache's entries: each pair's sLSTM and mLSTM state
XLSTM_STATE = ("s_c", "s_n", "s_h", "s_m", "m_c", "m_n", "m_m")
#: per family, the cache's state entries: they have no sequence axis, a
#: prefill hands them over whole and a decode step overwrites them whole
STATE_ENTRIES = {"hybrid": ("ssm_h", "ssm_conv"), "ssm": XLSTM_STATE}
#: the hybrid cache's rings, which a decode step rolls once full
RINGS = ("attn_k", "attn_v")
#: the audio cache's entries: the decoder's self K/V, the encoder's K/V
AUDIO_CACHE = ("k", "v", "cross_k", "cross_v")
#: the entries a decode step reads and never writes (rows under enc_len)
CROSS = ("cross_k", "cross_v")


def state_entries(cfg: ModelConfig) -> Tuple[str, ...]:
    """The decode cache's state entries in ``cfg``'s family (none in the
    dense and MoE families): spliced whole, not along a sequence axis."""
    return STATE_ENTRIES.get(cfg.family, ())


def cache_rows(cfg: ModelConfig, n: int) -> int:
    """The rows along the decode cache's sequence axis that ``n`` tokens
    take: ``n``; in the hybrid family, whose rings keep the last
    ``sliding_window`` rows, ``min(n, sliding_window)``; in the SSM family,
    whose state has no sequence axis, 0.  So a cache of ``max_len`` holds
    ``cache_rows(cfg, max_len)`` rows (the ring's ``W``)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid" and cfg.sliding_window:
        return min(n, cfg.sliding_window)
    return n


def _ssm_prefill(params: Transformer, cfg: ModelConfig, x):
    states = []
    for pair in params.layers:
        s, sfin = pair.slstm(x, cfg, return_state=True)
        x = x + s
        m, mfin = pair.mlstm(x, cfg, return_state=True)
        x = shard(x + m, "batch", "seq", "embed")
        states.append((sfin["c"], sfin["n"], sfin["h"], sfin["m"],
                       mfin["c"], mfin["n"], mfin["m"]))
    return _lm_head(params, cfg, x), {
        key: torch.stack(rows) for key, rows in zip(XLSTM_STATE,
                                                    zip(*states))}


def cache_keys(cfg: ModelConfig) -> Tuple[str, str]:
    """The decode cache's two entries: ``("ckv", "krope")`` with MLA, else
    ``("k", "v")``."""
    return ("ckv", "krope") if cfg.use_mla else ("k", "v")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """An all-zero ``{"k", "v"}`` cache, each ``(L, batch, max_len, K,
    hd)``, or with MLA the latent ``{"ckv", "krope"}``, ``(L, batch,
    max_len, kv_lora_rank)`` and ``(L, batch, max_len,
    qk_rope_head_dim)``, in ``cfg.dtype`` (``device=None`` means
    ``"cuda"``); in the hybrid family the SSM state and the rings of the
    module's docstring, in the SSM family the pairs' f32 state (the
    stabilisers at -1e30), whatever ``max_len``; in the audio family also
    ``{"cross_k", "cross_v"}`` of ``enc_len`` rows (0: 1,500, whisper's
    frames, as the JAX package's default)."""
    check_supported(cfg)
    if cfg.family == "audio":
        dev = resolve_device(device)
        shapes = ((cfg.n_layers, batch, n, cfg.n_kv_heads, cfg.hd)
                  for n in (max_len, max_len, enc_len or 1500,
                            enc_len or 1500))
        return {key: torch.zeros(shape, dtype=cfg.dtype, device=dev)
                for key, shape in zip(AUDIO_CACHE, shapes)}
    if cfg.family == "hybrid":
        return _hybrid_cache(cfg, batch, max_len, resolve_device(device))
    if cfg.family == "ssm":
        return _ssm_cache(cfg, batch, resolve_device(device))
    lead = (cfg.n_layers, batch, max_len)
    if cfg.use_mla:
        shapes = (lead + (cfg.kv_lora_rank,), lead + (cfg.qk_rope_head_dim,))
    else:
        shapes = (lead + (cfg.n_kv_heads, cfg.hd),) * 2
    dev = resolve_device(device)
    return {key: torch.zeros(shape, dtype=cfg.dtype, device=dev)
            for key, shape in zip(cache_keys(cfg), shapes)}


def cache_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical sharding for each cache entry (``None``: a whole dimension),
    the JAX package's; the SSM family's ``s_m``, an ``(np, B, H, hd)``
    array here and there, takes four names (the JAX package gives three:
    ROADMAP C28)."""
    seq = "seq" if cfg.seq_shard_attn else None
    kvh = None if cfg.seq_shard_attn else "kv_heads"
    fam = cfg.family
    if fam in ("dense", "vlm") or (fam == "moe" and not cfg.use_mla):
        return {"k": (None, "batch", seq, kvh, None),
                "v": (None, "batch", seq, kvh, None)}
    if fam == "moe":
        return {"ckv": (None, "batch", seq, None),
                "krope": (None, "batch", seq, None)}
    if fam == "hybrid":
        return {"ssm_h": (None, "batch", "heads", None, None),
                "ssm_conv": (None, "batch", None, None),
                "attn_k": (None, "batch", seq, kvh, None),
                "attn_v": (None, "batch", seq, kvh, None)}
    if fam == "ssm":
        return {"s_c": (None, "batch", None, None),
                "s_n": (None, "batch", None, None),
                "s_h": (None, "batch", None, None),
                "s_m": (None, "batch", None, None),
                "m_c": (None, "batch", "heads", None, None),
                "m_n": (None, "batch", "heads", None),
                "m_m": (None, "batch", None)}
    if fam == "audio":
        return {"k": (None, "batch", seq, kvh, None),
                "v": (None, "batch", seq, kvh, None),
                "cross_k": (None, "batch", None, kvh, None),
                "cross_v": (None, "batch", None, kvh, None)}
    raise ValueError(fam)

def _hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, dev):
    npts = -(-cfg.n_layers // cfg.hybrid_shared_period)
    W = cache_rows(cfg, max_len)
    state = mamba2_init_state(cfg, batch, cfg.dtype, device=dev)
    ring = (npts, batch, W, cfg.n_kv_heads, cfg.hd)
    return {
        "ssm_h": state["h"].expand(cfg.n_layers, *state["h"].shape).clone(),
        "ssm_conv": state["conv"].expand(cfg.n_layers,
                                         *state["conv"].shape).clone(),
        "attn_k": torch.zeros(ring, dtype=cfg.dtype, device=dev),
        "attn_v": torch.zeros(ring, dtype=cfg.dtype, device=dev),
    }


def _ssm_cache(cfg: ModelConfig, batch: int, dev):
    s0 = slstm_init_state(cfg, batch, device=dev)
    m0 = mlstm_init_state(cfg, batch, device=dev)
    n = stacked_layers(cfg)
    state = {"s_" + k: s0[k] for k in ("c", "n", "h", "m")}
    state.update({"m_" + k: m0[k] for k in ("c", "n", "m")})
    return {key: state[key].expand(n, *state[key].shape).clone()
            for key in XLSTM_STATE}


def _roll_full(ring: torch.Tensor, full: Union[bool, torch.Tensor]) -> None:
    """Once ``full``, shift the ``(B, W, K, hd)`` ring left by one row in
    place (the reference's ``roll(-1)``: row 0 goes to row W - 1, which the
    step then writes).  The rows are gathered by ``(t + full) mod W``, so a
    0-d tensor ``full`` stays on the device (the identity while the ring
    fills)."""
    if full is False:
        return
    idx = (torch.arange(ring.shape[1], device=ring.device) + full) \
        % ring.shape[1]
    ring.copy_(ring.index_select(1, idx))


def _hybrid_decode(params: Transformer, cfg: ModelConfig, cache, x, pos,
                   cache_len: Union[int, torch.Tensor]):
    W = cache["attn_k"].shape[2]
    if isinstance(cache_len, torch.Tensor):
        wpos = cache_len.clamp(max=W - 1)
    else:
        wpos = min(cache_len, W - 1)
    full = cache_len >= W
    period = cfg.hybrid_shared_period
    for i, layer in enumerate(params.layers):
        if i % period == 0:
            kc = cache["attn_k"][i // period]
            vc = cache["attn_v"][i // period]
            _roll_full(kc, full)
            _roll_full(vc, full)
            x = params.shared_attn.decode(x, pos, kc, vc, wpos, cfg)
        m, state = layer.decode(x, {"h": cache["ssm_h"][i],
                                    "conv": cache["ssm_conv"][i]}, cfg)
        cache["ssm_h"][i].copy_(state["h"])
        cache["ssm_conv"][i].copy_(state["conv"])
        x = x + m
    return x


def _ssm_decode(params: Transformer, cfg: ModelConfig, cache, x):
    for i, pair in enumerate(params.layers):
        s, st = pair.slstm.decode(x, {k: cache["s_" + k][i]
                                      for k in ("c", "n", "h", "m")}, cfg)
        x = x + s
        m, mt = pair.mlstm.decode(x, {k: cache["m_" + k][i]
                                      for k in ("c", "n", "m")}, cfg)
        x = x + m
        for prefix, state in (("s_", st), ("m_", mt)):
            for k, new in state.items():
                cache[prefix + k][i].copy_(new)
    return x


def _learned_position(params: Transformer,
                      cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """Row ``cache_len`` of ``dec_pos_embed``, ``(1, d)``, read on the
    device for a tensor ``cache_len``; past the last row, the last (the
    JAX gather clamps)."""
    last = params.dec_pos_embed.shape[0] - 1
    if isinstance(cache_len, torch.Tensor):
        row = cache_len.reshape(1).long().clamp(max=last)
    else:
        row = torch.full((1,), min(cache_len, last), dtype=torch.int64,
                         device=params.dec_pos_embed.device)
    return params.dec_pos_embed.index_select(0, row)


def _whisper_decode(params: Transformer, cfg: ModelConfig, cache, x, pos,
                    cache_len: Union[int, torch.Tensor],
                    enc_len: Union[None, int, torch.Tensor]):
    x = x + _learned_position(params, cache_len)[None].to(x.dtype)
    enc_last = (cache["cross_k"].shape[2] if enc_len is None
                else enc_len) - 1
    for l, block in enumerate(params.dec_layers):
        x = block.decode(x, pos, cache["k"][l], cache["v"][l],
                         cache["cross_k"][l], cache["cross_v"][l], cache_len,
                         enc_last, cfg)
    return x


def decode_step(params: Transformer, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                cache_len: Union[int, torch.Tensor],
                enc_len: Union[None, int, torch.Tensor] = None):
    """One-token decode.  tokens: (B, 1) -> ``(logits (B, 1, V), cache)``;
    the new K/V (MLA: latent) rows are written into ``cache`` at
    ``cache_len`` in place (hybrid: the SSM state overwritten and the rings
    written as the module's docstring says; SSM: the pairs' state
    overwritten, ``cache_len`` unused; audio: the self K/V written, the
    cross K/V read at rows under ``enc_len``, all of them for ``None`` as
    in the JAX package, where the engine's cache holds fewer).
    ``cache_len`` and ``enc_len`` are ints or 0-d integer tensors (the JAX
    package's traced ``jnp.int32``); a tensor is never read by the host, so
    the step captures as one CUDA graph (the serving engine's decode
    program)."""
    B = tokens.shape[0]
    x = _embed_tokens(params, cfg, tokens)
    if isinstance(cache_len, torch.Tensor):
        pos = cache_len.reshape(1).expand(B)
    else:
        pos = torch.full((B,), cache_len, dtype=torch.int32, device=x.device)
    if cfg.family == "audio":
        x = _whisper_decode(params, cfg, cache, x, pos, cache_len, enc_len)
        return _lm_head(params, cfg, x), cache
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, cache, x, pos, cache_len)
        return _lm_head(params, cfg, x), cache
    if cfg.family == "ssm":
        return _lm_head(params, cfg, _ssm_decode(params, cfg, cache, x)), \
            cache
    k1, k2 = cache_keys(cfg)
    for l, block in enumerate(params.layers):
        x = block.decode(x, pos, cache[k1][l], cache[k2][l], cache_len, cfg)
    return _lm_head(params, cfg, x), cache


def _xent(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    # the gather along a vocab-sharded dimension (aten.gather's
    # MaskPartial strategy) fails on a 2-D mesh: the vocab is made whole
    lf = shard(logits.float(), "batch", None, None)
    lse = torch.logsumexp(lf, dim=-1)
    # the gold logit as a masked sum, the value of gather's: on a mesh
    # gather's backward would build its zeros as a plain tensor of the
    # global (B, S, V) shape on every rank; where's backward keeps the
    # gradient's placements
    vocab = torch.arange(lf.shape[-1], device=lf.device)
    gold = torch.where(labels.long()[..., None] == vocab, lf, 0.0).sum(-1)
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(params: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]):
    """Next-token cross-entropy: ``(loss, {"ce_loss", "aux_loss",
    "loss"})``, 0-d f32 tensors (audio: over ``forward`` of the tokens
    and ``batch["frames"]``).  Without ``labels`` in ``batch`` the
    labels are the tokens shifted by one and the last position is masked
    out; with them, ``loss_mask`` (if any) weighs the positions.  With
    ``cfg.use_mtp`` and an ``mtp`` block, ``cfg.mtp_loss_weight`` times
    the multi-token-prediction loss (``"mtp_loss"``) is added."""
    logits, aux = forward(params, cfg, batch)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
        ones = torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                          device=tokens.device)
        mask = torch.cat([ones, torch.zeros_like(ones[:, :1])], dim=1)
    else:
        mask = batch.get("loss_mask")
    loss = _xent(logits, labels, mask)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    if cfg.use_mtp and params.mtp is not None:
        mtp_loss = _mtp_loss(params, cfg, tokens)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + cfg.mtp_loss_weight * mtp_loss
    total = loss + aux
    metrics["loss"] = total
    return total, metrics


def _mtp_loss(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor):
    """DeepSeek-V3 MTP (depth 1), as the JAX package runs it: token t + 2
    predicted from the embeddings of t and t + 1 (the JAX package's proxy
    for the trunk's hidden state) through ``proj`` and one block; the last
    two positions masked out."""
    mtp = params.mtp
    B, S = tokens.shape
    h = _embed_tokens(params, cfg, tokens)
    e_next = _embed_tokens(params, cfg, torch.roll(tokens, -1, dims=1))
    hcat = torch.cat([rms_norm(mtp.ln_h, h, cfg.norm_eps),
                      rms_norm(mtp.ln_e, e_next, cfg.norm_eps)], dim=-1)
    x = _seq_whole(hcat) @ mtp.proj.to(h.dtype)
    x, _ = mtp.block(x, _positions(cfg, B, S, x.device), cfg)
    logits = _lm_head(params, cfg, x)
    labels = torch.roll(tokens, -2, dims=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -2:] = 0.0
    return _xent(logits, labels, mask)
