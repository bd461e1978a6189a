"""The decoder LM, dense and MoE families (PyTorch port of
``repro.models.transformer``).

A :class:`Transformer` module of :class:`DecoderBlock` modules, each with an
:class:`Attention` and a :class:`DenseFFN` submodule (``mlp``), or with
``cfg.moe_experts`` a :class:`~repro_torch.models.moe.MoEFFN` (``moe``).
Weights keep the JAX package's layout (``x @ W``), so a JAX parameter tree
carries across as a copy (:func:`repro_torch.convert.lm_params_from_numpy`).
The entry points keep the JAX package's functional signatures, with the
module as ``params``:

* ``init_params(cfg, generator)``                        a :class:`Transformer`
* ``forward(params, cfg, batch)``                        ``(logits (B,S,V), aux)``
* ``prefill_step(params, cfg, batch)``                   ``(logits, cache)``
* ``loss_fn(params, cfg, batch)``                        ``(loss, metrics)``
* ``init_cache(cfg, batch, max_len, device=)``           ``{"k", "v"}``
* ``decode_step(params, cfg, cache, tokens, cache_len)`` ``(logits (B,1,V), cache)``

The cache is ``{"k", "v"}``, each ``(L, B, T, K, hd)``, in both families;
a decode step writes the new token's K/V into it in place.  Layers run in a
Python loop (the JAX package's ``lax.scan``); its sharding constraints have
no counterpart on one device.  ``forward`` sums the MoE layers' load-balance
losses into its ``aux``; the prefill and decode steps drop them.  The MLA,
hybrid, SSM, audio and VLM families raise ``NotImplementedError`` and name
the slice of the port that brings them.

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

from .attention import (decode_attention, init_attention_params,
                        multihead_attention)
from .common import ModelConfig, dense_init, embed_init, rms_norm
from .moe import MoEFFN, dense_ffn, dense_ffn_init, init_moe_params

#: the families the port runs
FAMILIES = ("dense", "moe")
#: the slice of the port that brings each family the port does not run yet
LATER_SLICES = {
    "mla": "the MLA slice",
    "hybrid": "the hybrid (Mamba2 + shared attention) slice",
    "ssm": "the SSM (xLSTM) slice", "audio": "the audio (whisper) slice",
    "vlm": "the VLM (M-RoPE) slice",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what only later slices run."""
    if cfg.family not in FAMILIES:
        later = LATER_SLICES.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family waits for {later} of "
            "the PyTorch port; only the dense and MoE families run so far")
    for flag, key in ((cfg.use_mla, "mla"),
                      (cfg.mrope_sections is not None, "vlm"),
                      (cfg.is_encoder_decoder, "audio")):
        if flag:
            raise NotImplementedError(
                f"{cfg.name}: {key} layers wait for {LATER_SLICES[key]} of "
                "the PyTorch port")


def param_path(name: str) -> Tuple[Tuple[str, ...], int]:
    """The JAX package's tree path of the port's parameter ``name`` and its
    layer (-1 outside the stacked ``layers``): ``"layers.3.attn.p.wq"`` is
    ``(("layers", "attn", "wq"), 3)``.  Names sorted by it are in the JAX
    package's leaf order (sorted keys, a stacked leaf's layers in turn)."""
    parts = [p for p in name.split(".") if p != "p"]
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
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

    def decode(self, x, position, k_cache, v_cache, cache_len: int,
               cfg: ModelConfig):
        return decode_attention(self.p, x, position, k_cache, v_cache,
                                cache_len, cfg)


class DenseFFN(nn.Module):
    """The SwiGLU MLP of one block; ``p`` holds ``wi, wg, wo``."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.p = _parameter_dict(params)

    def forward(self, x):
        return dense_ffn(self.p, x)


class DecoderBlock(nn.Module):
    """Pre-norm block: ``x + attn(ln1(x))``, then ``+ ffn(ln2(.))``, the
    ffn a dense ``mlp`` or a ``moe``.  ``forward`` returns ``(x, aux)``
    (``(x, aux, kv)`` with ``return_kv``), aux the MoE's load-balance loss
    or ``None`` for a dense block."""

    def __init__(self, params: Mapping):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"])
        self.ln2 = nn.Parameter(params["ln2"])
        self.attn = Attention(params["attn"])
        if "moe" in params:
            self.moe = MoEFFN(params["moe"])
        else:
            self.mlp = DenseFFN(params["mlp"])

    def ffn(self, x, cfg: ModelConfig):
        """``(y, aux)`` of the block's feed-forward on ``ln2(x)``."""
        h = rms_norm(self.ln2, x, cfg.norm_eps)
        if hasattr(self, "moe"):
            return self.moe(h, cfg)
        return self.mlp(h), None

    def forward(self, x, positions, cfg: ModelConfig,
                return_kv: bool = False):
        hn = rms_norm(self.ln1, x, cfg.norm_eps)
        a = self.attn(hn, positions, cfg, causal=True, return_kv=return_kv)
        a, kv = a if return_kv else (a, None)
        x = x + a
        f, aux = self.ffn(x, cfg)
        return (x + f, aux, kv) if return_kv else (x + f, aux)

    def decode(self, x, position, k_cache, v_cache, cache_len: int,
               cfg: ModelConfig):
        a, _, _ = self.attn.decode(rms_norm(self.ln1, x, cfg.norm_eps),
                                   position, k_cache, v_cache, cache_len, cfg)
        x = x + a
        return x + self.ffn(x, cfg)[0]


class Transformer(nn.Module):
    """The decoder LM.  ``params`` is the JAX package's tree with the
    stacked ``layers`` given as a list of per-layer trees: ``embed (V,
    d)``, ``final_norm (d,)``, ``lm_head (d, V)`` (absent with
    ``tie_embeddings``), and per layer ``ln1``, ``ln2``, ``attn`` and
    ``mlp`` (``moe`` with ``cfg.moe_experts``)."""

    def __init__(self, cfg: ModelConfig, params: Mapping):
        super().__init__()
        check_supported(cfg)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(params['layers'])} layers "
                             f"given, the config has {cfg.n_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = None if cfg.tie_embeddings \
            else nn.Parameter(params["lm_head"])
        self.layers = nn.ModuleList(DecoderBlock(lp)
                                    for lp in params["layers"])

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
    tree["layers"] = []
    for _ in range(cfg.n_layers):
        layer = {"ln1": ones(cfg.d_model), "ln2": ones(cfg.d_model),
                 "attn": init_attention_params(g, cfg)}
        if cfg.moe_experts:
            layer["moe"] = init_moe_params(g, cfg)
        else:
            layer["mlp"] = dense_ffn_init(g, cfg)
        tree["layers"].append(layer)
    return Transformer(cfg, tree)


def _lm_head(params: Transformer, cfg: ModelConfig, x: torch.Tensor):
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params.embed.to(x.dtype).T
    else:
        w = params.lm_head.to(x.dtype)
    return x @ w


def _embed_tokens(params: Transformer, cfg: ModelConfig, tokens):
    return params.embed[tokens.long()].to(cfg.dtype)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


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


def forward(params: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logits (B, S, V), aux_loss)``: the sum of the MoE
    layers' load-balance losses (0 in the dense family)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params.layers:
        x, a = _maybe_remat(block, cfg)(x, positions, cfg)
        if a is not None:
            aux = aux + a
    return _lm_head(params, cfg, x), aux


def prefill_step(params: Transformer, cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor]):
    """Forward pass that also returns the decode cache built from the
    prompt: ``(logits (B, S, V), {"k", "v"})``, each ``(L, B, S, K, hd)``
    (the serving engine pads it to its max length)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    ks, vs = [], []
    for block in params.layers:
        x, _, (k, v) = block(x, positions, cfg, return_kv=True)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return _lm_head(params, cfg, x), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    """An all-zero ``{"k", "v"}`` cache, each ``(L, batch, max_len, K,
    hd)`` in ``cfg.dtype`` (``device=None`` means ``"cuda"``)."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def decode_step(params: Transformer, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                cache_len: Union[int, torch.Tensor]):
    """One-token decode.  tokens: (B, 1) -> ``(logits (B, 1, V), cache)``;
    the new K/V are written into ``cache`` at ``cache_len`` in place."""
    cache_len = int(cache_len)
    B = tokens.shape[0]
    x = _embed_tokens(params, cfg, tokens)
    pos = torch.full((B,), cache_len, dtype=torch.int32, device=x.device)
    for l, block in enumerate(params.layers):
        x = block.decode(x, pos, cache["k"][l], cache["v"][l], cache_len,
                         cfg)
    return _lm_head(params, cfg, x), cache


def _xent(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(params: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]):
    """Next-token cross-entropy: ``(loss, {"ce_loss", "aux_loss",
    "loss"})``, 0-d f32 tensors.  Without ``labels`` in ``batch`` the
    labels are the tokens shifted by one and the last position is masked
    out; with them, ``loss_mask`` (if any) weighs the positions."""
    if cfg.use_mtp:
        raise NotImplementedError(
            f"{cfg.name}: the multi-token-prediction loss waits for "
            f"{LATER_SLICES['mla']} of the PyTorch port")
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
    total = loss + aux
    return total, {"ce_loss": loss, "aux_loss": aux, "loss": total}
