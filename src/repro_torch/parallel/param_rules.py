"""Parameter partitioning rules (path + shape -> PartitionSpec; PyTorch
port of ``repro.parallel.param_rules``).

Logical placement follows MaxText-style 2-D sharding: every weight is
sharded on the TP axis ("model") along its parallel dim (heads / ff /
experts / vocab) and on the FSDP axis ("data") along the other dim; the
"pod" axis (multi-pod mesh) carries pure data parallelism, so parameters
are *replicated* across pods and gradients reduce over ("pod","data").

Axes that do not divide the dimension are dropped (e.g. whisper's vocab
51865 on a 16-way axis).

Paths are the JAX package's tree paths (``/layers/attn/wq``).  The port's
per-layer parameters (``layers.3.attn.p.wq``) have no leading layer axis:
:func:`module_param_specs` gives each the spec of its JAX stacked leaf
without that axis.
"""
from __future__ import annotations

from typing import Dict, Tuple

from torch import nn

from .sharding import LogicalMesh, PartitionSpec

# trailing-dims logical layout per parameter name (last path segment)
_TRAILING: dict = {
    # name: tuple of logical names for the trailing dims
    "embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "pos_embed": (None, "fsdp"),
    # up-style projections (d -> parallel)
    "wq": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"),
    "wv": ("fsdp", "tensor"), "wi": ("fsdp", "tensor"),
    "wg": ("fsdp", "tensor"), "w_up": ("fsdp", "tensor"),
    "w_x": ("fsdp", None), "w_in": ("fsdp", None),
    "wdq": ("fsdp", "tensor"), "wuq": ("fsdp", "tensor"),
    "wdkv": ("fsdp", None), "wuk": ("fsdp", "tensor"),
    "wuv": ("fsdp", "tensor"),
    "shared_wi": ("fsdp", "tensor"), "shared_wg": ("fsdp", "tensor"),
    "w_if": ("fsdp", None),
    "mtp_proj": ("fsdp", "tensor"),
    # down-style projections (parallel -> d)
    "wo": ("tensor", "fsdp"), "w_down": ("tensor", "fsdp"),
    "w_out": ("tensor", "fsdp"), "shared_wo": ("tensor", "fsdp"),
    # router
    "router": ("fsdp", None), "router_bias": (None,),
    # everything else (norms, biases, convs, gates): replicated
}

# MoE expert tensors (path contains "/moe"): trailing 3 dims
_MOE_TRAILING = {
    "wi": ("experts", "fsdp", None),
    "wg": ("experts", "fsdp", None),
    "wo": ("experts", None, "fsdp"),
}


def spec_for_param(path: str, shape: Tuple[int, ...],
                   lm: LogicalMesh) -> PartitionSpec:
    name = path.split("/")[-1]
    if "moe" in path and name in _MOE_TRAILING:
        logical = _MOE_TRAILING[name]
    else:
        logical = _TRAILING.get(name, ())

    ndim = len(shape)
    spec: list = [None] * ndim
    # align logical names to the trailing dims (leading dims: layer stack)
    off = ndim - len(logical)
    for i, lname in enumerate(logical):
        if lname is None or off + i < 0:
            continue
        dim = shape[off + i]
        axes = lm.axes_for(lname)
        if axes is None:
            continue
        n = lm.size(lname)
        if dim % max(n, 1) == 0 and dim >= n:
            spec[off + i] = axes
    return PartitionSpec(*spec)


def tree_param_specs(params, lm: LogicalMesh, prefix: str = ""):
    """Map a param tree (nested dicts, leaves with a ``shape``) to a
    matching tree of specs."""
    if isinstance(params, dict):
        return {k: tree_param_specs(v, lm, f"{prefix}/{k}")
                for k, v in params.items()}
    return spec_for_param(prefix, tuple(params.shape), lm)


def module_param_specs(model: nn.Module,
                       lm: LogicalMesh) -> Dict[str, PartitionSpec]:
    """The spec of each of ``model``'s parameters (a
    :class:`~repro_torch.models.Transformer`), keyed by its name: the spec
    of the JAX package's leaf at its tree path, a per-layer parameter's
    that of the stacked leaf less the leading layer axis."""
    from repro_torch.models.transformer import layer_stacks, param_path
    stacks = layer_stacks(model.cfg)
    out = {}
    for name, p in model.named_parameters():
        path, layer = param_path(name)
        jpath = "/" + "/".join(path)
        if layer < 0:
            out[name] = spec_for_param(jpath, tuple(p.shape), lm)
        else:
            spec = spec_for_param(jpath, (stacks[path[0]],) + tuple(p.shape),
                                  lm)
            out[name] = PartitionSpec(*spec[1:])
    return out
