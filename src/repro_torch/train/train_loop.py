"""Training loop: fault-tolerant, restartable, on one device or on a
device mesh (PyTorch port of ``repro.train.train_loop``).

One step function fuses: loss and grad -> pipelined grad-norm clip (stale
norm, off the critical path) -> in-graph bad-step gate (a non-finite or
spiking step leaves parameters, optimizer and clip state untouched,
selected with ``torch.where`` on the device) -> AdamW.  The loop around
it owns checkpoints (atomic, async, the JAX package's format),
restart-on-failure, straggler timing and the stateless data pipeline
(step index = iterator state).  It reads the device once a step: the
loss, the grad norm and the accepted flag, as one copy.

The model is a :class:`~repro_torch.models.Transformer`; its parameters
are updated in place.  Optimizer moments are keyed by parameter name
(:mod:`repro_torch.optim.adamw`); a checkpoint holds ``{"params", "opt":
{"m", "v", "count"}, "clip"}`` in the JAX package's tree layout
(:func:`state_tree`), so either package resumes from the other's.

On a mesh (``lm``, a :class:`~repro_torch.parallel.LogicalMesh`) every
parameter is a DTensor placed by
:func:`~repro_torch.parallel.module_param_specs` and every moment is
placed like its parameter (:func:`place_model`, :func:`place_opt_state`);
the step runs under :func:`~repro_torch.parallel.sharding.mesh_context`,
where the models' logical constraints redistribute the activations and
plain tensors made inside it (the batch, masks, positions) take part as
replicated DTensors.  The
gradients are redistributed to their parameters' placements, the clip's
global norm is one all-reduce across the mesh, and the scalars (loss,
norm, gate, step count, clip state) are plain tensors, the same on every
rank.  A checkpoint on a mesh is gathered whole and written by the mesh's
first rank, in the same format; a restore places it under the restoring
job's mesh, or none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.types import resolve_device
from repro_torch.data import DataConfig, make_dataset
from repro_torch.models import ModelConfig, Transformer, init_params, loss_fn
from repro_torch.models.attention import NO_FLASH_DERIVATIVE
from repro_torch.models.transformer import (check_supported,
                                            params_from_tree, params_tree)
from repro_torch.optim import (AdamWConfig, PipelinedClipState, adamw_init,
                               adamw_update, pipelined_clip,
                               pipelined_clip_init)
from repro_torch.optim.eightbit import Q8
from repro_torch.parallel import (LogicalMesh, PartitionSpec,
                                  module_param_specs)
from repro_torch.parallel.sharding import mesh_context, mesh_group

from .checkpoint import CheckpointManager
from .fault_tolerance import BadStepFilter, FailureInjector, StepTimer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    max_grad_norm: float = 1.0
    spike_factor: float = 50.0
    seed: int = 0
    resume: bool = True
    opt: AdamWConfig = AdamWConfig()


def _select(ok: torch.Tensor, new, old):
    """``new`` where ``ok``, else ``old``, leaf by leaf."""
    if isinstance(new, Mapping):
        return {k: _select(ok, new[k], old[k]) for k in new}
    if isinstance(new, tuple):                 # Q8, PipelinedClipState
        return type(new)(*(_select(ok, a, b) for a, b in zip(new, old)))
    return torch.where(ok, new, old)


def _check_mesh(lm) -> None:
    if lm is not None and not isinstance(lm, LogicalMesh):
        raise TypeError("lm must be a repro_torch.parallel.LogicalMesh (or "
                        f"None for one device), not {type(lm).__name__}")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor (the same on every rank);
    a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed_like(new, old):
    """``new``, a DTensor or a tree of them, redistributed to ``old``'s
    placements (so a step leaves the state's layout as it found it)."""
    if isinstance(new, Mapping):
        return {k: _placed_like(new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return type(new)(*(_placed_like(a, b) for a, b in zip(new, old)))
    if isinstance(old, DTensor):
        if tuple(new.placements) != tuple(old.placements):
            new = new.redistribute(old.device_mesh, old.placements)
        return new
    return _whole(new)


def place_model(model: Transformer, lm: LogicalMesh
                ) -> Dict[str, PartitionSpec]:
    """Replace every parameter of ``model`` by a DTensor on ``lm``'s mesh,
    placed by :func:`~repro_torch.parallel.module_param_specs` (each rank's
    values are rank 0's); returns the specs."""
    specs = module_param_specs(model, lm)
    names = {id(p): k for k, p in model.named_parameters()}
    with torch.no_grad():
        for mod in model.modules():
            # one parameter held at a time: a sharded placement copies its
            # tensor, so the old one must go before the next is placed (a
            # module of three 7 GiB expert stacks would otherwise hold all
            # three twice)
            for key in list(mod._parameters):
                p = mod._parameters[key]
                if p is None or isinstance(p, DTensor):
                    continue
                placements = lm.placements(specs[names[id(p)]])
                mod._parameters[key] = torch.nn.Parameter(
                    distribute_tensor(p.detach(), lm.mesh, placements),
                    requires_grad=p.requires_grad)
                del p
    return specs


def _place_moment(s, spec: PartitionSpec, lm: LogicalMesh):
    if isinstance(s, Q8):
        # the codes follow the parameter; the scales (one per block of the
        # last dim) its leading dims, the last whole
        lead = tuple(spec)[:-1] if len(spec) else ()
        return Q8(_place_moment(s.codes, spec, lm),
                  _place_moment(s.scales, PartitionSpec(*lead, None), lm))
    return distribute_tensor(s, lm.mesh, lm.placements(spec))


def place_opt_state(opt_state: Mapping, specs: Mapping[str, PartitionSpec],
                    lm: LogicalMesh) -> Dict:
    """The AdamW moments placed like their parameters (``specs``, as
    :func:`place_model` returns them); the step count stays plain."""
    return {"m": {k: _place_moment(s, specs[k], lm)
                  for k, s in opt_state["m"].items()},
            "v": {k: _place_moment(s, specs[k], lm)
                  for k, s in opt_state["v"].items()},
            "count": opt_state["count"]}


def loss_and_grads(model: Transformer, model_cfg: ModelConfig, batch,
                   lm: Optional[LogicalMesh] = None):
    """``(loss, metrics, grads)`` of ``loss_fn``, the gradients keyed by
    parameter name.  With ``lm`` (the model placed on its mesh) the loss is
    a plain tensor and each gradient a DTensor placed as its parameter."""
    _check_mesh(lm)
    params = dict(model.named_parameters())
    with mesh_context(lm):
        loss, metrics = loss_fn(model, model_cfg, batch)
        # a MoE router's bias moves the selection only: its gradient is
        # zero, as in the JAX package, not missing
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        if lm is not None:
            with torch.no_grad():
                # partial sums reduced (and scattered) to each parameter's
                # placements
                grads = {k: g.redistribute(params[k].device_mesh,
                                           params[k].placements)
                         for k, g in grads.items()}
                loss = _whole(loss)
    return loss, metrics, grads


def make_train_step(model_cfg: ModelConfig, tcfg: TrainConfig,
                    lm: Optional[LogicalMesh] = None):
    """Returns the fused step ``(model, opt, clip, batch, spike_thresh) ->
    (model, opt, clip, metrics)``; the model's parameters are written in
    place, the metrics are 0-d tensors.  With ``lm`` the model and the
    moments must be placed on its mesh (:func:`place_model`,
    :func:`place_opt_state`), as :func:`train` places them."""
    _check_mesh(lm)
    check_supported(model_cfg)
    if model_cfg.use_flash_kernel:
        raise NotImplementedError(f"{model_cfg.name}: {NO_FLASH_DERIVATIVE}")

    def step_fn(model: Transformer, opt_state, clip_state, batch,
                spike_thresh):
        params = dict(model.named_parameters())
        loss, metrics, grads = loss_and_grads(model, model_cfg, batch, lm)
        with torch.no_grad(), mesh_context(lm):
            scale, clip2 = pipelined_clip(grads, clip_state,
                                          tcfg.max_grad_norm)
            gnorm = clip2.prev_norm
            new_params, new_opt = adamw_update(params, grads, opt_state,
                                               tcfg.opt, grad_scale=scale)
            # in-graph bad-step gate: non-finite loss/grads or a spike
            # leaves params, opt and clip state untouched
            ok = torch.isfinite(loss) & torch.isfinite(gnorm) \
                & (gnorm < spike_thresh)
            for k, p in params.items():
                p.copy_(torch.where(ok, new_params[k], p))
            new_opt = _select(ok, new_opt, opt_state)
            clip_state = _select(ok, clip2, clip_state)
            if lm is not None:
                new_opt = _placed_like(new_opt, opt_state)
            opt_state = new_opt
        metrics = {k: _whole(v.detach()) for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, accepted=ok.float())
        return model, opt_state, clip_state, metrics

    return step_fn


def state_tree(model: Transformer, opt_state: Mapping,
               clip_state: PipelinedClipState) -> Dict:
    """The training state in the JAX package's tree layout: ``{"params",
    "opt": {"m", "v", "count"}, "clip"}``, per-layer leaves stacked."""
    return {"params": params_tree({k: p.detach() for k, p in
                                   model.named_parameters()}),
            "opt": {"m": params_tree(opt_state["m"]),
                    "v": params_tree(opt_state["v"]),
                    "count": opt_state["count"]},
            "clip": clip_state}


def load_state_tree(model: Transformer, tree: Mapping):
    """Write ``tree``'s parameters (the layout of :func:`state_tree`) into
    ``model`` and return its ``(opt_state, clip_state)``."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, t in params_from_tree(tree["params"], params).items():
            params[k].copy_(t)
    opt = tree["opt"]
    return ({"m": params_from_tree(opt["m"], params),
             "v": params_from_tree(opt["v"], params),
             "count": opt["count"]},
            PipelinedClipState(*tree["clip"]))


def train(model_cfg: ModelConfig, data_cfg: DataConfig, tcfg: TrainConfig,
          lm=None, injector: Optional[FailureInjector] = None,
          callback: Optional[Callable[[int, Dict], None]] = None, *,
          device=None) -> Dict[str, Any]:
    """Run (or resume) training on ``device`` (``None`` means ``"cuda"``),
    or with ``lm`` on its mesh's devices (a ``device`` given must be of
    the mesh's type).  Returns the summary and metric history of the JAX
    package's ``train``, and ``checkpoint``, the checkpointer's bytes and
    seconds; ``params`` is the model, on a mesh with DTensor
    parameters."""
    _check_mesh(lm)
    if lm is not None:
        if device is not None and \
                torch.device(device).type != lm.mesh.device_type:
            raise ValueError(f"device {device!r} is not of the mesh's type "
                             f"{lm.mesh.device_type!r}")
        device = lm.mesh.device_type
    device = resolve_device(device)
    # on a mesh its first rank writes the checkpoints
    writer = lm is None or not any(lm.mesh.get_coordinate())
    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts,
                             writer=writer)
    step_fn = make_train_step(model_cfg, tcfg, lm)
    batch_fn = make_dataset(data_cfg, model_cfg)

    model = init_params(model_cfg, torch.Generator(
        device=device).manual_seed(tcfg.seed))
    opt_state = adamw_init(dict(model.named_parameters()), tcfg.opt)
    if lm is not None:
        opt_state = place_opt_state(opt_state, place_model(model, lm), lm)
        # every rank sees the checkpoints its writer published before
        dist.barrier(group=mesh_group(lm.mesh))
    clip_state = pipelined_clip_init(device)
    start_step = 0
    if tcfg.resume and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(
            state_tree(model, opt_state, clip_state))
        opt_state, clip_state = load_state_tree(model, state)
        del state

    bad_filter = BadStepFilter(nan_zap=tcfg.spike_factor)
    timer = StepTimer()
    history: List[Dict[str, float]] = []

    step = start_step
    try:
        while step < tcfg.steps:
            if injector is not None:
                injector.check(step)
            timer.start()
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch_fn(step).items()}
            norms = list(bad_filter.norms) or [1e9]
            spike = torch.tensor(
                tcfg.spike_factor * float(np.median(norms)),
                dtype=torch.float32, device=device)
            model, opt_state, clip_state, metrics = step_fn(
                model, opt_state, clip_state, batch, spike)
            loss, gnorm, accepted = torch.stack(
                [metrics["loss"].float(), metrics["grad_norm"],
                 metrics["accepted"]]).tolist()       # the step's one host read
            accepted = accepted > 0
            if accepted:
                bad_filter.accept(loss, gnorm)   # updates running stats
            else:
                bad_filter.rejected += 1
            dt = timer.stop(step)
            rec = {"step": step, "loss": loss, "grad_norm": gnorm,
                   "accepted": accepted, "time_s": dt}
            history.append(rec)
            if callback:
                callback(step, rec)
            step += 1
            if step % tcfg.ckpt_every == 0 or step == tcfg.steps:
                ckpt.save(state_tree(model, opt_state, clip_state), step)
    finally:
        # a step that raises leaves no write running: a restart in this
        # process sees every checkpoint saved before the failure (C21)
        ckpt.wait()
    return {
        "params": model,
        "final_loss": history[-1]["loss"] if history else float("nan"),
        "history": history,
        "start_step": start_step,
        "rejected_steps": bad_filter.rejected,
        "straggler_stats": timer.stats(),
        "checkpoint": dict(ckpt.stats),
    }
