"""Training loop: fault-tolerant, restartable, on one device (PyTorch port
of ``repro.train.train_loop``).

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.data import DataConfig, make_dataset
from repro_torch.models import ModelConfig, Transformer, init_params, loss_fn
from repro_torch.models.attention import NO_FLASH_DERIVATIVE
from repro_torch.models.transformer import (check_supported,
                                            params_from_tree, params_tree)
from repro_torch.optim import (AdamWConfig, PipelinedClipState, adamw_init,
                               adamw_update, pipelined_clip,
                               pipelined_clip_init)

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


def make_train_step(model_cfg: ModelConfig, tcfg: TrainConfig, lm=None):
    """Returns the fused step ``(model, opt, clip, batch, spike_thresh) ->
    (model, opt, clip, metrics)``; the model's parameters are written in
    place, the metrics are 0-d tensors."""
    if lm is not None:
        raise NotImplementedError(
            "training on a mesh waits for the parallel/ slice of the "
            "PyTorch port (ROADMAP A11.10); train on one device (lm=None)")
    check_supported(model_cfg)
    if model_cfg.use_flash_kernel:
        raise NotImplementedError(f"{model_cfg.name}: {NO_FLASH_DERIVATIVE}")

    def step_fn(model: Transformer, opt_state, clip_state, batch,
                spike_thresh):
        params = dict(model.named_parameters())
        loss, metrics = loss_fn(model, model_cfg, batch)
        # a MoE router's bias moves the selection only: its gradient is
        # zero, as in the JAX package, not missing
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        with torch.no_grad():
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
            opt_state = _select(ok, new_opt, opt_state)
            clip_state = _select(ok, clip2, clip_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
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
    """Run (or resume) training on ``device`` (``None`` means ``"cuda"``).
    Returns the summary and metric history of the JAX package's ``train``,
    and ``checkpoint``, the checkpointer's bytes and seconds."""
    device = resolve_device(device)
    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
    step_fn = make_train_step(model_cfg, tcfg, lm)
    batch_fn = make_dataset(data_cfg, model_cfg)

    model = init_params(model_cfg, torch.Generator(
        device=device).manual_seed(tcfg.seed))
    opt_state = adamw_init(dict(model.named_parameters()), tcfg.opt)
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
