"""Optimizers of the port (PyTorch port of ``repro.optim``): AdamW with
f32 / bf16 / int8 moments, pipelined (one-step-stale) gradient clipping,
and the Newton-Krylov step whose inner solve is p-BiCGSafe."""
from .adamw import AdamWConfig, adamw_init, adamw_update, schedule
from .clipping import (PipelinedClipState, global_norm, pipelined_clip,
                       pipelined_clip_init)
from .eightbit import Q8, dequantize, quantize
from .newton_krylov import (NewtonKrylovConfig, make_ggn_matvec,
                            newton_krylov_step)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "schedule",
           "PipelinedClipState", "global_norm", "pipelined_clip_init",
           "pipelined_clip", "Q8", "dequantize", "quantize",
           "NewtonKrylovConfig", "make_ggn_matvec", "newton_krylov_step"]
