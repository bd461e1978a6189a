"""repro_torch.resilience — guarded solves: detection, recovery, injection
(PyTorch port of ``repro.resilience``).

* **Detection** rides inside the solver's single reduction: with
  ``SolverConfig.guard`` the fused (9, m) phase of the batched p-BiCGSafe
  iteration becomes an (11, m) phase whose two extra rows carry
  ``||x||^2`` and a NaN/Inf probe (the ``fused_dots_health`` kernels on
  ``"cuda"``), and the state gains typed per-column statuses, the Cools
  drift bound and a stagnation monitor (:mod:`repro_torch.core.multirhs`).
* **Recovery** is host-side and declarative: a :class:`RecoveryPolicy`
  tells the :class:`GuardedSolver` what it may do at chunk boundaries —
  residual replacement, restart from the current x, BiCGStab fallback,
  ``"cuda"`` -> ``"torch"`` degradation after a simulated kernel
  failure.
* **Injection** (:mod:`repro_torch.resilience.inject`): NaN insertion,
  near-singular operators and simulated kernel failures.

Front door: ``repro_torch.make_solver(..., recovery=RecoveryPolicy())``.
"""
from ..core.types import SolveStatus
from .guard import GuardedSolver, guarded_config
from .inject import (ChunkFaultInjector, SimulatedKernelFailure, nan_columns,
                     near_singular_dense, orthogonal_shadow)
from .policy import RecoveryPolicy
from .recover import replace_columns, restart_columns

__all__ = [
    "SolveStatus", "RecoveryPolicy", "GuardedSolver", "guarded_config",
    "replace_columns", "restart_columns",
    "ChunkFaultInjector", "SimulatedKernelFailure", "nan_columns",
    "near_singular_dense", "orthogonal_shadow",
]
