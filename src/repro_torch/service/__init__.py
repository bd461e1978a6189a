"""repro_torch.service — continuous-batching solve service (PyTorch port
of ``repro.service``).

Independent requests (one right-hand side each, with their own ``tol`` /
``maxiter`` / ``deadline``) are multiplexed onto a fixed
``(n, max_batch)`` resident block per registered operator, stepped by one
program of the operator's session: one ``(9, m)`` reduction per iteration
for the whole block.  Converged columns retire between chunks and freed
slots are refilled mid-flight by a splice that opens the next chunk.

    from repro_torch.service import ServiceConfig, SolveEngine

    eng = SolveEngine(ServiceConfig(max_batch=8, chunk=32,
                                    substrate="cuda"))
    name = eng.register(op, precond="block_jacobi")
    rids = [eng.submit(name, b_i, tol=1e-8) for b_i in rhs_stream]
    for res in eng.run():
        print(res.rid, res.status, res.iterations,
              res.telemetry.queue_wait_s)
"""
from .engine import SolveEngine
from .registry import OperatorRegistry, RegisteredOperator
from .types import (RequestResult, RequestTelemetry, ServiceConfig,
                    SolveRequest)

__all__ = [
    "SolveEngine",
    "OperatorRegistry", "RegisteredOperator",
    "ServiceConfig", "SolveRequest", "RequestResult", "RequestTelemetry",
]
