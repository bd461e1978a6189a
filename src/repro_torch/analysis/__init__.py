"""repro_torch.analysis — the static contract verifier for the paper's
invariants (PyTorch port of ``repro.analysis``).

The paper's value proposition is *structural*: one fused inner-product
phase per iteration, with no dependency edge from that reduction to the
in-flight matvec, so communication hides behind computation; and
pipelined recurrences stay trustworthy only if dtype discipline holds.
This package states those invariants as named contract passes over the
FX graph (``make_fx``, fake mode) of one solver step, the callable a
session's program captures as a CUDA graph, and is what every probe reads:
the tests, the session hook (:meth:`repro_torch.api.LinearSolver
.verify_contracts`) and the audit.

    from repro_torch.analysis import trace_binding, run_passes

    tb = trace_binding("p-bicgsafe", op, binding="batched",
                       substrate="cuda", guard=True, device="cpu")
    report = run_passes(tb)
    assert report.ok, report.violations

    # or sweep the whole binding matrix:
    #   python -m repro_torch.analysis audit [--quick] [--device cpu]

The port's kernels are ``torch.library`` ops (:data:`repro_torch.kernels
.ops.KERNEL_OPS`), one node each in a step's graph, so ``kernel_backed``
sees a silent fallback to plain PyTorch on the CPU too.

Layout:

* :mod:`fx_tools` — the FX-walking toolbox; the dependency walk follows
  in-place writes (the graph is not functional).
* :mod:`trace`    — trace any session binding (single / batched /
  open-loop service chunk / mesh) into a ``TracedBinding``.
* :mod:`passes`   — the contract passes + registry:
  ``one_reduction_per_iteration``, ``overlap_edge_free``,
  ``single_psum_sharded``, ``kernel_backed``, ``dtype_flow``.
* :mod:`report`   — typed ``Finding`` / ``ContractReport`` with FX
  provenance, plus the human-readable contract table.
* :mod:`audit`    — the binding-matrix sweep behind ``python -m
  repro_torch.analysis audit``; writes
  ``experiments/torch_contract_audit.json``.

The JAX package's HLO backend (``repro.analysis.hlo``) reads XLA's HLO
text and has no counterpart: the step's FX graph carries the structure,
and :mod:`repro_torch.observe.profile`'s overlap report the time.
"""
from .fx_tools import (count_op, find_op_nodes, op_name, transitive_inputs,
                       written_args)
from .passes import PASSES, contract_pass, reduction_consumes_matvec, \
    run_passes
from .report import BindingSpec, ContractReport, Finding, format_table
from .trace import (TAGGED_REDUCE, TracedBinding, mark_matvec, mark_reduce,
                    tag_matvec, tag_reduce, trace_binding, trace_fn)

__all__ = [
    # toolbox
    "op_name", "count_op", "find_op_nodes", "written_args",
    "transitive_inputs",
    # tracing
    "TracedBinding", "trace_binding", "trace_fn", "tag_reduce",
    "tag_matvec", "mark_reduce", "mark_matvec", "TAGGED_REDUCE",
    # passes
    "PASSES", "contract_pass", "run_passes", "reduction_consumes_matvec",
    # reports
    "BindingSpec", "ContractReport", "Finding", "format_table",
]
