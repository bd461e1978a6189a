"""The contract passes: the paper's invariants as named static checks
over the FX graph of one solver step (counterpart of
``repro.analysis.passes``).

Each pass consumes a :class:`~repro_torch.analysis.trace.TracedBinding`
and returns one :class:`~repro_torch.analysis.report.Finding`.  The
registry :data:`PASSES` is ordered and name-addressable; :func:`run_passes`
applies every applicable pass and packages a
:class:`~repro_torch.analysis.report.ContractReport`.

The five contracts (Huynh & Suito 2021; Cools & Vanroose 1612.01395;
Cools 1809.01948), with the JAX package's names:

* ``one_reduction_per_iteration`` — the step holds EXACTLY ONE fused
  reduction phase, carrying the whole (9, m) partial block ((11, m) when
  the guard rides along), never a second sync.
* ``overlap_edge_free``           — that reduction transitively consumes
  NO output of the in-flight matvec (the halo ``recv_`` writes on a
  mesh), so communication can hide behind computation.
* ``single_psum_sharded``         — on a mesh the reduction is ONE
  all-reduce per step and nothing else introduces a collective
  (shard-local preconditioners must cost zero extra).
* ``kernel_backed``               — ``"cuda"``-substrate steps dispatch
  the hot-loop phases to the port's kernel ops (``repro_torch::*``
  nodes), no silent PyTorch fallback.
* ``dtype_flow``                  — no precision-losing float cast inside
  the recurrence chain.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import torch

from .fx_tools import op_name, transitive_inputs
from .report import (OK, SKIPPED, VIOLATION, ContractReport, Finding,
                     node_provenance)
from .trace import TracedBinding

__all__ = ["PASSES", "contract_pass", "run_passes",
           "reduction_consumes_matvec"]

#: ordered registry: name -> (applies(spec) predicate, pass fn)
PASSES: "OrderedDict[str, tuple]" = OrderedDict()


def contract_pass(name: str, applies: Optional[Callable] = None):
    """Register a contract pass under ``name`` (decorator)."""
    def deco(fn):
        PASSES[name] = ((applies or (lambda spec: True)), fn)
        return fn
    return deco


def run_passes(tb: TracedBinding,
               names: Optional[Sequence[str]] = None) -> ContractReport:
    """Run the (named subset of the) registered passes over one traced
    binding; inapplicable passes report ``skipped``."""
    findings: List[Finding] = []
    for name, (applies, fn) in PASSES.items():
        if names is not None and name not in names:
            continue
        if not applies(tb.spec):
            findings.append(Finding(name, SKIPPED, "not applicable to "
                                    f"{tb.spec.binding}/{tb.spec.substrate}"))
            continue
        findings.append(fn(tb))
    return ContractReport(spec=tb.spec, findings=tuple(findings))


# ---------------------------------------------------------------------------
# pass bodies
# ---------------------------------------------------------------------------

def _fused_leading_dim(spec) -> int:
    return 11 if spec.guard_effective else 9


def _operand_shape(red) -> tuple:
    """The shape of a reduction node's partial block (an all-reduce takes
    a list of tensors: its first)."""
    arg = red.args[0]
    if isinstance(arg, (list, tuple)):
        arg = arg[0]
    return tuple(arg.meta["val"].shape)


@contract_pass("one_reduction_per_iteration")
def one_reduction_per_iteration(tb: TracedBinding) -> Finding:
    """EXACTLY ONE reduction phase per step, carrying the whole (9[, m])
    (guarded: (11[, m])) fused partial block."""
    name = "one_reduction_per_iteration"
    reds = tb.reduce_nodes()
    if len(reds) != 1:
        return Finding(
            name, VIOLATION,
            f"{len(reds)} reduction phases per iteration (contract: 1)",
            tuple(node_provenance(e) for e in reds))
    shape = _operand_shape(reds[0])
    want = _fused_leading_dim(tb.spec)
    if shape[:1] != (want,):
        return Finding(
            name, VIOLATION,
            f"the single reduction carries {shape}, not the fused "
            f"({want}[, m]) partial block",
            (node_provenance(reds[0]),))
    return Finding(name, OK,
                   f"one fused {shape} reduction per iteration",
                   (node_provenance(reds[0]),))


def reduction_consumes_matvec(tb: TracedBinding):
    """Shared overlap core: does ANY reduction phase of the step
    transitively consume the in-flight matvec (the matvec tag locally,
    the halo ``recv_`` writes on a mesh), through arguments and in-place
    writes alike?  Returns ``(edge_exists, detail, provenance)`` or
    raises ValueError when the probe found nothing to anchor on."""
    reds = tb.reduce_nodes()
    if tb.spec.binding == "mesh":
        if not reds:
            raise ValueError("no all-reduce found in the step")
        producers = set(tb.halo_nodes())
        producer_kind = "halo recv_"
        if not producers:
            return (False, "no halo recv_ in the step (single-rank "
                    "mesh); reduction trivially edge-free", ())
    else:
        if not reds:
            raise ValueError("no reduction phase found in the step")
        producers = set(tb.matvec_tag_nodes())
        producer_kind = "matvec"
        if not producers:
            raise ValueError("no matvec tag found in the step")
    for red in reds:
        if transitive_inputs(tb.graph, red) & producers:
            return (True,
                    f"a reduction transitively consumes the in-flight "
                    f"{producer_kind} output",
                    (node_provenance(red),))
    return (False,
            f"no dependency edge from any reduction to the in-flight "
            f"{producer_kind} ({len(reds)} reduction(s), "
            f"{len(producers)} tagged output(s))",
            tuple(node_provenance(e) for e in reds))


@contract_pass("overlap_edge_free")
def overlap_edge_free(tb: TracedBinding) -> Finding:
    """The reduction has NO dependency edge to the in-flight matvec: the
    communication-hiding property itself."""
    name = "overlap_edge_free"
    try:
        edge, detail, prov = reduction_consumes_matvec(tb)
    except ValueError as e:
        return Finding(name, VIOLATION, f"probe inconclusive: {e}")
    return Finding(name, VIOLATION if edge else OK, detail, prov)


#: collectives that must NOT appear in a sharded step beyond the single
#: all-reduce (the halo's send / recv_ are the matvec's and are allowed),
#: by the stem of their ``c10d`` / ``_c10d_functional`` op names
_FORBIDDEN_COLLECTIVES = ("allgather", "all_gather", "reduce_scatter",
                          "alltoall", "all_to_all", "broadcast")


def _collective_stem(node) -> str:
    ns, _, name = op_name(node).partition("::")
    if ns not in ("c10d", "_c10d_functional"):
        return ""
    name = name.lstrip("_")
    return next((s for s in _FORBIDDEN_COLLECTIVES if name.startswith(s)),
                "")


@contract_pass("single_psum_sharded",
               applies=lambda spec: spec.binding == "mesh")
def single_psum_sharded(tb: TracedBinding) -> Finding:
    """On a mesh: ONE all-reduce per step (the fused block) and zero other
    collectives (shard-local preconditioners add none)."""
    name = "single_psum_sharded"
    reds = tb.reduce_nodes()
    if len(reds) != 1:
        return Finding(name, VIOLATION,
                       f"{len(reds)} all-reduces per iteration "
                       "(contract: 1)",
                       tuple(node_provenance(e) for e in reds))
    extra = sorted({s for s in map(_collective_stem, tb.graph.nodes) if s})
    if extra:
        return Finding(name, VIOLATION,
                       f"extra collectives in the step: {extra}")
    shape = _operand_shape(reds[0])
    want = _fused_leading_dim(tb.spec)
    if shape[:1] != (want,):
        return Finding(name, VIOLATION,
                       f"the all-reduce carries {shape}, not the fused "
                       f"({want}[, m]) block", (node_provenance(reds[0]),))
    return Finding(name, OK, f"one {shape} all-reduce per iteration, no "
                   "other collectives", (node_provenance(reds[0]),))


#: kernel-backed fused phases per method on the ``"cuda"`` substrate: the
#: pipelined variants run fused-dots AND the fused-axpy update phase as
#: kernels; sequential ssBiCGSafe2 has only the fused-dots phase.  The
#: BiCGStab/GPBi-CG family's dot phases stay plain PyTorch (not the
#: paper's hot path), so the contract does not apply to them.
_KERNEL_PHASES = {"p-bicgsafe": 2, "p-bicgsafe-rr": 2, "ssbicgsafe2": 1}


@contract_pass("kernel_backed",
               applies=lambda spec: spec.substrate == "cuda"
               and spec.method in _KERNEL_PHASES)
def kernel_backed(tb: TracedBinding) -> Finding:
    """``"cuda"``-substrate steps dispatch the hot-loop phases to the
    port's kernel ops: the step must hold the method's fused-phase
    ``repro_torch`` nodes (plus the block-Jacobi apply when that
    preconditioner is bound with varying blocks).  A silent fallback to
    plain PyTorch shows up here as a missing node, on the CPU too."""
    name = "kernel_backed"
    nodes = tb.kernel_nodes()
    want = _KERNEL_PHASES.get(tb.spec.method, 1) + tb.spec.precond_kernels
    if len(nodes) < want:
        return Finding(name, VIOLATION,
                       f"{len(nodes)} kernel op(s) in the step "
                       f"(contract: >= {want} fused-phase kernel(s)"
                       + ("; + block-Jacobi apply"
                          if tb.spec.precond_kernels else "")
                       + ") — silent torch fallback",
                       tuple(node_provenance(n) for n in nodes))
    return Finding(name, OK,
                   f"{len(nodes)} kernel op(s) back the step",
                   tuple(node_provenance(n) for n in nodes))


def _cast(node):
    """``(source node, destination dtype)`` of a node that changes a
    tensor's dtype, else ``None``."""
    name = op_name(node)
    val = node.meta.get("val")
    if name in ("aten::_to_copy", "aten::to", "prims::convert_element_type"):
        return node.args[0], getattr(val, "dtype", None)
    if name == "aten::copy_" and len(node.args) > 1:
        return node.args[1], node.args[0].meta["val"].dtype
    return None


@contract_pass("dtype_flow")
def dtype_flow(tb: TracedBinding) -> Finding:
    """No precision-losing float cast inside the recurrence chain.

    Pipelined recurrences replace the true residual with recurred
    vectors; a hidden downcast (f64->f32, f32->bf16) inside the operator
    or preconditioner closure breaks their linearity and lets the
    recurred residual drift from the true one.  Statically: the step must
    hold no ``_to_copy`` / ``to`` / ``convert_element_type`` / ``copy_``
    from a wider float to a narrower one."""
    name = "dtype_flow"
    bad = []
    for node in tb.graph.nodes:
        cast = _cast(node)
        if cast is None or cast[1] is None \
                or not hasattr(cast[0], "meta"):
            continue
        src, dst = cast[0].meta["val"].dtype, cast[1]
        if src.is_floating_point and dst.is_floating_point \
                and torch.finfo(dst).bits < torch.finfo(src).bits:
            bad.append((str(src).replace("torch.", ""),
                        str(dst).replace("torch.", ""), node))
    if bad:
        return Finding(
            name, VIOLATION,
            "precision-losing float cast(s) in the recurrence chain: "
            + ", ".join(f"{s}->{d}" for s, d, _ in bad),
            tuple(node_provenance(n) for _, _, n in bad))
    return Finding(name, OK, "no precision-losing float casts in the "
                   "iteration body")
