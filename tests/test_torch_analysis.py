"""The port's contract analyzer (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the audit's 8 x 6 x 6 stencil in fp64.

* The 60 quick matrix cells of ``python -m repro_torch.analysis audit
  --quick`` give, cell by cell, the statuses of the matching records of the JAX
  package's committed ``experiments/contract_audit.json`` (jnp -> torch,
  pallas -> cuda), and the same method x substrate matrix; a few cells are
  held against a live ``repro.analysis`` trace as well.  Exact: statuses
  equal, and the reduced block has the same leading dimension.
* Hand-built negative controls, one per contract, as in
  ``tests/test_analysis.py``, and the mutation-aware walk: a reduction of a
  buffer filled in place by the matvec is an edge.
* The mesh cells at world 2 over gloo (``tests/_torch_distributed_child.py
  ... analysis``) against the JAX artifact's 8-device mesh records.
* ``LinearSolver.verify_contracts`` and the kernels' ``torch.library``
  ops: bitwise their plain versions on the CPU, one FX node per call.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

import repro_torch  # noqa: E402
from conftest import enable_x64  # noqa: E402
from repro_torch.analysis import (BindingSpec, TracedBinding,  # noqa: E402
                                  count_op, run_passes, tag_matvec,
                                  tag_reduce, trace_binding, trace_fn)
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis.audit import (ARTIFACT_SCHEMA,  # noqa: E402
                                        METHOD_ORDER, audit_operator,
                                        audit_specs, expected_outcomes,
                                        mesh_cells)
from repro_torch.scenarios.cells import matrix_cells  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_axpy import IN_ORDER  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
CHILD = os.path.join(HERE, "_torch_distributed_child.py")
JAX_ARTIFACT = os.path.join(ROOT, "experiments", "contract_audit.json")
TORCH_ARTIFACT = os.path.join(ROOT, "experiments",
                              "torch_contract_audit.json")
SUBSTRATE = {"jnp": "torch", "pallas": "cuda"}
SPAWN_TIMEOUT = 300


@pytest.fixture(autouse=True)
def fresh_sessions():
    repro_torch.clear_session_cache()


def _cell_key(binding: dict) -> tuple:
    return (binding["method"], SUBSTRATE.get(binding["substrate"],
                                             binding["substrate"]),
            binding["binding"], binding["guard"], binding["precond"])


def _statuses(record: dict) -> dict:
    return {f["contract"]: f["status"] for f in record["findings"]}


def _leading_dim(record: dict):
    """The reduced block's leading dimension, from the one-reduction
    pass's provenance (``... -> float64[9, 3]`` / ``float64[9,3]``)."""
    f = next(f for f in record["findings"]
             if f["contract"] == "one_reduction_per_iteration")
    if f["status"] != "ok":
        return None
    return int(f["detail"].split("(")[1].split(",")[0].rstrip(")"))


@pytest.fixture(scope="module")
def jax_artifact():
    with open(JAX_ARTIFACT) as f:
        art = json.load(f)
    return {_cell_key(r["binding"]): r for r in art["reports"]
            if r["binding"]["binding"] != "mesh"}, art


@pytest.fixture(scope="module")
def quick_audit(tmp_path_factory):
    """The CLI's quick audit on the CPU: the 60 matrix cells, the 14 quick
    scenario rows and the 5 mesh cells on a one-rank gloo group."""
    out = tmp_path_factory.mktemp("audit") / "audit.json"
    code = cli.main(["audit", "--quick", "--device", "cpu", "--out",
                     str(out)])
    with open(out) as f:
        return code, json.load(f)


# -- the audit against the JAX package ----------------------------------------

QUICK = matrix_cells(quick=True)


def _label(c: dict) -> str:
    return "/".join(str(c[k]) for k in ("method", "substrate", "binding",
                                        "guard", "precond"))


def test_quick_audit_has_no_deviation(quick_audit):
    code, art = quick_audit
    assert code == 0 and art["ok"] and not art["deviations"]
    assert art["schema"] == ARTIFACT_SCHEMA
    assert (art["n_cells"], art["n_mesh_cells"],
            art["n_scenario_cells"]) == (79, 5, 14)
    assert len(QUICK) == 60


@pytest.mark.parametrize("cell", QUICK, ids=_label)
def test_quick_cell_matches_the_jax_artifact(cell, quick_audit,
                                             jax_artifact):
    _, art = quick_audit
    key = (cell["method"], cell["substrate"], cell["binding"],
           cell["guard"], cell["precond"])
    mine = next(r for r in art["reports"] if _cell_key(r["binding"]) == key)
    theirs = jax_artifact[0][key]
    assert _statuses(mine) == _statuses(theirs)
    assert _leading_dim(mine) == _leading_dim(theirs)
    assert mine["binding"]["guard_effective"] \
        == theirs["binding"]["guard_effective"]


def test_matrix_aggregate_matches_the_jax_artifact(quick_audit,
                                                    jax_artifact):
    _, art = quick_audit
    want = {f"{k.split('/')[0]}/{SUBSTRATE[k.split('/')[1]]}": v
            for k, v in jax_artifact[1]["matrix"].items()}
    assert art["matrix"] == want
    assert art["contracts"] == jax_artifact[1]["contracts"]
    assert art["methods"] == list(METHOD_ORDER)


def test_committed_artifact_agrees_with_the_quick_audit(quick_audit):
    """The committed CPU artifact (the full matrix and the 16 scenario
    rows) holds every quick cell with the statuses a fresh run gives, and
    no deviation."""
    with open(TORCH_ARTIFACT) as f:
        full = json.load(f)
    assert full["schema"] == ARTIFACT_SCHEMA and full["ok"]
    assert not full["quick"] and full["device"] == "cpu"
    assert full["n_cells"] == len(audit_specs(quick=False)) + 5 == 137
    assert full["n_scenario_cells"] == 16

    def key(r):
        return _cell_key(r["binding"]) + (str(r["binding"]["mesh_shape"]),
                                          r.get("scenario"))
    recs = {key(r): _statuses(r) for r in full["reports"]}
    for r in quick_audit[1]["reports"]:
        assert recs[key(r)] == _statuses(r), key(r)
    assert full["matrix"] == quick_audit[1]["matrix"]


LIVE = [
    ("p-bicgsafe", "batched", "pallas", True, None),
    ("p-bicgsafe", "open_loop", "jnp", False, None),
    ("p-bicgsafe-rr", "single", "pallas", False, "jacobi"),
    ("ssbicgsafe2", "single", "jnp", False, None),
    ("bicgstab", "single", "pallas", False, None),
]


@pytest.mark.parametrize("method,binding,jsub,guard,precond", LIVE)
def test_cell_against_a_live_jax_trace(method, binding, jsub, guard,
                                       precond):
    import jax.numpy as jnp
    from repro.analysis import run_passes as jrun_passes
    from repro.analysis import trace_binding as jtrace_binding
    from repro.core.linear_operator import Stencil7Operator
    with enable_x64(True):
        jop = Stencil7Operator(jnp.asarray(audit_operator().c.numpy()),
                               8, 6, 6)
        theirs = jrun_passes(jtrace_binding(
            method, jop, binding=binding, substrate=jsub, guard=guard,
            precond=precond, m=3)).to_dict()
    mine = run_passes(trace_binding(
        method, audit_operator(), binding=binding, substrate=SUBSTRATE[jsub],
        guard=guard, precond=precond, m=3, device="cpu")).to_dict()
    assert _statuses(mine) == _statuses(theirs)
    assert _leading_dim(mine) == _leading_dim(theirs)
    assert mine["binding"]["guard_effective"] \
        == theirs["binding"]["guard_effective"]


# -- hand-built negative controls ---------------------------------------------

def _spec(**kw) -> BindingSpec:
    return BindingSpec(**dict(dict(method="p-bicgsafe", substrate="torch",
                                   binding="single"), **kw))


def _x() -> torch.Tensor:
    return torch.ones(8, dtype=torch.float64)


def test_clean_pipelined_binding_passes_all():
    rep = run_passes(trace_binding("p-bicgsafe", audit_operator(),
                                   binding="batched", m=3, device="cpu"))
    assert rep.ok, [f.to_dict() for f in rep.findings if not f.ok]
    assert [f.status for f in rep.findings] == \
        ["ok", "ok", "skipped", "skipped", "ok"]


def test_tags_are_ops_with_no_marker_shape():
    """The tags are identity ``torch.library`` ops, one node each: the
    JAX package's ``REDUCE_MARK_DIM`` marker has no counterpart, and the
    tagged reduction keeps the partials' own shape."""
    import repro_torch.analysis as analysis
    assert not hasattr(analysis, "REDUCE_MARK_DIM")
    tb = trace_binding("p-bicgsafe", audit_operator(), binding="batched",
                       guard=True, m=3, device="cpu")
    red, = tb.reduce_nodes()
    assert tuple(red.meta["val"].shape) == (11, 3)
    assert len(tb.matvec_tag_nodes()) == 2          # A S and A w


def test_second_reduction_violates_one_reduction_pass():
    mv = tag_matvec(lambda x: 2.0 * x)

    def step(x):
        y = mv(x)
        p1 = tag_reduce(x[0] * torch.ones(9, dtype=x.dtype))
        p2 = tag_reduce(y[0] * torch.ones(9, dtype=x.dtype))  # second sync
        return y + p1[0] + p2[0]

    f = run_passes(trace_fn(step, _x(), spec=_spec())).finding(
        "one_reduction_per_iteration")
    assert f.status == "violation"
    assert "2 reduction phases" in f.detail
    assert len(f.provenance) == 2


def test_wrong_partial_block_shape_violates():
    def step(x):
        p = tag_reduce(x[:4])
        return tag_matvec(lambda v: 2.0 * v)(x) + p[0]

    f = run_passes(trace_fn(step, _x(), spec=_spec())).finding(
        "one_reduction_per_iteration")
    assert f.status == "violation"
    assert "fused" in f.detail


def test_reduction_consuming_matvec_violates_overlap():
    mv = tag_matvec(lambda x: 2.0 * x)

    def dirty(x):
        y = mv(x)
        return y + tag_reduce(y[0] * torch.ones(9, dtype=x.dtype))[0]

    def clean(x):
        y = mv(x)                                         # in flight
        return y + tag_reduce(x[0] * torch.ones(9, dtype=x.dtype))[0]

    f = run_passes(trace_fn(dirty, _x(), spec=_spec())).finding(
        "overlap_edge_free")
    assert f.status == "violation"
    assert "transitively consumes" in f.detail
    assert run_passes(trace_fn(clean, _x(), spec=_spec())).finding(
        "overlap_edge_free").status == "ok"


@pytest.mark.parametrize("through", ["buffer", "view"])
def test_walk_follows_an_in_place_write(through):
    """``out.copy_(matvec(x))``: the read of ``out`` (or of a view of it
    made before the write, which the graph points at the allocation) must
    reach the matvec through the write."""
    mv = tag_matvec(lambda x: 2.0 * x)

    def step(x):
        out = torch.zeros_like(x)
        seen = out if through == "buffer" else out.view(-1)
        out.copy_(mv(x))
        return x + tag_reduce(seen[0] * torch.ones(9, dtype=x.dtype))[0]

    def clean(x):
        out = torch.zeros_like(x)
        seen = out.view(-1)
        p = tag_reduce(seen[0] * torch.ones(9, dtype=x.dtype))
        out.copy_(mv(x))                  # written after the reduction
        return out + p[0]

    f = run_passes(trace_fn(step, _x(), spec=_spec())).finding(
        "overlap_edge_free")
    assert f.status == "violation", f.detail
    assert run_passes(trace_fn(clean, _x(), spec=_spec())).finding(
        "overlap_edge_free").status == "ok"


def test_dtype_flow_catches_an_f32_round_trip_in_the_operator():
    op = audit_operator()
    clean = trace_binding("p-bicgsafe", op, binding="batched", m=3,
                          device="cpu")
    assert run_passes(clean).finding("dtype_flow").status == "ok"

    def dirty(X):                          # f64 -> f32 -> f64 round trip
        return op.matvec(X.float()).to(X.dtype)

    tb = trace_binding("p-bicgsafe", dirty, binding="batched", m=3,
                       n=op.n, blocked=True, device="cpu")
    f = run_passes(tb).finding("dtype_flow")
    assert f.status == "violation"
    assert "float64->float32" in f.detail
    assert f.provenance


def test_kernel_backed_flags_a_silent_torch_fallback():
    op = audit_operator()
    tb = trace_binding("p-bicgsafe", op, binding="batched",
                       substrate="cuda", m=3, device="cpu")
    assert run_passes(tb).finding("kernel_backed").status == "ok"
    # the same step traced on "torch", under a spec CLAIMING "cuda":
    # exactly what a silent fallback looks like to the analyzer
    plain = trace_binding("p-bicgsafe", op, binding="batched",
                          substrate="torch", m=3, device="cpu")
    faked = TracedBinding(
        spec=dataclasses.replace(plain.spec, substrate="cuda"), gm=plain.gm)
    f = run_passes(faked).finding("kernel_backed")
    assert f.status == "violation"
    assert "silent torch fallback" in f.detail


def test_expected_outcomes_key_on_the_port_substrates():
    spec = BindingSpec(method="p-bicgsafe", substrate="cuda",
                       binding="batched")
    assert expected_outcomes(spec)["kernel_backed"] == "ok"
    one_rank = BindingSpec(method="bicgstab", substrate="torch",
                           binding="mesh", mesh_shape=(1,))
    assert expected_outcomes(one_rank)["overlap_edge_free"] == "ok"


# -- the scenario rows ---------------------------------------------------------

def test_scenario_rows_count_and_carry_their_scenario(quick_audit):
    """16 scenario rows in full mode, 14 in quick mode (the mesh scenario
    is the mesh smoke's), each record naming its scenario and class."""
    assert len(audit_specs(quick=False)) - len(matrix_cells(False)) == 16
    assert len(audit_specs(quick=True)) - len(QUICK) == 14
    rows = [r for r in quick_audit[1]["reports"] if r.get("scenario")]
    assert len(rows) == 14
    assert {r["operator_class"] for r in rows} >= {
        "convection_diffusion", "helmholtz_shifted", "random_nonsym"}


def _one_cell_audit(monkeypatch, cell):
    import repro_torch.scenarios as scenarios
    monkeypatch.setattr(scenarios, "contract_cells",
                        lambda quick=False: [cell])
    from repro_torch.analysis.audit import run_audit
    return run_audit(quick=True, mesh_smoke=False, device="cpu")


def test_audit_unregistered_operator_class_fails_loudly(monkeypatch):
    """A registry row whose operator class is not registered stops the
    audit with the registry's error, naming the registered classes."""
    from repro_torch.scenarios import ScenarioError
    cell = dict(method="p-bicgsafe", binding="single", substrate="torch",
                guard=False, precond=None, scenario="negctl",
                operator_class="no_such_class", operator_params={},
                expected={})
    with pytest.raises(ScenarioError,
                       match="unregistered operator class 'no_such_class'"
                       ".*registered classes"):
        _one_cell_audit(monkeypatch, cell)


def test_audit_honours_a_plugins_contract_overrides(monkeypatch):
    """A plugin's ``contract_overrides`` replace the expected status of
    its rows: BiCGStab's expected fused-reduction violation, declared "ok"
    by the plugin, becomes the row's one deviation."""
    from repro_torch.scenarios import (OperatorSpec, Scenario,
                                       build_problem, registry)
    monkeypatch.setattr(registry, "OPERATOR_CLASSES",
                        dict(registry.OPERATOR_CLASSES))
    registry.register_operator_class(
        "delta-probe",
        lambda device=None, **kw: build_problem("convection_diffusion",
                                                nx=6, device=device),
        contract_overrides={"one_reduction_per_iteration": "ok"})
    cell = Scenario("delta-probe-cell", OperatorSpec.of("delta-probe"),
                    method="bicgstab").contract_cell()
    art = _one_cell_audit(monkeypatch, cell)
    assert (art["n_cells"], art["n_scenario_cells"]) == (1, 1)
    assert not art["ok"]
    (dev,) = art["deviations"]
    assert (dev["scenario"], dev["contract"], dev["expected"],
            dev["actual"]) == ("delta-probe-cell",
                               "one_reduction_per_iteration", "ok",
                               "violation")
    (rec,) = art["reports"]
    assert (rec["scenario"], rec["operator_class"]) == \
        ("delta-probe-cell", "delta-probe")
    assert rec["expected"]["overlap_edge_free"] == "violation"


def test_cli_refuses_a_bad_device(capsys):
    assert cli.main(["audit", "--device", "tpu", "--out", ""]) == 2
    assert "error" in capsys.readouterr().err


# -- the mesh at world 2 ------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The mesh cells and two bindings' ``verify_contracts`` on two gloo
    processes; rank 0's reports."""
    work = tmp_path_factory.mktemp("mesh2")
    op = audit_operator()
    n = op.n
    np.savez(work / "inputs.npz", c=op.c.numpy(), shape=np.array([8, 6, 6]),
             b=np.ones(n), B=np.ones((n, 3)))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(rank), "2", str(work / "store"),
         str(work / "inputs.npz"), str(work / "out"), "analysis"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0, 0], "\n".join(
        f"--- rank {r} exit {c}\n{log}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    with open(work / "out" / "scalars.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", mesh_cells(), ids=_label)
def test_mesh_cell_at_world_2_matches_the_jax_artifact(cell, world2,
                                                       jax_artifact):
    mine = next(v for k, v in world2.items() if k.startswith("analysis/")
                and _cell_key(v["binding"]) == (
                    cell["method"], "torch", "mesh", cell["guard"],
                    cell["precond"]))
    theirs = next(r for r in jax_artifact[1]["reports"]
                  if r["binding"]["binding"] == "mesh"
                  and (r["binding"]["method"], r["binding"]["guard"],
                       r["binding"]["precond"])
                  == (cell["method"], cell["guard"], cell["precond"]))
    assert mine["binding"]["mesh_shape"] == [2]
    assert _statuses(mine) == _statuses(theirs)
    assert _leading_dim(mine) == _leading_dim(theirs)


def test_mesh_overlap_edge_runs_through_the_halo_receive(world2):
    """ssBiCGSafe2 and BiCGStab fail overlap_edge_free at world 2 only
    through the ``recv_`` writes: the read of a received plane points at
    the buffer's allocation, not at the receive."""
    for method in ("ssbicgsafe2", "bicgstab"):
        rec = world2[f"analysis/{method}/torch/mesh/mesh2"]
        f = next(f for f in rec["findings"]
                 if f["contract"] == "overlap_edge_free")
        assert f["status"] == "violation"
        assert "halo recv_" in f["detail"]
    rec = world2["analysis/p-bicgsafe/torch/mesh/mesh2"]
    f = next(f for f in rec["findings"]
             if f["contract"] == "overlap_edge_free")
    assert f["status"] == "ok" and "halo recv_" in f["detail"]


def test_distributed_solver_verify_contracts(world2):
    assert world2["verify/p-bicgsafe"]["ok"]
    assert world2["verify/p-bicgsafe"]["binding"]["binding"] == "mesh"
    assert not world2["verify/ssbicgsafe2"]["ok"]


# -- sessions -----------------------------------------------------------------

def _ell(nx=8):
    return TM.stencil_to_ell(TM.convection_diffusion(nx, device="cpu")[0])


def test_verify_contracts_on_a_cuda_session():
    """The session's own step: ELL matvecs through the SpMV op, so four
    kernel nodes back a p-BiCGSafe step on "cuda" (dots, axpy, 2 SpMVs)."""
    sess = repro_torch.make_solver("p-bicgsafe", _ell(), substrate="cuda",
                                   device="cpu")
    reps = sess.verify_contracts(bindings=["single", "batched"])
    assert [r.spec.binding for r in reps] == ["single", "batched"]
    for rep in reps:
        assert rep.ok, [f.to_dict() for f in rep.violations]
        f = rep.finding("kernel_backed")
        assert f.status == "ok" and f.detail.startswith("4 kernel op(s)")
    assert sess.stats["solves"] == 0 and sess.stats["programs"] == 0
    default, = sess.verify_contracts()
    assert default.spec.binding == "batched"


def test_verify_contracts_counts_the_block_jacobi_kernel():
    sess = repro_torch.make_solver("p-bicgsafe", _ell(), substrate="cuda",
                                   precond="block_jacobi", device="cpu")
    rep, = sess.verify_contracts(bindings=["single"])
    assert rep.spec.precond_kernels == 1
    assert rep.ok
    assert rep.finding("kernel_backed").detail.startswith("6 kernel op(s)")


def test_verify_contracts_raises_on_ssbicgsafe2():
    sess = repro_torch.make_solver("ssbicgsafe2", audit_operator(),
                                   device="cpu")
    rep, = sess.verify_contracts()
    assert rep.finding("overlap_edge_free").status == "violation"
    with pytest.raises(ValueError, match="overlap_edge_free"):
        sess.verify_contracts(raise_on_violation=True)


def test_verify_contracts_on_a_one_rank_mesh():
    from repro_torch.analysis.audit import one_rank_group
    sess = repro_torch.make_solver("p-bicgsafe", audit_operator(),
                                   device="cpu")
    with one_rank_group(torch.device("cpu")) as group:
        reps = sess.verify_contracts(mesh=group)
    assert [r.spec.binding for r in reps] == ["batched", "mesh"]
    assert all(r.ok for r in reps)
    assert reps[1].finding("single_psum_sharded").status == "ok"


# -- the kernels as library ops -----------------------------------------------

def _vecs(n, m, k, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if m is None else (n, m)
    return [torch.randn(shape, generator=g, dtype=torch.float64)
            for _ in range(k)]


def _axpy_call(vs, scal, mask):
    return ops.fused_axpy(dict(zip(IN_ORDER, vs)), scal, mask)


OP_CASES = {
    "fused_dots": (lambda vs: ops.fused_dots(*vs[:5]),
                   lambda vs: ref.fused_dots(*vs[:5])),
    "fused_dots_health": (lambda vs: ops.fused_dots_health(*vs[:6]),
                          lambda vs: ref.fused_dots_health(*vs[:6])),
    "fused_axpy": (
        lambda vs: list(_axpy_call(vs[:12], vs[12][:4, ...],
                                   None).values()),
        lambda vs: list(ref.fused_axpy(dict(zip(IN_ORDER, vs[:12])),
                                       vs[12][:4, ...].unbind(0)).values())),
}


@pytest.mark.parametrize("m", [None, 1, 4])
@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_is_bitwise_the_plain_version_and_one_node(name, m):
    vs = _vecs(50, m, 13, seed=len(name))
    call, plain = OP_CASES[name]
    got, want = call(vs), plain(vs)
    for a, b in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert torch.equal(a, b)
    gm = make_fx(call)(vs)
    assert count_op(gm, f"repro_torch::{name}") == 1


@pytest.mark.parametrize("m", [None, 3])
def test_spmv_and_block_jacobi_ops(m):
    ell = _ell(6)
    x = _vecs(ell.n, m, 1, seed=7)[0]
    assert torch.equal(ops.spmv_ell(ell, x),
                       ref.spmv_ell(ell.values, ell.cols, x))
    gm = make_fx(lambda v: ops.spmv_ell(ell, v))(x)
    assert count_op(gm, "repro_torch::spmv_ell") == 1
    blocks = torch.randn(ell.n // 6, 6, 6, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(ops.block_jacobi_apply(blocks, x),
                       ref.block_jacobi_apply(blocks, x))
    gm = make_fx(lambda v: ops.block_jacobi_apply(blocks, v))(x)
    assert count_op(gm, "repro_torch::block_jacobi_apply") == 1
    # the shared block is one matmul, no kernel and no op
    shared = blocks[:1].contiguous()
    gm = make_fx(lambda v: ops.block_jacobi_apply(shared, v))(x)
    assert count_op(gm, "repro_torch::block_jacobi_apply") == 0


def test_masked_axpy_op_returns_no_input():
    """A frozen column's outputs are its inputs' values in fresh tensors:
    the op's outputs alias none of its inputs."""
    vs = _vecs(40, 3, 12, seed=1)
    mask = torch.tensor([True, False, True])
    out = ops.fused_axpy(dict(zip(IN_ORDER, vs)),
                         torch.ones(4, 3, dtype=torch.float64), mask)
    want = ref.fused_axpy(dict(zip(IN_ORDER, vs)),
                          torch.ones(4, 3, dtype=torch.float64).unbind(0),
                          mask)
    ptrs = {v.data_ptr() for v in vs}
    for k, v in out.items():
        assert torch.equal(v, want[k])
        assert v.data_ptr() not in ptrs
