"""The port's scenario registry (``repro_torch.scenarios``) against the JAX
package's (``repro.scenarios``), on the CPU.

* The 18 tests of ``tests/test_scenarios.py``, through the port: registry
  semantics, JSON round trips, cache-hitting binds and
  ``make_solver(scenario=...)``, the operator-plugin protocol (the
  Helmholtz class and its complex oracle), ``register_scenario`` of the
  solve service, the audit CLI's scenario errors, and the sweep runner.
* Every one of the 17 seed cells, run once through ``run_sweep(device=
  "cpu")``, held to the JAX package's committed
  ``experiments/scenario_sweep.json``: converged, oracle-verified,
  contract-clean, iterations within ±2 (ROADMAP C4); and the port's
  committed ``experiments/torch_scenario_sweep.json`` to that run.
* The batched and open-loop cells on one numpy block through each
  package's own ``Scenario.bind()``: per column, iterations within ±2 and
  ``max|x - x_ref| <= 1e-6`` (C4).  The sweep's columns 1..m-1 come from
  another generator in each package, so this is where the two are held to
  the same right-hand sides.
* ``HelmholtzShiftedOperator.matvec`` / ``diagonal`` against the JAX
  operator's on ``(n,)`` and ``(n, m)`` inputs at 1e-12.
"""
import json
import os
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax.numpy as jnp  # noqa: E402

import repro.scenarios as JS  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.scenarios import (OperatorSpec, Scenario,  # noqa: E402
                                   ScenarioError, build_problem,
                                   get_operator_class, get_scenario,
                                   register_operator_class,
                                   register_scenario, resolve_scenario,
                                   scenario_names)
from repro_torch.scenarios import registry as R  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_SWEEP = os.path.join(ROOT, "experiments", "scenario_sweep.json")
TORCH_SWEEP = os.path.join(ROOT, "experiments", "torch_scenario_sweep.json")
CPU = "cpu"
ITER_SLACK = 2
X_TOL = 1e-6
SUBSTRATE = {"jnp": "torch", "pallas": "cuda"}


@pytest.fixture(autouse=True)
def _hermetic_registries():
    """Roll back registrations and the built-problem cache after every
    test, and start each from an empty session cache."""
    ops = dict(R.OPERATOR_CLASSES)
    scs = OrderedDict(R.SCENARIOS)
    probs = OrderedDict(R._PROBLEMS)
    repro_torch.clear_session_cache()
    yield
    R.OPERATOR_CLASSES.clear()
    R.OPERATOR_CLASSES.update(ops)
    R.SCENARIOS.clear()
    R.SCENARIOS.update(scs)
    R._PROBLEMS.clear()
    R._PROBLEMS.update(probs)


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# ---------------------------------------------------------------------------
# serialization: JSON <-> dataclass is lossless
# ---------------------------------------------------------------------------

def test_json_round_trip_lossless_for_every_registered_scenario():
    for name in scenario_names():
        sc = get_scenario(name)
        assert Scenario.from_json(sc.to_json()) == sc
        assert Scenario.from_dict(json.loads(sc.to_json())) == sc


def test_json_round_trip_lossless_nondefault_fields():
    sc = Scenario(
        "rt", OperatorSpec.of("convection_diffusion", nx=9, peclet=2.0),
        method="ssbicgsafe2", substrate="cuda", precond="jacobi",
        tol=1e-10, maxiter=777, batch=1, binding="single",
        trace=True, tags=("a", "b"), quick=False)
    back = Scenario.from_json(sc.to_json())
    assert back == sc and back.operator.kwargs == {"nx": 9, "peclet": 2.0}


def test_from_dict_rejects_unknown_and_missing_keys():
    with pytest.raises(ScenarioError, match="unknown scenario keys"):
        Scenario.from_dict({"name": "x", "operator": {"cls": "poisson3d"},
                            "solvr": "p-bicgsafe"})
    with pytest.raises(ScenarioError, match="missing required keys"):
        Scenario.from_dict({"name": "x"})
    with pytest.raises(ScenarioError, match="JSON scalar"):
        OperatorSpec.of("poisson3d", nx=[8, 8])


# ---------------------------------------------------------------------------
# registry: conflict detection, validation messages
# ---------------------------------------------------------------------------

def test_duplicate_scenario_registration_raises():
    sc = Scenario("dup-cell", OperatorSpec.of("poisson3d", nx=6))
    assert register_scenario(sc) is sc
    # equal content: idempotent (returns the existing registration)
    assert register_scenario(
        Scenario("dup-cell", OperatorSpec.of("poisson3d", nx=6))) is sc
    with pytest.raises(ScenarioError, match="already registered"):
        register_scenario(
            Scenario("dup-cell", OperatorSpec.of("poisson3d", nx=7)))


def test_duplicate_operator_class_registration_raises():
    def build(device=None, **kw):
        return build_problem("poisson3d", device=device, **kw)
    register_operator_class("dup-op-class", build)
    register_operator_class("dup-op-class", build)   # same builder: ok
    with pytest.raises(ScenarioError, match="already registered"):
        register_operator_class("dup-op-class", lambda **kw: None)


def test_validation_names_the_valid_choices():
    with pytest.raises(ScenarioError, match="unregistered operator class"):
        register_scenario(Scenario("bad-op", OperatorSpec.of("nope")))
    with pytest.raises(ScenarioError, match="unknown precond"):
        register_scenario(Scenario(
            "bad-pc", OperatorSpec.of("poisson3d", nx=6), precond="ilu"))
    with pytest.raises(ScenarioError, match="unknown method"):
        Scenario("bad-m", OperatorSpec.of("poisson3d", nx=6),
                 method="gmres").validate()
    with pytest.raises(ScenarioError, match="p-BiCGSafe iteration only"):
        Scenario("bad-b", OperatorSpec.of("poisson3d", nx=6),
                 method="bicgstab", batch=4).validate()
    with pytest.raises(ScenarioError, match="unknown scenario"):
        get_scenario("never-registered")
    with pytest.raises(ScenarioError, match="unregistered operator class"):
        build_problem("never-registered-class", device=CPU)
    with pytest.raises(ScenarioError, match="not mesh-capable"):
        register_scenario(Scenario(
            "bad-mesh", OperatorSpec.of("hard_nonsym", n=50),
            binding="mesh"))
    # the port's substrates: the JAX package's names are refused
    with pytest.raises(ScenarioError, match="unknown substrate 'pallas'"):
        Scenario("bad-sub", OperatorSpec.of("poisson3d", nx=6),
                 substrate="pallas").validate()


# ---------------------------------------------------------------------------
# bind(): the session cache, through the scenario layer
# ---------------------------------------------------------------------------

def test_bind_hits_session_cache_no_retrace():
    sc = get_scenario("poisson-jacobi")
    s1 = sc.bind(CPU)
    _, b, _ = sc.problem(CPU)
    s1.solve(b)
    traces = s1.stats["traces"]
    assert traces >= 1
    s2 = sc.bind(CPU)                   # same content -> SAME session
    assert s2 is s1
    s2.solve(b)                         # the program is reused
    assert s1.stats["traces"] == traces


def test_make_solver_scenario_kwarg():
    sc = get_scenario("poisson-jacobi")
    assert repro_torch.make_solver(scenario="poisson-jacobi",
                                   device=CPU) is sc.bind(CPU)
    # the scenario declares everything: other arguments are a loud error
    with pytest.raises(TypeError, match="exclusive"):
        repro_torch.make_solver(scenario="poisson-jacobi", precond="jacobi",
                                device=CPU)
    with pytest.raises(TypeError, match="exclusive"):
        repro_torch.make_solver(scenario="poisson-jacobi", substrate="cuda",
                                device=CPU)
    with pytest.raises(ScenarioError, match="unknown scenario"):
        repro_torch.make_solver(scenario="never-registered", device=CPU)


def test_resolve_scenario_passthrough_validates():
    ad_hoc = Scenario("ad-hoc", OperatorSpec.of("poisson3d", nx=6))
    assert resolve_scenario(ad_hoc) is ad_hoc
    with pytest.raises(ScenarioError, match="unregistered operator"):
        resolve_scenario(Scenario("ad-hoc2", OperatorSpec.of("zzz")))


def test_built_problems_are_cached_per_spec_content():
    p1 = build_problem("convection_diffusion", nx=8, peclet=1.0, device=CPU)
    p2 = build_problem(OperatorSpec.of("convection_diffusion",
                                      peclet=1.0, nx=8), device=CPU)
    assert p1[0] is p2[0]               # param order is normalized
    assert p1[0].device == torch.device(CPU)


# ---------------------------------------------------------------------------
# the Helmholtz plugin: oracle + contracts, zero core edits
# ---------------------------------------------------------------------------

def test_helmholtz_session_verify_contracts():
    session = get_scenario("helmholtz-shifted").bind(CPU)
    reports = session.verify_contracts()
    assert reports and all(r.ok for r in reports)


def test_helmholtz_solve_and_complex_oracle():
    sc = get_scenario("helmholtz-shifted")
    plugin = get_operator_class("helmholtz_shifted")
    problem = sc.problem(CPU)
    op, b, x_true = problem
    res = sc.bind(CPU).solve(b)
    assert bool(res.converged)
    X = np_(res.x)[:, None]
    B = np_(b)[:, None]
    verdict = plugin.oracle(problem, B, X, sc.tol)
    assert verdict["ok"] and verdict["relres_complex"] < 1e-6
    assert verdict["x_err_complex"] < 1e-6
    # the oracle judges the COMPLEX system: flipping the imaginary half
    # (a real-equivalent sign bug) must fail verification
    X_bad = X.copy()
    X_bad[op.stencil.n:] *= -1.0
    assert not plugin.oracle(problem, B, X_bad, sc.tol)["ok"]


def test_helmholtz_real_equivalent_algebra():
    op, b, x_true = build_problem("helmholtz_shifted", nx=6, device=CPU)
    half = op.stencil.n
    rng = np.random.default_rng(0)
    z = rng.standard_normal(2 * half)
    y = np_(op.matvec(torch.from_numpy(z)))
    # against straight complex arithmetic
    zc = z[:half] + 1j * z[half:]
    Lr = np_(op.stencil.matvec(torch.from_numpy(z[:half])))
    Li = np_(op.stencil.matvec(torch.from_numpy(z[half:])))
    yc = (Lr + 1j * Li) - 1j * float(op.eps) * zc
    np.testing.assert_allclose(y[:half], yc.real, rtol=1e-12)
    np.testing.assert_allclose(y[half:], yc.imag, rtol=1e-12)


@pytest.mark.parametrize("m", [None, 3], ids=["vector", "block"])
def test_helmholtz_operator_matches_the_jax_operator(x64, m):
    """``matvec`` on an (n,) vector and on an (n, m) block, and
    ``diagonal``, against the JAX operator (which takes one vector: the
    block column by column), at 1e-12."""
    jop = JS.build_problem("helmholtz_shifted", nx=6, shift=0.45, eps=0.7)[0]
    op = build_problem("helmholtz_shifted", nx=6, shift=0.45, eps=0.7,
                       device=CPU)[0]
    assert op.shape == jop.shape
    rng = np.random.default_rng(11)
    z = rng.standard_normal((op.n,) if m is None else (op.n, m))
    got = np_(op.matvec(torch.from_numpy(z)))
    cols = z[:, None] if m is None else z
    want = np.stack([np.asarray(jop.matvec(jnp.asarray(cols[:, j])))
                     for j in range(cols.shape[1])], axis=1)
    want = want[:, 0] if m is None else want
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np_(op.diagonal()),
                               np.asarray(jop.diagonal()), rtol=1e-12)


# ---------------------------------------------------------------------------
# service + audit integration
# ---------------------------------------------------------------------------

def test_engine_register_scenario():
    from repro_torch.service import ServiceConfig, SolveEngine
    eng = SolveEngine(ServiceConfig(device=CPU))
    name = eng.register_scenario("poisson-jacobi")
    assert name == "poisson-jacobi"
    entry = eng.registry[name]
    _, b, x_true = get_scenario("poisson-jacobi").problem(CPU)
    rid = eng.submit(name, np_(b))
    results = {r.rid: r for r in eng.run()}
    assert results[rid].converged
    np.testing.assert_allclose(np_(results[rid].x), np_(x_true), atol=1e-6)
    assert entry.n == len(np_(b))
    assert entry.precond.name == "jacobi"
    # a second registration of the scenario is the same entry
    assert eng.register_scenario(get_scenario("poisson-jacobi")) == name
    assert len(eng.registry.entries()) == 1


def test_audit_negative_control_unregistered_class(tmp_path, capsys):
    """The audit CLI fails with a clear one-line message, not a traceback,
    when a scenario file names an unregistered operator class or an
    unknown precond."""
    from repro_torch.analysis.__main__ import main
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{
        "name": "negctl", "operator": {"cls": "no_such_class"}}]))
    rc = main(["audit", "--quick", "--no-mesh", "--device", CPU,
               "--scenarios", str(bad),
               "--out", str(tmp_path / "a.json")])
    assert rc == 2
    err = capsys.readouterr().err
    assert "error:" in err and "no_such_class" in err \
        and "registered classes" in err

    bad.write_text(json.dumps([{
        "name": "negctl2", "operator": {"cls": "poisson3d",
                                        "params": {"nx": 6}},
        "precond": "ilu"}]))
    rc = main(["audit", "--quick", "--no-mesh", "--device", CPU,
               "--scenarios", str(bad),
               "--out", str(tmp_path / "a.json")])
    assert rc == 2
    assert "unknown precond 'ilu'" in capsys.readouterr().err
    assert not (tmp_path / "a.json").exists()


# ---------------------------------------------------------------------------
# the sweep runner
# ---------------------------------------------------------------------------

def test_sweep_single_cell_artifact():
    from repro_torch.scenarios.sweep import ARTIFACT_SCHEMA, run_sweep
    art = run_sweep(only=["convdiff-baseline"], device=CPU)
    assert art["schema"] == ARTIFACT_SCHEMA \
        == "repro_torch.scenarios/scenario_sweep/v1"
    assert art["device"] == CPU
    assert art["summary"]["n_cells"] == 1
    assert art["claims"] == {"all_converged": True,
                             "all_oracle_ok": True,
                             "all_contracts_ok": True}
    (cell,) = art["cells"]
    assert cell["scenario"] == "convdiff-baseline"
    assert cell["operator"]["cls"] == "convection_diffusion"
    assert cell["oracle"]["ok"] and cell["contracts"]["ok"]


def test_sweep_unknown_selection_raises():
    from repro_torch.scenarios.sweep import run_sweep
    with pytest.raises(ScenarioError, match="unknown scenario"):
        run_sweep(only=["no-such-cell"], device=CPU)
    with pytest.raises(ScenarioError, match="matched nothing"):
        run_sweep(tags=["no-such-tag"], device=CPU)


def test_plugin_expected_outcome_deltas_are_honored():
    """A plugin's contract_overrides REPLACE the expected status for its
    cells.  bicgstab is a negative control: the default matrix expects
    'violation' for the fused-reduction contract, so its cell is clean.  A
    plugin declaring 'ok' for that contract flips the expectation and the
    same trace now counts as a deviation."""
    from repro_torch.scenarios.sweep import _check_contracts
    plain = Scenario("delta-plain-cell",
                     OperatorSpec.of("convection_diffusion", nx=6),
                     method="bicgstab")
    rec = _check_contracts(plain, plain.problem(CPU), device=CPU)
    assert rec["ok"]                    # violation expected -> no deviation

    register_operator_class(
        "delta-probe",
        lambda device=None, **kw: build_problem("convection_diffusion",
                                                nx=6, device=device),
        contract_overrides={"one_reduction_per_iteration": "ok"})
    sc = Scenario("delta-probe-cell", OperatorSpec.of("delta-probe"),
                  method="bicgstab")
    rec = _check_contracts(sc, sc.problem(CPU), device=CPU)
    assert not rec["ok"]                # plugin's delta is now violated
    assert rec["deviations"][0]["contract"] == \
        "one_reduction_per_iteration"
    assert rec["deviations"][0]["expected"] == "ok"


# ---------------------------------------------------------------------------
# the 17 seed cells against the JAX artifact
# ---------------------------------------------------------------------------

with open(JAX_SWEEP) as _f:
    JAX_CELLS = {c["scenario"]: c for c in json.load(_f)["cells"]}


@pytest.fixture(scope="module")
def cpu_sweep():
    """The full sweep through the port once, on the CPU."""
    repro_torch.clear_session_cache()
    art = repro_torch.scenarios.run_sweep(quick=False, device=CPU)
    return {c["scenario"]: c for c in art["cells"]}, art


def test_seed_names_and_specs_are_the_jax_ones():
    assert scenario_names() == list(JS.scenario_names()) == list(JAX_CELLS)
    for name in scenario_names():
        mine, theirs = get_scenario(name), JS.get_scenario(name)
        assert mine.operator.to_dict() == theirs.operator.to_dict()
        assert mine.substrate == SUBSTRATE[theirs.substrate]
        assert (mine.method, mine.precond, mine.guard, mine.recovery,
                mine.tol, mine.maxiter, mine.batch, mine.resolved_binding(),
                mine.tags, mine.quick) == \
            (theirs.method, theirs.precond, theirs.guard, theirs.recovery,
             theirs.tol, theirs.maxiter, theirs.batch,
             theirs.resolved_binding(), theirs.tags, theirs.quick)


@pytest.mark.parametrize("name", list(JAX_CELLS))
def test_seed_cell_matches_the_jax_artifact(name, cpu_sweep):
    mine, theirs = cpu_sweep[0][name], JAX_CELLS[name]
    assert mine["converged"] and mine["oracle"]["ok"]
    assert mine["contracts"]["ok"], mine["contracts"]["deviations"]
    assert (mine["n"], mine["m"], mine["binding"]) == \
        (theirs["n"], theirs["m"], theirs["binding"])
    assert abs(mine["iterations"] - theirs["iterations"]) <= ITER_SLACK


def test_committed_sweep_artifact_matches_a_fresh_run(cpu_sweep):
    from repro_torch.scenarios.sweep import ARTIFACT_SCHEMA
    with open(TORCH_SWEEP) as f:
        committed = json.load(f)
    assert committed["schema"] == ARTIFACT_SCHEMA
    assert committed["device"] == CPU and not committed["quick"]
    assert committed["claims"] == cpu_sweep[1]["claims"] == {
        "all_converged": True, "all_oracle_ok": True,
        "all_contracts_ok": True}
    assert {c["scenario"]: c["iterations"] for c in committed["cells"]} \
        == {k: c["iterations"] for k, c in cpu_sweep[0].items()}


# ---------------------------------------------------------------------------
# the batched and open-loop cells on one block, through both packages
# ---------------------------------------------------------------------------

BLOCK_CELLS = [name for name in JAX_CELLS
               if JS.get_scenario(name).resolved_binding()
               in ("batched", "open_loop")]


def _run_block(sc, solver, B):
    if sc.resolved_binding() == "open_loop":
        st = solver.init(B)
        return solver.result(solver.step_chunk(st, sc.maxiter))
    return solver.solve_many(B)


@pytest.mark.parametrize("name", BLOCK_CELLS)
def test_block_cell_matches_the_jax_solve_on_the_same_block(x64, name):
    jsc, sc = JS.get_scenario(name), get_scenario(name)
    _, jb, _ = jsc.problem()
    _, b, _ = sc.problem(CPU)
    np.testing.assert_allclose(np_(b), np.asarray(jb), rtol=1e-14)
    rng = np.random.default_rng(5)
    B = np.concatenate([np_(b)[:, None],
                        rng.standard_normal((b.shape[0], sc.batch - 1))],
                       axis=1)
    want = _run_block(jsc, jsc.bind(), jnp.asarray(B))
    got = _run_block(sc, sc.bind(CPU), torch.from_numpy(B))
    assert np_(got.converged).all() and np.asarray(want.converged).all()
    assert np.abs(np_(got.iterations).astype(int)
                  - np.asarray(want.iterations).astype(int)).max() \
        <= ITER_SLACK
    assert np.abs(np_(got.x) - np.asarray(want.x)).max() <= X_TOL
