"""The guarded slice: the recovery driver (``make_solver(recovery=...)``,
:mod:`repro_torch.resilience`) and BiCGStab, its method fallback, held
against the JAX package on the same numpy inputs.

Each recovery scenario of ``tests/test_resilience.py`` (NaN restart, typed
NONFINITE, BREAKDOWN_RHO restart, typed breakdown, BiCGStab fallback,
kernel failure -> ``"torch"``, failure without fallback, drift-triggered
replacement, stagnation) runs through both packages: the same typed status,
the same ``events`` (event, chunk, columns), solutions within 1e-6 and
iterations within ±2 (ROADMAP C4).  The port runs on its ``"torch"`` and
``"cuda"`` substrates (on the CPU the latter runs its kernels' plain
versions); the JAX package on ``"jnp"``, or ``"pallas"`` where its test
degrades from it."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from conftest import enable_x64  # noqa: E402
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.core.bicgstab import bicgstab_solve as jbicgstab  # noqa: E402
from repro.resilience import ChunkFaultInjector as JInjector  # noqa: E402
from repro.resilience import RecoveryPolicy as JPolicy  # noqa: E402
from repro.resilience import inject as jinject  # noqa: E402
from repro_torch import SolverConfig, SolveStatus  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core.bicgstab import bicgstab_solve  # noqa: E402
from repro_torch.core.linear_operator import DenseOperator  # noqa: E402
from repro_torch.resilience import (ChunkFaultInjector,  # noqa: E402
                                    GuardedSolver, RecoveryPolicy,
                                    SimulatedKernelFailure, nan_columns,
                                    near_singular_dense, orthogonal_shadow)


@pytest.fixture(autouse=True)
def fresh_sessions():
    """Each test starts from an empty session cache: a session cached by an
    earlier test would carry that test's counts in its ``stats``."""
    repro_torch.clear_session_cache()


CPU = "cpu"
ITER_SLACK = 2
X_TOL = 1e-6
SUBSTRATES = ["torch", "cuda"]


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@functools.lru_cache(maxsize=None)
def problem(kind="normalized", n=64):
    """``(A, b)`` in numpy: the JAX package's ``nonsym_dense`` with a unit
    rhs (its recovery scenarios anchor tolerances to ||b||), or its
    near-singular operator with a normalized ones rhs."""
    with enable_x64(True):
        if kind == "normalized":
            op, b, _ = JM.nonsym_dense(n)
            a, b = np.array(op.a), np_(b)
        else:
            a = np.array(jinject.near_singular_dense(n, sigma_min=kind).a)
            b = np.ones(n)
    return a, b / np.linalg.norm(b)


def events_of(events):
    """An ``events`` log with the substrate names and error texts left
    out (they differ between the packages by design)."""
    out = []
    for e in events:
        e = dict(e)
        detail = e.pop("detail", None)
        if detail is not None:
            e["to"] = {"jnp": "torch", "pallas": "cuda"}.get(detail["to"],
                                                             detail["to"])
        out.append(e)
    return out


def run_jax(a, rhs, policy_kw, cfg_kw, *, substrate="jnp", inject=None,
            single=True, r0_star=None):
    with enable_x64(True):
        gs = repro.make_solver("p-bicgsafe", repro.core.DenseOperator(
            jnp.asarray(a)), substrate=substrate, config=JConfig(**cfg_kw),
            recovery=JPolicy(**policy_kw))
        gs.inject = None if inject is None else JInjector(**inject)
        rs = None if r0_star is None else jnp.asarray(r0_star)
        res = (gs.solve(jnp.asarray(rhs), r0_star=rs) if single
               else gs.solve_many(jnp.asarray(rhs)))
        return dict(x=np_(res.x), iterations=np_(res.iterations),
                    status=np_(res.status), converged=np_(res.converged),
                    breakdown=np_(res.breakdown), relres=np_(res.relres),
                    events=events_of(gs.events),
                    active=gs._active.sub.name)


def run_port(a, rhs, policy_kw, cfg_kw, *, substrate="torch", inject=None,
             single=True, r0_star=None):
    gs = repro_torch.make_solver("p-bicgsafe", DenseOperator(
        torch.from_numpy(a)), substrate=substrate, device=CPU,
        config=SolverConfig(**cfg_kw), recovery=RecoveryPolicy(**policy_kw))
    gs.inject = None if inject is None else ChunkFaultInjector(**inject)
    rhs = torch.from_numpy(rhs)
    res = (gs.solve(rhs, r0_star=r0_star) if single else gs.solve_many(rhs))
    return gs, res


def assert_same_outcome(gs, res, ref):
    """Typed status and events exactly; iterations within ±2; x within
    1e-6; x finite."""
    assert np_(res.status).tolist() == ref["status"].tolist()
    assert np_(res.converged).tolist() == ref["converged"].tolist()
    assert events_of(gs.events) == ref["events"]
    it = np_(res.iterations).astype(int)
    assert np.abs(it - ref["iterations"]).max() <= ITER_SLACK, (
        it, ref["iterations"])
    x = np_(res.x)
    assert np.isfinite(x).all()
    assert np.max(np.abs(x - ref["x"])) <= X_TOL


# -- the policy and the session ------------------------------------------------

def test_policy_validation_matches_jax():
    assert [f.name for f in dataclasses.fields(RecoveryPolicy)] \
        == [f.name for f in dataclasses.fields(JPolicy)]
    assert RecoveryPolicy() == RecoveryPolicy(**vars(JPolicy()))
    for bad in (dict(chunk=0), dict(method_fallback="not-a-method"),
                dict(max_restarts=-1), dict(max_replacements=-1),
                dict(max_retries=-1)):
        with pytest.raises(ValueError):
            RecoveryPolicy(**bad)
    assert RecoveryPolicy(method_fallback=None).method_fallback is None


@pytest.mark.parametrize("field,value", [("max_retries", 3),
                                         ("retry_backoff_s", 0.5),
                                         ("retry_backoff_cap_s", 2.0)])
def test_policy_refuses_unported_service_retries(field, value):
    """The service's retry fields exist for parity with the JAX policy,
    but nothing in the port reads them: setting one raises."""
    JPolicy(**{field: value})                    # valid in the JAX package
    with pytest.raises(NotImplementedError, match=field):
        RecoveryPolicy(**{field: value})


def test_make_solver_recovery_returns_guarded():
    op, _, _ = TM.nonsym_dense(32, device=CPU)
    gs = repro_torch.make_solver("p-bicgsafe", op, device=CPU, recovery=True)
    assert isinstance(gs, GuardedSolver)
    assert gs.session.config.guard and gs.config.guard
    assert gs.policy == RecoveryPolicy()
    pol = RecoveryPolicy(stagnation_window=7, drift_scale=0.5)
    gs = repro_torch.make_solver("p-bicgsafe", op, device=CPU, recovery=pol)
    assert gs.config.stagnation_window == 7 and gs.config.drift_scale == 0.5
    plain = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                    recovery=False)
    assert isinstance(plain, repro_torch.LinearSolver)
    for bad in ("yes", "jacobi", 1):
        with pytest.raises(TypeError, match="RecoveryPolicy"):
            repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                    recovery=bad)


def test_guarded_solver_rejects_wrong_sessions():
    op, _, _ = TM.nonsym_dense(32, device=CPU)
    with pytest.raises(ValueError, match="guarded session"):
        GuardedSolver(repro_torch.make_solver("p-bicgsafe", op, device=CPU))
    with pytest.raises(ValueError, match="bicgstab"):
        GuardedSolver(repro_torch.make_solver(
            "bicgstab", op, device=CPU, config=SolverConfig(guard=True)))


def test_injection_helpers():
    st = {"r": torch.ones(5, 3, dtype=torch.float64)}
    out = nan_columns(st, [1])
    assert torch.isnan(out["r"][:, 1]).all()
    assert bool(torch.isfinite(out["r"][:, [0, 2]]).all())
    assert bool(torch.isfinite(st["r"]).all())          # not in place
    inj = ChunkFaultInjector(nan_at={2: (0,)}, fail_at=(1,))
    assert inj(0, st) is st
    with pytest.raises(SimulatedKernelFailure):
        inj(1, st)
    assert inj(1, st) is st                             # fires once
    assert torch.isnan(inj(2, st)["r"][:, 0]).all()
    assert inj.fired == [("kernel_failure", 1), ("nan", 2, (0,))]
    with enable_x64(True):
        want = np_(jinject.near_singular_dense(24, sigma_min=1e-10).a)
        r0 = np.random.default_rng(0).standard_normal(24)
        jshadow = np_(jinject.orthogonal_shadow(jnp.asarray(r0)))
    got = near_singular_dense(24, sigma_min=1e-10, device=CPU)
    np.testing.assert_array_equal(np_(got.a), want)     # bitwise
    shadow = np_(orthogonal_shadow(torch.from_numpy(r0)))
    np.testing.assert_allclose(shadow, jshadow, rtol=1e-13, atol=1e-14)
    assert abs(shadow @ r0) <= 1e-12 * np.linalg.norm(r0)


# -- the recovery scenarios of tests/test_resilience.py ---------------------------

@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_clean_guarded_solve_is_the_unguarded_one(substrate):
    a, b = problem()
    B = np.stack([b, 0.5 * b, b + 1.0], axis=1)
    cfg = dict(tol=1e-10, maxiter=400)
    gs, res = run_port(a, B, {}, cfg, substrate=substrate, single=False)
    plain = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(torch.from_numpy(a)), device=CPU,
        substrate=substrate, config=SolverConfig(**cfg)).solve_many(
            torch.from_numpy(B))
    assert gs.events == []
    assert torch.equal(res.x, plain.x)
    assert torch.equal(res.iterations, plain.iterations)
    assert (np_(res.status) == SolveStatus.CONVERGED).all()
    ref = run_jax(a, B, {}, cfg, single=False)
    assert_same_outcome(gs, res, ref)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_nan_injection_restart_recovers(substrate):
    a, b = problem()
    B = np.stack([b, 0.7 * b], axis=1)
    cfg = dict(tol=1e-8, maxiter=400)
    kw = dict(policy_kw=dict(chunk=8), cfg_kw=cfg,
              inject=dict(nan_at={1: (0,)}), single=False)
    ref = run_jax(a, B, **kw)
    gs, res = run_port(a, B, substrate=substrate, **kw)
    assert gs.inject.fired == [("nan", 1, (0,))]
    assert any(e["event"] == "restart" for e in gs.events)
    assert_same_outcome(gs, res, ref)
    assert (np_(res.status) == SolveStatus.CONVERGED).all()
    clean = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(torch.from_numpy(a)), device=CPU,
        config=SolverConfig(**cfg)).solve_many(torch.from_numpy(B))
    np.testing.assert_allclose(np_(res.x), np_(clean.x), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_nan_without_recovery_is_typed_failure(substrate):
    a, b = problem()
    kw = dict(policy_kw=dict(chunk=8, max_restarts=0, method_fallback=None),
              cfg_kw=dict(tol=1e-8, maxiter=200),
              inject=dict(nan_at={1: (0,)}))
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate, **kw)
    assert SolveStatus(int(res.status)) == SolveStatus.NONFINITE
    assert not bool(res.converged)
    assert_same_outcome(gs, res, ref)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_breakdown_restart_recovers(substrate):
    a, b = problem()
    shadow = np_(orthogonal_shadow(torch.from_numpy(b)))
    kw = dict(policy_kw=dict(chunk=16, method_fallback=None),
              cfg_kw=dict(tol=1e-2, maxiter=300, breakdown_eps=1e-12),
              r0_star=shadow)
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate,
                       **dict(kw, r0_star=torch.from_numpy(shadow)))
    assert any(e["event"] == "restart" for e in gs.events)
    assert SolveStatus(int(res.status)) == SolveStatus.CONVERGED
    x = np_(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) <= 1e-2 * 1.01
    assert_same_outcome(gs, res, ref)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_breakdown_without_recovery_is_typed(substrate):
    a, b = problem()
    shadow = np_(orthogonal_shadow(torch.from_numpy(b)))
    kw = dict(policy_kw=dict(chunk=16, max_restarts=0, method_fallback=None),
              cfg_kw=dict(tol=1e-2, maxiter=300, breakdown_eps=1e-12),
              r0_star=shadow)
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate,
                       **dict(kw, r0_star=torch.from_numpy(shadow)))
    assert SolveStatus(int(res.status)) == SolveStatus.BREAKDOWN_RHO
    assert bool(res.breakdown)
    assert_same_outcome(gs, res, ref)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_method_fallback_rescues_exhausted_column(substrate):
    a, b = problem()
    shadow = np_(orthogonal_shadow(torch.from_numpy(b)))
    kw = dict(policy_kw=dict(chunk=16, max_restarts=0,
                             method_fallback="bicgstab"),
              cfg_kw=dict(tol=1e-2, maxiter=300, breakdown_eps=1e-12),
              r0_star=shadow)
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate,
                       **dict(kw, r0_star=torch.from_numpy(shadow)))
    fb = [e for e in gs.events if e["event"] == "method_fallback"]
    assert fb and fb[0]["method"] == "bicgstab"
    assert fb[0]["from_status"] == "BREAKDOWN_RHO" and fb[0]["converged"]
    assert SolveStatus(int(res.status)) == SolveStatus.CONVERGED
    assert_same_outcome(gs, res, ref)


def test_policy_takes_every_method_as_fallback():
    """Every name of the port's SOLVERS, the JAX package's seven, is a
    fallback both packages accept; another name is refused by both."""
    assert set(repro_torch.SOLVERS) == set(repro.SOLVERS)
    for method in repro_torch.SOLVERS:
        assert RecoveryPolicy(method_fallback=method).method_fallback \
            == JPolicy(method_fallback=method).method_fallback == method
    for bad in ("gmres", "P-BiCGStab", ""):
        with pytest.raises(ValueError, match="method_fallback"):
            RecoveryPolicy(method_fallback=bad)
        with pytest.raises(ValueError, match="method_fallback"):
            JPolicy(method_fallback=bad)


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("method", ["ssbicgsafe2", "p-bicgstab", "gpbicg",
                                    "cgs"])
def test_each_method_fallback_matches_jax(method, substrate):
    """The scenario of test_method_fallback_rescues_exhausted_column with
    each of the paper's comparison methods as the fallback: the typed
    outcome and the ``method_fallback`` event as the JAX package's."""
    a, b = problem()
    shadow = np_(orthogonal_shadow(torch.from_numpy(b)))
    kw = dict(policy_kw=dict(chunk=16, max_restarts=0,
                             method_fallback=method),
              cfg_kw=dict(tol=1e-2, maxiter=300, breakdown_eps=1e-12),
              r0_star=shadow)
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate,
                       **dict(kw, r0_star=torch.from_numpy(shadow)))
    fb = [e for e in gs.events if e["event"] == "method_fallback"]
    assert len(fb) == 1 and fb[0]["method"] == method
    assert fb[0]["from_status"] == "BREAKDOWN_RHO"
    assert_same_outcome(gs, res, ref)


def test_kernel_failure_degrades_substrate():
    """A kernel failure on ``"cuda"`` rebuilds the session on ``"torch"``
    on the same device and finishes from the same state, as the JAX
    package degrades ``"pallas"`` to ``"jnp"``."""
    a, b = problem()
    kw = dict(policy_kw=dict(chunk=8), cfg_kw=dict(tol=1e-8, maxiter=400),
              inject=dict(fail_at=(1,)))
    ref = run_jax(a, b, substrate="pallas", **kw)
    gs, res = run_port(a, b, substrate="cuda", **kw)
    deg = [e for e in gs.events if e["event"] == "substrate_degraded"]
    assert deg and deg[0]["detail"]["to"] == "torch"
    assert "injected kernel failure" in deg[0]["detail"]["error"]
    assert gs._active.sub.name == "torch" and ref["active"] == "jnp"
    assert gs._active.device == gs.session.device
    assert gs._active.stats is gs.stats        # one set of counters
    assert bool(res.converged)
    assert_same_outcome(gs, res, ref)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_kernel_failure_without_fallback_raises(substrate):
    a, b = problem()
    gs = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(torch.from_numpy(a)), device=CPU,
        substrate=substrate, config=SolverConfig(tol=1e-8, maxiter=100),
        recovery=RecoveryPolicy(substrate_fallback=False))
    gs.inject = ChunkFaultInjector(fail_at=(0,))
    with pytest.raises(SimulatedKernelFailure):
        gs.solve(torch.from_numpy(b))
    assert gs.events == []


def test_real_failure_on_torch_is_not_degraded():
    """A RuntimeError that is not simulated, on ``"torch"``, has nowhere
    lower to go: it is raised, not swallowed."""
    a, b = problem()
    gs = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(torch.from_numpy(a)), device=CPU,
        config=SolverConfig(tol=1e-8, maxiter=100), recovery=True)

    def boom(ci, st):
        raise RuntimeError("device lost")
    gs.inject = boom
    with pytest.raises(RuntimeError, match="device lost"):
        gs.solve(torch.from_numpy(b))


@pytest.mark.parametrize("error", ["nvcc failed (exit 1)",
                                   "CUDA error 700: an illegal memory access"])
def test_real_failure_on_cuda_is_raised(error):
    """A real failure on ``"cuda"`` (a failed build or launch) is raised,
    even with substrate degradation on: the plain version never stands in
    for a kernel; only a SimulatedKernelFailure degrades."""
    a, b = problem()
    gs = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(torch.from_numpy(a)), device=CPU,
        substrate="cuda", config=SolverConfig(tol=1e-8, maxiter=100),
        recovery=True)
    assert gs.policy.substrate_fallback

    def boom(ci, st):
        raise RuntimeError(error)
    gs.inject = boom
    with pytest.raises(RuntimeError, match=error.split(" (")[0]):
        gs.solve(torch.from_numpy(b))
    assert gs.events == []
    assert gs._active is gs.session and gs._active.sub.name == "cuda"


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_drift_trigger_replaces_residual(substrate):
    a, b = problem()
    kw = dict(policy_kw=dict(chunk=8, drift_scale=1e-12),
              cfg_kw=dict(tol=1e-8, maxiter=400))
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate, **kw)
    rep = [e for e in gs.events if e["event"] == "replace"]
    assert rep and all(e["columns"] == [0] for e in rep)
    assert bool(res.converged)
    assert_same_outcome(gs, res, ref)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_stagnation_gives_up_typed(substrate):
    """The near-singular operator (sigma_min 1e-14) amplifies the two
    packages' different summation orders until the drift bound, which is
    set at ``tol * ||r_0||`` = 1e-13 here, trips in different chunks: the
    typed outcome and the kinds of action agree, their chunks need not."""
    a, b = problem(1e-14, 48)
    kw = dict(policy_kw=dict(chunk=32, stagnation_window=64, max_restarts=1,
                             method_fallback=None),
              cfg_kw=dict(tol=1e-13, maxiter=4000))
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate, **kw)
    sts = SolveStatus(int(res.status))
    assert sts.is_failure or bool(res.converged)
    assert np.isfinite(np_(res.x)).all()
    if sts == SolveStatus.STAGNATION:
        assert any(e["event"] == "stagnation_giveup" for e in gs.events)
    assert int(res.status) == int(ref["status"])
    kinds = {e["event"] for e in gs.events}
    assert kinds == {e["event"] for e in ref["events"]}
    assert gs.events[-1] == dict(gs.events[-1], event="stagnation_giveup",
                                 columns=[0])
    assert sum(e["event"] == "restart" for e in gs.events) == 1


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_near_singular_never_silent_nan(substrate):
    """As for stagnation, the near-singular operator moves the chunk of
    each drift replacement between the packages; the outcome agrees."""
    a, b = problem(1e-15, 48)
    b = b * np.linalg.norm(np.ones(48))          # the JAX test's ones rhs
    kw = dict(policy_kw=dict(max_restarts=0, method_fallback=None, chunk=16),
              cfg_kw=dict(tol=1e-12, maxiter=500, breakdown_eps=1e-12))
    ref = run_jax(a, b, **kw)
    gs, res = run_port(a, b, substrate=substrate, **kw)
    assert np.isfinite(np_(res.x)).all()
    assert SolveStatus(int(res.status)).is_terminal
    assert int(res.status) == int(ref["status"])
    assert [e["event"] for e in gs.events] == [e["event"]
                                               for e in ref["events"]]


# -- BiCGStab, the method fallback ---------------------------------------------------

#: experiments/bench_convergence.json's problems (tol 1e-8)
BENCH_PROBLEMS = {
    "convdiff_24": ("convection_diffusion", dict(nx=24, peclet=1.0)),
    "convdiff_32_pe2": ("convection_diffusion", dict(nx=32, peclet=2.0)),
    "poisson_32": ("poisson3d", dict(nx=32)),
    "aniso_24": ("anisotropic3d", dict(nx=24, eps=1e-2)),
}


@functools.lru_cache(maxsize=None)
def jax_bicgstab(name):
    gen, kwargs = BENCH_PROBLEMS[name]
    with enable_x64(True):
        op, b, _ = getattr(JM, gen)(**kwargs)
        res = jbicgstab(op.matvec, b, config=JConfig(tol=1e-8,
                                                     maxiter=2000))
        return dict(b=np_(b), x=np_(res.x), iterations=int(res.iterations),
                    converged=bool(res.converged), status=int(res.status))


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("name", sorted(BENCH_PROBLEMS))
def test_bicgstab_matches_jax_on_bench_problems(name, substrate):
    ref = jax_bicgstab(name)
    gen, kwargs = BENCH_PROBLEMS[name]
    op, b, _ = getattr(TM, gen)(device=CPU, **kwargs)
    np.testing.assert_allclose(np_(b), ref["b"], rtol=0, atol=1e-14)
    solver = repro_torch.make_solver(
        "bicgstab", op, substrate=substrate, device=CPU,
        config=SolverConfig(tol=1e-8, maxiter=2000))
    res = solver.solve(ref["b"])
    assert bool(res.converged) and ref["converged"]
    assert abs(int(res.iterations) - ref["iterations"]) <= ITER_SLACK
    assert np.max(np.abs(np_(res.x) - ref["x"])) <= X_TOL
    assert int(res.status) == ref["status"] == SolveStatus.CONVERGED
    assert solver.stats["steps"] >= int(res.iterations)


def test_bicgstab_edges_match_jax():
    """Zero rhs, maxiter, the history and an x0 / r0* against the JAX
    package's BiCGStab."""
    a, b = problem()
    op = DenseOperator(torch.from_numpy(a))
    zero = bicgstab_solve(op, torch.zeros(64, dtype=torch.float64))
    assert bool(zero.converged) and int(zero.iterations) == 0
    assert float(zero.relres) == 0.0 and not bool(zero.x.any())
    cfg = dict(tol=1e-10, maxiter=7, record_history=True)
    x0 = np.random.default_rng(4).standard_normal(64)
    rs = np.random.default_rng(5).standard_normal(64)
    with enable_x64(True):
        jres = jbicgstab(repro.core.DenseOperator(jnp.asarray(a)).matvec,
                         jnp.asarray(b), jnp.asarray(x0),
                         config=JConfig(**cfg), r0_star=jnp.asarray(rs))
        want = {k: np_(getattr(jres, k)) for k in
                ("x", "iterations", "relres", "converged",
                 "residual_history", "status")}
    res = bicgstab_solve(op, torch.from_numpy(b), torch.from_numpy(x0),
                         config=SolverConfig(**cfg),
                         r0_star=torch.from_numpy(rs))
    assert int(res.iterations) == int(want["iterations"]) == 7
    assert bool(res.converged) == bool(want["converged"])
    assert int(res.status) == int(want["status"]) == SolveStatus.MAXITER
    np.testing.assert_allclose(np_(res.x), want["x"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(res.residual_history),
                               want["residual_history"], rtol=1e-9)
    np.testing.assert_allclose(float(res.relres), float(want["relres"]),
                               rtol=1e-9)
