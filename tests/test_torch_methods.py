"""The paper's comparison methods in the port: ssBiCGSafe2, p-BiCGStab,
GPBi-CG and CGS through ``repro_torch.make_solver(...).solve(b)``, held
against live solves of the JAX package on the same numpy inputs (fp64, CPU),
and the structure of Table 3.1 (reductions per iteration, and what each
reduction is fed).

Parity is C4's (ROADMAP): both converge, iterations within ±2 and
``max|x - x_ref| <= 1e-6``.  The port's ``"torch"`` substrate solves the
Stencil7 form of each problem, against the JAX ``"jnp"`` solve of that
form; ``"cuda"`` (on the CPU, its kernels' plain versions) solves the ELL
form, against the JAX solve of the same ELL arrays.  Three cases follow
the summation order instead (ROADMAP C13).  CGS diverges on aniso_24:
both packages must end with the same typed status at the same small
``maxiter``.  p-BiCGStab's count on aniso_24 moves by 4, and CGS's
solution on convdiff_32_pe2 by 8.6e-6, within the JAX package itself
between the two forms of the operator: there the histories are held while
rounding is still small, then the convergence, and the solution's error
against the exact one to twice the JAX solve's own."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from conftest import enable_x64  # noqa: E402
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.core import linear_operator as jlo  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro_torch import SolverConfig, SolveStatus  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core import pipelined_bicgsafe  # noqa: E402
from repro_torch.core.substrate import CudaSubstrate  # noqa: E402
from repro_torch.resilience import orthogonal_shadow  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_sessions():
    """Each test starts from an empty session cache: a session cached by an
    earlier test would carry that test's counts in its ``stats``."""
    repro_torch.clear_session_cache()


CPU = "cpu"
ITER_SLACK = 2
X_TOL = 1e-6
MAXITER = 300
NEW = ["ssbicgsafe2", "p-bicgstab", "gpbicg", "cgs"]

#: the bench_convergence quick set (benchmarks/bench_convergence.py)
PROBLEMS = {
    "convdiff_24": ("convection_diffusion", dict(nx=24, peclet=1.0)),
    "convdiff_32_pe2": ("convection_diffusion", dict(nx=32, peclet=2.0)),
    "poisson_32": ("poisson3d", dict(nx=32)),
    "aniso_24": ("anisotropic3d", dict(nx=24, eps=1e-2)),
}
#: ROADMAP C13: the cases whose outcome follows the summation order
DIVERGES = {("cgs", "aniso_24")}
ORDER_BOUND = {("p-bicgstab", "aniso_24"), ("cgs", "convdiff_32_pe2")}
#: iterations over which C13's histories still agree to 1e-6 (they part
#: at about 10x per 4 iterations from 1e-14)
HIST_AGREE = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The solves here are many small eager steps: one intra-op thread runs
    them as fast alone, and does not contend with the other test workers'
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jax_result(res):
    return dict(iterations=int(res.iterations), converged=bool(res.converged),
                status=int(res.status), x=np_(res.x), relres=float(res.relres),
                hist=np_(res.residual_history))


@functools.lru_cache(maxsize=None)
def problem(name):
    """(stencil c, (nx, ny, nz), ELL values, ELL cols, exact x, b) in numpy,
    from the port's generator (its b equals the JAX generator's, checked
    below)."""
    gen, kwargs = PROBLEMS[name]
    op, b, x_true = getattr(TM, gen)(device=CPU, **kwargs)
    values, cols = TM.stencil_ell_arrays(np_(op.c), op.nx, op.ny, op.nz)
    return (np_(op.c), (op.nx, op.ny, op.nz), values, cols, np_(x_true),
            np_(b))


def port_operator(name, form):
    c, (nx, ny, nz), values, cols, _, _ = problem(name)
    if form == "stencil7":
        return repro_torch.operator_from_numpy(
            "stencil7", {"c": c, "nx": nx, "ny": ny, "nz": nz}, device=CPU)
    return repro_torch.operator_from_numpy(
        "ell", {"values": values, "cols": cols, "n": values.shape[0]},
        device=CPU)


def jax_operator(name, form):
    gen, kwargs = PROBLEMS[name]
    if form == "stencil7":
        op, b, _ = getattr(JM, gen)(**kwargs)
        np.testing.assert_allclose(np_(b), problem(name)[-1], rtol=0,
                                   atol=1e-14)
        return op
    _, _, values, cols, _, _ = problem(name)
    return jlo.ELLOperator(jnp.asarray(values), jnp.asarray(cols),
                           values.shape[0])


@functools.lru_cache(maxsize=None)
def jax_solve(method, name, form):
    with enable_x64(True):
        res = repro.make_solver(
            method, jax_operator(name, form), substrate="jnp",
            config=JConfig(tol=1e-8, maxiter=MAXITER,
                           record_history=True)).solve(
                jnp.asarray(problem(name)[-1]))
        return _jax_result(res)


def assert_parity(res, ref):
    assert bool(res.converged) and ref["converged"]
    assert abs(int(res.iterations) - ref["iterations"]) <= ITER_SLACK, (
        int(res.iterations), ref["iterations"])
    assert np.max(np.abs(np_(res.x) - ref["x"])) <= X_TOL
    assert int(res.status) == ref["status"] == SolveStatus.CONVERGED


# -- the table -----------------------------------------------------------------

def test_solvers_table_matches_jax():
    assert set(repro_torch.core.SOLVERS) == set(repro.core.SOLVERS)
    assert len(repro_torch.core.SOLVERS) == 7
    assert repro_torch.SOLVERS is repro_torch.core.SOLVERS
    for fn in ("ssbicgsafe2_solve", "pbicgstab_solve", "gpbicg_solve",
               "cgs_solve"):
        assert fn in repro_torch.core.__all__ and hasattr(repro.core, fn)
        assert getattr(repro_torch.core, fn) in \
            repro_torch.core.SOLVERS.values()


# -- parity on the bench_convergence quick set ---------------------------------

@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("method", NEW)
def test_bench_convergence_problems_match_jax(method, name, substrate):
    form = "ell" if substrate == "cuda" else "stencil7"
    ref = jax_solve(method, name, form)
    op = port_operator(name, form)
    b = torch.from_numpy(problem(name)[-1])
    solver = repro_torch.make_solver(
        method, op, substrate=substrate, device=CPU,
        config=SolverConfig(tol=1e-8, maxiter=MAXITER, record_history=True))
    res = solver.solve(b)
    if (method, name) in DIVERGES:
        # both run to maxiter without a breakdown: the same typed status
        assert int(res.status) == ref["status"] == SolveStatus.MAXITER
        assert int(res.iterations) == ref["iterations"] == MAXITER
        assert not bool(res.converged) and not bool(res.breakdown)
        assert solver.stats["steps"] == MAXITER
        return
    if (method, name) in ORDER_BOUND:
        hist = np_(res.residual_history)
        np.testing.assert_allclose(hist[:HIST_AGREE + 1],
                                   ref["hist"][:HIST_AGREE + 1], rtol=1e-6)
        assert bool(res.converged) and ref["converged"]
        assert int(res.status) == ref["status"] == SolveStatus.CONVERGED
        x_true = problem(name)[4]
        assert np.max(np.abs(np_(res.x) - x_true)) \
            <= 2 * np.max(np.abs(ref["x"] - x_true))
        return
    assert_parity(res, ref)
    it = int(res.iterations)
    # the steps queued: the iterations, the step that found convergence
    # and the rest of its chunk
    assert it + 1 <= solver.stats["steps"] <= it + pipelined_bicgsafe.CHUNK


# -- the edges -----------------------------------------------------------------

@pytest.mark.parametrize("method", NEW)
def test_x0_and_r0_star_match_jax(method):
    rng = np.random.default_rng(4)
    with enable_x64(True):
        jop, jb, _ = JM.convection_diffusion(9, peclet=1.0)
        x0 = rng.standard_normal(jop.n)
        rs = np_(jb) + 0.1 * rng.standard_normal(jop.n)
        ref = _jax_result(repro.make_solver(method, jop).solve(
            jb, jnp.asarray(x0), r0_star=jnp.asarray(rs)))
    op, b, _ = TM.convection_diffusion(9, peclet=1.0, device=CPU)
    res = repro_torch.solve(op, b, method, x0=x0, r0_star=rs, device=CPU)
    assert_parity(res, ref)


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("method", NEW)
def test_zero_rhs_converges_at_once(method, substrate):
    op, b, _ = TM.poisson3d(6, device=CPU)
    solver = repro_torch.make_solver(method, TM.stencil_to_ell(op),
                                     substrate=substrate, device=CPU)
    res = solver.solve(torch.zeros_like(b))
    assert int(res.iterations) == 0 and bool(res.converged)
    assert not bool(res.breakdown)
    assert int(res.status) == SolveStatus.CONVERGED
    assert float(res.relres) == 0.0 and solver.stats["steps"] == 0
    assert bool((res.x == 0).all())


@pytest.mark.parametrize("method", NEW)
def test_maxiter_stops_exactly_as_jax(method):
    """Seven iterations against the JAX package's: the count, the typed
    status, x and the recorded history to 1e-9."""
    cfg = dict(tol=1e-12, maxiter=7, record_history=True)
    with enable_x64(True):
        jop, jb, _ = JM.convection_diffusion(8, peclet=1.0)
        want = _jax_result(repro.make_solver(
            method, jop, config=JConfig(**cfg)).solve(jb))
    op, b, _ = TM.convection_diffusion(8, peclet=1.0, device=CPU)
    solver = repro_torch.make_solver(method, op, device=CPU,
                                     config=SolverConfig(**cfg))
    res = solver.solve(b)
    assert int(res.iterations) == want["iterations"] == 7
    assert not bool(res.converged) and not want["converged"]
    assert int(res.status) == want["status"] == SolveStatus.MAXITER
    assert solver.stats["steps"] == 7          # no chunk runs past maxiter
    np.testing.assert_allclose(np_(res.x), want["x"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(res.residual_history), want["hist"],
                               rtol=1e-9)
    np.testing.assert_allclose(float(res.relres), want["relres"], rtol=1e-9)


@pytest.mark.parametrize("method", NEW)
def test_breakdown_stops_as_jax(method, monkeypatch):
    """A shadow residual orthogonal to r_0 breaks each method down; the
    typed status, the step and x are the JAX package's, and the steps
    queued after the breakdown (a chunk of 16) leave the state as it
    was."""
    cfg = dict(tol=1e-10, maxiter=50, breakdown_eps=1e-12)
    op, b, _ = TM.convection_diffusion(8, peclet=1.0, device=CPU)
    rs = orthogonal_shadow(b)
    with enable_x64(True):
        jop, _, _ = JM.convection_diffusion(8, peclet=1.0)
        want = _jax_result(repro.make_solver(
            method, jop, config=JConfig(**cfg)).solve(
                jnp.asarray(np_(b)), r0_star=jnp.asarray(np_(rs))))
    runs = []
    for chunk in (1, 16):
        monkeypatch.setattr(pipelined_bicgsafe, "CHUNK", chunk)
        runs.append(repro_torch.make_solver(
            method, op, device=CPU, config=SolverConfig(**cfg)).solve(
                b, r0_star=rs))
    for res in runs:
        assert bool(res.breakdown) and not bool(res.converged)
        assert int(res.status) == want["status"] == SolveStatus.BREAKDOWN
        assert int(res.iterations) == want["iterations"] < 50
        np.testing.assert_allclose(np_(res.x), want["x"], rtol=1e-9,
                                   atol=1e-12)
    assert torch.equal(runs[0].x, runs[1].x)


@pytest.mark.parametrize("method", NEW)
def test_chunk_size_does_not_change_the_result(method, monkeypatch):
    op, b, _ = TM.convection_diffusion(10, peclet=1.0, device=CPU)
    ell = TM.stencil_to_ell(op)
    cfg = SolverConfig(record_history=True, maxiter=200)
    fn = repro_torch.core.SOLVERS[method]
    runs = []
    for chunk in (1, 7, 16):
        monkeypatch.setattr(pipelined_bicgsafe, "CHUNK", chunk)
        stats = {}
        runs.append(fn(ell, b, config=cfg, substrate="cuda", stats=stats))
        assert stats["steps"] - int(runs[-1].iterations) <= chunk
    assert bool(runs[0].converged)
    for res in runs[1:]:
        assert int(res.iterations) == int(runs[0].iterations)
        assert torch.equal(res.x, runs[0].x)
        assert torch.equal(res.relres, runs[0].relres)
        assert torch.equal(res.residual_history.nan_to_num(-1),
                           runs[0].residual_history.nan_to_num(-1))


# -- preconditioned solves against the JAX package ------------------------------

def _precond_problem():
    top, b, _ = TM.convection_diffusion(10, peclet=1.0, device=CPU)
    values, cols = TM.stencil_ell_arrays(np_(top.c), 10, 10, 10)
    return values, cols, np_(b)


@functools.lru_cache(maxsize=None)
def jax_precond_solve(method, pc):
    values, cols, b = _precond_problem()
    with enable_x64(True):
        op = jlo.ELLOperator(jnp.asarray(values), jnp.asarray(cols),
                             values.shape[0])
        res = repro.make_solver(method, op, precond=pc,
                                config=JConfig(tol=1e-8, maxiter=2000)
                                ).solve(jnp.asarray(b))
        return _jax_result(res)


@pytest.mark.parametrize("pc", ["jacobi", "block_jacobi"])
@pytest.mark.parametrize("method", NEW)
def test_preconditioned_solve_matches_jax(method, pc):
    ref = jax_precond_solve(method, pc)
    values, cols, b = _precond_problem()
    op = repro_torch.operator_from_numpy(
        "ell", {"values": values, "cols": cols, "n": values.shape[0]},
        device=CPU)
    res = repro_torch.make_solver(
        method, op, precond=pc, substrate="cuda", device=CPU,
        config=SolverConfig(tol=1e-8, maxiter=2000)).solve(b)
    assert_parity(res, ref)
    # relres is the preconditioned system's; the original one's is small too
    bt = torch.from_numpy(b)
    orig = float(torch.linalg.vector_norm(bt - op.matvec(res.x))
                 / torch.linalg.vector_norm(bt))
    assert orig <= 1e-5, orig


# -- Table 3.1: reductions per iteration, and what each is fed ------------------

class RecordingSubstrate(CudaSubstrate):
    """The "cuda" substrate, recording in order every reduction phase (the
    ``dots`` of a method, the fused ``bicgsafe_dots``) and every matvec."""

    name = "recording"

    def __init__(self):
        self.log = []

    def dots(self, pairs):
        self.log.append(("dots", [t for pair in pairs for t in pair]))
        return super().dots(pairs)

    def bicgsafe_dots(self, s, y, r, t_prev, rs):
        self.log.append(("dots", [s, y, r, t_prev, rs]))
        return super().bicgsafe_dots(s, y, r, t_prev, rs)

    def as_matvec(self, op):
        inner = super().as_matvec(op)

        def matvec(x):
            out = inner(x)
            self.log.append(("matvec", (x, out)))
            return out
        return matvec


#: the paper's Table 3.1: reduction phases per iteration
REDUCTIONS = {"ssbicgsafe2": 1, "p-bicgsafe": 1, "p-bicgsafe-rr": 1,
              "bicgstab": 2, "p-bicgstab": 2, "cgs": 2, "gpbicg": 3}


def _recorded_solve(method, monkeypatch):
    monkeypatch.setattr(pipelined_bicgsafe, "CHUNK", 1)
    op, b, _ = TM.convection_diffusion(8, device=CPU)
    sub = RecordingSubstrate()
    stats = {}
    res = repro_torch.core.SOLVERS[method](
        TM.stencil_to_ell(op), b, substrate=sub, stats=stats,
        config=SolverConfig(rr_epoch=10))
    assert bool(res.converged)
    assert stats["steps"] == int(res.iterations) + 1
    return sub.log, stats["steps"]


@pytest.mark.parametrize("method", sorted(REDUCTIONS))
def test_reductions_per_iteration_follow_table_3_1(method, monkeypatch):
    log, steps = _recorded_solve(method, monkeypatch)
    phases = sum(1 for kind, _ in log if kind == "dots")
    # one set-up reduction (||r_0||, with (r0*, r_0) / (r0*, A r_0))
    assert phases == 1 + REDUCTIONS[method] * steps


def test_pbicgstab_phases_never_read_the_matvec_beside_them(monkeypatch):
    log, steps = _recorded_solve("p-bicgstab", monkeypatch)
    loop = log[next(k for k, (kind, _) in enumerate(log)
                    if kind == "dots") + 1:]
    # each step: MV #1, phase 1, MV #2, phase 2
    assert [kind for kind, _ in loop] == ["matvec", "dots"] * (2 * steps)
    for (_, (_x, out)), (_, operands) in zip(loop[0::2], loop[1::2]):
        assert not any(v is out for v in operands)


def test_ssbicgsafe2_phase_reads_the_fresh_matvec(monkeypatch):
    """The negative control: ssBiCGSafe2's one phase is fed s = A r of
    the same step, so it cannot overlap with that matvec."""
    log, steps = _recorded_solve("ssbicgsafe2", monkeypatch)
    loop = log[1:]
    # each step: MV #1 (A r), the phase, MV #2 (A u)
    assert [kind for kind, _ in loop] == ["matvec", "dots", "matvec"] * steps
    for k in range(steps):
        (_, (r, s)), (_, (s_in, _y, r_in, _t, _rs)) = loop[3 * k:3 * k + 2]
        assert s_in is s and r_in is r
