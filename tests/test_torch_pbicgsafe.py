"""The slice as a whole: p-BiCGSafe and p-BiCGSafe-rr through
``repro_torch.make_solver(...).solve(b)`` held against the JAX package's
solves of the same systems, plus the loop's structure (one dot phase per
iteration, fed only {s, y, r, t_prev, rs}) and its chunked stopping rule.

Parity is "both converge, iterations within ±2, max|x - x_ref| <= 1e-6":
the two packages sum in different orders, which moves an iteration count
near the tolerance by 1-2 (ROADMAP C4), not bitwise histories."""
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
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import SolverConfig, SolveStatus  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core.linear_operator import (CSROperator,  # noqa: E402
                                              ELLOperator)
from repro_torch.core import pipelined_bicgsafe  # noqa: E402
from repro_torch.core.pipelined_bicgsafe import pbicgsafe_solve  # noqa: E402
from repro_torch.core.substrate import CudaSubstrate  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_sessions():
    """Each test starts from an empty session cache: a session cached by an
    earlier test would carry that test's counts in its ``stats``."""
    repro_torch.clear_session_cache()


CPU = "cpu"
ITER_SLACK = 2
X_TOL = 1e-6

#: experiments/bench_convergence.json, p-bicgsafe column (tol 1e-8)
BENCH_CONVERGENCE = {
    "convdiff_24": ("convection_diffusion", dict(nx=24, peclet=1.0), 55),
    "convdiff_32_pe2": ("convection_diffusion", dict(nx=32, peclet=2.0), 70),
    "poisson_32": ("poisson3d", dict(nx=32), 55),
    "aniso_24": ("anisotropic3d", dict(nx=24, eps=1e-2), 67),
}


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jax_result(res):
    return dict(iterations=int(res.iterations), converged=bool(res.converged),
                status=int(res.status), x=np_(res.x),
                hist=np_(res.residual_history))


def _ell_problem():
    """convection_diffusion(8) as a banded ELL operator (band 64), numpy."""
    top, b, _ = TM.convection_diffusion(8, device=CPU)
    values, cols = TM.stencil_ell_arrays(np_(top.c), 8, 8, 8)
    return values, cols, np_(b)


@functools.lru_cache(maxsize=None)
def jax_ell_solve(method):
    values, cols, b = _ell_problem()
    with enable_x64(True):
        op = jlo.ELLOperator(jnp.asarray(values), jnp.asarray(cols),
                             values.shape[0])
        # banded: the "pallas" solve reaches all three Pallas kernels
        assert jops.ell_is_banded(op)
        cfg = JConfig(rr_epoch=10, record_history=True)
        res = repro.make_solver(method, op, substrate="pallas",
                                config=cfg).solve(jnp.asarray(b))
        return _jax_result(res)


@functools.lru_cache(maxsize=None)
def jax_bench_solve(name):
    gen, kwargs, _ = BENCH_CONVERGENCE[name]
    with enable_x64(True):
        op, b, _ = getattr(JM, gen)(**kwargs)
        res = repro.make_solver("p-bicgsafe", op, substrate="jnp",
                                config=JConfig(tol=1e-8)).solve(b)
        return dict(_jax_result(res), b=np_(b))


def assert_parity(res, ref):
    assert bool(res.converged) and ref["converged"]
    assert abs(int(res.iterations) - ref["iterations"]) <= ITER_SLACK
    assert np.max(np.abs(np_(res.x) - ref["x"])) <= X_TOL
    assert int(res.status) == ref["status"] == SolveStatus.CONVERGED


@pytest.mark.parametrize("substrate", ["cuda", "torch"])
@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr"])
def test_ell_slice_matches_jax_pallas(method, substrate):
    ref = jax_ell_solve(method)
    values, cols, b = _ell_problem()
    op = repro_torch.operator_from_numpy(
        "ell", {"values": values, "cols": cols, "n": values.shape[0]},
        device=CPU, dtype=torch.float64)
    solver = repro_torch.make_solver(
        method, op, substrate=substrate, device=CPU,
        config=SolverConfig(rr_epoch=10, record_history=True))
    res = solver.solve(torch.from_numpy(b))
    assert_parity(res, ref)
    if method == "p-bicgsafe-rr":
        # rr_epoch=10: the replacement step ran several times
        assert solver.stats["rr_steps"] >= 2
    # the recorded histories agree while both are far from the tolerance
    hist, jhist = np_(res.residual_history), ref["hist"]
    assert hist.shape == jhist.shape
    np.testing.assert_allclose(hist[:10], jhist[:10], rtol=1e-9)
    assert np.isnan(hist[int(res.iterations) + 1:]).all()


@pytest.mark.parametrize("substrate", ["cuda", "torch"])
@pytest.mark.parametrize("name", sorted(BENCH_CONVERGENCE))
def test_bench_convergence_problems_match(name, substrate):
    ref = jax_bench_solve(name)
    gen, kwargs, committed = BENCH_CONVERGENCE[name]
    assert abs(ref["iterations"] - committed) <= ITER_SLACK
    op, b, _ = getattr(TM, gen)(device=CPU, **kwargs)
    np.testing.assert_allclose(np_(b), ref["b"], rtol=0, atol=1e-14)
    res = repro_torch.make_solver("p-bicgsafe", op, substrate=substrate,
                                  device=CPU).solve(ref["b"])
    assert_parity(res, ref)
    assert abs(int(res.iterations) - committed) <= ITER_SLACK


def test_residual_replacement_arrests_drift():
    """experiments/bench_rr.json on hard_sr3.0: p-BiCGSafe's true/recurred
    residual gap is 18.3, p-BiCGSafe-rr (m=50) brings it to 1.0.

    The matrix is the dense generator's, held in ELL form (its 8.4k
    nonzeros) and solved on one thread: thousands of iterations of a dense
    1200x1200 matvec would dominate this file's time."""
    dense, b, _ = TM.hard_nonsym(1200, seed=3, scale_range=3.0, device=CPU)
    rows, cols = dense.a.nonzero(as_tuple=True)
    op = ELLOperator.from_csr(CSROperator(
        dense.a[rows, cols].contiguous(), cols.to(torch.int32),
        rows.to(torch.int32), dense.shape[0]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gaps = {}
        for method, cfg in (("p-bicgsafe", SolverConfig(maxiter=10_000)),
                            ("p-bicgsafe-rr", SolverConfig(maxiter=10_000,
                                                           rr_epoch=50))):
            res = repro_torch.make_solver(method, op, substrate="torch",
                                          device=CPU, config=cfg).solve(b)
            assert bool(res.converged), method
            true = float(torch.linalg.vector_norm(b - dense.matvec(res.x))
                         / torch.linalg.vector_norm(b))
            gaps[method] = true / float(res.relres)
    finally:
        torch.set_num_threads(threads)
    assert gaps["p-bicgsafe"] > 5.0, gaps
    assert gaps["p-bicgsafe-rr"] < 1.5, gaps


class RecordingSubstrate(CudaSubstrate):
    """The "cuda" substrate, recording what each phase is fed."""

    name = "recording"

    def __init__(self):
        self.dot_calls, self.matvec_io = [], []

    def bicgsafe_dots(self, s, y, r, t_prev, rs):
        self.dot_calls.append((s, y, r, t_prev, rs))
        return super().bicgsafe_dots(s, y, r, t_prev, rs)

    def as_matvec(self, op):
        inner = super().as_matvec(op)

        def matvec(x):
            out = inner(x)
            self.matvec_io.append((x, out))
            return out
        return matvec


@pytest.mark.parametrize("chunk", [1, 16])
def test_one_dot_phase_per_iteration_never_fed_as(chunk, monkeypatch):
    monkeypatch.setattr(pipelined_bicgsafe, "CHUNK", chunk)
    op, b, _ = TM.convection_diffusion(8, device=CPU)
    ell = TM.stencil_to_ell(op)
    sub = RecordingSubstrate()
    stats = {}
    res = pbicgsafe_solve(ell, b, substrate=sub, stats=stats)
    it = int(res.iterations)
    assert bool(res.converged)
    # one dot phase per queued step: the iterations, the step that found
    # convergence, and the rest of its chunk
    assert len(sub.dot_calls) == stats["steps"]
    assert it + 1 <= stats["steps"] <= it + chunk
    if chunk == 1:
        assert stats["steps"] == it + 1
    for s, y, r, t_prev, rs in sub.dot_calls:
        # the iteration's matvec A s reads the same s the dots read ...
        As = [out for x, out in sub.matvec_io if x is s]
        assert len(As) == 1
        # ... and its result is never an operand of the dots
        assert not any(v is As[0] for v in (s, y, r, t_prev, rs))
        assert rs is sub.dot_calls[0][4]


def test_chunk_size_does_not_change_the_result(monkeypatch):
    op, b, _ = TM.convection_diffusion(10, peclet=1.0, device=CPU)
    ell = TM.stencil_to_ell(op)
    cfg = SolverConfig(record_history=True)
    runs = []
    for chunk in (1, 7, 16):
        monkeypatch.setattr(pipelined_bicgsafe, "CHUNK", chunk)
        runs.append(pbicgsafe_solve(ell, b, config=cfg, substrate="cuda"))
    for res in runs[1:]:
        assert int(res.iterations) == int(runs[0].iterations)
        assert torch.equal(res.x, runs[0].x)
        assert torch.equal(res.relres, runs[0].relres)
        assert torch.equal(res.residual_history.nan_to_num(-1),
                           runs[0].residual_history.nan_to_num(-1))


def test_maxiter_stops_exactly():
    op, b, _ = TM.convection_diffusion(8, device=CPU)
    solver = repro_torch.make_solver("p-bicgsafe", op, device=CPU)
    res = solver.solve(b, maxiter=7)
    assert int(res.iterations) == 7 and not bool(res.converged)
    assert int(res.status) == SolveStatus.MAXITER
    assert solver.stats["steps"] == 7          # no chunk runs past maxiter


def test_zero_rhs_converges_at_once():
    op, b, _ = TM.poisson3d(6, device=CPU)
    stats = {}
    res = pbicgsafe_solve(op, torch.zeros_like(b), stats=stats)
    assert int(res.iterations) == 0 and bool(res.converged)
    assert float(res.relres) == 0.0 and stats["steps"] == 0
    assert bool((res.x == 0).all())


def test_x0_and_r0_star_match_jax():
    rng = np.random.default_rng(4)
    with enable_x64(True):
        jop, jb, _ = JM.convection_diffusion(9, peclet=1.0)
        x0 = rng.standard_normal(jop.n)
        rs = np_(jb) + 0.1 * rng.standard_normal(jop.n)
        ref = _jax_result(repro.make_solver("p-bicgsafe-rr", jop).solve(
            jb, jnp.asarray(x0), r0_star=jnp.asarray(rs)))
    op, b, _ = TM.convection_diffusion(9, peclet=1.0, device=CPU)
    res = repro_torch.solve(op, b, "p-bicgsafe-rr", x0=x0, r0_star=rs,
                            device=CPU)
    assert_parity(res, ref)


@pytest.mark.parametrize("call", ["precond", "recovery", "trace", "profile",
                                  "solve_many", "on_mesh"])
def test_later_slices_raise_not_implemented(call):
    op, b, _ = TM.poisson3d(4, device=CPU)
    if call == "recovery":
        # ported: a string is not a policy, as in the JAX package
        with pytest.raises(TypeError, match="RecoveryPolicy"):
            repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                    recovery="jacobi")
        return
    if call == "precond":
        # ported: the JAX package's spec errors, an unknown name and a name
        # with a bare matvec callable to build from
        with pytest.raises(ValueError, match="unknown preconditioner"):
            repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                    precond="ilu")
        with pytest.raises(TypeError, match="operator object"):
            repro_torch.make_solver("p-bicgsafe", op.matvec, device=CPU,
                                    precond="jacobi")
        return
    with pytest.raises(NotImplementedError):
        if call in ("trace", "profile"):
            repro_torch.make_solver("p-bicgsafe", op, device=CPU).solve(
                b, **{call: True})
        elif call == "solve_many":      # ported; its trace ring is not
            repro_torch.make_solver("p-bicgsafe", op, device=CPU).solve_many(
                [b], trace=True)
        else:
            getattr(repro_torch.make_solver("p-bicgsafe", op, device=CPU),
                    call)([b])


def test_session_checks_method_and_device():
    op, _, _ = TM.poisson3d(4, device=CPU)
    with pytest.raises(ValueError, match="unknown method"):
        repro_torch.make_solver("gmres", op, device=CPU)
    with pytest.raises(ValueError, match="unknown substrate"):
        repro_torch.make_solver("p-bicgsafe", op, substrate="pallas",
                                device=CPU)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lies on"):
            repro_torch.make_solver("p-bicgsafe", op, device="cuda")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.make_solver("p-bicgsafe", op)
