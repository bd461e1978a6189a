"""The batched multi-RHS slice: ``solve_batched``, ``solve_many`` and the
open-loop handles held against the JAX package's batched solve on its
``"jnp"`` substrate (its ``"pallas"`` batched path fails its own parity
test, ROADMAP C1), plus the loop's structure and its chunked stopping rule.

Per column, parity is "converged, iterations within ±2, max|x - x_ref| <=
1e-6" (ROADMAP C4).  Inputs are made by numpy from a seed.  Every test runs
on the ``"torch"`` and the ``"cuda"`` substrate; on the CPU the latter runs
its kernels' plain versions through the same wrappers."""
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax.numpy as jnp  # noqa: E402

from conftest import enable_x64  # noqa: E402
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.core import _common as jcommon  # noqa: E402
from repro.core import linear_operator as jlo  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.core import multirhs as jmrhs  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import SolverConfig, SolveStatus  # noqa: E402
from repro_torch.core import _common as tcommon  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core import multirhs, pipelined_bicgsafe  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.linear_operator import (CSROperator,  # noqa: E402
                                              DenseOperator, as_block_matvec)
from repro_torch.core.substrate import CudaSubstrate  # noqa: E402


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


def rhs_block(b, m, seed=3):
    """Column 0 is ``b``; the others seeded normal vectors."""
    rng = np.random.default_rng(seed)
    b = np_(b)
    return np.stack([b] + [rng.standard_normal(b.shape)
                           for _ in range(m - 1)], axis=1)


def convdiff(nx=10):
    op, b, _ = TM.convection_diffusion(nx, peclet=1.0, device=CPU)
    return TM.stencil_to_ell(op), b


@functools.lru_cache(maxsize=None)
def jax_batched(problem, m, tols=None, maxiter=2000):
    """The JAX package's batched solve on the "jnp" substrate."""
    gen, kwargs = problem
    with enable_x64(True):
        op, b, _ = getattr(JM, gen)(**dict(kwargs))
        B = rhs_block(b, m)
        res = jmrhs.solve_batched(
            op.matvec, jnp.asarray(B), config=JConfig(tol=1e-8,
                                                      maxiter=maxiter),
            substrate="jnp", tol=None if tols is None else jnp.asarray(tols))
        return dict(B=B, x=np_(res.x), iterations=np_(res.iterations),
                    converged=np_(res.converged), relres=np_(res.relres))


CONVDIFF_10 = ("convection_diffusion", (("nx", 10), ("peclet", 1.0)))
POISSON_8 = ("poisson3d", (("nx", 8),))


def assert_column_parity(res, ref):
    it, jit = np_(res.iterations), ref["iterations"]
    assert np_(res.converged).all() and ref["converged"].all()
    assert np.abs(it.astype(int) - jit).max() <= ITER_SLACK, (it, jit)
    assert np.max(np.abs(np_(res.x) - ref["x"])) <= X_TOL


# -- the pieces under the loop -------------------------------------------------

def test_per_column_matches_jax(x64):
    for value in (1e-6, [1e-4, 1e-8, 1e-10]):
        want = np_(jtypes.per_column(value, 3, jnp.float64))
        got = ttypes.per_column(value, 3, torch.float64)
        np.testing.assert_array_equal(np_(got), want)
    for bad in ([1e-8, 1e-8], np.ones((3, 1))):
        with pytest.raises(ValueError, match="per-column tol"):
            ttypes.per_column(bad, 3, torch.float64)


def test_local_dots_on_blocks_match_jax(x64):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((300, 5)), rng.standard_normal((300, 5))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = np_(jcommon.local_dots([(ja, jb), (ja, ja)]))
    got = tcommon.local_dots([(torch.from_numpy(a), torch.from_numpy(b)),
                              (torch.from_numpy(a), torch.from_numpy(a))])
    assert got.shape == (2, 5)
    np.testing.assert_allclose(np_(got), want, rtol=1e-13)


@pytest.mark.parametrize("kind", ["dense", "csr", "ell", "stencil",
                                  "callable"])
def test_block_matvec_matches_columns(kind, x64):
    """Each operator's (n, m) matvec is its (n,) matvec column by column,
    and matches JAX's vmapped lift."""
    top, _, _ = TM.convection_diffusion(5, 6, 7, peclet=1.0, device=CPU)
    ell = TM.stencil_to_ell(top)
    rows = torch.arange(ell.n)[:, None].expand(ell.cols.shape).reshape(-1)
    op = {"dense": DenseOperator(ell.matvec(torch.eye(ell.n,
                                                      dtype=torch.float64))),
          "csr": CSROperator(ell.values.reshape(-1), ell.cols.reshape(-1),
                             rows.to(torch.int32), ell.n),
          "ell": ell, "stencil": top, "callable": top.matvec}[kind]
    X = np.random.default_rng(2).standard_normal((ell.n, 4))
    got = as_block_matvec(op)(torch.from_numpy(X))
    cols = np.stack([np_(ell.matvec(torch.from_numpy(X[:, j].copy())))
                     for j in range(4)], axis=1)
    np.testing.assert_allclose(np_(got), cols, rtol=1e-13, atol=1e-13)
    jop = jlo.ELLOperator(jnp.asarray(np_(ell.values)),
                          jnp.asarray(np_(ell.cols)), ell.n)
    want = np_(jmrhs.batched_matvec(jop.matvec)(jnp.asarray(X)))
    np.testing.assert_allclose(np_(got), want, rtol=1e-13, atol=1e-13)


# -- the solve against the JAX package ------------------------------------------

@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_solve_batched_matches_jax(substrate):
    ref = jax_batched(CONVDIFF_10, 4)
    ell, _ = convdiff(10)
    res = multirhs.solve_batched(ell, torch.from_numpy(ref["B"]),
                                 config=SolverConfig(maxiter=2000),
                                 substrate=substrate)
    assert_column_parity(res, ref)
    assert res.x.shape == (ell.n, 4)
    assert (np_(res.status) == SolveStatus.CONVERGED).all()
    for j in range(4):
        x = res.x[:, j].contiguous()
        true = float(torch.linalg.vector_norm(ell.matvec(x) - res.x.new_tensor(
            ref["B"][:, j])) / np.linalg.norm(ref["B"][:, j]))
        assert true < 1e-6, (j, true)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_per_column_tol_matches_jax(substrate):
    """Each column converges against its own tolerance, as the JAX solve's
    column does (JAX test_batched_per_column_tol)."""
    tols = (1e-4, 1e-8, 1e-10)
    ref = jax_batched(POISSON_8, 3, tols)
    op, _, _ = TM.poisson3d(8, device=CPU)
    res = multirhs.solve_batched(op, torch.from_numpy(ref["B"]),
                                 config=SolverConfig(maxiter=2000),
                                 substrate=substrate, tol=list(tols))
    assert_column_parity(res, ref)
    iters, relres = np_(res.iterations), np_(res.relres)
    assert (relres <= np.asarray(tols)).all()
    assert iters[0] < iters[1] < iters[2]


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_scaled_column_matches_its_parent(substrate):
    """A 2**-20-scaled copy of b runs the same trajectory (power-of-two
    scaling is exact), so it converges in the same iteration."""
    op, b, _ = TM.poisson3d(8, device=CPU)
    rng = np.random.default_rng(0)
    B = torch.stack([b, 2.0 ** -20 * b,
                     torch.from_numpy(rng.standard_normal(b.shape[0]))], 1)
    res = multirhs.solve_batched(op, B, config=SolverConfig(maxiter=2000),
                                 substrate=substrate)
    iters = np_(res.iterations)
    assert np_(res.converged).all() and iters[1] == iters[0]
    assert np_(res.relres).max() <= 1e-8


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_zero_column_converges_at_once_beside_live_ones(substrate):
    ell, b = convdiff(8)
    B = torch.stack([b, torch.zeros_like(b), -b], 1)
    stats = {}
    res = multirhs.solve_batched(ell, B, substrate=substrate, stats=stats)
    assert np_(res.converged).all()
    assert int(res.iterations[1]) == 0 and float(res.relres[1]) == 0.0
    assert bool((res.x[:, 1] == 0).all())
    assert bool(torch.isfinite(res.x).all())
    assert bool(torch.isfinite(res.relres).all())
    assert int(res.iterations[0]) == int(res.iterations[2]) > 0
    assert torch.equal(res.x[:, 0], -res.x[:, 2])


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_x0_and_history(substrate):
    op, b, _ = TM.poisson3d(8, device=CPU)
    B = torch.from_numpy(rhs_block(b, 3))
    X0 = torch.full_like(B, 0.37)
    cfg = SolverConfig(maxiter=500, record_history=True)
    res = multirhs.solve_batched(op, B, X0, config=cfg, substrate=substrate)
    assert np_(res.converged).all()
    h = np_(res.residual_history)
    assert h.shape == (501, 3)
    for j in range(3):
        it = int(res.iterations[j])
        assert np.isfinite(h[:it + 1, j]).all()
        assert np.isnan(h[it + 1:, j]).all()
    # X0 moved the start: the true residual of the result is still small
    R = B - op.matvec(res.x)
    assert float((torch.linalg.vector_norm(R, dim=0)
                  / torch.linalg.vector_norm(B, dim=0)).max()) < 1e-6


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_bad_shapes_raise(substrate):
    op, b, _ = TM.poisson3d(6, device=CPU)
    B = torch.from_numpy(rhs_block(b, 3))
    with pytest.raises(ValueError, match="per-column tol"):
        multirhs.solve_batched(op, B, substrate=substrate, tol=[1e-8, 1e-8])
    with pytest.raises(ValueError, match=r"\(n, m\)"):
        multirhs.solve_batched(op, b, substrate=substrate)
    solver = repro_torch.make_solver("p-bicgsafe", op, substrate=substrate,
                                     device=CPU)
    with pytest.raises(ValueError, match=r"\(n, m\)"):
        solver.solve_many(b)
    with pytest.raises(ValueError, match="per-column maxiter"):
        solver.init(B, maxiter=[5, 5])


# -- the session and the open-loop handles ---------------------------------------

@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_solve_many_is_init_step_result(substrate):
    ref = jax_batched(CONVDIFF_10, 4)
    ell, _ = convdiff(10)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate=substrate,
                                     device=CPU,
                                     config=SolverConfig(maxiter=2000))
    B = torch.from_numpy(ref["B"])
    res = solver.solve_many([B[:, j] for j in range(4)])   # list of columns
    assert_column_parity(res, ref)
    steps = solver.stats["steps"]
    st = solver.init(B)
    st = solver.step_chunk(st, 2000)
    opened = solver.result(st)
    for a, b in zip(res, opened):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert solver.stats["solves"] == 1
    assert solver.stats["steps"] == 2 * steps
    # a scalar maxiter re-bounds the loop; per-column budgets stop columns
    short = solver.solve_many(B, maxiter=5)
    assert (np_(short.iterations) == 5).all()
    assert (np_(short.status) == SolveStatus.MAXITER).all()
    mixed = solver.solve_many(B, maxiter=[3, 2000, 7, 2000])
    it = np_(mixed.iterations)
    assert it[0] == 3 and it[2] == 7 and np_(mixed.converged)[[1, 3]].all()


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_splice_leaves_surviving_columns_bitwise_unchanged(substrate):
    ell, b = convdiff(8)
    B = torch.from_numpy(rhs_block(b, 4))
    B_new = torch.from_numpy(rhs_block(2 * b, 4, seed=11))
    refill = torch.tensor([False, True, False, True])
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate=substrate,
                                     device=CPU)
    st = solver.step_chunk(solver.init(B), 5)
    plain = solver.result(solver.step_chunk(st, 500))
    spliced_state = solver.splice_step(st, refill, B_new, 1e-10, 400, 500)
    spliced = solver.result(spliced_state)
    keep = ~refill
    assert torch.equal(spliced.x[:, keep], plain.x[:, keep])
    for field in ("iterations", "relres", "converged", "status"):
        assert torch.equal(getattr(spliced, field)[keep],
                           getattr(plain, field)[keep]), field
    # the fresh columns solve their own systems from their own start
    assert np_(spliced.converged).all()
    assert (np_(spliced.relres)[[1, 3]] <= 1e-10).all()
    fresh = solver.solve_many(B_new[:, refill], tol=1e-10)
    assert np.abs(np_(spliced.iterations)[[1, 3]].astype(int)
                  - np_(fresh.iterations)).max() <= ITER_SLACK
    assert int(spliced_state["i"]) > int(st["i"])      # i is kept, not reset
    assert float((spliced.x[:, refill] - fresh.x).abs().max()) <= X_TOL


def test_open_loop_handles_need_pbicgsafe():
    op, b, _ = TM.poisson3d(4, device=CPU)
    solver = repro_torch.make_solver("p-bicgsafe-rr", op, device=CPU)
    for call in ("solve_many", "init"):
        with pytest.raises(ValueError, match="p-bicgsafe"):
            getattr(solver, call)([b])


def test_later_slices_raise_not_implemented():
    op, b, _ = TM.poisson3d(4, device=CPU)
    B = torch.stack([b, b], 1)
    # blocked=True is ported: the block matvec is taken as given
    blocked = multirhs.solve_batched(op.matvec, B, blocked=True)
    plain = multirhs.solve_batched(op, B)
    assert torch.equal(blocked.x, plain.x)
    assert torch.equal(blocked.iterations, plain.iterations)
    # precond= is ported: the JAX package's spec errors
    with pytest.raises(ValueError, match="unknown preconditioner"):
        multirhs.solve_batched(op, B, precond="ilu")
    with pytest.raises(TypeError, match="operator object"):
        multirhs.solve_batched(op.matvec, B, precond="jacobi")
    # profile= is ported: the profiled block solve is the unprofiled one
    session = repro_torch.make_solver("p-bicgsafe", op, device=CPU)
    with tempfile.TemporaryDirectory() as out:
        profiled = session.solve_many(B, profile=out)
    assert torch.equal(profiled.x, plain.x)
    assert session.last_profile.phase_us["reduce"] > 0
    # the guard is ported: a guarded solve runs and types its statuses
    res = multirhs.solve_batched(op, B, config=SolverConfig(guard=True))
    assert (np_(res.status) == SolveStatus.CONVERGED).all()


# -- the loop's structure ----------------------------------------------------------

@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_chunk_size_does_not_change_the_result(substrate, monkeypatch):
    """Steps queued after every column stopped leave the state bitwise as
    it was, the global counter ``i`` included."""
    _chunk_size_invariance(substrate, monkeypatch,
                           SolverConfig(record_history=True, maxiter=300))


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_chunk_size_does_not_change_the_guarded_result(substrate,
                                                       monkeypatch):
    """The same with the guard: each guard field changes only under
    ``active`` / ``advance``, so queued steps leave it bitwise unchanged
    (a stagnation window of 1, which trips on every column, included)."""
    one = _chunk_size_invariance(
        substrate, monkeypatch,
        SolverConfig(record_history=True, maxiter=300, guard=True,
                     stagnation_window=1))
    assert set(multirhs.GUARD_FIELDS) <= set(one)
    assert (np_(one["status"]) == SolveStatus.CONVERGED).all()
    assert bool(one["stagnant"].all())
    assert bool(one["drift"].gt(0).all())


def _chunk_size_invariance(substrate, monkeypatch, cfg):
    ell, b = convdiff(8)
    B = torch.from_numpy(rhs_block(b, 3))
    states = []
    for chunk in (1, 16):
        monkeypatch.setattr(pipelined_bicgsafe, "CHUNK", chunk)
        bmv = multirhs.get_substrate(substrate).as_block_matvec(ell)
        st = multirhs.init_state(bmv, B, config=cfg, substrate=substrate,
                                 tol=[1e-6, 1e-8, 1e-10])
        states.append(multirhs.step_chunk(bmv, st, 300, config=cfg,
                                          substrate=substrate))
    one, sixteen = states
    assert set(one) == set(sixteen)
    for key in one:
        a, b = one[key], sixteen[key]
        if a.is_floating_point():
            a, b = a.nan_to_num(-1), b.nan_to_num(-1)
        assert torch.equal(a, b), key
    assert int(one["i"]) == int(one["iterations"].max()) + 1
    return one


class RecordingSubstrate(CudaSubstrate):
    """The "cuda" substrate, recording what each phase is fed."""

    name = "recording"

    def __init__(self):
        self.dot_calls, self.matvec_io = [], []

    def bicgsafe_dots(self, s, y, r, t_prev, rs):
        self.dot_calls.append((s, y, r, t_prev, rs))
        out = super().bicgsafe_dots(s, y, r, t_prev, rs)
        assert out.shape == (9, s.shape[1])
        return out

    def as_block_matvec(self, op):
        inner = super().as_block_matvec(op)

        def bmv(X):
            out = inner(X)
            self.matvec_io.append((X, out))
            return out
        return bmv


def test_one_dot_phase_per_step_never_fed_as():
    ell, b = convdiff(8)
    B = torch.from_numpy(rhs_block(b, 3))
    sub = RecordingSubstrate()
    stats = {}
    res = multirhs.solve_batched(ell, B, substrate=sub, stats=stats)
    assert np_(res.converged).all()
    assert len(sub.dot_calls) == stats["steps"]
    # 1 block matvec at init, then 2 per step (A S and A W)
    assert len(sub.matvec_io) == 1 + 2 * stats["steps"]
    for s, y, r, t_prev, rs in sub.dot_calls:
        As = [out for X, out in sub.matvec_io if X is s]
        assert len(As) == 1
        assert not any(v is As[0] for v in (s, y, r, t_prev, rs))
        assert rs is sub.dot_calls[0][4]


class RecordingGuardedSubstrate(RecordingSubstrate):
    """The recording "cuda" substrate, guarded phase."""

    def bicgsafe_dots_health(self, s, y, r, t_prev, rs, x):
        self.dot_calls.append((s, y, r, t_prev, rs, x))
        out = super(RecordingSubstrate, self).bicgsafe_dots_health(
            s, y, r, t_prev, rs, x)
        assert out.shape == (11, s.shape[1])
        return out


def test_one_guarded_dot_phase_per_step_never_fed_as():
    """The guarded (11, m) phase is still the step's one reduction, and it
    reads the previous iterate x, never the in-flight A s."""
    ell, b = convdiff(8)
    B = torch.from_numpy(rhs_block(b, 3))
    sub = RecordingGuardedSubstrate()
    stats = {}
    res = multirhs.solve_batched(ell, B, substrate=sub, stats=stats,
                                 config=SolverConfig(guard=True))
    assert (np_(res.status) == SolveStatus.CONVERGED).all()
    assert len(sub.dot_calls) == stats["steps"]
    assert len(sub.matvec_io) == 1 + 2 * stats["steps"]
    for *ops_, x in sub.dot_calls:
        As = [out for X, out in sub.matvec_io if X is ops_[0]]
        assert len(As) == 1
        assert not any(v is As[0] for v in (*ops_, x))


# -- the guard against the JAX package -------------------------------------------

GUARD_FLOAT_FIELDS = ("x", "r", "drift", "best_relres")
GUARD_EXACT_FIELDS = ("status", "drift_flag", "stall", "stagnant",
                      "replacements", "restarts", "iterations", "converged",
                      "breakdown")


@functools.lru_cache(maxsize=None)
def jax_guarded_chunk(k=12, window=0):
    """The JAX package's guarded state after ``step_chunk(..., k)`` on
    ``"jnp"`` (the port of tests/test_resilience.py's kernel-parity test:
    nonsym_dense(64), B = [b, 2b])."""
    with enable_x64(True):
        op, b, _ = JM.nonsym_dense(64)
        B = jnp.stack([b, 2.0 * b], axis=1)
        cfg = JConfig(guard=True, stagnation_window=window)
        bmv = jmrhs.batched_matvec(op.matvec)
        st = jmrhs.step_chunk(bmv, jmrhs.init_state(bmv, B, config=cfg),
                              k, config=cfg, substrate="jnp")
        return np.asarray(op.a), np_(B), {key: np_(v) for key, v in
                                          st.items()}


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_guarded_step_chunk_matches_jax(substrate):
    a, B, want = jax_guarded_chunk()
    op = DenseOperator(torch.from_numpy(a.copy()))
    bmv = as_block_matvec(op)
    cfg = SolverConfig(guard=True)
    st = multirhs.init_state(bmv, torch.from_numpy(B), config=cfg,
                             substrate=substrate)
    got = multirhs.step_chunk(bmv, st, 12, config=cfg, substrate=substrate)
    assert set(want) == set(got)
    for key in GUARD_FLOAT_FIELDS:
        np.testing.assert_allclose(np_(got[key]), want[key], rtol=1e-10,
                                   atol=1e-12, err_msg=key)
    for key in GUARD_EXACT_FIELDS:
        np.testing.assert_array_equal(np_(got[key]), want[key], err_msg=key)
    assert (np_(got["iterations"]) == 12).all()
    assert (np_(got["status"]) == SolveStatus.RUNNING).all()
    assert np_(got["drift"]).min() > 0


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_guarded_typed_statuses_match_jax(substrate):
    """A NaN written into column 1's residual: the (11, m) probe types it
    NONFINITE and freezes it on the next step, on both sides; a column
    whose budget runs out is stamped MAXITER."""
    a, B, _ = jax_guarded_chunk()
    with enable_x64(True):
        op = jlo.DenseOperator(jnp.asarray(a))
        bmv = jmrhs.batched_matvec(op.matvec)
        cfg = JConfig(guard=True)
        st = jmrhs.init_state(bmv, jnp.asarray(B), config=cfg,
                              maxiter=jnp.asarray([5, 400], jnp.int32))
        st = jmrhs.step_chunk(bmv, st, 3, config=cfg)
        st = dict(st, r=st["r"].at[:, 1].set(jnp.nan))
        st = jmrhs.step_chunk(bmv, st, 4, config=cfg)
        want = {k: np_(v) for k, v in st.items()}
        want_res = np_(jmrhs.result_from_state(st).status)
    top = DenseOperator(torch.from_numpy(a.copy()))
    tbmv = as_block_matvec(top)
    tcfg = SolverConfig(guard=True)
    got = multirhs.init_state(tbmv, torch.from_numpy(B), config=tcfg,
                              substrate=substrate, maxiter=[5, 400])
    got = multirhs.step_chunk(tbmv, got, 3, config=tcfg, substrate=substrate)
    got["r"] = got["r"].clone()
    got["r"][:, 1] = float("nan")
    got = multirhs.step_chunk(tbmv, got, 4, config=tcfg, substrate=substrate)
    for key in GUARD_EXACT_FIELDS:
        np.testing.assert_array_equal(np_(got[key]), want[key], err_msg=key)
    assert np_(got["status"]).tolist() == [SolveStatus.MAXITER,
                                           SolveStatus.NONFINITE]
    res = multirhs.result_from_state(got)
    assert np_(res.status).tolist() == want_res.tolist()
    assert bool(torch.isfinite(got["x"]).all())     # NaN never advanced


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_splice_resets_the_guard_fields(substrate):
    ell, b = convdiff(8)
    B = torch.from_numpy(rhs_block(b, 3))
    solver = repro_torch.make_solver(
        "p-bicgsafe", ell, substrate=substrate, device=CPU,
        config=SolverConfig(guard=True, stagnation_window=2))
    st = solver.step_chunk(solver.init(B), 6)
    st = dict(st, replacements=st["replacements"] + 1,
              restarts=st["restarts"] + 2)
    refill = torch.tensor([False, True, False])
    out = solver.splice(st, refill, 2 * B)
    fresh = multirhs._guard_init(3, torch.float64,
                                 torch.zeros(3, dtype=torch.bool))
    for key in multirhs.GUARD_FIELDS:
        assert torch.equal(out[key][1], fresh[key][1]), key
        assert torch.equal(out[key][[0, 2]], st[key][[0, 2]]), key
    assert float(st["drift"][1]) > 0 and int(st["restarts"][1]) == 2
    # a zero column spliced in is typed CONVERGED at t=0, as init types it
    zero = solver.splice(st, refill, torch.zeros_like(B))
    assert int(zero["status"][1]) == SolveStatus.CONVERGED
    with enable_x64(True):
        jst = jmrhs.splice_columns(
            lambda X: X, {k: jnp.asarray(np_(v)) for k, v in st.items()},
            jnp.asarray(np_(refill)), jnp.zeros((B.shape[0], 3)))
    for key in multirhs.GUARD_FIELDS:
        np.testing.assert_array_equal(np_(zero[key]), np_(jst[key]),
                                      err_msg=key)
