"""The port's session layer against the JAX package's: the content-keyed
session cache, the memoized programs and the fingerprints
(``repro_torch.api`` beside ``repro.api``).

Each test runs one sequence of calls through both packages on the same
seeded numpy content and asserts the same pattern of cache hits and misses
and the same ``traces`` counts; where a sequence solves, the results are
held to each other with C4's tolerance (ROADMAP: iterations within 2,
``max|x - x_ref| <= 1e-6``).  The JAX package's bar against serving a
session for mutated content is immutability (a writeable numpy leaf is
never cached); the port's is the tensor's version counter (ROADMAP C15):
both must refuse the stale session.  The last tests pin what the port's
programs owe the caller on the CPU: a cached session's result is a fresh
session's, bit for bit, and ``step_chunk`` leaves its input and every
state it returned before as they were.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from conftest import enable_x64  # noqa: F401,E402  (x64 fixture)
from repro import api as japi  # noqa: E402
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.core import linear_operator as jlo  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import SolverConfig  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402

CPU = "cpu"
ITER_SLACK = 2
X_TOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_caches():
    """Both packages' session caches start empty: a session cached by an
    earlier test would carry its counts into this one."""
    japi.clear_session_cache()
    tapi.clear_session_cache()
    yield
    japi.clear_session_cache()
    tapi.clear_session_cache()


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def poisson(nx):
    """(c, (nx, ny, nz), b) of the 7-point Laplacian, in numpy."""
    op, b, _ = TM.poisson3d(nx, device=CPU)
    return np_(op.c), (op.nx, op.ny, op.nz), np_(b)


class Jax:
    """The JAX package's side of a sequence (fresh objects per call)."""

    substrates = ("jnp", "pallas")

    @staticmethod
    def op(nx):
        c, (x, y, z), _ = poisson(nx)
        return jlo.Stencil7Operator(jnp.asarray(c), x, y, z)

    @staticmethod
    def vec(a):
        return jnp.asarray(a)

    @staticmethod
    def make(method, op, **kw):
        if "config" in kw:
            kw["config"] = JConfig(**kw["config"])
        return repro.make_solver(method, op, **kw)

    @staticmethod
    def solve(A, b, **kw):
        return repro.solve(A, b, **kw)

    @staticmethod
    def dense(a):
        return repro.DenseOperator(jnp.asarray(a))


class Port:
    """The port's side (the CPU, where the kernels run their plain
    versions)."""

    substrates = ("torch", "cuda")

    @staticmethod
    def op(nx):
        c, (x, y, z), _ = poisson(nx)
        return repro_torch.operator_from_numpy(
            "stencil7", {"c": c, "nx": x, "ny": y, "nz": z}, device=CPU)

    @staticmethod
    def vec(a):
        return torch.from_numpy(np.array(a))

    @staticmethod
    def make(method, op, **kw):
        if "config" in kw:
            kw["config"] = SolverConfig(**kw["config"])
        if "substrate" not in kw:
            kw["substrate"] = "torch"
        return repro_torch.make_solver(method, op, device=CPU, **kw)

    @staticmethod
    def solve(A, b, **kw):
        return repro_torch.solve(A, b, device=CPU, **kw)

    @staticmethod
    def dense(a):
        return repro_torch.DenseOperator(torch.from_numpy(np.array(a)))


BOTH = (Jax, Port)


def assert_c4(res, ref):
    assert bool(res.converged) and bool(ref.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= ITER_SLACK
    assert np.max(np.abs(np_(res.x) - np_(ref.x))) <= X_TOL


# -- caching: no rebuild on repeat solves; content-keyed session reuse ------


def test_second_solve_does_not_retrace(x64):
    """Solve #2 with a new b reuses the program (``traces`` stays 1) and
    the built preconditioner; a new static override builds its own
    program, once."""
    seen, first = {}, {}
    _, _, b = poisson(8)
    for side in BOTH:
        session = side.make("p-bicgsafe", side.op(8), precond="block_jacobi")
        pc = session.precond
        assert pc is not None
        first[side] = session.solve(side.vec(b))
        counts = [session.stats["traces"]]
        for i in range(3):
            session.solve(side.vec(b + float(i + 1)))
        counts.append(session.stats["traces"])
        assert session.precond is pc
        session.solve(side.vec(b), tol=1e-4)
        session.solve(side.vec(2.0 * b), tol=1e-4)
        counts.append(session.stats["traces"])
        seen[side] = counts
    assert seen[Port] == seen[Jax] == [1, 1, 2]
    assert_c4(first[Port], first[Jax])


def test_make_solver_content_cache_hit(x64):
    """Equal-content operators (fresh objects) return the same session;
    distinct content, spec, method or substrate do not."""
    seen = {}
    _, _, b = poisson(8)
    for side in BOTH:
        s1 = side.make("p-bicgsafe", side.op(8), precond="block_jacobi")
        s1.solve(side.vec(b))
        traces = s1.stats["traces"]
        s2 = side.make("p-bicgsafe", side.op(8), precond="block_jacobi")
        pattern = [s2 is s1, s2.precond is s1.precond]
        s2.solve(side.vec(2.0 * b))
        pattern.append(s1.stats["traces"] == traces)
        pattern += [
            side.make("p-bicgsafe", side.op(10),
                      precond="block_jacobi") is s1,
            side.make("p-bicgsafe", side.op(8), precond="jacobi") is s1,
            side.make("bicgstab", side.op(8), precond="block_jacobi") is s1,
            side.make("p-bicgsafe", side.op(8), precond="block_jacobi",
                      substrate=side.substrates[1]) is s1]
        seen[side] = pattern
    assert seen[Port] == seen[Jax] == [True, True, True,
                                       False, False, False, False]


def test_repro_solve_one_shot_hits_session_cache(x64):
    seen, results = {}, {}
    _, _, b = poisson(8)
    for side in BOTH:
        r1 = side.solve(side.op(8), side.vec(b), tol=1e-8)
        s = side.make("p-bicgsafe", side.op(8), config={})
        traces = s.stats["traces"]
        r2 = side.solve(side.op(8), side.vec(2.0 * b), tol=1e-8)
        seen[side] = [traces, s.stats["traces"], bool(r1.converged),
                      bool(r2.converged)]
        results[side] = r2
    assert seen[Port] == seen[Jax] == [1, 1, True, True]
    assert_c4(results[Port], results[Jax])


def test_uncacheable_sessions_are_fresh(x64):
    """Bare matvec callables are not content-addressable: sessions are
    built fresh, and still solve."""
    seen, results = {}, {}
    _, _, b = poisson(8)
    for side in BOTH:
        op = side.op(8)
        s1 = side.make("p-bicgsafe", op.matvec)
        s2 = side.make("p-bicgsafe", op.matvec)
        seen[side] = [s1 is s2, s1.fingerprint]
        results[side] = s1.solve(side.vec(b))
        with pytest.raises(TypeError, match="operator"):
            side.make("p-bicgsafe", op.matvec, precond="jacobi")
    assert seen[Port] == seen[Jax] == [False, None]
    assert_c4(results[Port], results[Jax])


def test_session_cache_is_bounded(x64):
    """The cache is an LRU of 64 sessions in both packages."""
    assert tapi._SESSION_CACHE_MAX == japi._SESSION_CACHE_MAX == 64
    seen = {}
    for side, mod in ((Jax, japi), (Port, tapi)):
        for i in range(mod._SESSION_CACHE_MAX + 8):
            side.make("p-bicgsafe", side.dense(np.eye(4) * (2.0 + i)))
        seen[side] = mod.session_cache_info()["sessions"]
        # the oldest went first: the newest is still found
        newest = side.dense(np.eye(4) * (2.0 + mod._SESSION_CACHE_MAX + 7))
        assert side.make("p-bicgsafe", newest) is side.make("p-bicgsafe",
                                                            newest)
    assert seen[Port] == seen[Jax] == 64


def test_mutable_operator_sessions_not_served_stale(x64):
    """A session must not stay findable once the content it was bound to
    is written in place: the JAX package never caches a writeable numpy
    leaf; the port drops the entry when the bound tensor's version moved
    (here ``op.values.mul_(50)`` on an ELL operator)."""
    seen = {}
    a = np.diag(np.full(8, 2.0))
    s1 = repro.make_solver("p-bicgsafe", repro.DenseOperator(a))
    a *= 50.0                                  # mutate under the cache
    s2 = repro.make_solver("p-bicgsafe",
                           repro.DenseOperator(np.diag(np.full(8, 2.0))))
    seen[Jax] = [s2 is s1, np_(s2.solve(jnp.ones(8)).x)]

    def diag_ell():
        return repro_torch.operator_from_numpy(
            "ell", {"values": np.full((8, 1), 2.0),
                    "cols": np.arange(8, dtype=np.int32)[:, None], "n": 8},
            device=CPU)
    op = diag_ell()
    s1 = Port.make("p-bicgsafe", op)
    assert Port.make("p-bicgsafe", diag_ell()) is s1     # equal content
    op.values.mul_(50)                         # mutate under the cache
    s2 = Port.make("p-bicgsafe", diag_ell())
    seen[Port] = [s2 is s1, np_(s2.solve(torch.ones(8, dtype=torch.float64)
                                         ).x)]
    for side in BOTH:
        assert seen[side][0] is False, "stale session served for mutated " \
            "content"
        np.testing.assert_allclose(seen[side][1], 0.5)   # 2 x = 1
    # the fresh session is cached in its place; the mutated operator has
    # content of its own
    assert Port.make("p-bicgsafe", diag_ell()) is s2
    assert Port.make("p-bicgsafe", op) is not s2


def test_fingerprint_not_memoized_for_mutable_operators(x64):
    """Content written in place changes the fingerprint (no stale memo);
    unchanged content keeps it, and the port's memo is then a hit."""
    a = np.eye(6) * 3.0
    op = repro.DenseOperator(a)
    fp1 = repro.operator_fingerprint(op)
    a *= 2.0
    jax_changed = repro.operator_fingerprint(op) != fp1
    op_j = repro.DenseOperator(jnp.asarray(a))
    jax_stable = (repro.operator_fingerprint(op_j)
                  == repro.operator_fingerprint(op_j))

    t = torch.from_numpy(np.eye(6) * 3.0)
    op = repro_torch.DenseOperator(t)
    fp1 = repro_torch.operator_fingerprint(op)
    assert id(op) in tapi._CONTENT_DIGESTS        # memoized ...
    t.mul_(2.0)                                   # ... until a write
    fp2 = repro_torch.operator_fingerprint(op)
    port_changed = fp2 != fp1
    port_stable = repro_torch.operator_fingerprint(op) == fp2
    assert [port_changed, port_stable] == [jax_changed, jax_stable] \
        == [True, True]
    # equal content, equal fingerprint, whatever the object
    assert fp2 == repro_torch.operator_fingerprint(
        repro_torch.DenseOperator(torch.from_numpy(np.eye(6) * 6.0)))


def test_fingerprint_rejects_non_array_content(x64):
    for pkg in (repro, repro_torch):
        with pytest.raises(TypeError, match="fingerprint"):
            pkg.operator_fingerprint(lambda x: x)
    op = Port.op(8)
    assert repro_torch.operator_fingerprint(op, "jacobi") \
        == repro_torch.operator_fingerprint(Port.op(8), "jacobi") \
        != repro_torch.operator_fingerprint(op)


# -- what the port's programs owe the caller ---------------------------------


@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr",
                                    "bicgstab"])
def test_cached_session_result_equals_a_fresh_sessions(method):
    _, _, b = poisson(8)
    cfg = SolverConfig(rr_epoch=10, record_history=True)
    cached = repro_torch.make_solver(method, Port.op(8), config=cfg,
                                     device=CPU)
    cached.solve(Port.vec(2.0 * b))
    assert repro_torch.make_solver(method, Port.op(8), config=cfg,
                                   device=CPU) is cached
    got = cached.solve(Port.vec(b))
    want = tapi.LinearSolver(method, Port.op(8), config=cfg,
                             device=CPU).solve(Port.vec(b))
    assert cached.stats["traces"] == 1
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g.nan_to_num(-1), w.nan_to_num(-1))


@pytest.mark.parametrize("guarded", [False, True])
def test_step_chunk_leaves_its_input_and_earlier_states_unchanged(guarded):
    _, _, b = poisson(8)
    cfg = SolverConfig(record_history=True, maxiter=200, guard=guarded)
    s = repro_torch.make_solver("p-bicgsafe", Port.op(8), config=cfg,
                                device=CPU)
    B = torch.stack([Port.vec(b), Port.vec(2.0 * b + 1.0)], dim=1)
    st0 = s.init(B, tol=1e-10)

    def snap(st):
        return {k: v.clone() for k, v in st.items()}

    def same(st, ref):
        return all(torch.equal(st[k].nan_to_num(-1), ref[k].nan_to_num(-1))
                   for k in ref)
    before0 = snap(st0)
    st1 = s.step_chunk(st0, 4)
    before1 = snap(st1)
    st2 = s.step_chunk(st1, 4)
    st3 = s.step_chunk(st2, 4)
    assert same(st0, before0) and same(st1, before1)
    assert int(st3["i"]) == 12 and not same(st2, snap(st3))
    # the same 12 steps in one call reach the same state
    assert same(st3, s.step_chunk(st0, 12))
    assert s.stats["traces"] == 1
