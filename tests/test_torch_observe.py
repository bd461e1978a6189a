"""The iteration-trace ring of the port (``SolverConfig.trace_cap``,
``solve(..., trace=)``, the engine's ``ServiceConfig(trace_cap=)``) held
against the JAX package's, on the CPU.

* Against the JAX traces, over the first 16 recorded iterations
  (``ConvergenceTrace.per_iteration``): the iteration and status channels
  exactly, relres, the three denominators and the drift channel within
  ``RTOL`` of each channel's largest magnitude over those rows (ROADMAP
  C4: the two packages sum in another order), for p-BiCGSafe, -rr,
  ssBiCGSafe2, the batched solve, the guarded solve and the engine.
* The trace is write-only: a traced solve is the untraced one bit for bit
  (single, batched, open loop, guarded), on both substrates.
* The ring: wraparound (``trace=N`` is the last N rows of the full trace),
  the splice's reset of a reused slot, and ``steps`` exact although
  chunks run past convergence (ROADMAP C9).
* ``ConvergenceTrace`` JSON loads in the JAX package's ``from_json`` and
  the other way round.

Problems are ``poisson3d`` and ``convection_diffusion`` at 5-10, fp64,
made by each package's generator (equal matrices).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from conftest import enable_x64  # noqa: E402,F401
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.observe import ConvergenceTrace as JTrace  # noqa: E402
from repro.resilience import RecoveryPolicy as JPolicy  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import SolveEngine as JSolveEngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import RecoveryPolicy, SolverConfig, SolveStatus  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core.types import TRACE_CHANNELS  # noqa: E402
from repro_torch.observe import ConvergenceTrace, wrap_trace  # noqa: E402
from repro_torch.service import ServiceConfig, SolveEngine  # noqa: E402

CPU = "cpu"
ROWS = 16            # rows held against the JAX trace
RTOL = 1e-8          # of each channel's largest magnitude over those rows
CH = {name: i for i, name in enumerate(TRACE_CHANNELS)}
EXACT = ("iteration", "status")
CLOSE = ("relres", "rho_denom", "alpha_denom", "omega_denom", "drift")
PROBLEMS = {"poisson": ("poisson3d", dict(nx=6)),
            "convdiff": ("convection_diffusion", dict(nx=8, peclet=1.0))}
FIELDS = ("x", "iterations", "relres", "converged", "breakdown", "status")


@pytest.fixture(autouse=True)
def fresh_sessions():
    repro_torch.clear_session_cache()


def both(name):
    gen, kw = PROBLEMS[name]
    jop, jb, _ = getattr(JM, gen)(**kw)
    op, b, _ = getattr(TM, gen)(**kw, device=CPU)
    return jop, jb, op, b


def port(name):
    """The port's operator and right-hand side of ``PROBLEMS[name]``."""
    gen, kw = PROBLEMS[name]
    op, b, _ = getattr(TM, gen)(**kw, device=CPU)
    return op, b


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def same(a, b) -> bool:
    return np.array_equal(np_(a), np_(b), equal_nan=True)


def assert_rows_match(got: ConvergenceTrace, want, rows: int = ROWS):
    """The first ``rows`` recorded iterations of two single-column
    traces: the exact channels equal, the others within RTOL."""
    g, w = got.per_iteration()[:rows], want.per_iteration()[:rows]
    assert g.shape == w.shape and len(g) == min(rows, len(w)), (g.shape,
                                                                 w.shape)
    for ch in EXACT:
        assert np.array_equal(g[:, CH[ch]], w[:, CH[ch]]), ch
    for ch in CLOSE:
        scale = max(np.max(np.abs(w[:, CH[ch]])), np.finfo(float).tiny)
        err = np.max(np.abs(g[:, CH[ch]] - w[:, CH[ch]]))
        assert err <= RTOL * scale, (ch, err, scale)


def assert_bitwise(bare, traced):
    assert bare.trace is None and traced.trace is not None
    for field in FIELDS:
        assert same(getattr(bare, field), getattr(traced, field)), field


# -- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr",
                                    "ssbicgsafe2"])
def test_single_trace_matches_jax(x64, method, problem):
    """-rr replaces its residual every 5 steps here, so the rows cross
    replacement steps."""
    jop, jb, op, b = both(problem)
    cfg = dict(tol=1e-8, maxiter=300, rr_epoch=5)
    want = repro.make_solver(method, jop, config=JConfig(**cfg)).solve(
        jb, trace=True)
    got = repro_torch.make_solver(method, op, device=CPU,
                                  config=SolverConfig(**cfg)).solve(
        b, trace=True)
    assert isinstance(got.trace, ConvergenceTrace) and not got.trace.batched
    assert got.trace.cap == 300
    assert_rows_match(got.trace, want.trace)
    rows = got.trace.per_iteration()
    assert rows[0, CH["iteration"]] == 0 and rows[0, CH["relres"]] == 1.0
    assert rows[-1, CH["iteration"]] == int(got.iterations)
    assert rows[-1, CH["relres"]] == float(got.relres)
    assert rows[-1, CH["status"]] == SolveStatus.CONVERGED.value
    assert (np.diff(rows[:, CH["iteration"]]) == 1).all()


@pytest.mark.parametrize("guard", [False, True])
def test_batched_trace_matches_jax(x64, guard):
    """Per column of an (n, 3) block (one zero-free column converging
    early), against the JAX ``"jnp"`` batched solve (ROADMAP C1); guarded,
    the drift and status channels are the guard's."""
    jop, jb, op, b = both("convdiff")
    rng = np.random.default_rng(3)
    B = np.stack([np_(b), rng.standard_normal(b.shape[0]),
                  2.0 * np_(b)], axis=1)
    cfg = dict(tol=1e-8, maxiter=300, guard=guard)
    want = repro.make_solver("p-bicgsafe", jop, config=JConfig(**cfg)) \
        .solve_many(jnp.asarray(B), trace=True)
    got = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                  config=SolverConfig(**cfg)).solve_many(
        torch.from_numpy(B), trace=True)
    assert got.trace.batched and got.trace.m == 3
    assert got.trace.steps == int(want.trace.steps)
    for j in range(3):
        assert_rows_match(got.trace.column(j), want.trace.column(j))
        rows = got.trace.column(j).per_iteration()
        assert rows[-1, CH["iteration"]] == int(got.iterations[j])
    if guard:
        drift = got.trace.column(0).per_iteration()[:, CH["drift"]]
        assert drift[-1] > 0


@pytest.mark.parametrize("entry", ["solve", "solve_many"])
def test_guarded_trace_matches_jax(x64, entry):
    """``make_solver(..., recovery=...)`` with ``trace_cap`` bound: the
    guarded ``solve`` returns column 0's trace, ``solve_many`` the
    block's, each as the JAX guarded solve's."""
    jop, jb, op, b = both("poisson")
    cfg = dict(tol=1e-8, maxiter=300, trace_cap=64)
    jg = repro.make_solver("p-bicgsafe", jop, config=JConfig(**cfg),
                           recovery=JPolicy())
    tg = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                 config=SolverConfig(**cfg),
                                 recovery=RecoveryPolicy())
    if entry == "solve":
        want, got = jg.solve(jb), tg.solve(b)
        assert not got.trace.batched
        assert_rows_match(got.trace, want.trace)
    else:
        B = np.stack([np_(b), 0.5 * np_(b)], axis=1)
        want = jg.solve_many(jnp.asarray(B))
        got = tg.solve_many(torch.from_numpy(B))
        for j in range(2):
            assert_rows_match(got.trace.column(j), want.trace.column(j))
    assert got.trace.cap == 64
    assert not tg.events


def test_engine_traces_match_jax(x64):
    """Five requests through two slots of both engines, traced: each
    request's harvested trace is the JAX engine's, starts at its own
    iteration 0 (the splice reset its reused slot) and ends at its
    iterations."""
    jop, _, op, _ = both("poisson")
    rng = np.random.default_rng(5)
    rhs = [rng.standard_normal(op.shape[0]) for _ in range(5)]
    got = {}
    for side in ("jax", "port"):
        kw = dict(max_batch=2, chunk=8, tol=1e-8, maxiter=500, trace_cap=64)
        eng = JSolveEngine(JServiceConfig(substrate="jnp", **kw)) \
            if side == "jax" else SolveEngine(ServiceConfig(device=CPU, **kw))
        name = eng.register(jop if side == "jax" else op)
        for v in rhs:
            eng.submit(name, jnp.asarray(v) if side == "jax" else v)
        got[side] = {r.rid: r for r in eng.run()}
    assert sorted(got["port"]) == sorted(got["jax"]) == list(range(5))
    for rid, t in got["port"].items():
        assert t.status == SolveStatus.CONVERGED
        assert_rows_match(t.trace, got["jax"][rid].trace)
        it = t.trace.per_iteration()[:, CH["iteration"]]
        assert it[0] == 0, "a reused slot leaked its predecessor's rows"
        assert it[-1] == t.iterations
        assert (np.diff(it) == 1).all()


# -- write-only: traced is untraced, bit for bit ------------------------------


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr",
                                    "ssbicgsafe2"])
def test_traced_single_is_bitwise_untraced(method, substrate):
    op, b = port("convdiff")
    s = repro_torch.make_solver(method, op, device=CPU, substrate=substrate,
                                config=SolverConfig(tol=1e-8, maxiter=300,
                                                    rr_epoch=5))
    assert_bitwise(s.solve(b), s.solve(b, trace=True))
    # and the relres channel is the recorded history, bit for bit
    hist = s.solve(b, trace=True)
    hs = repro_torch.make_solver(
        method, op, device=CPU, substrate=substrate,
        config=SolverConfig(tol=1e-8, maxiter=300, rr_epoch=5,
                            record_history=True)).solve(b)
    k = int(hs.iterations) + 1
    assert same(hist.trace.channel("relres")[:k],
                hs.residual_history[:k])


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
def test_traced_batched_is_bitwise_untraced(substrate):
    op, b = port("convdiff")
    rng = np.random.default_rng(3)
    B = torch.from_numpy(np.stack([np_(b), rng.standard_normal(b.shape[0])],
                                  axis=1))
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                substrate=substrate,
                                config=SolverConfig(tol=1e-8, maxiter=300))
    assert_bitwise(s.solve_many(B), s.solve_many(B, trace=True))
    g = repro_torch.make_solver(
        "p-bicgsafe", op, device=CPU, substrate=substrate,
        config=SolverConfig(tol=1e-8, maxiter=300, trace_cap=32),
        recovery=RecoveryPolicy())
    bare = repro_torch.make_solver(
        "p-bicgsafe", op, device=CPU, substrate=substrate,
        config=SolverConfig(tol=1e-8, maxiter=300),
        recovery=RecoveryPolicy()).solve_many(B)
    assert_bitwise(bare, g.solve_many(B))


def test_traced_open_loop_is_bitwise_untraced():
    """``init`` / ``step_chunk`` / ``splice_step`` / ``result`` with a
    traced config: the same bits as untraced, the ring in the state; the
    refilled column's rows are NaN'd by the splice."""
    op, b = port("poisson")
    B = torch.stack([b, 0.5 * b], 1)
    fresh = torch.stack([2.0 * b, b], 1)
    out = []
    for cap in (0, 64):
        s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                    config=SolverConfig(tol=1e-8, maxiter=300,
                                                        trace_cap=cap))
        st = s.step_chunk(s.init(B), 16)
        mid = s.result(st)
        refill = torch.tensor([True, False])
        st = s.splice_step(st, refill, fresh, 1e-8, 300, 16)
        st = s.step_chunk(st, 64)
        out.append((mid, s.result(st)))
    (mid0, end0), (mid1, end1) = out
    assert_bitwise(mid0, mid1)
    assert_bitwise(end0, end1)
    col0 = end1.trace.column(0).per_iteration()
    assert col0[0, CH["iteration"]] == 0          # the refill's own start
    assert col0[-1, CH["iteration"]] == int(end1.iterations[0])
    col1 = end1.trace.column(1).per_iteration()
    assert col1[0, CH["iteration"]] == 0 and \
        col1[-1, CH["iteration"]] == int(end1.iterations[1])


# -- the ring -----------------------------------------------------------------


@pytest.mark.parametrize("entry", ["solve", "solve_many"])
def test_ring_wraparound_keeps_the_last_rows(entry):
    op, b = port("convdiff")
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                config=SolverConfig(tol=1e-8, maxiter=300))
    call = s.solve if entry == "solve" else \
        (lambda v, **kw: s.solve_many(torch.stack([v, 0.5 * v], 1), **kw))
    full, ringed = call(b, trace=True).trace, call(b, trace=4).trace
    assert ringed.cap == 4 and ringed.steps == full.steps
    assert same(ringed.rows(), full.rows()[-4:])
    views = [(full, ringed)] if entry == "solve" else \
        [(full.column(j), ringed.column(j)) for j in range(2)]
    for f, r in views:
        it_f = f.per_iteration()[:, CH["iteration"]]
        it_r = r.per_iteration()[:, CH["iteration"]]
        assert list(it_r) == list(it_f[-len(it_r):])


def test_steps_count_rows_not_queued_steps():
    """Chunks of 16 steps run past convergence (C9); the ring counts the
    rows written: the iterations plus the terminal detection row."""
    op, b = port("poisson")
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                config=SolverConfig(tol=1e-8, maxiter=300))
    res = s.solve(b, trace=True)
    assert s.stats["steps"] % 16 == 0
    assert s.stats["steps"] > int(res.iterations) + 1
    assert res.trace.steps == int(res.iterations) + 1
    assert len(res.trace) == res.trace.steps
    # the rows past the last one were never written
    assert np.isnan(res.trace.buffer[res.trace.steps:]).all()


def test_trace_programs_and_options():
    """A traced solve is a program of its own (``trace_cap`` is in the
    key); the untraced program is the same object afterwards; ``trace=``
    on a method without a ring gives ``None`` (as in the JAX package);
    ``trace=False`` turns a bound ``trace_cap`` off; the program's bytes
    count the ring."""
    op, b = port("poisson")
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                config=SolverConfig(tol=1e-8, maxiter=300))
    s.solve(b)
    before = dict(s._programs)
    bytes_bare = s.nbytes
    s.solve(b, trace=True)
    assert s.stats["programs"] == 2
    s.solve(b)
    assert all(s._programs[k] is p for k, p in before.items())
    assert s.nbytes - bytes_bare >= 300 * len(TRACE_CHANNELS) * 8
    assert repro_torch.make_solver("bicgstab", op, device=CPU).solve(
        b, trace=True).trace is None
    bound = repro_torch.make_solver(
        "p-bicgsafe", op, device=CPU,
        config=SolverConfig(tol=1e-8, maxiter=300, trace_cap=16))
    assert bound.solve(b).trace.cap == 16
    assert bound.solve(b, trace=False).trace is None


# -- the host boundary --------------------------------------------------------


def test_trace_init_and_record_edge_cases():
    cfg = SolverConfig(trace_cap=3)
    buf = repro_torch.core.types.trace_init(cfg, torch.float64, CPU, m=2)
    assert buf.shape == (3, len(TRACE_CHANNELS), 2) and buf.isnan().all()
    one = torch.ones(2, dtype=torch.float64)
    row = [one * k for k in range(len(TRACE_CHANNELS))]
    repro_torch.core.types.trace_record(
        buf, torch.tensor(4, dtype=torch.int32), row, torch.tensor(False))
    assert buf.isnan().all()                          # a frozen step
    repro_torch.core.types.trace_record(
        buf, torch.tensor(4, dtype=torch.int32), row, torch.tensor(True))
    assert (buf[1, :, 0] == torch.arange(len(TRACE_CHANNELS))).all()
    assert buf[0].isnan().all() and buf[2].isnan().all()


def test_wrap_trace_takes_device_tensors():
    assert wrap_trace(None) is None
    buf = torch.full((4, len(TRACE_CHANNELS)), float("nan"),
                     dtype=torch.float64)
    tr = wrap_trace({"buffer": buf, "steps": torch.tensor(2)})
    assert isinstance(tr, ConvergenceTrace) and tr.steps == 2
    assert isinstance(tr.buffer, np.ndarray)
    assert wrap_trace(tr) is tr
    with pytest.raises(ValueError, match="trace buffer"):
        ConvergenceTrace(np.zeros((4, 3)), 1)


@pytest.mark.parametrize("batched", [False, True])
def test_trace_json_loads_in_either_package(batched):
    rng = np.random.default_rng(0)
    shape = (5, len(TRACE_CHANNELS)) + ((2,) if batched else ())
    buf = rng.standard_normal(shape)
    buf[0] = np.nan
    port = ConvergenceTrace(buf, 12)
    jax_side = JTrace.from_json(json.loads(json.dumps(port.to_json())))
    assert jax_side.steps == 12 and jax_side.batched == batched
    assert same(jax_side.buffer, buf)
    back = ConvergenceTrace.from_json(
        json.loads(json.dumps(JTrace(buf, 12).to_json())))
    assert back.steps == 12 and same(back.buffer, buf)
    assert port.to_json() == JTrace(buf, 12).to_json()
    assert TRACE_CHANNELS == jtypes.TRACE_CHANNELS
    if not batched:
        assert port.summary() == JTrace(buf, 12).summary()
