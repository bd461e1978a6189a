"""The solve service (``repro_torch.service``) held against the JAX
package's ``repro.service`` on the same numpy request streams, and the
session cache's byte budget it relies on (ROADMAP C16).

Both engines serve the same requests (the JAX one on its ``"jnp"``
substrate, ROADMAP C1; the port on ``"torch"`` and on ``"cuda"``, whose
kernels run their plain versions on the CPU) with the same slot and chunk
geometry and, where deadlines matter, the same clock.  Per request they
must give the same rid, status and retries, iterations within ±2 and
``x`` within 1e-6 (ROADMAP C4), and chunks resident within ±1.  The port's
own checks mirror ``tests/test_service.py``: each request against a
standalone ``solve_many`` column, per-request budgets and deadlines,
telemetry, fingerprint reuse and the loud errors; and, as the counterpart
of the JAX test that traces one ``dot_reduce`` in the step program, one
fused dots call per step counted through the substrate.  A chunk costs one
run of the block's program and one host read of the flags, with refills
or without (``SolveEngine.stats``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.observe import metrics as jmetrics  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import SolveEngine as JSolveEngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import SolverConfig, SolveStatus  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core.substrate import TorchSubstrate  # noqa: E402
from repro_torch.observe import RECORDER  # noqa: E402
from repro_torch.observe import metrics as tmetrics  # noqa: E402
from repro_torch.scenarios import ScenarioError  # noqa: E402
from repro_torch.service import ServiceConfig, SolveEngine  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_sessions():
    """Each test starts from an empty session cache: a session cached by an
    earlier test would carry that test's counts in its ``stats``."""
    repro_torch.clear_session_cache()


CPU = "cpu"
ITER_SLACK = 2
X_TOL = 1e-6
SUBSTRATES = ["torch", "cuda"]


def ops_of(*specs):
    """``{name: (JAX operator, port operator)}`` from ``(name, generator,
    kwargs)``: the same generator of each package (equal matrices)."""
    out = {}
    for name, gen, kw in specs:
        jop = getattr(JM, gen)(**kw)[0]
        top = getattr(TM, gen)(**kw, device=CPU)[0]
        out[name] = (jop, top)
    return out


def serve_both(ops, requests, *, precond=None, substrate="torch",
               clock=None, step=None, **scfg):
    """Serve ``requests`` (``(operator name, b, submit kwargs)``) through
    both engines; ``clock`` (a zero-argument factory of a fresh clock and
    its advance function) drives deadlines, ``step`` seconds per poll.
    Returns ``({rid: JAX result}, {rid: port result}, port engine)``."""
    precond = precond or {}
    got = []
    for side in ("jax", "port"):
        kw = {}
        if clock is not None:
            now, advance = clock()
            kw = dict(clock=now)
        if side == "jax":
            eng = JSolveEngine(JServiceConfig(substrate="jnp", **scfg), **kw)
        else:
            eng = SolveEngine(ServiceConfig(substrate=substrate, device=CPU,
                                            **scfg), **kw)
        for name, pair in ops.items():
            eng.register(pair[0] if side == "jax" else pair[1],
                         precond=precond.get(name), name=name)
        rids = [eng.submit(opn, jnp.asarray(b) if side == "jax" else b, **k)
                for opn, b, k in requests]
        assert rids == list(range(len(requests)))
        out = []
        while eng.has_work():
            out.extend(eng.poll())
            if step is not None:
                advance(step)
        got.append({r.rid: r for r in out})
        port = eng
    return got[0], got[1], port


def assert_same(jres, tres, *, partial_x=True):
    """The C4 bar per request, and the same typed outcome.  ``partial_x``
    False leaves out the ``x`` of unconverged requests (on an
    ill-conditioned system their partial iterates follow the rounding)."""
    assert sorted(jres) == sorted(tres)
    for rid, j in jres.items():
        t = tres[rid]
        assert t.status == j.status, (rid, t.status, j.status)
        assert t.retries == j.retries, rid
        assert t.converged == j.converged, rid
        assert abs(t.iterations - j.iterations) <= ITER_SLACK, (
            rid, t.iterations, j.iterations)
        if t.converged or partial_x:
            assert np.max(np.abs(t.x - np.asarray(j.x))) <= X_TOL, rid
        assert abs(t.telemetry.chunks_resident
                   - j.telemetry.chunks_resident) <= 1, rid
        assert t.telemetry.deadline_exceeded == j.telemetry.deadline_exceeded


def manual_clock():
    t = [0.0]

    def advance(dt):
        t[0] += dt
    return (lambda: t[0]), advance


# -- the engine against the JAX engine ----------------------------------------


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_engine_matches_jax_with_refill(x64, substrate):
    """More requests than slots, mixed tolerances, two operators (one
    preconditioned): the refills happen mid-flight, and every request is
    the JAX engine's, and its own standalone ``solve_many`` column."""
    ops = ops_of(("poisson", "poisson3d", dict(nx=8)),
                 ("convdiff", "convection_diffusion", dict(nx=8,
                                                            peclet=1.0)))
    rng = np.random.default_rng(7)
    tols = [1e-4, 1e-8, 1e-10]
    reqs = [("poisson" if i % 2 == 0 else "convdiff",
             rng.standard_normal(512), dict(tol=tols[i % 3], maxiter=300))
            for i in range(8)]
    jres, tres, eng = serve_both(ops, reqs, precond={"convdiff": "jacobi"},
                                 substrate=substrate, max_batch=3, chunk=4,
                                 tol=1e-8, maxiter=400)
    assert_same(jres, tres)
    assert eng.stats["admissions"] > 0               # refills happened
    assert not eng.has_work()
    for rid, (opn, b, kw) in enumerate(reqs):
        ref = repro_torch.make_solver(
            "p-bicgsafe", ops[opn][1], device=CPU, substrate=substrate,
            precond=None if opn == "poisson" else "jacobi",
        ).solve_many(b[:, None], tol=kw["tol"], maxiter=kw["maxiter"])
        t = tres[rid]
        assert t.converged == bool(ref.converged[0])
        assert abs(t.iterations - int(ref.iterations[0])) <= ITER_SLACK
        assert np.max(np.abs(t.x - ref.x[:, 0].numpy())) <= X_TOL


@pytest.mark.parametrize("gen,kw,budget_n", [
    ("hard_nonsym", dict(n=200), 50),
    ("convection_diffusion", dict(nx=8, peclet=1.0), 20)])
def test_engine_per_request_maxiter_and_deadline(x64, gen, kw, budget_n):
    """A maxiter-capped request retires unconverged at exactly its budget;
    a deadline-blown one at the next chunk boundary with its partial
    iterate; a queued one whose deadline lapses never takes a slot.  The
    same clock drives both engines.  On the JAX test's ill-conditioned
    ``hard_nonsym`` the two packages' partial iterates differ by up to
    about 2e-2 (the rounding, amplified: ROADMAP C4; in the port alone a
    block of width 1 against 2 moves the 50th iterate by 6e-2, the dense
    product's summation order), so each is held to the port's standalone
    ``solve_many`` with the engine's block width and the same budget; on
    the convection-diffusion system they also agree with the JAX
    engine's."""
    ops = ops_of(("sys", gen, kw))
    b = np.asarray(getattr(JM, gen)(**kw)[1])
    reqs = [("sys", b, dict(maxiter=budget_n, tol=1e-14)),
            ("sys", b, dict(deadline=0.5, tol=1e-14)),
            ("sys", 2.0 * b, dict(deadline=0.1))]
    jres, tres, _ = serve_both(ops, reqs, clock=manual_clock, step=0.2,
                               max_batch=2, chunk=4, maxiter=10_000)
    well_conditioned = gen != "hard_nonsym"
    assert_same(jres, tres, partial_x=well_conditioned)
    budget, deadline, expired = (tres[i] for i in range(3))
    session = repro_torch.make_solver("p-bicgsafe", ops["sys"][1],
                                      device=CPU)
    for r in (budget, deadline):
        ref = session.solve_many(np.stack([b, b], axis=1), tol=1e-14,
                                 maxiter=r.iterations)
        assert np.max(np.abs(r.x - ref.x[:, 0].numpy())) <= X_TOL
    assert not budget.converged and budget.iterations == budget_n
    assert budget.status == SolveStatus.MAXITER
    assert not budget.telemetry.deadline_exceeded
    assert deadline.status == SolveStatus.DEADLINE
    assert deadline.telemetry.deadline_exceeded and deadline.iterations > 0
    assert expired.telemetry.deadline_exceeded
    assert expired.iterations == 0
    assert expired.telemetry.chunks_resident == 0


def test_engine_telemetry(x64):
    ops = ops_of(("p", "poisson3d", dict(nx=8)))
    reqs = [("p", v, {})
            for v in np.random.default_rng(1).standard_normal((5, 512))]
    jres, tres, _ = serve_both(ops, reqs, max_batch=2, chunk=8, maxiter=200)
    assert_same(jres, tres)
    for r in tres.values():
        tel = r.telemetry
        assert tel.chunks_resident >= 1
        assert tel.queue_wait_s >= 0.0
        assert tel.wall_s >= tel.service_s >= 0.0
        assert not tel.deadline_exceeded
    waits = sorted(r.telemetry.queue_wait_s for r in tres.values())
    assert waits[-1] > waits[0]          # 5 requests, 2 slots: some waited


def test_engine_records_metrics_and_spans(x64):
    """The engine's retirements land in the port's metrics registry as in
    the JAX package's, and each chunk is one ``engine.chunk`` span."""
    jmetrics.REGISTRY.reset()
    tmetrics.REGISTRY.reset()
    RECORDER.clear()
    ops = ops_of(("p", "poisson3d", dict(nx=6)))
    b = np.asarray(JM.poisson3d(6)[1])
    reqs = [("p", b, {}), ("p", 0.5 * b, dict(maxiter=3)), ("p", -b, {})]
    _, _, eng = serve_both(ops, reqs, max_batch=2, chunk=4)
    for status in ("CONVERGED", "MAXITER"):
        assert tmetrics.ENGINE_REQUESTS.value(status=status) == \
            jmetrics.ENGINE_REQUESTS.value(status=status) > 0
    assert tmetrics.SOLVE_ITERATIONS.count() == 3
    assert "repro_engine_requests_total" in tmetrics.REGISTRY.prometheus()
    chunks = [s for s in RECORDER.spans() if s.name == "engine.chunk"]
    assert len(chunks) == eng.stats["chunks"]


# -- what a chunk costs ---------------------------------------------------------


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_chunk_is_one_run_and_one_host_read(substrate):
    """With refills or without, a chunk boundary costs one run of the
    block's program (one graph replay on the card) and one host read of
    the flags; the retiring columns' ``x`` is one more copy."""
    op, b, _ = TM.poisson3d(6, device=CPU)
    eng = SolveEngine(ServiceConfig(max_batch=3, chunk=5, maxiter=300,
                                    substrate=substrate, device=CPU))
    eng.register(op, name="p")
    rng = np.random.default_rng(2)
    for i in range(7):
        eng.submit("p", rng.standard_normal(op.n), tol=[1e-4, 1e-8][i % 2])
    out = eng.run()
    st = eng.stats
    assert len(out) == 7 and st["admissions"] > 0
    assert st["runs"] == st["host_reads"] == st["chunks"]
    assert st["x_reads"] <= st["chunks"]
    session = eng.registry["p"].session
    assert session.stats["programs"] == 1     # init, steps and splices
    assert session.stats["host_reads"] == 0   # the engine reads, not it


class CountingSubstrate(TorchSubstrate):
    """The plain substrate, counting its reductions."""

    name = "counting"

    def __init__(self):
        self.calls = {"bicgsafe_dots": 0, "dots": 0}

    def bicgsafe_dots(self, *args):
        self.calls["bicgsafe_dots"] += 1
        return super().bicgsafe_dots(*args)

    def dots(self, pairs):
        self.calls["dots"] += 1
        return super().dots(pairs)


def test_engine_step_single_reduction_per_iter():
    """Each step of the engine's block makes ONE reduction, the fused
    (9, m) dots, whatever the mix in the slots; an admission adds one
    (1, m) norm, the initial fill one."""
    sub = CountingSubstrate()
    op, b, _ = TM.nonsym_dense(64, device=CPU)
    eng = SolveEngine(ServiceConfig(max_batch=3, chunk=8, substrate=sub,
                                    device=CPU))
    eng.register(op, name="d")
    for v in (b, 0.5 * b, b + 1.0, 2.0 * b, -b):
        eng.submit("d", v.numpy())
    eng.run()
    assert sub.calls["bicgsafe_dots"] == eng.stats["steps"]
    assert sub.calls["dots"] == 1 + eng.stats["admissions"]


@pytest.mark.parametrize("guard", [False, True])
def test_fused_splice_step_equals_splice_then_step(guard):
    """The fused ``splice_step`` (the splice as the first step of the
    chunk's program, its block a constant on the host) equals ``splice``
    then ``step_chunk``, bit for bit, in one run."""
    op, b, _ = TM.convection_diffusion(6, peclet=1.0, device=CPU)
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                config=SolverConfig(guard=guard),
                                precond="jacobi")
    rng = np.random.default_rng(4)
    B = torch.from_numpy(rng.standard_normal((op.n, 3)))
    B_new = rng.standard_normal((op.n, 3))
    refill = torch.tensor([True, False, True])
    st = s.step_chunk(s.init(B), 6)
    runs = s.stats["runs"]
    fused = s.splice_step(st, refill, B_new, [1e-6, 0.0, 1e-9], 50, 12,
                          one_run=True)
    assert s.stats["runs"] == runs + 1
    plain = s.step_chunk(s.splice(st, refill, torch.from_numpy(B_new),
                                  tol=torch.tensor([1e-6, 0.0, 1e-9],
                                                   dtype=torch.float64),
                                  maxiter=50), 12)
    assert fused.keys() == plain.keys()
    for k in fused:
        assert torch.equal(fused[k].nan_to_num(), plain[k].nan_to_num()), k


# -- the registry --------------------------------------------------------------


def test_registry_fingerprint_reuses_precond_and_programs():
    """Equal content registers as the same entry (one session, one
    preconditioner build, one program); another spec or content does not;
    a name taken by other content is refused."""
    eng = SolveEngine(ServiceConfig(max_batch=2, device=CPU))
    op_a = TM.poisson3d(8, device=CPU)[0]
    op_b = TM.poisson3d(8, device=CPU)[0]
    assert op_a is not op_b
    n1 = eng.register(op_a, precond="block_jacobi", name="A")
    n2 = eng.register(op_b, precond="block_jacobi")
    e1, e2 = eng.registry[n1], eng.registry[n2]
    assert e1 is e2 and e1.precond is e2.precond
    assert e1.session is e2.session and e1.step_fn is e2.step_fn
    assert len(eng.registry.entries()) == 1
    # a second engine shares the session through the api's cache
    other = SolveEngine(ServiceConfig(max_batch=2, device=CPU))
    assert other.registry[other.register(op_b, precond="block_jacobi")
                          ].session is e1.session
    n3 = eng.register(op_a, precond="jacobi")
    assert eng.registry[n3] is not e1
    n4 = eng.register(TM.poisson3d(10, device=CPU)[0], precond="block_jacobi")
    assert eng.registry[n4] is not e1
    assert len(eng.registry.entries()) == 3
    with pytest.raises(ValueError, match="different content"):
        eng.register(TM.convection_diffusion(8, device=CPU)[0], name="A")
    assert not e1.kernel_backed
    cuda_eng = SolveEngine(ServiceConfig(substrate="cuda", device=CPU))
    assert cuda_eng.registry[cuda_eng.register(op_a)].kernel_backed


def test_registry_unknown_operator_is_loud():
    eng = SolveEngine(ServiceConfig(device=CPU))
    with pytest.raises(KeyError, match="unknown operator"):
        eng.submit("nope", np.ones(8))


def test_submit_validates_rhs_shape():
    eng = SolveEngine(ServiceConfig(device=CPU))
    name = eng.register(TM.poisson3d(8, device=CPU)[0], name="p")
    with pytest.raises(ValueError, match="shape"):
        eng.submit(name, np.ones(7))


def test_unported_service_options_are_refused(tmp_path):
    """``trace_cap`` and ``profile_dir`` are ported (taken as the JAX
    package takes them); ``register_scenario`` is ported too, and refuses
    only a scenario that is not registered, as the JAX package's does."""
    for kw in (dict(trace_cap=8), dict(profile_dir=str(tmp_path))):
        JServiceConfig(**kw)
        assert SolveEngine(ServiceConfig(device=CPU, **kw)).scfg == \
            ServiceConfig(device=CPU, **kw)
    eng = SolveEngine(ServiceConfig(device=CPU))
    with pytest.raises(ScenarioError, match="unknown scenario 'poisson'"):
        eng.register_scenario("poisson")


# -- C16: one program per key, and the byte budget ----------------------------


@pytest.mark.parametrize("method", sorted(repro_torch.SOLVERS))
def test_tol_and_maxiter_overrides_reuse_one_program(x64, method):
    """Three ``tol`` and two ``maxiter`` overrides run the program of the
    first solve: ``tol`` is a constant buffer of the body, ``maxiter`` the
    host's bound.  Each override still stops where the JAX package's
    solve with the same settings stops."""
    jop, jb, _ = JM.nonsym_dense(48)
    op, b, _ = TM.nonsym_dense(48, device=CPU)
    s = repro_torch.make_solver(method, op, device=CPU)
    jsession = repro.make_solver(method, jop)
    for kw in (dict(tol=1e-4), dict(tol=1e-8), dict(tol=1e-10),
               dict(maxiter=3), dict(maxiter=7)):
        res = s.solve(b, **kw)
        ref = jsession.solve(jb, **kw)
        assert int(res.status) == int(ref.status), kw
        assert abs(int(res.iterations) - int(ref.iterations)) \
            <= ITER_SLACK, kw
    assert s.stats["programs"] == s.stats["traces"] == 1
    assert tapi.session_cache_info()["programs"] == 1


def test_solve_many_overrides_reuse_one_program():
    op, b, _ = TM.convection_diffusion(6, device=CPU)
    B = torch.stack([b, 2.0 * b], dim=1)
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU)
    iters = [s.solve_many(B, tol=tol).iterations[0].item()
             for tol in (1e-4, 1e-8, [1e-6, 1e-10])]
    assert iters[0] < iters[2] < iters[1]
    assert (s.solve_many(B, maxiter=4).iterations == 4).all()
    assert (s.solve_many(B, maxiter=9).iterations == 9).all()
    assert s.stats["programs"] == 1


def test_record_history_keys_its_program_on_maxiter():
    """The history buffer is sized by ``maxiter``: there, and only there,
    a ``maxiter`` override is a program of its own."""
    op, b, _ = TM.poisson3d(5, device=CPU)
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                config=SolverConfig(record_history=True))
    assert s.solve(b, maxiter=30).residual_history.shape == (31,)
    s.solve(b, maxiter=30, tol=1e-4)
    assert s.stats["programs"] == 1
    assert s.solve(b, maxiter=40).residual_history.shape == (41,)
    assert s.stats["programs"] == 2


def test_byte_budget_evicts_least_recently_used(monkeypatch):
    """Past the byte budget the least recently used sessions release their
    programs and leave the cache, never the session just used; a session
    handed out before keeps working and builds its program again."""
    ops = [TM.poisson3d(6, device=CPU)[0] for _ in range(4)]
    ops = [dataclasses.replace(op, c=op.c * (1.0 + i))
           for i, op in enumerate(ops)]
    sessions = [repro_torch.make_solver("p-bicgsafe", op, device=CPU)
                for op in ops]
    b = torch.ones(ops[0].n, dtype=torch.float64)
    sessions[0].solve(b)
    one = sessions[0].nbytes
    assert one > 0 and tapi.session_cache_info()["bytes"] == one
    budget = int(3.5 * one)
    monkeypatch.setattr(tapi, "_SESSION_CACHE_BYTES", budget)
    sessions[1].solve(b)
    sessions[2].solve(b)
    info = tapi.session_cache_info()
    assert info == dict(sessions=4, programs=3, bytes=3 * one)  # not over
    sessions[3].solve(b)                 # 4 programs: the oldest goes
    info = tapi.session_cache_info()
    assert info == dict(sessions=3, programs=3, bytes=3 * one)
    assert sessions[0].nbytes == 0 and not sessions[0]._programs
    fresh = repro_torch.make_solver("p-bicgsafe", ops[0], device=CPU)
    assert fresh is not sessions[0]
    # a call moves a session to the back: 1 is used, so 2 goes next
    sessions[1].solve(2.0 * b)
    fresh.solve(b)
    assert [bool(s._programs) for s in sessions[1:] + [fresh]] == \
        [True, False, True, True]
    assert tapi.session_cache_info()["bytes"] == 3 * one <= budget
    res = sessions[0].solve(b)           # evicted, still works: rebuilds
    assert bool(res.converged) and sessions[0].stats["traces"] == 2
