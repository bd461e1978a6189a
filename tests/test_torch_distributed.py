"""The port's distributed driver (``repro_torch.core.distributed``, reached
through ``make_solver(...).on_mesh(mesh)``) on the CPU: gloo processes,
as the JAX package's ``tests/test_distributed.py`` runs 8 fake devices.

The problem is the JAX check's (``tests/_distributed_check.py``):
``convection_diffusion(16, peclet=1.0)``, fp64, tol 1e-8, built by the
JAX package and handed to the port as numpy arrays.  One spawn of
``tests/_torch_distributed_child.py`` per world size (8, 4, 2 and 1
processes, each with its own ``file://`` store) runs every case of that
size; the tests here read what its rank 0 wrote.

* Every method on the meshes (8,), (4, 2) and (2, 2, 2) of 8 ranks, (4,)
  and (2, 2) of 4, and on the default group of 2 ranks: held against the JAX single-process solve with the
  JAX check's own bars (converged, ``||x - x_true|| / ||x_true|| < 1e-6``,
  iterations within ``max(3, 20%)``), and against the port's world-1
  solve with the same bars.
* World 1 (one gloo rank): bitwise the port's single-process Stencil7
  solve, single, batched, guarded and block-Jacobi (single and batched).
* The reductions started per iteration (the ``SyncCounter`` of the
  binding): Table 3.1's counts; shard-local preconditioners leave them as
  they are; the order of one p-BiCGSafe step: the all-reduce is started
  before the halo exchange and waited on after the matvec.
* ``solve_many`` of an (n, 3) block against the JAX ``solve_batched`` per
  column and against the JAX 8-device mesh solve; guarded against
  unguarded.
* In this process: ``make_solver(dot_reduce=..., blocked=...)`` and
  ``solve_batched(blocked=True)`` against the JAX package's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from conftest import enable_x64  # noqa: E402
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.core import multirhs as jmultirhs  # noqa: E402
from repro_torch import SolverConfig  # noqa: E402
from repro_torch.core import Stencil7Operator, multirhs  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core._common import SyncCounter  # noqa: E402
from repro_torch.core.types import identity_reduce  # noqa: E402
from repro_torch.observe import ConvergenceTrace  # noqa: E402
from test_torch_observe import assert_rows_match  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_distributed_child.py")
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
SPAWN_TIMEOUT = 300
JAX_MESH_TIMEOUT = 60

METHODS = ("p-bicgsafe", "p-bicgsafe-rr", "ssbicgsafe2", "p-bicgstab",
           "bicgstab", "gpbicg", "cgs")
#: reductions per iteration (paper Table 3.1; the JAX package's psums)
REDUCTIONS = {"p-bicgsafe": 1, "p-bicgsafe-rr": 1, "ssbicgsafe2": 1,
              "p-bicgstab": 2, "bicgstab": 2, "gpbicg": 3, "cgs": 2}
MESHES = ("8", "4x2", "2x2x2", "4", "2x2", "2")
CFG = dict(tol=1e-8, maxiter=2000)


def iters_close(it: int, ref: int) -> bool:
    """The JAX check's bar: sharded partial sums reduce in another order,
    which may move the stopping iteration when relres hovers at tol."""
    return abs(it - ref) <= max(3, int(0.2 * ref))


def rel_err(x, ref) -> float:
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# the problem, the JAX references and the spawned runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    with enable_x64(True):
        op, b, xt = JM.convection_diffusion(16, peclet=1.0)
        c, b, xt = (np.asarray(v) for v in (op.c, b, xt))
    rng = np.random.default_rng(11)
    B = np.stack([b, rng.standard_normal(b.size),
                  rng.standard_normal(b.size)], axis=1)
    path = tmp_path_factory.mktemp("problem") / "inputs.npz"
    np.savez(path, c=c, shape=np.array([16, 16, 16]), b=b, B=B)
    return dict(c=c, b=b, B=B, xt=xt, path=str(path))


@pytest.fixture(scope="module")
def jax_refs(problem):
    """The JAX package's single-process solves of every method (the
    p-BiCGSafe one traced), and its batched solve of the block, per
    column."""
    out = {}
    with enable_x64(True):
        op = JM.Stencil7Operator(jnp.asarray(problem["c"]), 16, 16, 16)
        b = jnp.asarray(problem["b"])
        for method in METHODS:
            res = repro.make_solver(method, op,
                                    config=JConfig(**CFG)).solve(
                b, trace=True if method == "p-bicgsafe" else None)
            out[method] = dict(iterations=int(res.iterations),
                               x=np.asarray(res.x), trace=res.trace)
        res = repro.make_solver("p-bicgsafe", op, config=JConfig(**CFG)) \
            .solve_many(jnp.asarray(problem["B"]))
        out["many"] = dict(iterations=np.asarray(res.iterations),
                           x=np.asarray(res.x))
    return out


def _spawn(world: int, problem, tmp_path_factory) -> dict:
    """Run the child on ``world`` gloo processes; return rank 0's output."""
    work = tmp_path_factory.mktemp(f"world{world}")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(rank), str(world),
         str(work / "store"), problem["path"], str(work / "out")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
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
    assert codes == [0] * world, "\n".join(
        f"--- rank {r} exit {c}\n{log}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    arrays = dict(np.load(work / "out" / "arrays.npz"))
    with open(work / "out" / "scalars.json") as f:
        return dict(arrays=arrays, scalars=json.load(f))


@pytest.fixture(scope="module")
def world8(problem, tmp_path_factory):
    return _spawn(8, problem, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(problem, tmp_path_factory):
    return _spawn(4, problem, tmp_path_factory)


@pytest.fixture(scope="module")
def world2(problem, tmp_path_factory):
    return _spawn(2, problem, tmp_path_factory)


@pytest.fixture(scope="module")
def world1(problem, tmp_path_factory):
    return _spawn(1, problem, tmp_path_factory)


@pytest.fixture(scope="module")
def runs(world8, world4, world2):
    """The multi-rank runs' cases together, by name."""
    worlds = (world8, world4, world2)
    return ({k: v for w in worlds for k, v in w["arrays"].items()},
            {k: v for w in worlds for k, v in w["scalars"].items()})


# ---------------------------------------------------------------------------
# the meshes against the JAX package and against world 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_solve_matches_jax(mesh, method, runs, jax_refs, problem):
    arrays, scalars = runs
    got = scalars[f"{mesh}/{method}"]
    assert got["converged"], got
    assert rel_err(arrays[f"{mesh}/{method}/x"], problem["xt"]) < 1e-6
    assert iters_close(got["iterations"], jax_refs[method]["iterations"]), \
        (got["iterations"], jax_refs[method]["iterations"])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_solve_matches_world1(mesh, method, runs, world1):
    arrays, scalars = runs
    one = world1["scalars"][f"1/{method}"]
    assert iters_close(scalars[f"{mesh}/{method}"]["iterations"],
                       one["iterations"])
    assert rel_err(arrays[f"{mesh}/{method}/x"],
                   world1["arrays"][f"1/{method}/x"]) < 1e-6


@pytest.mark.parametrize("case", [f"{m}/bitwise" for m in METHODS]
                         + ["many/bitwise", "guard/bitwise",
                            "block_jacobi/bitwise",
                            "block_jacobi_many/bitwise"])
def test_world1_is_bitwise_the_single_process_solve(case, world1):
    """One rank: an all-reduce of one rank and zero halos at both ends,
    so the arithmetic is the single-process Stencil7 solve's."""
    assert world1["scalars"][f"1/{case}"] is True


def test_cache_eviction_keeps_the_mesh_programs(world1):
    assert world1["scalars"]["1/eviction"] == dict(
        own_released=True, mesh_kept=True, rebuilt=0)


def test_world1_refuses_trace_and_profile(world1):
    """Ported now: at world 1 a traced mesh ``solve`` and ``solve_many``
    return the single-process solves' rings and bits, and a profiled
    mesh solve writes its report."""
    assert world1["scalars"]["1/refused"] == [True] * 3


@pytest.mark.parametrize("world", [1, 2, 4])
def test_traced_mesh_ring_is_the_same_on_every_rank(world, world1, world2,
                                                     world4, jax_refs):
    """The ring is built from the all-reduced dots, so every rank holds
    the same one.  It is the JAX package's single-process trace of the same
    solve over the first 16 rows (``test_torch_observe.assert_rows_match``:
    the iteration and status channels exact, the others within 1e-8 of each
    channel's largest magnitude), and the port's single-process trace's:
    bitwise at world 1, within the same noise across ranks."""
    run = {1: world1, 2: world2, 4: world4}[world]
    got = run["scalars"][f"{world}/traced/trace"]
    assert got["same_on_every_rank"] is True
    ring = run["arrays"][f"{world}/traced/trace"]
    assert_rows_match(ConvergenceTrace(ring, got["steps"]),
                      jax_refs["p-bicgsafe"]["trace"])
    single = world1["arrays"]["1/single/trace"]
    if world == 1:
        assert np.array_equal(ring, single, equal_nan=True)
        return
    assert iters_close(got["iterations"],
                       world1["scalars"]["1/traced/trace"]["iterations"])
    assert got["steps"] == got["iterations"] + 1
    rows = min(16, got["iterations"])
    for ch in range(ring.shape[1]):
        g, w = ring[:rows, ch], single[:rows, ch]
        if ch in (0, 6):                            # iteration, status
            assert np.array_equal(g, w), ch
        else:
            assert np.max(np.abs(g - w)) <= 1e-8 * max(
                np.max(np.abs(w)), np.finfo(float).tiny), ch


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_reductions_started_per_iteration(method, runs):
    assert runs[1][f"syncs/{method}"] == REDUCTIONS[method]


def test_one_step_starts_its_reduction_before_the_halo_exchange(world2):
    """p-BiCGSafe's step: the all-reduce of the fused dots is started
    before the halo exchange of ``A s``, and waited on after that
    matvec."""
    log = world2["scalars"]["order"]
    # the built solve's one eager all-reduce (it makes the communicator);
    # the set-up: A r_0 (a halo matvec), then the ||r_0|| reduction
    setup = ["reduce_start", "reduce_wait",
             "halo_send", "matvec_end", "reduce_start", "reduce_wait"]
    assert log[:6] == setup, log
    step = log[6:]
    assert step[:4] == ["reduce_start", "halo_send", "matvec_end",
                        "reduce_wait"], log
    # then A w: one more matvec and no other reduction
    assert step[4:] == ["halo_send", "matvec_end"], log


@pytest.mark.parametrize("pc", ["block_jacobi", "jacobi"])
def test_shard_local_precond_adds_no_reduction(pc, runs, problem):
    arrays, scalars = runs
    assert scalars[f"syncs/precond/{pc}"] == 1
    got = scalars[f"precond/{pc}"]
    assert got["converged"]
    assert got["iterations"] <= scalars["8/p-bicgsafe"]["iterations"]
    assert rel_err(arrays[f"precond/{pc}/x"], problem["xt"]) < 1e-6


def test_cuda_substrate_on_the_mesh(runs, problem):
    """The ``"cuda"`` substrate on CPU tensors (its kernels' plain
    versions) on the (8,) mesh."""
    arrays, scalars = runs
    got = scalars["8/p-bicgsafe/cuda"]
    assert got["converged"]
    assert iters_close(got["iterations"],
                       scalars["8/p-bicgsafe"]["iterations"])
    assert rel_err(arrays["8/p-bicgsafe/cuda/x"], problem["xt"]) < 1e-6


@pytest.mark.parametrize("case,shards", [("4x2[model]", 2),
                                         ("2x2x2[data,model]", 4)])
def test_shard_axes_shards_over_the_named_dimensions(case, shards, runs,
                                                     problem, jax_refs):
    arrays, scalars = runs
    assert scalars[f"{case}/shards"] == shards
    got = scalars[f"{case}/p-bicgsafe"]
    assert got["converged"]
    assert iters_close(got["iterations"],
                       jax_refs["p-bicgsafe"]["iterations"])
    assert rel_err(arrays[f"{case}/p-bicgsafe/x"], problem["xt"]) < 1e-6


def test_free_functions_solve_as_the_session_does(world2):
    """``distributed_stencil_solve{,_batched}`` (deprecated, as in the JAX
    package) build what the bound session builds, and solve as it does."""
    arrays, scalars = world2["arrays"], world2["scalars"]
    assert scalars["deprecated"] == ["DeprecationWarning"]
    assert scalars["2/free/p-bicgsafe"] == scalars["2/p-bicgsafe"]
    np.testing.assert_array_equal(arrays["2/free/p-bicgsafe/x"],
                                  arrays["2/p-bicgsafe/x"])
    assert all(scalars["2/free/many"]["converged"])
    assert scalars["replicated"] == [2.0, 2.0, 2.0]


def test_indivisible_nx_raises(world2):
    assert world2["scalars"]["indivisible"] == \
        "ValueError: nx=15 not divisible by 2 shards"


def test_repeated_on_mesh_returns_the_same_binding(world2):
    assert world2["scalars"]["same_binding"] is True


# ---------------------------------------------------------------------------
# the batched solve on the mesh
# ---------------------------------------------------------------------------

def _true_relres(problem, x, j):
    """The true residual of column j of the block (the stencil in
    numpy)."""
    op = Stencil7Operator(torch.tensor(problem["c"]), 16, 16, 16)
    b = problem["B"][:, j]
    r = b - op.matvec(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    return float(np.linalg.norm(r) / np.linalg.norm(b))


@pytest.mark.parametrize("mesh", ["8", "4x2"])
def test_solve_many_matches_jax_per_column(mesh, runs, jax_refs, problem):
    arrays, scalars = runs
    got = scalars[f"{mesh}/many"]
    x = arrays[f"{mesh}/many/x"]
    assert all(got["converged"]), got
    for j in range(3):
        assert _true_relres(problem, x[:, j], j) < 1e-6
        assert iters_close(got["iterations"][j],
                           int(jax_refs["many"]["iterations"][j]))
        assert rel_err(x[:, j], jax_refs["many"]["x"][:, j]) < 1e-6
    # one (9, 3) all-reduce per step, and the set-up's (1, 3) norms
    assert scalars[f"{mesh}/many/shapes"] == [[1, 3], [9, 3]]


_JAX_MESH = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from repro.core import SolverConfig, matrices as M
from repro.core.distributed import build_stencil_solver_batched
d = np.load(sys.argv[1])
op = M.Stencil7Operator(jnp.asarray(d["c"]), 16, 16, 16)
mesh = jax.make_mesh((8,), ("rows",))
res = build_stencil_solver_batched(
    op, mesh, config=SolverConfig(tol=1e-8, maxiter=2000))(
    jnp.asarray(d["B"]).reshape(16, 16, 16, 3))
np.savez(sys.argv[2], x=np.asarray(res.x).reshape(-1, 3),
         iterations=np.asarray(res.iterations))
"""


def test_solve_many_matches_the_jax_mesh_solve(runs, problem, tmp_path):
    """Against the JAX 8-device mesh solve, run in a process of its own
    with 8 fake CPU devices; its ``x`` is gathered with ``np.asarray``
    before anything else touches it (ROADMAP C2)."""
    out = tmp_path / "jax_mesh.npz"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_MESH, problem["path"],
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=JAX_MESH_TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(out)
    arrays, scalars = runs
    for j in range(3):
        assert iters_close(scalars["8/many"]["iterations"][j],
                           int(ref["iterations"][j]))
        assert rel_err(arrays["8/many/x"][:, j], ref["x"][:, j]) < 1e-6


def test_guarded_mesh_solve_equals_unguarded(runs):
    """The JAX check_guarded_numeric: the health rows observe, never
    steer; one (11, m) all-reduce per step."""
    arrays, scalars = runs
    plain, guard = scalars["guard=False"], scalars["guard=True"]
    assert all(guard["converged"])
    assert guard["iterations"] == plain["iterations"]
    np.testing.assert_allclose(arrays["guard=True/x"],
                               arrays["guard=False/x"], rtol=1e-12,
                               atol=1e-13)
    assert scalars["guard=True/shapes"] == [[1, 2], [11, 2]]
    assert scalars["guard=False/shapes"] == [[1, 2], [9, 2]]


# ---------------------------------------------------------------------------
# dot_reduce= and blocked= in one process
# ---------------------------------------------------------------------------

@pytest.fixture
def small():
    op, b, _ = TM.convection_diffusion(
        8, peclet=1.0, device="cpu")
    repro_torch.clear_session_cache()
    return op, b


@pytest.mark.parametrize("method", METHODS)
def test_dot_reduce_session_is_bitwise_the_default(method, small):
    """A counting identity hook computes what the default does, counts
    Table 3.1's reductions per step, and its session is not cached."""
    op, b = small
    cfg = SolverConfig(tol=1e-8, maxiter=300)
    ref = repro_torch.make_solver(method, op, device="cpu",
                                  config=cfg).solve(b)
    counter = SyncCounter(identity_reduce)
    sess = repro_torch.make_solver(method, op, device="cpu", config=cfg,
                                   dot_reduce=counter)
    res = sess.solve(b)
    assert torch.equal(res.x, ref.x)
    assert int(res.iterations) == int(ref.iterations)
    assert counter.calls == 1 + REDUCTIONS[method] * sess.stats["steps"]
    assert repro_torch.make_solver(method, op, device="cpu", config=cfg,
                                   dot_reduce=counter) is not sess
    assert repro_torch.api.session_cache_info()["sessions"] == 1


def test_one_shot_solve_takes_dot_reduce(small):
    op, b = small
    counter = SyncCounter(lambda p: p)
    res = repro_torch.solve(op, b, device="cpu", dot_reduce=counter)
    assert bool(res.converged) and counter.calls > 1


def test_on_mesh_refuses_a_custom_dot_reduce(small):
    op, _ = small
    sess = repro_torch.make_solver("p-bicgsafe", op, device="cpu",
                                   dot_reduce=identity_reduce)
    with pytest.raises(ValueError, match="custom dot_reduce"):
        sess.on_mesh(None)


def test_on_mesh_refuses_a_non_stencil_operator(small):
    op, _ = small
    ell = TM.stencil_to_ell(op)
    with pytest.raises(TypeError, match="Stencil7Operator"):
        repro_torch.make_solver("p-bicgsafe", ell, device="cpu").on_mesh(None)


def test_recovery_passes_dot_reduce_on(small):
    op, b = small
    counter = SyncCounter(identity_reduce)
    guarded = repro_torch.make_solver("p-bicgsafe", op, device="cpu",
                                      recovery=True, dot_reduce=counter)
    res = guarded.solve_many(torch.stack([b, 2 * b], dim=1))
    assert bool(res.converged.all())
    assert counter.shapes == {(1, 2), (11, 2)}


def _jax_block(jop):
    """The JAX operator's (n, m) block matvec, column by column."""
    return jax.vmap(jop.matvec, in_axes=1, out_axes=1)


def _jax_block_problem():
    with enable_x64(True):
        op, b, _ = JM.convection_diffusion(8, peclet=1.0)
        B = np.stack([np.asarray(b), 0.5 * np.asarray(b) + 1.0], axis=1)
        return np.asarray(op.c), B


def test_solve_batched_blocked_matches_jax():
    c, B = _jax_block_problem()
    cfg = dict(tol=1e-8, maxiter=500)
    with enable_x64(True):
        jop = JM.Stencil7Operator(jnp.asarray(c), 8, 8, 8)
        ref = jmultirhs.solve_batched(_jax_block(jop), jnp.asarray(B),
                                      config=JConfig(**cfg), blocked=True)
    op = Stencil7Operator(torch.tensor(c), 8, 8, 8)
    res = multirhs.solve_batched(op.matvec, torch.from_numpy(B),
                                 config=SolverConfig(**cfg), blocked=True)
    assert bool(res.converged.all())
    for j in range(2):
        assert abs(int(res.iterations[j]) - int(ref.iterations[j])) <= 2
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-6)


def test_make_solver_blocked_matches_jax():
    c, B = _jax_block_problem()
    cfg = dict(tol=1e-8, maxiter=500)
    with enable_x64(True):
        jop = JM.Stencil7Operator(jnp.asarray(c), 8, 8, 8)
        ref = repro.make_solver("p-bicgsafe", _jax_block(jop),
                                config=JConfig(**cfg), blocked=True) \
            .solve_many(jnp.asarray(B))
    op = Stencil7Operator(torch.tensor(c), 8, 8, 8)
    sess = repro_torch.make_solver("p-bicgsafe", op.matvec, device="cpu",
                                   config=SolverConfig(**cfg), blocked=True)
    res = sess.solve_many(torch.from_numpy(B))
    assert bool(res.converged.all())
    for j in range(2):
        assert abs(int(res.iterations[j]) - int(ref.iterations[j])) <= 2
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-6)
    with pytest.raises(ValueError, match="blocked=True"):
        sess.solve(torch.from_numpy(B[:, 0]))


def test_batched_m1_with_squeezing_dot_reduce():
    """The JAX package's regression: a dot_reduce that squeezes the
    degenerate (k, 1) partial block to (k,) still solves, as the
    default does."""
    op, b, _ = TM.poisson3d(8, device="cpu")
    cfg = SolverConfig(tol=1e-8, maxiter=2000)
    res = multirhs.solve_batched(
        op, b[:, None], config=cfg,
        dot_reduce=lambda p: p.reshape(p.shape[0]))
    ref = multirhs.solve_batched(op, b[:, None], config=cfg)
    assert bool(res.converged.all())
    assert torch.equal(res.iterations, ref.iterations)
    assert torch.equal(res.x, ref.x)
    with pytest.raises(ValueError, match="dot_reduce turned"):
        multirhs.solve_batched(op, torch.stack([b, b], 1), config=cfg,
                               dot_reduce=lambda p: p[:, 0])
