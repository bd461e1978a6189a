"""The preconditioning slice: ``repro_torch.precond`` and ``precond=`` on every
entry point of the port, held against the JAX package's ``repro.precond``
on the same numpy inputs.

* the block-Jacobi apply (``ops.block_jacobi_apply``, its plain path on the
  CPU) against the JAX oracle and its Pallas kernels in interpret mode;
* each factory built by both packages from the same operator, and carried
  over with ``preconditioner_from_numpy``: equal arrays, equal applies;
* preconditioned solves, single (p-BiCGSafe, -rr, BiCGStab), batched,
  open-loop and guarded, against the JAX solves with the same spec:
  converged, iterations within ±2, ``max|x - x_ref| <= 1e-6`` (ROADMAP C4);
  columns of a batched solve within ±3 of the single solve, as the JAX
  package's own test holds them;
* the loop's structure under preconditioning: the dots never read the
  in-flight ``M^{-1} A s``, and the applies are one per matvec plus one.

fp64 unless stated.  The CUDA kernels run in tests/test_torch_cuda.py and
chip_smoke.py, on the card."""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from conftest import enable_x64  # noqa: E402
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.core import linear_operator as jlo  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.core import multirhs as jmrhs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.precond_apply import (  # noqa: E402
    block_jacobi_apply_batched_pallas, block_jacobi_apply_pallas)
from repro import precond as jprecond  # noqa: E402
from repro.resilience import ChunkFaultInjector as JInjector  # noqa: E402
from repro.resilience import RecoveryPolicy as JPolicy  # noqa: E402
from repro_torch import (SolverConfig, SolveStatus,  # noqa: E402
                         operator_from_numpy, preconditioner_from_numpy)
from repro_torch import precond as tprecond  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core import multirhs, pipelined_bicgsafe  # noqa: E402
from repro_torch.core.bicgstab import bicgstab_solve  # noqa: E402
from repro_torch.core.linear_operator import DenseOperator  # noqa: E402
from repro_torch.core.pipelined_bicgsafe import pbicgsafe_solve  # noqa: E402
from repro_torch.core.substrate import CudaSubstrate  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.resilience import (ChunkFaultInjector,  # noqa: E402
                                    RecoveryPolicy)


@pytest.fixture(autouse=True)
def fresh_sessions():
    """Each test starts from an empty session cache: a session cached by an
    earlier test would carry that test's counts in its ``stats``."""
    repro_torch.clear_session_cache()


CPU = "cpu"
ITER_SLACK = 2
COLUMN_SLACK = 3
X_TOL = 1e-6
SUBSTRATES = ["torch", "cuda"]
PRECONDS = ["jacobi", "block_jacobi", "neumann", "ssor"]
METHODS = ["p-bicgsafe", "p-bicgsafe-rr", "bicgstab"]


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def t_(a):
    return torch.from_numpy(np.array(a))


# -- the block-Jacobi apply ------------------------------------------------------

def _assert_apply_close(got, want, scale, dtype):
    """fp64: within 1e-12 of the result's scale (Σ|B_ij x_j|); fp32: the
    tolerances of tests/test_precond.py."""
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    if dtype == np.float64:
        assert np.max(np.abs(got - want) / np_(scale)) <= 1e-12
    else:
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-5)


@pytest.mark.parametrize("nb,bs", [(12, 16), (7, 8), (300, 4), (3, 128),
                                   (1000, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_jacobi_apply_matches_ref_and_pallas(nb, bs, dtype):
    rng = np.random.default_rng(0)
    inv = rng.standard_normal((nb, bs, bs)).astype(dtype)
    x = rng.standard_normal(nb * bs).astype(dtype)
    got = ops.block_jacobi_apply(t_(inv), t_(x))
    assert got.shape == (nb * bs,) and got.dtype == t_(x).dtype
    scale = ref.block_jacobi_apply(t_(np.abs(inv)), t_(np.abs(x)))
    with enable_x64(dtype == np.float64):
        want = jref.block_jacobi_apply(jnp.asarray(inv), jnp.asarray(x))
        pallas = block_jacobi_apply_pallas(jnp.asarray(inv), jnp.asarray(x),
                                           interpret=True)
    _assert_apply_close(got, want, scale, dtype)
    _assert_apply_close(got, pallas, scale, dtype)


@pytest.mark.parametrize("nb,bs,m", [(12, 16, 3), (7, 8, 1), (64, 4, 17),
                                     (3, 128, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_jacobi_apply_batched_matches_ref_and_pallas(nb, bs, m, dtype):
    rng = np.random.default_rng(1)
    inv = rng.standard_normal((nb, bs, bs)).astype(dtype)
    X = rng.standard_normal((nb * bs, m)).astype(dtype)
    got = ops.block_jacobi_apply(t_(inv), t_(X))
    assert got.shape == (nb * bs, m) and got.is_contiguous()
    scale = ref.block_jacobi_apply(t_(np.abs(inv)), t_(np.abs(X)))
    with enable_x64(dtype == np.float64):
        want = jref.block_jacobi_apply(jnp.asarray(inv), jnp.asarray(X))
        pallas = block_jacobi_apply_batched_pallas(
            jnp.asarray(inv), jnp.asarray(X), interpret=True)
    _assert_apply_close(got, want, scale, dtype)
    _assert_apply_close(got, pallas, scale, dtype)
    # column j of the block apply is the vector apply of column j
    col = ops.block_jacobi_apply(t_(inv), t_(X[:, 0]).contiguous())
    _assert_apply_close(got[:, 0], col, scale[:, 0], dtype)


#: (nb, bs, m, dtype, aligned, route) of the batched kernel: the main
#: path's shape (n = 108**3 in blocks of 64, 8 columns) in both dtypes on
#: the bulk route; rows of no multiple of 16 bytes, too few rows, unaligned
#: pointers and blocks past the ring on the rows route; X_g past the ring
#: on bulk_x_direct
ROUTE_CASES = [
    (19_683, 64, 8, torch.float64, True, "bulk"),
    (19_683, 64, 8, torch.float32, True, "bulk"),
    (19_683, 64, 1, torch.float64, True, "bulk"),
    (37, 64, 17, torch.float64, True, "bulk"),
    (37, 64, 159, torch.float64, True, "bulk"),
    (37, 64, 160, torch.float64, True, "bulk_x_direct"),
    (37, 64, 300, torch.float64, True, "bulk_x_direct"),
    (37, 64, 300, torch.float32, True, "bulk"),
    (301, 3, 8, torch.float64, True, "rows"),
    (301, 5, 8, torch.float32, True, "rows"),
    (301, 6, 8, torch.float32, True, "rows"),
    (301, 30, 8, torch.float64, True, "rows"),
    (301, 32, 8, torch.float64, True, "bulk"),
    (19_683, 64, 8, torch.float64, False, "rows"),
    (20, 116, 8, torch.float64, True, "bulk_x_direct"),
    (20, 120, 8, torch.float64, True, "rows"),
    (20, 164, 8, torch.float32, True, "bulk_x_direct"),
    (20, 172, 8, torch.float32, True, "rows"),
    (2, 1024, 8, torch.float64, True, "rows"),
]


@pytest.mark.parametrize("nb,bs,m,dtype,aligned,route", ROUTE_CASES)
def test_batched_apply_route_follows_the_shape(nb, bs, m, dtype, aligned,
                                               route):
    """The batched kernel's route (kernels/precond_apply.py) is a pure
    function of the shape, the dtype and the operands' alignment."""
    from repro_torch.kernels.precond_apply import batched_route
    assert batched_route(nb, bs, m, dtype, aligned=aligned) == route


@pytest.mark.parametrize("shape", [(72,), (72, 4)])
def test_shared_block_is_one_matmul(shape):
    """nb == 1: one block for every row block (a Stencil7 z-line block),
    the JAX package's dense-product path, on either shape."""
    rng = np.random.default_rng(2)
    inv = rng.standard_normal((1, 8, 8))
    x = rng.standard_normal(shape)
    got = ops.block_jacobi_apply(t_(inv), t_(x))
    with enable_x64(True):
        want = jref.block_jacobi_apply(jnp.asarray(inv), jnp.asarray(x))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-12, atol=1e-14)


def test_block_jacobi_apply_rejects_bad_operands():
    inv = torch.ones(3, 4, 4, dtype=torch.float64)
    x = torch.ones(12, dtype=torch.float64)
    with pytest.raises(ValueError, match="rows"):
        ops.block_jacobi_apply(inv, torch.ones(16, dtype=torch.float64))
    with pytest.raises(ValueError, match="rows"):
        ops.block_jacobi_apply(inv, torch.ones(13, dtype=torch.float64))
    with pytest.raises(ValueError, match="inv_blocks"):
        ops.block_jacobi_apply(inv, x.float())
    with pytest.raises(ValueError, match=r"\(nb, bs, bs\)"):
        ops.block_jacobi_apply(torch.ones(3, 4, 5, dtype=torch.float64), x)
    with pytest.raises(ValueError, match=r"\(nb, bs, bs\)"):
        ops.block_jacobi_apply(torch.ones(12, 4, dtype=torch.float64), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_jacobi_apply(inv.transpose(1, 2), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_jacobi_apply(inv, torch.ones(24, dtype=torch.float64)[::2])
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.block_jacobi_apply(inv.long(), x.long())
    with pytest.raises(TypeError, match="tensor"):
        ops.block_jacobi_apply(np.ones((3, 4, 4)), x)


# -- the factories, built by both packages ----------------------------------------

def _operators(kind):
    """(port operator, JAX operator) of the same matrix, from numpy (call
    it with x64 on)."""
    if kind == "dense":
        op, _, _ = TM.nonsym_dense(48, device=CPU)
        return op, jlo.DenseOperator(jnp.asarray(np_(op.a)))
    if kind == "csr":
        op, _, _ = TM.random_nonsym(96, 5, seed=2, device=CPU)
        return op, jlo.CSROperator(jnp.asarray(np_(op.data)),
                                   jnp.asarray(np_(op.indices)),
                                   jnp.asarray(np_(op.row_ids)), op.n)
    if kind == "ell":
        op, _, _ = TM.random_nonsym(96, 5, seed=3, fmt="ell", device=CPU)
        return op, jlo.ELLOperator(jnp.asarray(np_(op.values)),
                                   jnp.asarray(np_(op.cols)), op.n)
    op, _, _ = TM.convection_diffusion(4, 5, 6, peclet=0.7, device=CPU)
    return op, jlo.Stencil7Operator(jnp.asarray(np_(op.c)), 4, 5, 6)


def _arrays(kind, jpc):
    """The numpy arrays of a JAX preconditioner, for preconditioner_from_numpy."""
    if kind == "jacobi":
        return {"inv_diag": np_(jpc.inv_diag)}
    if kind == "block_jacobi":
        return {"inv_blocks": np_(jpc.inv_blocks)}
    if kind == "neumann":
        return {"inv_diag": np_(jpc.inv_diag), "degree": jpc.degree,
                "omega": jpc.omega}
    return {"c": np_(jpc.c), "nx": jpc.nx, "ny": jpc.ny, "nz": jpc.nz,
            "omega": jpc.omega, "terms": jpc.terms}


FACTORY_CASES = [(op, pc) for op in ("dense", "csr", "ell", "stencil7")
                 for pc in PRECONDS if pc != "ssor" or op == "stencil7"]


@pytest.mark.parametrize("op_kind,pc_kind", FACTORY_CASES)
def test_factory_matches_jax_and_carries_over(op_kind, pc_kind):
    with enable_x64(True):
        op, jop = _operators(op_kind)
        n = op.shape[0]
        rng = np.random.default_rng(5)
        x = rng.standard_normal(n)
        X = rng.standard_normal((n, 3))
        jpc = jprecond.resolve_precond(pc_kind, jop)
        want_x = np_(jpc.apply(jnp.asarray(x)))
        want_X = np_(jpc.apply(jnp.asarray(X)))
        arrays = _arrays(pc_kind, jpc)
    pc = tprecond.resolve_precond(pc_kind, op)
    assert pc.name == pc_kind
    mine = _arrays(pc_kind, pc)
    for key, val in arrays.items():
        if isinstance(val, np.ndarray):
            assert mine[key].shape == val.shape and mine[key].dtype == val.dtype
            np.testing.assert_allclose(mine[key], val, rtol=1e-15, atol=0,
                                       err_msg=key)
        else:
            assert mine[key] == val, key
    carried = preconditioner_from_numpy(pc_kind, arrays, op=op, device=CPU)
    assert type(carried) is type(pc)
    cuda = repro_torch.get_substrate("cuda")
    for p in (pc, carried):
        for apply in (p.apply, cuda.as_precond_apply(p),
                      repro_torch.get_substrate("torch").as_precond_apply(p)):
            np.testing.assert_allclose(np_(apply(t_(x))), want_x,
                                       rtol=1e-12, atol=1e-13)
            np.testing.assert_allclose(np_(apply(t_(X))), want_X,
                                       rtol=1e-12, atol=1e-13)


def test_block_jacobi_shapes_follow_the_jax_package():
    """ELL and CSR: the largest divisor of n up to 64 (the main path's
    1,259,712 rows take 64); Stencil7: one shared z-line block; an
    explicit block size must divide n (nz for a stencil)."""
    from repro.precond.block_jacobi import _default_block_size as jdefault
    from repro_torch.precond.block_jacobi import _default_block_size
    for n in (1, 2, 7, 96, 1000, 108 ** 3, 97 * 3):
        assert _default_block_size(n) == jdefault(n)
    assert _default_block_size(108 ** 3) == 64
    ell, _ = _operators("ell")
    assert tuple(tprecond.block_jacobi(ell).inv_blocks.shape) == (2, 48, 48)
    assert tuple(tprecond.block_jacobi(ell, 8).inv_blocks.shape) == (12, 8, 8)
    sten, _ = _operators("stencil7")
    assert tuple(tprecond.block_jacobi(sten).inv_blocks.shape) == (1, 6, 6)
    with pytest.raises(ValueError, match="divide nz"):
        tprecond.block_jacobi(sten, 4)
    with pytest.raises(ValueError, match="divide n"):
        tprecond.block_jacobi(ell, 7)
    with pytest.raises(TypeError, match="cannot extract"):
        tprecond.block_jacobi(types.SimpleNamespace(shape=(8, 8)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_jacobi_inverts_in_the_operator_dtype(dtype):
    op, _, _ = TM.random_nonsym(64, 5, seed=4, dtype=dtype, fmt="ell",
                                device=CPU)
    with enable_x64(dtype == np.float64):
        jop = jlo.ELLOperator(jnp.asarray(np_(op.values)),
                              jnp.asarray(np_(op.cols)), op.n)
        want = np_(jprecond.block_jacobi(jop).inv_blocks)
    got = np_(tprecond.block_jacobi(op).inv_blocks)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_block_jacobi_singular_block_guard():
    """A singular diagonal block (an empty row) becomes the identity, as in
    the JAX package, instead of a LinAlgError at set-up."""
    a = np.diag(np.arange(1.0, 13.0))
    a[2, :] = 0.0
    inv = np_(tprecond.block_jacobi(DenseOperator(t_(a)), 4).inv_blocks)
    with enable_x64(True):
        want = np_(jprecond.block_jacobi(jlo.DenseOperator(jnp.asarray(a)),
                                         block_size=4).inv_blocks)
    assert np.isfinite(inv).all()
    np.testing.assert_allclose(inv[0], np.eye(4))
    np.testing.assert_allclose(inv[1], np.linalg.inv(a[4:8, 4:8]))
    np.testing.assert_array_equal(inv, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jacobi_zero_diagonal_guard_keeps_the_dtype(dtype):
    a = torch.diag(torch.tensor([2.0, 0.0, -4.0, 8.0], dtype=dtype))
    pc = tprecond.jacobi(DenseOperator(a))
    assert pc.inv_diag.dtype == dtype
    np.testing.assert_allclose(np_(pc.inv_diag), [0.5, 1.0, -0.25, 0.125])


def test_specs_raise_the_jax_packages_errors():
    op, b, _ = TM.poisson3d(4, device=CPU)
    assert tprecond.resolve_precond(None, op) is None
    pc = tprecond.jacobi(op)
    assert tprecond.resolve_precond(pc, op) is pc
    with pytest.raises(ValueError, match="unknown preconditioner"):
        tprecond.resolve_precond("ilu", op)
    with pytest.raises(TypeError, match="operator object"):
        tprecond.resolve_precond("jacobi", op.matvec)
    with pytest.raises(TypeError, match="Preconditioner"):
        tprecond.resolve_precond(3, op)
    with pytest.raises(TypeError, match="Stencil7Operator"):
        tprecond.ssor(TM.nonsym_dense(16, device=CPU)[0])
    # the session checks the spec when it is made, and builds it lazily
    with pytest.raises(ValueError, match="unknown preconditioner"):
        repro_torch.make_solver("p-bicgsafe", op, device=CPU, precond="ilu")
    with pytest.raises(TypeError, match="operator object"):
        repro_torch.make_solver("p-bicgsafe", op.matvec, device=CPU,
                                precond="jacobi")
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                precond="block_jacobi")
    assert "block_jacobi" in repr(s) and not s._precond_built
    assert s.precond is s.precond and s.precond_spec == "block_jacobi"
    # the bare-callable composition of the JAX package
    mv = tprecond.preconditioned_matvec(op, pc)
    np.testing.assert_allclose(np_(mv(b)), np_(op.matvec(b) / 6.0),
                               rtol=1e-12)


def test_preconditioner_from_numpy_checks_its_arrays():
    with pytest.raises(ValueError, match="unknown preconditioner kind"):
        preconditioner_from_numpy("ilu", {}, device=CPU)
    with pytest.raises(KeyError, match="inv_blocks"):
        preconditioner_from_numpy("block_jacobi", {}, device=CPU)
    with pytest.raises(TypeError, match="op="):
        preconditioner_from_numpy("neumann", {"inv_diag": np.ones(4),
                                              "degree": 2, "omega": 1.0},
                                  device=CPU)
    pc = preconditioner_from_numpy("jacobi", {"inv_diag": np.ones(4)},
                                   device=CPU, dtype=torch.float32)
    assert pc.inv_diag.dtype == torch.float32


# -- preconditioned solves against the JAX package ------------------------------------

def _convdiff_arrays():
    top, b, _ = TM.convection_diffusion(10, peclet=1.0, device=CPU)
    values, cols = TM.stencil_ell_arrays(np_(top.c), 10, 10, 10)
    return np_(top.c), values, cols, np_(b)


def _jax_operator(form):
    c, values, cols, _ = _convdiff_arrays()
    if form == "stencil7":
        return jlo.Stencil7Operator(jnp.asarray(c), 10, 10, 10)
    return jlo.ELLOperator(jnp.asarray(values), jnp.asarray(cols),
                           values.shape[0])


def _port_operator(form):
    c, values, cols, _ = _convdiff_arrays()
    if form == "stencil7":
        return operator_from_numpy("stencil7", {"c": c, "nx": 10, "ny": 10,
                                                "nz": 10}, device=CPU)
    return operator_from_numpy("ell", {"values": values, "cols": cols,
                                       "n": values.shape[0]}, device=CPU)


CFG = dict(tol=1e-8, maxiter=2000, rr_epoch=5)


@functools.lru_cache(maxsize=None)
def jax_solve(method, pc, form):
    b = _convdiff_arrays()[3]
    with enable_x64(True):
        res = repro.make_solver(method, _jax_operator(form), precond=pc,
                                config=JConfig(**CFG)).solve(jnp.asarray(b))
        return dict(x=np_(res.x), iterations=int(res.iterations),
                    converged=bool(res.converged), relres=float(res.relres))


SOLVE_CASES = [(m, p, f) for f in ("stencil7", "ell") for p in PRECONDS
               for m in METHODS if p != "ssor" or f == "stencil7"]


@pytest.mark.parametrize("method,pc,form", SOLVE_CASES)
def test_preconditioned_solve_matches_jax(method, pc, form):
    ref_ = jax_solve(method, pc, form)
    op = _port_operator(form)
    b = t_(_convdiff_arrays()[3])
    substrate = "cuda" if form == "ell" else "torch"
    solver = repro_torch.make_solver(method, op, precond=pc, device=CPU,
                                     substrate=substrate,
                                     config=SolverConfig(**CFG))
    res = solver.solve(b)
    assert bool(res.converged) and ref_["converged"]
    assert abs(int(res.iterations) - ref_["iterations"]) <= ITER_SLACK
    x = np_(res.x)
    assert np.max(np.abs(x - ref_["x"])) <= X_TOL
    # relres is the preconditioned residual's; the original system's
    # residual is reported beside it and is small too
    assert float(res.relres) <= CFG["tol"]
    orig = float(torch.linalg.vector_norm(b - op.matvec(res.x))
                 / torch.linalg.vector_norm(b))
    assert orig <= 1e-5, orig
    if method == "p-bicgsafe-rr":
        assert solver.stats["rr_steps"] >= 1


def test_precond_rescues_hard_nonsym():
    """bench_precond.json's scenario at n = 600: plain p-BiCGSafe does not
    converge in 1500 iterations; block_jacobi does, within ±2 of the JAX
    package's count, and solves the original system."""
    op, b, xt = TM.hard_nonsym(n=600, device=CPU)
    cfg = dict(tol=1e-8, maxiter=1500)
    with enable_x64(True):
        jop, jb, _ = JM.hard_nonsym(n=600)
        jres = repro.make_solver("p-bicgsafe", jop, precond="block_jacobi",
                                 config=JConfig(**cfg)).solve(jb)
        jit, jconv = int(jres.iterations), bool(jres.converged)
    np.testing.assert_array_equal(np_(op.a), np_(jop.a))
    plain = pbicgsafe_solve(op, b, config=SolverConfig(**cfg))
    prec = pbicgsafe_solve(op, b, config=SolverConfig(**cfg),
                           precond="block_jacobi", substrate="cuda")
    assert not bool(plain.converged)
    assert bool(prec.converged) and jconv
    assert abs(int(prec.iterations) - jit) <= ITER_SLACK
    assert int(prec.iterations) < 100
    orig = float(torch.linalg.vector_norm(b - op.matvec(prec.x))
                 / torch.linalg.vector_norm(b))
    assert orig < 1e-4
    assert float(torch.linalg.vector_norm(prec.x - xt)
                 / torch.linalg.vector_norm(xt)) < 1e-5


# -- batched, open-loop and guarded ------------------------------------------------------

def _rhs_block(m=4, seed=3):
    b = _convdiff_arrays()[3]
    rng = np.random.default_rng(seed)
    return np.stack([b] + [rng.standard_normal(b.shape)
                           for _ in range(m - 1)], axis=1)


@functools.lru_cache(maxsize=None)
def jax_batched(pc, form):
    B = _rhs_block()
    with enable_x64(True):
        op = _jax_operator(form)
        res = jmrhs.solve_batched(op, jnp.asarray(B), config=JConfig(**CFG),
                                  precond=pc, substrate="jnp")
        return dict(x=np_(res.x), iterations=np_(res.iterations),
                    converged=np_(res.converged))


def _assert_columns(res, ref_, singles):
    it = np_(res.iterations).astype(int)
    assert np_(res.converged).all() and ref_["converged"].all()
    assert np.abs(it - ref_["iterations"]).max() <= ITER_SLACK
    assert np.max(np.abs(np_(res.x) - ref_["x"])) <= X_TOL
    for j, single in enumerate(singles):
        assert abs(it[j] - int(single.iterations)) <= COLUMN_SLACK
        assert np.max(np.abs(np_(res.x)[:, j] - np_(single.x))) <= X_TOL


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("pc,form", [("block_jacobi", "ell"),
                                     ("neumann", "ell"),
                                     ("ssor", "stencil7")])
def test_solve_batched_and_solve_many_match_jax(pc, form, substrate):
    ref_ = jax_batched(pc, form)
    op = _port_operator(form)
    B = t_(_rhs_block())
    cfg = SolverConfig(**CFG)
    singles = [pbicgsafe_solve(op, B[:, j].contiguous(), config=cfg,
                               precond=pc, substrate=substrate)
               for j in range(B.shape[1])]
    res = multirhs.solve_batched(op, B, config=cfg, precond=pc,
                                 substrate=substrate)
    _assert_columns(res, ref_, singles)
    many = repro_torch.make_solver("p-bicgsafe", op, precond=pc,
                                   substrate=substrate, device=CPU,
                                   config=cfg).solve_many(B)
    assert torch.equal(many.iterations, res.iterations)
    assert torch.equal(many.x, res.x)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_open_loop_handles_precondition_every_rhs(substrate):
    """init / step_chunk / splice on a block_jacobi session: the spliced
    columns solve the preconditioned systems of their fresh right-hand
    sides (as solve_many of them does) and the kept ones run on."""
    op = _port_operator("ell")
    B = t_(_rhs_block())
    cfg = SolverConfig(**CFG)
    solver = repro_torch.make_solver("p-bicgsafe", op, precond="block_jacobi",
                                     substrate=substrate, device=CPU,
                                     config=cfg)
    st = solver.init(B)
    st = solver.step_chunk(st, 5)
    refill = torch.tensor([False, True, False, True])
    B_new = t_(_rhs_block(seed=9))
    st = solver.splice(st, refill, B_new)
    st = solver.step_chunk(st, 2000)
    res = solver.result(st)
    assert np_(res.converged).all()
    whole = solver.solve_many(B)
    fresh = solver.solve_many(B_new[:, refill])
    it = np_(res.iterations).astype(int)
    assert np.abs(it[[0, 2]] - np_(whole.iterations)[[0, 2]]).max() <= 1
    assert np.abs(it[[1, 3]] - np_(fresh.iterations)).max() <= ITER_SLACK
    assert float((res.x[:, refill] - fresh.x).abs().max()) <= X_TOL
    assert float((res.x[:, ~refill] - whole.x[:, ~refill]).abs().max()) \
        <= X_TOL
    with enable_x64(True):
        jref_ = jmrhs.solve_batched(
            _jax_operator("ell"), jnp.asarray(np_(B_new[:, refill])),
            config=JConfig(**CFG), precond="block_jacobi", substrate="jnp")
        jx = np_(jref_.x)
    assert np.max(np.abs(np_(res.x[:, refill]) - jx)) <= X_TOL


def _guarded_problem():
    with enable_x64(True):
        op, b, _ = JM.nonsym_dense(64)
        a, b = np.array(op.a), np_(b)
    return a, b / np.linalg.norm(b)


def _run_guarded_jax(a, B, policy_kw, cfg_kw, inject):
    with enable_x64(True):
        gs = repro.make_solver(
            "p-bicgsafe", repro.core.DenseOperator(jnp.asarray(a)),
            precond="block_jacobi", config=JConfig(**cfg_kw),
            recovery=JPolicy(**policy_kw))
        gs.inject = None if inject is None else JInjector(**inject)
        res = gs.solve_many(jnp.asarray(B))
        return dict(x=np_(res.x), iterations=np_(res.iterations),
                    status=np_(res.status), events=list(gs.events))


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("scenario", ["nan_restart", "drift_replace"])
def test_recovery_under_preconditioning_matches_jax(scenario, substrate):
    """The recovery steps recompute residuals of the preconditioned system
    (against M^{-1} B): the same events and typed statuses as the JAX
    package's guarded solve with the same spec, solutions within 1e-6."""
    a, b = _guarded_problem()
    B = np.stack([b, 0.7 * b], axis=1)
    cfg_kw = dict(tol=1e-8, maxiter=400)
    if scenario == "nan_restart":
        policy_kw, inject = dict(chunk=8), dict(nan_at={1: (0,)})
    else:
        policy_kw, inject = dict(chunk=8, drift_scale=1e-12), None
    ref_ = _run_guarded_jax(a, B, policy_kw, cfg_kw, inject)
    gs = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(t_(a)), precond="block_jacobi",
        substrate=substrate, device=CPU, config=SolverConfig(**cfg_kw),
        recovery=RecoveryPolicy(**policy_kw))
    gs.inject = None if inject is None else ChunkFaultInjector(**inject)
    res = gs.solve_many(t_(B))
    kinds = {"nan_restart": "restart", "drift_replace": "replace"}
    assert any(e["event"] == kinds[scenario] for e in gs.events)
    assert gs.events == ref_["events"]
    assert np_(res.status).tolist() == ref_["status"].tolist()
    assert (np_(res.status) == SolveStatus.CONVERGED).all()
    assert np.abs(np_(res.iterations).astype(int)
                  - ref_["iterations"]).max() <= ITER_SLACK
    assert np.max(np.abs(np_(res.x) - ref_["x"])) <= X_TOL
    # the original systems are solved, not only the preconditioned ones
    true = np.linalg.norm(B - a @ np_(res.x), axis=0) / np.linalg.norm(B,
                                                                       axis=0)
    assert (true <= 1e-6).all()


def test_degraded_and_fallback_sessions_keep_the_preconditioner():
    a, b = _guarded_problem()
    gs = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(t_(a)), precond="block_jacobi",
        substrate="cuda", device=CPU,
        config=SolverConfig(tol=1e-8, maxiter=400),
        recovery=RecoveryPolicy(chunk=8))
    gs.inject = ChunkFaultInjector(fail_at=(1,))
    res = gs.solve(t_(b))
    assert bool(res.converged)
    assert gs._active.sub.name == "torch"
    assert gs._active.precond is gs.session.precond
    assert isinstance(gs.session.precond,
                      tprecond.BlockJacobiPreconditioner)
    plain = repro_torch.make_solver(
        "p-bicgsafe", DenseOperator(t_(a)), precond="block_jacobi",
        device=CPU, config=SolverConfig(tol=1e-8, maxiter=400)).solve(t_(b))
    assert abs(int(res.iterations) - int(plain.iterations)) <= ITER_SLACK


def test_bicgstab_and_top_level_solve_take_precond():
    op, b, xt = TM.convection_diffusion(8, peclet=1.0, device=CPU)
    for method in METHODS:
        res = repro_torch.solve(op, b, method, precond="ssor", device=CPU,
                                config=SolverConfig(tol=1e-8, maxiter=2000))
        assert bool(res.converged), method
        assert float(torch.linalg.vector_norm(res.x - xt)
                     / torch.linalg.vector_norm(xt)) < 1e-5
    res = bicgstab_solve(op, b, precond=tprecond.jacobi(op))
    assert bool(res.converged)


# -- the loop's structure under preconditioning ------------------------------------

class RecordingSubstrate(CudaSubstrate):
    """The "cuda" substrate, recording what the dots are fed and what each
    matvec and each M^{-1}-apply takes and gives."""

    name = "recording"

    def __init__(self):
        self.dot_calls, self.matvec_io, self.apply_io = [], [], []

    def bicgsafe_dots(self, s, y, r, t_prev, rs):
        self.dot_calls.append((s, y, r, t_prev, rs))
        return super().bicgsafe_dots(s, y, r, t_prev, rs)

    def _recorded(self, fn, log):
        def call(x):
            out = fn(x)
            log.append((x, out))
            return out
        return call

    def as_matvec(self, op):
        return self._recorded(super().as_matvec(op), self.matvec_io)

    def as_block_matvec(self, op):
        return self._recorded(super().as_block_matvec(op), self.matvec_io)

    def as_precond_apply(self, pc):
        return self._recorded(super().as_precond_apply(pc), self.apply_io)


@pytest.mark.parametrize("pc", ["jacobi", "block_jacobi", "neumann"])
@pytest.mark.parametrize("chunk", [1, 16])
def test_dots_never_read_the_preconditioned_matvec(pc, chunk, monkeypatch):
    """One dot phase per queued step, fed only {s, y, r, t_prev, rs}: the
    composite's output M^{-1} A s is never among them.  One apply per
    matvec of the operator, plus one for b (x0 = None)."""
    monkeypatch.setattr(pipelined_bicgsafe, "CHUNK", chunk)
    op = _port_operator("ell")
    b = t_(_convdiff_arrays()[3])
    sub = RecordingSubstrate()
    stats = {}
    res = pbicgsafe_solve(op, b, substrate=sub, precond=pc, stats=stats)
    it = int(res.iterations)
    assert bool(res.converged)
    assert len(sub.dot_calls) == stats["steps"]
    assert it + 1 <= stats["steps"] <= it + chunk
    # neumann's series runs degree more matvecs inside each apply
    per_apply = 1 + (2 if pc == "neumann" else 0)
    outer = len(sub.apply_io)
    assert len(sub.matvec_io) == per_apply * outer - 1
    assert outer == 2 * stats["steps"] + 2
    mv_in = {id(x): i for i, (x, _) in enumerate(sub.matvec_io)}
    for s, y, r, t_prev, rs in sub.dot_calls:
        # the step's composite: A s, then M^{-1} of it
        As = [out for x, out in sub.matvec_io if x is s]
        assert len(As) == 1 and id(s) in mv_in
        MAs = [out for x, out in sub.apply_io if x is As[0]]
        assert len(MAs) == 1
        for v in (As[0], MAs[0]):
            assert not any(v is w for w in (s, y, r, t_prev, rs))


def test_batched_dots_never_read_the_preconditioned_block_matvec():
    op = _port_operator("ell")
    B = t_(_rhs_block())
    sub = RecordingSubstrate()
    stats = {}
    res = multirhs.solve_batched(op, B, substrate=sub,
                                 precond="block_jacobi", stats=stats,
                                 config=SolverConfig(**CFG))
    assert np_(res.converged).all()
    assert len(sub.dot_calls) == stats["steps"]
    assert len(sub.apply_io) == len(sub.matvec_io) + 1
    assert len(sub.matvec_io) == 1 + 2 * stats["steps"]
    for s, y, r, t_prev, rs in sub.dot_calls:
        MAs = [out for x, out in sub.apply_io
               if any(x is o and i is s for i, o in sub.matvec_io)]
        assert len(MAs) == 1
        assert not any(MAs[0] is w for w in (s, y, r, t_prev, rs))
