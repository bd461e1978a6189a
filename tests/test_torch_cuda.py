"""The port's CUDA kernels on the card (marker ``gpu``; each test skips when
no CUDA device is present).  This file imports no JAX, so it runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import repro_torch  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core.linear_operator import ELLOperator  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_axpy import IN_ORDER, MASKED_OUT  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_sessions():
    """Each test starts from an empty session cache: a session cached by an
    earlier test would carry that test's counts in its ``stats``."""
    repro_torch.clear_session_cache()


pytestmark = pytest.mark.gpu

#: max |kernel - plain| over the result's scale; fp64: FMA contraction and
#: another summation order; fp32: the tolerances of tests/test_kernels.py
TOL = {torch.float64: 1e-12, torch.float32: 5e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def launches(**counts):
    """Every kernel's launch count: 0 unless given."""
    return dict(dict.fromkeys(ops.LAUNCHES, 0), **counts)


def randn(n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=g, device=device, dtype=torch.float64
                       ).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_versions(cuda, dtype):
    n = 100_003                                  # ragged: no multiple of 256
    vs = [randn(n, dtype, cuda, seed) for seed in range(5)]
    before = dict(ops.LAUNCHES)
    got = ops.fused_dots(*vs)
    scale = ref.fused_dots(*(v.abs() for v in vs))
    assert float(((got - ref.fused_dots(*vs)).abs() / scale).max()) \
        <= TOL[dtype]

    vecs = {k: randn(n, dtype, cuda, 10 + i) for i, k in enumerate(IN_ORDER)}
    scal = torch.tensor([0.3, -0.7, 1.1, 0.2], dtype=dtype, device=cuda)
    got = ops.fused_axpy(vecs, scal)
    want = ref.fused_axpy(vecs, scal.unbind(0))
    for k in want:
        assert float((got[k] - want[k]).abs().max()
                     / want[k].abs().max()) <= TOL[dtype], k

    op, _, _ = TM.convection_diffusion(20, 30, 40, dtype=dtype, device=cuda)
    ell = TM.stencil_to_ell(op)
    x = randn(ell.n, dtype, cuda, 99)
    got, want = ops.spmv_ell(ell, x), ref.spmv_ell(ell.values, ell.cols, x)
    assert float((got - want).abs().max() / want.abs().max()) <= TOL[dtype]
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == \
        launches(fused_dots=1, fused_axpy=1, spmv_ell=1)


def test_fused_dots_repeats_bitwise(cuda):
    vs = [randn(1_259_712, torch.float64, cuda, seed) for seed in range(5)]
    first = ops.fused_dots(*vs)
    for _ in range(3):
        assert torch.equal(ops.fused_dots(*vs), first)


def test_spmv_kernel_takes_unbanded_matrices(cuda):
    rng = np.random.default_rng(0)
    n, k = 50_000, 9
    op = ELLOperator(torch.from_numpy(rng.standard_normal((n, k))).to(cuda),
                     torch.from_numpy(rng.integers(0, n, (n, k)).astype(
                         np.int32)).to(cuda), n)
    x = randn(n, torch.float64, cuda, 3)
    got, want = ops.spmv_ell(op, x), ref.spmv_ell(op.values, op.cols, x)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


def test_wrappers_refuse_mixed_devices(cuda):
    v = torch.ones(64, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="unlike"):
        ops.fused_dots(v, v, v, v, v.cpu())


def method_launches(method, steps, rr=0):
    """A single-RHS solve's kernel launches for ``steps`` queued steps and
    ``rr`` replacement steps on an ELL operator (chip_smoke.py's phase 3f
    table): the fused dots only where the method has the 9-dot phase, the
    update kernel only in p-BiCGSafe's, and two SpMVs a step (p-BiCGSafe:
    plus its set-up's A r_0 and -rr's four; p-BiCGStab: plus its set-up's
    two)."""
    if method.startswith("p-bicgsafe"):
        return launches(fused_dots=steps, fused_axpy=steps,
                        spmv_ell=1 + 2 * steps + 4 * rr)
    if method == "ssbicgsafe2":
        return launches(fused_dots=steps, spmv_ell=2 * steps)
    if method == "p-bicgstab":
        return launches(spmv_ell=2 + 2 * steps)
    return launches(spmv_ell=2 * steps)


@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr",
                                    "ssbicgsafe2", "p-bicgstab", "bicgstab",
                                    "gpbicg", "cgs"])
def test_cuda_substrate_matches_torch_substrate(cuda, method):
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)   # default: the card
    assert b.is_cuda
    ell = TM.stencil_to_ell(op)
    cfg = repro_torch.SolverConfig(rr_epoch=20)
    plain = repro_torch.make_solver(method, ell, substrate="torch",
                                    config=cfg).solve(b)
    solver = repro_torch.make_solver(method, ell, substrate="cuda",
                                     config=cfg)
    ops.reset_launches()
    res = solver.solve(b)
    torch.cuda.synchronize()
    assert bool(res.converged) and bool(plain.converged)
    assert int(res.status) == int(plain.status)
    assert abs(int(res.iterations) - int(plain.iterations)) <= 2
    assert float((res.x - plain.x).abs().max()) <= 1e-6
    steps, rr = solver.stats["steps"], solver.stats["rr_steps"]
    assert int(res.iterations) + 1 <= steps <= int(res.iterations) + 16
    assert dict(ops.LAUNCHES) == method_launches(method, steps, rr)


#: batched fp32: the tolerances of tests/test_kernels.py
TOL_BATCHED = {torch.float64: 1e-12, torch.float32: 2e-4}


@pytest.mark.parametrize("m", [1, 3, 8, 17, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_kernels_match_plain_versions(cuda, dtype, m):
    """m = 300 takes the dots kernel's multi-tile path (256 columns a
    tile); the dots of an (n, 1) block go to the single-vector kernel."""
    n = 10_007 if m < 300 else 1_001
    g = torch.Generator(device=cuda).manual_seed(m)

    def block():
        return torch.randn(n, m, generator=g, device=cuda,
                           dtype=torch.float64).to(dtype)

    before = dict(ops.LAUNCHES)
    vs = [block() for _ in range(5)]
    got = ops.fused_dots(*vs)
    scale = ref.fused_dots(*(v.abs() for v in vs))
    assert got.shape == (9, m)
    assert float(((got - ref.fused_dots(*vs)).abs() / scale).max()) \
        <= TOL_BATCHED[dtype]

    vecs = {k: block() for k in IN_ORDER}
    scal = torch.randn(4, m, generator=g, device=cuda,
                       dtype=torch.float64).to(dtype)
    scal[:, 1::2] = float("nan")                 # frozen columns' garbage
    mask = torch.arange(m, device=cuda) % 2 == 0
    got = ops.fused_axpy(vecs, scal, mask)
    want = ref.fused_axpy(vecs, scal.unbind(0), mask)
    for k in want:
        live = want[k][:, mask]
        assert float((got[k][:, mask] - live).abs().max()
                     / live.abs().max()) <= TOL_BATCHED[dtype], k
        if k in MASKED_OUT:
            assert torch.equal(got[k][:, ~mask], vecs[k][:, ~mask]), k

    op, _, _ = TM.convection_diffusion(17, 19, 31, dtype=dtype, device=cuda)
    ell = TM.stencil_to_ell(op)
    x = torch.randn(ell.n, m, generator=g, device=cuda,
                    dtype=torch.float64).to(dtype)
    got, want = ops.spmv_ell(ell, x), ref.spmv_ell(ell.values, ell.cols, x)
    assert float((got - want).abs().max() / want.abs().max()) \
        <= TOL_BATCHED[dtype]
    torch.cuda.synchronize()
    dots = "fused_dots" if m == 1 else "fused_dots_batched"
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == \
        launches(**{dots: 1}, fused_axpy_batched=1, spmv_ell_batched=1)


def test_fused_dots_batched_repeats_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    vs = [torch.randn(1_259_712, 8, generator=g, device=cuda,
                      dtype=torch.float64) for _ in range(5)]
    first = ops.fused_dots(*vs)
    for _ in range(3):
        assert torch.equal(ops.fused_dots(*vs), first)


def test_solve_many_on_the_card_matches_the_torch_substrate(cuda):
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    g = torch.Generator(device=cuda).manual_seed(5)
    B = torch.stack([b] + [torch.randn(b.shape[0], generator=g, device=cuda,
                                       dtype=b.dtype) for _ in range(3)], 1)
    tol = [1e-8, 1e-8, 1e-6, 1e-6]
    plain = repro_torch.make_solver("p-bicgsafe", ell, substrate="torch"
                                    ).solve_many(B, tol=tol)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    ops.reset_launches()
    res = solver.solve_many(B, tol=tol)
    torch.cuda.synchronize()
    assert bool(res.converged.all()) and bool(plain.converged.all())
    assert int((res.iterations - plain.iterations).abs().max()) <= 2
    assert float((res.x - plain.x).abs().max()) <= 1e-6
    steps = solver.stats["steps"]
    assert dict(ops.LAUNCHES) == launches(fused_dots_batched=steps,
                                          fused_axpy_batched=steps,
                                          spmv_ell_batched=1 + 2 * steps)


# -- the guarded (11-row) health dots ------------------------------------------

@pytest.mark.parametrize("m", [None, 1, 3, 8, 17, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_health_kernels_match_plain_versions(cuda, dtype, m):
    """m = None is the single-RHS kernel on (n,) vectors, and an (n, 1)
    block goes to it too; m = 300 is the batched kernel's multi-tile path.
    Rows 0-8 equal the 9-row kernel's bit for bit (one template, one
    summation order)."""
    n = 100_003 if m is None else (10_007 if m < 300 else 1_001)
    g = torch.Generator(device=cuda).manual_seed(7 if m is None else m)
    shape = (n,) if m is None else (n, m)
    vs = [torch.randn(*shape, generator=g, device=cuda,
                      dtype=torch.float64).to(dtype) for _ in range(6)]
    single = m is None or m == 1
    before = dict(ops.LAUNCHES)
    got = ops.fused_dots_health(*vs)
    nine = ops.fused_dots(*(v.view(-1) if single else v for v in vs[:5]))
    torch.cuda.synchronize()
    name = "fused_dots_health" if single else "fused_dots_health_batched"
    base = "fused_dots" if single else "fused_dots_batched"
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == \
        launches(**{name: 1, base: 1})
    assert got.shape == (11,) + shape[1:]
    scale = ref.fused_dots_health(*(v.abs() for v in vs))
    tol = TOL[dtype] if m is None else TOL_BATCHED[dtype]
    assert float(((got - ref.fused_dots_health(*vs)).abs() / scale).max()) \
        <= tol
    assert torch.equal(got[:9].reshape(nine.shape), nine)


@pytest.mark.parametrize("batched", [False, True])
def test_health_kernels_repeat_bitwise(cuda, batched):
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (1_259_712, 8) if batched else (1_259_712,)
    vs = [torch.randn(*shape, generator=g, device=cuda, dtype=torch.float64)
          for _ in range(6)]
    first = ops.fused_dots_health(*vs)
    for _ in range(3):
        assert torch.equal(ops.fused_dots_health(*vs), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_health_probe_flags_exactly_the_poisoned_columns(cuda, dtype):
    """A NaN in x and an Inf in s make row 10 non-finite in exactly those
    columns, on the card as in the plain version; the single kernel flags
    its vector."""
    n, m = 50_000, 5
    g = torch.Generator(device=cuda).manual_seed(3)
    vs = [torch.randn(n, m, generator=g, device=cuda, dtype=torch.float64
                      ).to(dtype) for _ in range(6)]
    vs[0][17, 1] = float("inf")
    vs[5][40_000, 3] = float("nan")
    want = [False, True, False, True, False]
    for rows in (ops.fused_dots_health(*vs), ref.fused_dots_health(*vs)):
        assert (~torch.isfinite(rows[10])).tolist() == want
        assert bool(torch.isfinite(rows[:, [0, 2, 4]]).all())
    single = ops.fused_dots_health(*(v[:, 3].contiguous() for v in vs))
    assert not bool(torch.isfinite(single[10]))
    assert bool(torch.isfinite(single[:9]).all())


def test_guarded_solve_many_on_the_card_matches_the_torch_substrate(cuda):
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    g = torch.Generator(device=cuda).manual_seed(5)
    B = torch.stack([b] + [torch.randn(b.shape[0], generator=g, device=cuda,
                                       dtype=b.dtype) for _ in range(3)], 1)
    tol = [1e-8, 1e-8, 1e-6, 1e-6]
    pol = repro_torch.RecoveryPolicy(chunk=16, substrate_fallback=False)
    plain = repro_torch.make_solver("p-bicgsafe", ell, substrate="torch",
                                    recovery=pol).solve_many(B, tol=tol)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                     recovery=pol)
    unguarded = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda"
                                        ).solve_many(B, tol=tol)
    ops.reset_launches()
    res = solver.solve_many(B, tol=tol)
    torch.cuda.synchronize()
    assert solver.events == []
    assert bool(res.converged.all()) and bool(plain.converged.all())
    assert (res.status == repro_torch.SolveStatus.CONVERGED).all()
    assert int((res.iterations - plain.iterations).abs().max()) <= 2
    assert float((res.x - plain.x).abs().max()) <= 1e-6
    # the health rows observe only: the unguarded solve's iterations
    assert torch.equal(res.iterations, unguarded.iterations)
    steps = solver.stats["steps"]
    assert dict(ops.LAUNCHES) == launches(fused_dots_health_batched=steps,
                                          fused_axpy_batched=steps,
                                          spmv_ell_batched=1 + 2 * steps)


# -- the block-Jacobi apply (preconditioning) ------------------------------------

@pytest.mark.parametrize("m", [None, 1, 8, 17, 300])
@pytest.mark.parametrize("bs", [4, 16, 64, 128, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_jacobi_kernels_match_plain_versions(cuda, dtype, bs, m):
    """m = None is the single kernel on (n,) vectors; an (n, m) block, m = 1
    included, goes to the batched one: bs = 64 on its bulk routes (m = 17
    and 300 loop over the column tiles while one B_g is held), bs = 3 and
    5 (rows of no multiple of 16 bytes) and 4 and 16 on its rows route,
    128 on either by dtype."""
    nb = 301 if m in (None, 1, 8) else 37
    g = torch.Generator(device=cuda).manual_seed(bs)
    inv = torch.randn(nb, bs, bs, generator=g, device=cuda,
                      dtype=torch.float64).to(dtype)
    shape = (nb * bs,) if m is None else (nb * bs, m)
    x = torch.randn(*shape, generator=g, device=cuda,
                    dtype=torch.float64).to(dtype)
    before = dict(ops.LAUNCHES)
    got = ops.block_jacobi_apply(inv, x)
    torch.cuda.synchronize()
    name = "block_jacobi_apply" if m is None else "block_jacobi_apply_batched"
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == \
        launches(**{name: 1})
    assert got.shape == x.shape and got.is_contiguous()
    scale = ref.block_jacobi_apply(inv.abs(), x.abs())
    assert float(((got - ref.block_jacobi_apply(inv, x)).abs()
                  / scale).max()) <= TOL[dtype]


#: (dtype, nb, bs, m, offset, route): each route of the batched kernel and
#: each boundary between them (precond_apply.batched_route); offset shifts
#: x by that many elements off its 16-byte aligned start; nb = 1 (the
#: shared block, which ops keeps on torch.matmul) goes to the kernel's
#: wrapper itself
BATCHED_ROUTE_CASES = [
    (torch.float64, 301, 3, 8, 0, "rows"),      # 24-byte rows
    (torch.float32, 301, 5, 8, 0, "rows"),      # 20-byte rows
    (torch.float64, 40, 30, 8, 0, "rows"),      # below 32 rows
    (torch.float64, 40, 32, 8, 0, "bulk"),
    (torch.float64, 40, 34, 8, 0, "bulk"),      # a warp's rows ragged
    (torch.float64, 1000, 64, 8, 0, "bulk"),    # the main path's shape
    (torch.float32, 1000, 64, 8, 0, "bulk"),
    (torch.float64, 1000, 64, 8, 1, "rows"),    # x off 16 bytes
    (torch.float64, 1, 64, 8, 0, "bulk"),       # nb below the grid
    (torch.float64, 5, 64, 8, 0, "bulk"),
    (torch.float32, 133, 64, 8, 0, "bulk"),     # nb no multiple of it
    (torch.float64, 37, 64, 17, 0, "bulk"),     # column tiles, one B_g
    (torch.float32, 37, 64, 17, 0, "bulk"),
    (torch.float64, 10, 64, 159, 0, "bulk"),
    (torch.float64, 10, 64, 160, 0, "bulk_x_direct"),
    (torch.float64, 37, 64, 300, 0, "bulk_x_direct"),
    (torch.float32, 37, 64, 300, 0, "bulk"),
    (torch.float64, 20, 64, 301, 0, "bulk_x_direct"),
    (torch.float64, 20, 96, 5, 0, "bulk"),      # two row passes, odd m
    (torch.float32, 20, 128, 3, 0, "bulk"),
    (torch.float64, 20, 116, 8, 0, "bulk_x_direct"),
    (torch.float64, 20, 120, 8, 0, "rows"),     # B_g past the ring
    (torch.float32, 20, 164, 8, 0, "bulk_x_direct"),
    (torch.float32, 20, 172, 8, 0, "rows"),
]


@pytest.mark.parametrize("dtype,nb,bs,m,offset,route", BATCHED_ROUTE_CASES)
def test_block_jacobi_batched_routes_match_plain_version(cuda, dtype, nb, bs,
                                                         m, offset, route):
    from repro_torch.kernels import precond_apply
    g = torch.Generator(device=cuda).manual_seed(bs * 1000 + m)
    inv = torch.randn(nb, bs, bs, generator=g, device=cuda,
                      dtype=torch.float64).to(dtype)
    buf = torch.randn(nb * bs * m + offset, generator=g, device=cuda,
                      dtype=torch.float64).to(dtype)
    x = buf[offset:].view(nb * bs, m)
    aligned = all(t.data_ptr() % 16 == 0 for t in (inv, x))
    assert precond_apply.batched_route(nb, bs, m, dtype,
                                       aligned=aligned) == route
    before = ops.LAUNCHES["block_jacobi_apply_batched"]
    got = precond_apply.block_jacobi_apply_batched_cuda(inv, x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_jacobi_apply_batched"] == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    scale = ref.block_jacobi_apply(inv.abs(), x.abs())
    assert float(((got - ref.block_jacobi_apply(inv, x)).abs()
                  / scale).max()) <= TOL[dtype]
    assert torch.equal(precond_apply.block_jacobi_apply_batched_cuda(inv, x),
                       got)


@pytest.mark.parametrize("batched", [False, True])
def test_block_jacobi_kernels_repeat_bitwise(cuda, batched):
    n, bs = 1_259_712, 64
    g = torch.Generator(device=cuda).manual_seed(2)
    inv = torch.randn(n // bs, bs, bs, generator=g, device=cuda,
                      dtype=torch.float64)
    x = torch.randn(*((n, 8) if batched else (n,)), generator=g, device=cuda,
                    dtype=torch.float64)
    first = ops.block_jacobi_apply(inv, x)
    for _ in range(3):
        assert torch.equal(ops.block_jacobi_apply(inv, x), first)


@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr",
                                    "p-bicgstab"])
def test_preconditioned_solve_on_the_card_matches_the_torch_substrate(
        cuda, method):
    """block_jacobi on "cuda": the kernels, one apply per SpMV plus one (for
    b), the same solve as the plain apply's on the same card (p-BiCGStab:
    the method the Cools-Vanroose paper presents preconditioned)."""
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    cfg = repro_torch.SolverConfig(rr_epoch=10)
    plain = repro_torch.make_solver(method, ell, substrate="torch",
                                    precond="block_jacobi", config=cfg
                                    ).solve(b)
    solver = repro_torch.make_solver(method, ell, substrate="cuda",
                                     precond="block_jacobi", config=cfg)
    solver.precond                              # the set-up, not counted
    ops.reset_launches()
    res = solver.solve(b)
    torch.cuda.synchronize()
    assert bool(res.converged) and bool(plain.converged)
    assert abs(int(res.iterations) - int(plain.iterations)) <= 2
    assert float((res.x - plain.x).abs().max()) <= 1e-6
    steps, rr = solver.stats["steps"], solver.stats["rr_steps"]
    want = method_launches(method, steps, rr)
    want["block_jacobi_apply"] = want["spmv_ell"] + 1
    assert dict(ops.LAUNCHES) == want
    B = torch.stack([b, 0.5 * b, b + 1.0], dim=1)
    if method == "p-bicgsafe":
        ops.reset_launches()
        many = solver.solve_many(B)
        torch.cuda.synchronize()
        assert bool(many.converged.all())
        assert abs(int(many.iterations[0]) - int(res.iterations)) <= 3
        steps = solver.stats["steps"] - steps
        assert dict(ops.LAUNCHES) == launches(
            fused_dots_batched=steps, fused_axpy_batched=steps,
            spmv_ell_batched=1 + 2 * steps,
            block_jacobi_apply_batched=2 + 2 * steps)


@pytest.mark.parametrize("bs,m", [(6400, None), (1024, 8)])
def test_block_jacobi_kernels_take_blocks_past_shared_memory(cuda, bs, m):
    """x_g (single, fp64 past 6,144 rows) or the staged column tile
    (batched, fp64 past 767 rows) no longer fits 48 KB of shared memory:
    the kernels read it from device memory instead, with the same result."""
    g = torch.Generator(device=cuda).manual_seed(bs)
    inv = torch.randn(2, bs, bs, generator=g, device=cuda,
                      dtype=torch.float64)
    shape = (2 * bs,) if m is None else (2 * bs, m)
    x = torch.randn(*shape, generator=g, device=cuda, dtype=torch.float64)
    got = ops.block_jacobi_apply(inv, x)
    scale = ref.block_jacobi_apply(inv.abs(), x.abs())
    assert float(((got - ref.block_jacobi_apply(inv, x)).abs()
                  / scale).max()) <= TOL[torch.float64]
    assert torch.equal(ops.block_jacobi_apply(inv, x), got)


# -- flash attention (the LM serving slice) ---------------------------------------

#: per output row (b, s, h), max |kernel - plain| over that row's max-abs,
#: as chip_smoke.py's phase 2d measures it (a row's scale falls with its
#: causal length); the tolerances of tests/test_kernels.py's flash test
#: (bf16: the two round the same f32 values at other points; fp32: another
#: summation order and expf)
TOL_FLASH = {torch.bfloat16: 2e-2, torch.float32: 2e-5}

#: (B, K, G, S, hd, causal, dtype): S = 300 leaves a ragged last tile (the
#: kernels' tiles are 64 query rows, 64 or 32 keys), hd 20 (no multiple of
#: 8) takes the bf16 kernel's element-load staging and hd 18 (no multiple
#: of 4) the fp32 kernel's; the last cases are qwen3-8b's prefill, (B, H,
#: K, S, hd) = (4, 32, 8, 1024, 128), in both types; G = 5 is
#: llama4-scout's grouping (40 query heads on 8 KV heads), odd
FLASH_CASES = [(2, 2, G, 300, hd, causal, dtype)
               for hd in (16, 20, 64, 96, 128) for G in (1, 4)
               for causal in (True, False)
               for dtype in (torch.float32, torch.bfloat16)] + [
    (2, 2, 4, 300, 18, causal, torch.float32) for causal in (True, False)
] + [(4, 8, 4, 1024, 128, True, dtype)
     for dtype in (torch.bfloat16, torch.float32)] + [
    (2, 2, 5, 300, 128, causal, dtype) for causal in (True, False)
    for dtype in (torch.bfloat16, torch.float32)]


def flash_operands(B, K, G, S, hd, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    return rnd(B, S, K, G, hd), rnd(B, S, K, hd), rnd(B, S, K, hd)


def plain_flash(qg, k, v, scale, causal):
    B, S, K, G, hd = qg.shape
    o = ref.flash_attention(qg.reshape(B, S, K * G, hd).transpose(1, 2),
                            k.transpose(1, 2), v.transpose(1, 2),
                            scale=scale, causal=causal)
    return o.transpose(1, 2).reshape(B, S, K * G * hd)


def flash_row_err(got, want, hd):
    d = (got.float() - want.float()).unflatten(-1, (-1, hd)).abs().amax(-1)
    return float((d / want.float().unflatten(-1, (-1, hd)).abs().amax(-1))
                 .max())


@pytest.mark.parametrize(
    "B,K,G,S,hd,causal,dtype", FLASH_CASES,
    ids=lambda c: str(c).replace("torch.", ""))
def test_flash_kernel_matches_plain_version(cuda, B, K, G, S, hd, causal,
                                            dtype):
    """The model's (B, S, H, hd) tensors go in as (B, S, K, G, hd) views."""
    qg, k, v = flash_operands(B, K, G, S, hd, dtype, cuda, seed=hd + G)
    scale = 1.0 / hd ** 0.5
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(qg, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert {n: ops.LAUNCHES[n] - before[n] for n in before} == \
        launches(flash_attention=1)
    assert got.dtype == dtype and tuple(got.shape) == (B, S, K * G * hd)
    want = plain_flash(qg, k, v, scale, causal)
    assert flash_row_err(got, want, hd) <= TOL_FLASH[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=lambda d: str(d).replace("torch.", ""))
def test_flash_kernel_repeats_bitwise(cuda, dtype):
    qg, k, v = flash_operands(2, 8, 4, 1024, 128, dtype, cuda, 1)
    first = ops.flash_attention(qg, k, v, scale=128 ** -0.5)
    for _ in range(3):
        assert torch.equal(ops.flash_attention(qg, k, v, scale=128 ** -0.5),
                           first)


def test_fp32_flash_keeps_the_digits_one_tf32_pass_loses(cuda):
    """At qwen3-8b's prefill shape the plain version with TF32 matmuls (one
    TF32 pass per product) misses fp32's 2e-5 per row, while the kernel
    (3xTF32) meets it: the bar tells the two apart."""
    qg, k, v = flash_operands(4, 8, 4, 1024, 128, torch.float32, cuda, 7)
    scale = 128 ** -0.5
    want = plain_flash(qg, k, v, scale, True)
    assert flash_row_err(ops.flash_attention(qg, k, v, scale=scale), want,
                         128) <= TOL_FLASH[torch.float32]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = plain_flash(qg, k, v, scale, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert flash_row_err(one_pass, want, 128) > TOL_FLASH[torch.float32]


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    qg, k, v = flash_operands(1, 2, 2, 64, 16, torch.float32, cuda, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(qg.double(), k.double(), v.double(), scale=1.0)
    with pytest.raises(ValueError, match="on cpu"):
        ops.flash_attention(qg, k.cpu(), v, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(qg, k.transpose(1, 2).contiguous()
                            .transpose(1, 2), v, scale=1.0)
    big = flash_operands(1, 1, 1, 64, 160, torch.float32, cuda, 3)
    with pytest.raises(ValueError, match="head_dim 160"):
        ops.flash_attention(*big, scale=1.0)


def test_small_engine_on_the_card_gives_the_cpu_tokens(cuda):
    """fp32 (full-precision matmuls: TF32 off, PyTorch's default), the
    flash path, 256-token prompts: the card's tokens equal the CPU's, and
    the prefill launched the kernel once per layer."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = smoke_config("qwen3-8b").replace(
        use_flash_kernel=True, dtype=torch.float32, param_dtype=torch.float32)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, 256)))
               for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=3, max_len=264),
                            params=model.to(dev), device=dev)
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=4))
        ops.reset_launches()
        outs[dev] = [r.output for r in eng.run()]
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == \
            (cfg.n_layers if dev == "cuda" else 0)
    assert outs["cuda"] == outs["cpu"]


def test_small_moe_engine_on_the_card_gives_the_cpu_tokens(cuda):
    """The MoE family (llama4-scout's smoke config, 4 groups so that the
    gather dispatch's capacity drops tokens) in fp32 on the flash path:
    the card's greedy tokens equal the CPU's, one flash launch a layer."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = smoke_config("llama4-scout-17b-a16e").replace(
        use_flash_kernel=True, dtype=torch.float32,
        param_dtype=torch.float32, moe_groups=4)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, 256)))
               for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=3, max_len=264),
                            params=model.to(dev), device=dev)
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=4))
        ops.reset_launches()
        outs[dev] = [r.output for r in eng.run()]
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == \
            (cfg.n_layers if dev == "cuda" else 0)
    assert outs["cuda"] == outs["cpu"]


def test_moe_gather_makes_no_host_sync_and_sort_one(cuda):
    """Under ``set_sync_debug_mode("error")`` both dispatches run at decode
    and prefill sizes: the gather dispatch in fp32, the sort dispatch in
    bf16 (its grouped kernel takes the offsets on the device: no host read
    is left), each against the CPU's run of the same dispatch."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    cfg = smoke_config("llama4-scout-17b-a16e").replace(
        moe_groups=256, dtype=torch.float32, param_dtype=torch.float32)
    bf = cfg.replace(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    p = moe.init_moe_params(torch.Generator(device=cuda).manual_seed(0),
                            cfg)
    pb = {k: v if k.startswith("router") else v.bfloat16()
          for k, v in p.items()}
    for shape in ((4, 1, cfg.d_model), (4, 256, cfg.d_model)):
        x = torch.randn(*shape, device=cuda).to(cfg.dtype)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_ffn(p, x, cfg, impl="gather")
            ys, _ = moe.moe_ffn(pb, x.bfloat16(), bf, impl="sort")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want, _ = moe.moe_ffn({k: v.cpu() for k, v in p.items()},
                              x.cpu(), cfg, impl="gather")
        assert torch.isfinite(y.float()).all()
        assert float((y.cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        want, _ = moe.moe_ffn({k: v.cpu() for k, v in pb.items()},
                              x.bfloat16().cpu(), bf, impl="sort")
        assert float((ys.cpu().float() - want.float()).abs().max()) <= \
            2e-2 * float(want.float().abs().max())


# -- the serving engine's decode program: one CUDA-graph replay a step -------

def _serve_config(arch, dtype, **kw):
    from repro_torch.configs import smoke_config
    return smoke_config(arch).replace(dtype=dtype, param_dtype=dtype, **kw)


def _serve(eng, prompts, new=6):
    """Serve ``prompts`` on ``eng`` (one batch each run): their tokens."""
    from repro_torch.serve import Request
    for p in prompts:
        eng.submit(Request(prompt=p, max_new_tokens=new))
    eng.done.clear()
    return [r.output for r in eng.run()]


def _prompts(vocab, n, length, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, length))) for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["qwen3-8b", "llama4-scout-17b-a16e"])
def test_graphed_decode_gives_the_eager_engines_tokens(cuda, arch, dtype):
    """A dense and a MoE gather config, bf16 and fp32: the engine whose
    decode steps replay one CUDA graph gives the greedy tokens of the same
    engine under ``_eager_chunks`` (two batches of 3 in turn, then a batch
    of 2); one capture per batch size, none under ``_eager_chunks``."""
    from repro_torch.core.program import _eager_chunks
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = _serve_config(arch, dtype)
    scfg = ServeConfig(max_batch=3, max_len=40)
    batches = [_prompts(cfg.vocab_size, 3, 12, 0),
               _prompts(cfg.vocab_size, 3, 20, 1),
               _prompts(cfg.vocab_size, 2, 16, 2)]
    outs = {}
    for mode in ("eager", "graph"):
        eng = ServingEngine(cfg, scfg, device=cuda)
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(_eager_chunks())
            outs[mode] = [_serve(eng, b) for b in batches]
            if mode == "eager":
                assert eng.stats["decode_program"].startswith("eager: ")
                assert eng.stats["decode_graphs"] == 0
            else:
                assert eng.stats["decode_program"] == "graph"
                assert eng.stats["decode_graphs"] == 2
                assert sorted(eng.programs) == [2, 3]
                assert eng.stats["capture_s"] > 0.0
        assert len(eng.stats["decode_s"]) == 3 * 5
    assert outs["graph"] == outs["eager"]


def test_a_replayed_decode_step_makes_no_host_sync(cuda):
    """``set_sync_debug_mode("error")`` over a replay of the decode graph
    (bf16 MoE gather config) and over the eager step with ``cache_len`` a
    device tensor: neither synchronises; the replay advances
    ``cache_len`` by one and writes the tokens buffer."""
    from repro_torch.models import decode_step
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = _serve_config("llama4-scout-17b-a16e", torch.bfloat16)
    eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=32),
                        device=cuda)
    _serve(eng, _prompts(cfg.vocab_size, 2, 10, 3), new=3)
    prog = eng.programs[2]
    assert prog.graph is not None and prog.pool_bytes >= 0
    with torch.inference_mode():
        before = int(prog.cache_len)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.step()
            decode_step(eng.params, cfg, prog.cache, prog.tokens,
                        prog.cache_len)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert int(prog.cache_len) == before + 1
        assert prog.logits.shape == (2, 1, cfg.vocab_size)
        assert bool((prog.tokens[:, 0] == prog.logits[:, 0].argmax(-1)).all())


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v3-671b"])
def test_a_sort_config_decodes_eagerly_and_says_so(cuda, arch):
    """A MoE sort config (bf16: the grouped kernel's type), llama4's and
    deepseek-v3's with MLA: its decode is graphed now, one capture a batch
    size, three grouped-kernel launches a layer a replay, and the greedy
    tokens equal those of the same engine's decode under
    ``_eager_chunks``."""
    from repro_torch.core.program import _eager_chunks
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = _serve_config(arch, torch.bfloat16, moe_impl="sort")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(4))
    outs, counts = {}, {}
    for mode in ("eager", "graph"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=32),
                            params=model, device=cuda)
        with _eager_chunks() if mode == "eager" else \
                contextlib.nullcontext():
            _serve(eng, _prompts(cfg.vocab_size, 2, 10, 4), new=2)  # warm
            ops.reset_launches()
            outs[mode] = _serve(eng, _prompts(cfg.vocab_size, 2, 10, 5),
                                new=4)
            torch.cuda.synchronize()
            counts[mode] = ops.LAUNCHES["grouped_mm"]
        if mode == "graph":
            assert eng.stats["decode_program"] == "graph"
            assert eng.stats["decode_graphs"] == 1
            assert eng.programs[2].launches == {"grouped_mm": 3 * cfg.n_layers}
        else:
            assert eng.stats["decode_program"].startswith("eager: ")
    # a prefill and three decode steps, three launches a layer each
    assert counts["graph"] == counts["eager"] == 4 * 3 * cfg.n_layers
    assert outs["graph"] == outs["eager"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_hybrid_decode_past_the_window_gives_the_eager_tokens(
        cuda, dtype):
    """The smoke zamba2 (a 64-token window) at ``max_len`` 128: a batch of
    16-token prompts first (the graph captured there, its rings not full),
    then two prompts of 40 tokens (the rings fill at ``cache_len`` 64 and
    roll from then on) and two of 70 (rolling from the first step), 40 new
    tokens each.  The graphed engine gives the tokens of the same engine
    under ``_eager_chunks``, no kernel of the port is launched (the window
    keeps the shared block off the flash kernel), and a replay makes no
    host sync."""
    from repro_torch.core.program import _eager_chunks
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = _serve_config("zamba2-1.2b", dtype)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(5))
    outs = {}
    for mode in ("eager", "graph"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=128),
                            params=model, device=cuda)
        with _eager_chunks() if mode == "eager" else \
                contextlib.nullcontext():
            _serve(eng, _prompts(cfg.vocab_size, 2, 16, 6), new=4)
            ops.reset_launches()
            outs[mode] = [_serve(eng, _prompts(cfg.vocab_size, 2, S, S),
                                 new=40) for S in (40, 70)]
            torch.cuda.synchronize()
        assert not any(ops.LAUNCHES.values())
        if mode == "graph":
            assert eng.stats["decode_program"] == "graph"
            assert eng.stats["decode_graphs"] == 1
            assert eng.programs[2].launches == {}
        else:
            assert eng.stats["decode_program"].startswith("eager: ")
    assert outs["graph"] == outs["eager"]
    prog = eng.programs[2]
    with torch.inference_mode():
        before = int(prog.cache_len)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(prog.cache_len) == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_xlstm_decode_gives_the_eager_tokens(cuda, dtype):
    """The smoke xlstm (2 sLSTM + mLSTM pairs) at ``max_len`` 16: a batch
    of 16-token prompts first (the graph captured there, its warm-up's
    state put back), then two prompts of 40 tokens (one mLSTM chunk of
    40) and two of 512 (two chunks of 256), 30 new tokens each, far past
    ``max_len``: the state has no rows.  The graphed engine
    gives the tokens of the same engine under ``_eager_chunks``,
    ``decode_program_mode`` reads ``"graph"``, no kernel of the port is
    launched, and a replay makes no host sync."""
    from repro_torch.core.program import _eager_chunks
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve.engine import decode_program_mode
    cfg = _serve_config("xlstm-350m", dtype)
    assert decode_program_mode(cfg, cuda) == "graph"
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(6))
    outs = {}
    for mode in ("eager", "graph"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=16),
                            params=model, device=cuda)
        with _eager_chunks() if mode == "eager" else \
                contextlib.nullcontext():
            _serve(eng, _prompts(cfg.vocab_size, 2, 16, 7), new=4)
            ops.reset_launches()
            outs[mode] = [_serve(eng, _prompts(cfg.vocab_size, 2, S, S),
                                 new=30) for S in (40, 512)]
            torch.cuda.synchronize()
        assert not any(ops.LAUNCHES.values())
        if mode == "graph":
            assert eng.stats["decode_program"] == "graph"
            assert eng.stats["decode_graphs"] == 1
            assert eng.programs[2].launches == {}
        else:
            assert eng.stats["decode_program"].startswith("eager: ")
    assert outs["graph"] == outs["eager"]
    assert all(len(o) == 30 for run in outs["graph"] for o in run)
    prog = eng.programs[2]
    with torch.inference_mode():
        before = int(prog.cache_len)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(prog.cache_len) == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_whisper_decode_gives_the_eager_tokens(cuda, dtype):
    """The smoke whisper with the flash kernel at ``max_len`` 320: a batch
    of 16-token prompts first (the graph captured there), then a batch of
    300 tokens (the decoder's prefill on the kernel, one launch a decoder
    layer) and one of 40 (the plain branch), 12 new tokens each, through
    one program whose 320 cross rows are masked past each batch's by a
    device ``enc_len``.  The graphed engine gives the tokens of the same
    engine under ``_eager_chunks``, the decode launches no kernel, and a
    replay makes no host sync."""
    from repro_torch.core.program import _eager_chunks
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve.engine import decode_program_mode
    cfg = _serve_config("whisper-tiny", dtype, use_flash_kernel=True)
    assert decode_program_mode(cfg, cuda) == "graph"
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(8))
    outs = {}
    for mode in ("eager", "graph"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=320),
                            params=model, device=cuda)
        with _eager_chunks() if mode == "eager" else \
                contextlib.nullcontext():
            _serve(eng, _prompts(cfg.vocab_size, 2, 16, 7), new=4)
            ops.reset_launches()
            outs[mode] = [_serve(eng, _prompts(cfg.vocab_size, 2, S, S),
                                 new=12) for S in (300, 40)]
            torch.cuda.synchronize()
        assert dict(ops.LAUNCHES) == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                          flash_attention=cfg.n_layers)
        if mode == "graph":
            assert eng.stats["decode_program"] == "graph"
            assert eng.stats["decode_graphs"] == 1
            assert eng.programs[2].launches == {}
        else:
            assert eng.stats["decode_program"].startswith("eager: ")
    assert outs["graph"] == outs["eager"]
    assert all(len(o) == 12 for run in outs["graph"] for o in run)
    prog = eng.programs[2]
    assert int(prog.enc_len) == 40
    with torch.inference_mode():
        before = int(prog.cache_len)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(prog.cache_len) == before + 1


#: (B, K, G, S, hd): qwen2-vl-72b's prefill of 4 prompts of 1,024 tokens
#: (64 query heads on 8 KV heads, G = 8) and a ragged S at that grouping
VLM_FLASH_SHAPES = [(4, 8, 8, 1024, 128), (2, 2, 8, 300, 128)]


@pytest.mark.parametrize("shape", VLM_FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vlm_flash_kernel_at_g8_matches_the_plain_version(cuda, dtype,
                                                          shape):
    """The flash kernel at qwen2-vl's grouping, G = 8 (every query head of
    a KV head's group read from the one KV head), causal: one launch, the
    error per output row within the flash bar of its dtype."""
    B, K, G, S, hd = shape
    qg, k, v = flash_operands(B, K, G, S, hd, dtype, cuda, seed=S + G)
    scale = 1.0 / hd ** 0.5
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(qg, k, v, scale=scale, causal=True)
    torch.cuda.synchronize()
    assert {n: ops.LAUNCHES[n] - before[n] for n in before} == \
        launches(flash_attention=1)
    want = plain_flash(qg, k, v, scale, True)
    assert flash_row_err(got, want, hd) <= TOL_FLASH[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vlm_apply_mrope_on_the_card_matches_the_cpu(cuda, dtype):
    """``apply_mrope`` at qwen2-vl's (16, 24, 24) sections over (4, 1024,
    64, 128) queries and distinct seeded (t, h, w) positions: the card
    within 1e-5 of the CPU's f32 result (another cos / sin), a bf16 input
    within its rounding; with t = h = w equal to ``apply_rope`` on the
    card bit for bit, the engine's case."""
    from repro_torch.models.common import apply_mrope, apply_rope
    g = torch.Generator().manual_seed(11)
    x = torch.randn(4, 1024, 64, 128, generator=g).to(dtype)
    pos = torch.randint(0, 4096, (4, 1024, 3), generator=g)
    sections = (16, 24, 24)
    want = apply_mrope(x, pos, 1e6, sections).float()
    got = apply_mrope(x.to(cuda), pos.to(cuda), 1e6, sections).float().cpu()
    bar = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert float((got - want).abs().max() / want.abs().max()) <= bar
    one = pos[..., 0].to(cuda)
    xc = x.to(cuda)
    assert torch.equal(apply_mrope(xc, one[..., None].expand(4, 1024, 3),
                                   1e6, sections),
                       apply_rope(xc, one, 1e6))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_vlm_decode_gives_the_eager_tokens(cuda, dtype):
    """The smoke qwen2-vl with the flash kernel at ``max_len`` 320: a batch
    of 16-token prompts first (the graph captured there), then a batch of
    300 tokens (the prefill on the kernel, G = 2, one launch a layer) and
    one of 40 (the plain branch), 12 new tokens each.  The graphed engine
    gives the tokens of the same engine under ``_eager_chunks``, the decode
    launches no kernel, and a replay makes no host sync.  Then
    ``prefill_step`` with 64 seeded patch rows and the (t, h, w) ids of an
    8 x 8 grid at S = 300: the kernel's logits within the serving bar
    (bf16 5e-2, fp32 1e-4) of the plain branch's."""
    from repro_torch.core.program import _eager_chunks
    from repro_torch.models import init_params, prefill_step
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve.engine import decode_program_mode
    cfg = _serve_config("qwen2-vl-72b", dtype, use_flash_kernel=True)
    assert decode_program_mode(cfg, cuda) == "graph"
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(9))
    outs = {}
    for mode in ("eager", "graph"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=320),
                            params=model, device=cuda)
        with _eager_chunks() if mode == "eager" else \
                contextlib.nullcontext():
            _serve(eng, _prompts(cfg.vocab_size, 2, 16, 7), new=4)
            ops.reset_launches()
            outs[mode] = [_serve(eng, _prompts(cfg.vocab_size, 2, S, S),
                                 new=12) for S in (300, 40)]
            torch.cuda.synchronize()
        assert dict(ops.LAUNCHES) == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                          flash_attention=cfg.n_layers)
        if mode == "graph":
            assert eng.stats["decode_program"] == "graph"
            assert eng.stats["decode_graphs"] == 1
            assert eng.programs[2].launches == {}
        else:
            assert eng.stats["decode_program"].startswith("eager: ")
    assert outs["graph"] == outs["eager"]
    assert all(len(o) == 12 for run in outs["graph"] for o in run)
    prog = eng.programs[2]
    with torch.inference_mode():
        before = int(prog.cache_len)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(prog.cache_len) == before + 1
    g = torch.Generator(device=cuda).manual_seed(10)
    S, P = 300, 64
    r = torch.arange(P, device=cuda)
    pos = torch.arange(S, device=cuda)[:, None].repeat(1, 3)
    pos[1:1 + P] = torch.stack([torch.ones_like(r), 1 + r // 8, 1 + r % 8], 1)
    pos[1 + P:] = (9 + torch.arange(S - 1 - P, device=cuda))[:, None]
    b = {"tokens": torch.randint(1, cfg.vocab_size, (2, S), generator=g,
                                 device=cuda),
         "patch_embeds": torch.randn(2, P, cfg.d_model, generator=g,
                                     device=cuda).to(dtype),
         "positions": pos[None].expand(2, S, 3)}
    with torch.inference_mode():
        ops.reset_launches()
        flash = prefill_step(model, cfg, b)[0][:, -1].float()
        assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
        plain = prefill_step(model, cfg.replace(use_flash_kernel=False),
                             b)[0][:, -1].float()
    bar = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((flash - plain).abs().max() / plain.abs().max()) <= bar


def test_decode_attention_on_the_card_sums_bf16_products_in_f32(cuda):
    """bf16 ``decode_attention`` on the card (scores from ``bmm`` with an
    f32 output over the cache as it lies) against the same call on the CPU
    (the cache copied to f32): only row ``cache_len`` written, alike
    within bf16 rounding, and the outputs too; a 0-d ``cache_len`` and an
    int agree bitwise."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import attention, init_params
    cfg = smoke_config("qwen3-8b").replace(sliding_window=7)
    p = dict(init_params(cfg, torch.Generator().manual_seed(0))
             .layers[0].attn.p)
    g = torch.Generator().manual_seed(1)
    B, T, n = 3, 24, 13
    x = torch.randn(B, 1, cfg.d_model, generator=g).to(cfg.dtype)
    kc = torch.randn(B, T, cfg.n_kv_heads, cfg.hd, generator=g).to(cfg.dtype)
    vc = torch.randn(B, T, cfg.n_kv_heads, cfg.hd, generator=g).to(cfg.dtype)
    pos = torch.full((B,), n)
    outs = {}
    with torch.inference_mode():
        for dev, cl in (("cpu", n), ("cuda", n),
                        ("cuda-0d", torch.tensor(n, device=cuda))):
            d = dev.split("-")[0]
            k, v = kc.clone().to(d), vc.clone().to(d)
            y, k, v = attention.decode_attention(
                {key: w.to(d) for key, w in p.items()}, x.to(d), pos.to(d),
                k, v, cl, cfg)
            outs[dev] = (y.cpu(), k.cpu(), v.cpu())
    assert all(torch.equal(a, b) for a, b in zip(outs["cuda"],
                                                 outs["cuda-0d"]))
    others = [t for t in range(T) if t != n]
    for i, c in ((1, kc), (2, vc)):
        assert torch.equal(outs["cuda"][i][:, others], c[:, others])
        got, want = outs["cuda"][i][:, n].float(), outs["cpu"][i][:, n].float()
        assert float((got - want).abs().max() / want.abs().max()) <= 2e-2
    y, want = outs["cuda"][0].float(), outs["cpu"][0].float()
    assert float((y - want).abs().max() / want.abs().max()) <= 2e-2


# -- the grouped kernel of the MoE sort dispatch; MLA's decode --------------

def _grouped_operands(sizes, K, N, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    R, E = sum(sizes), len(sizes)
    x = torch.randn(R, K, generator=g, device=device).bfloat16()
    w = (torch.randn(E, K, N, generator=g, device=device)
         / K ** 0.5).bfloat16()
    offsets = torch.tensor([0] + list(np.cumsum(sizes)), device=device)
    return x, w, offsets


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("sizes,K,N", [
    ([70, 0, 1, 129, 0, 63], 96, 136),      # empty groups, one row, ragged
    ([0, 0, 200, 0], 64, 128),              # one group holds every row
    ([33], 32, 8),                          # E = 1, less than one tile
    ([1, 1, 2, 0, 1, 3, 0, 0] * 4, 256, 64),   # a decode step's 32 rows
    ([300, 0, 1, 211], 128, 256),           # 192 x 192 tiles (R >= 64 E)
])
def test_grouped_mm_kernel_matches_the_plain_version(cuda, sizes, K, N):
    """The kernel against its plain version (bf16 operands, f32 sums):
    within tests/test_kernels.py's bf16 bar of the max-abs, bitwise on a
    repeat, one launch a call."""
    from repro_torch.kernels import grouped_mm
    x, w, offsets = _grouped_operands(sizes, K, N, cuda)
    before = ops.LAUNCHES["grouped_mm"]
    got = ops.grouped_mm(x, w, offsets)
    again = ops.grouped_mm(x, w, offsets)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["grouped_mm"] - before == 2
    want = grouped_mm.plain(x, w, offsets)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, again)


def test_one_grouped_graph_serves_two_routings(cuda):
    """A CUDA graph captured over one call, replayed after the offsets
    (and x) buffers are rewritten with another routing: each replay gives
    the plain version's result for the routing it found in memory."""
    from repro_torch.kernels import grouped_mm
    x, w, offsets = _grouped_operands([5, 0, 40, 1, 18], 64, 64, cuda)
    routings = [torch.tensor([0, 5, 5, 45, 46, 64], device=cuda),
                torch.tensor([0, 0, 60, 61, 61, 64], device=cuda)]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.grouped_mm(x, w, offsets)                     # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ops.grouped_mm(x, w, offsets)
    g = torch.Generator(device=cuda).manual_seed(9)
    for routing in routings:
        offsets.copy_(routing)
        x.copy_(torch.randn(x.shape, generator=g, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(y, grouped_mm.plain(x, w, offsets)) <= 2e-2


def test_grouped_mm_on_the_card_refuses_what_the_kernel_does_not_take(cuda):
    x, w, offsets = _grouped_operands([3, 5], 16, 16, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.grouped_mm(x.half(), w.half(), offsets)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.grouped_mm(x[:, :12].contiguous(), w[:, :12].contiguous(),
                       offsets)


#: the bf16 route's tile variants
WGMMA_TILES = ["128x256", "192x192"]
#: shapes that force every edge of the tiles: a group with more rows than
#: one tile (300 > 192), R not a multiple of the tile with empty and
#: one-row groups, K = 96 (not a multiple of the 64-deep stage), N = 136 (a
#: ragged last column slab), one group holding every row, a decode step
GROUPED_EDGES = {
    "a group past one tile": ([300, 0, 1, 211], 128, 256),
    "ragged rows, K and N": ([70, 0, 1, 129, 0, 63], 96, 136),
    "one group holds every row": ([0, 0, 200, 0], 64, 128),
    "one-row groups": ([1, 1, 2, 0, 1, 3, 0, 0] * 4, 256, 64),
}


@pytest.mark.parametrize("case", list(GROUPED_EDGES))
@pytest.mark.parametrize("tile", WGMMA_TILES)
def test_each_bf16_grouped_route_matches_the_plain_version(cuda, tile, case):
    """The bf16 route with each tile named to ``grouped_mm_cuda`` against
    the plain version: tests/test_kernels.py's bf16 bar of the max-abs,
    bitwise on a repeat, one launch of the route a call."""
    from repro_torch.kernels import grouped_mm
    sizes, K, N = GROUPED_EDGES[case]
    x, w, offsets = _grouped_operands(sizes, K, N, cuda, seed=3)
    grouped_mm.reset_route_launches()
    got = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    again = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    torch.cuda.synchronize()
    assert grouped_mm.ROUTE_LAUNCHES["wgmma"] == 2
    want = grouped_mm.plain(x, w, offsets)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile", WGMMA_TILES)
def test_one_grouped_graph_serves_two_routings_on_each_route(cuda, tile):
    """test_one_grouped_graph_serves_two_routings with each tile of the
    bf16 route named: one capture, two routings written into the offsets,
    each replay the plain version's result for the routing it found (the
    tensor maps travel with the graph's node)."""
    from repro_torch.kernels import grouped_mm
    x, w, offsets = _grouped_operands([57, 0, 70, 1, 9], 64, 72, cuda)
    R = x.shape[0]
    routings = [torch.tensor([0, 5, 5, R - 75, R - 74, R], device=cuda),
                torch.tensor([0, 0, R - 1, R, R, R], device=cuda)]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                         # warm-up
        grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    torch.cuda.current_stream().wait_stream(side)
    grouped_mm.reset_route_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    assert grouped_mm.ROUTE_LAUNCHES["wgmma"] == 1
    g = torch.Generator(device=cuda).manual_seed(9)
    for routing in routings:
        offsets.copy_(routing)
        x.copy_(torch.randn(x.shape, generator=g, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(y, grouped_mm.plain(x, w, offsets)) <= 2e-2


def test_a_bf16_grouped_product_of_depth_0_is_zeros(cuda):
    """K = 0 (an empty sum, which a tensor map cannot describe): the bf16
    route writes zeros, as the plain version does."""
    from repro_torch.kernels import grouped_mm
    x = torch.empty(9, 0, device=cuda, dtype=torch.bfloat16)
    w = torch.empty(3, 0, 16, device=cuda, dtype=torch.bfloat16)
    offsets = torch.tensor([0, 4, 4, 9], device=cuda)
    got = ops.grouped_mm(x, w, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, grouped_mm.plain(x, w, offsets))
    assert torch.equal(got, torch.zeros_like(got))


#: the bars of the f32 / f64 route against the plain version, over the
#: max-abs: the same sums in another order (f32: 3xTF32, each stage's sums
#: joined in f32)
MMA_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _float_operands(sizes, K, N, device, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    R, E = sum(sizes), len(sizes)
    x = torch.randn(R, K, generator=g, device=device, dtype=dtype)
    w = torch.randn(E, K, N, generator=g, device=device,
                    dtype=dtype) / max(K, 1) ** .5
    offsets = torch.tensor([0] + list(np.cumsum(sizes)), device=device)
    return x, w, offsets


@pytest.mark.parametrize("K,N", [(96, 136), (37, 29), (7168, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grouped_mm_f32_and_f64_match_the_plain_version(cuda, dtype, K, N):
    """The "mma" route through ``ops.grouped_mm`` (K and N free: 37 and 29
    are no multiples of 4, so element copies), empty and one-row groups
    and a group past one 64-row tile, and deepseek's K of 7,168 (where
    sums truncated by the tensor cores over the whole depth would show),
    against the plain version: 1e-5 (f32) and 1e-12 (f64) of the max-abs
    (the same sums in another order), bitwise on a repeat."""
    from repro_torch.kernels import grouped_mm
    x, w, offsets = _float_operands([70, 0, 1, 129, 0, 63], K, N, cuda,
                                    dtype, seed=5)
    grouped_mm.reset_route_launches()
    got = ops.grouped_mm(x, w, offsets)
    again = ops.grouped_mm(x, w, offsets)
    torch.cuda.synchronize()
    assert grouped_mm.ROUTE_LAUNCHES["mma"] == 2
    want = grouped_mm.plain(x, w, offsets)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got.double(), want.double()) <= MMA_TOL[dtype]
    assert torch.equal(got, again)


#: the f32 / f64 route's tile variants
MMA_TILES = ["64x128", "144x128"]
#: (sizes, K, N): a group taller than the tall tile (300 > 144) over
#: deepseek's K, ragged rows with K and N that take element copies, K and
#: N 2 mod 4 (element copies in f32, 16-byte ones in f64), one-row groups
#: (a decode step), one group holding every row, and K = 0 (zeros)
MMA_EDGES = {
    "a group past the tall tile, K 7,168": ([300, 0, 1, 211], 7168, 136),
    "ragged rows, K and N": ([70, 0, 1, 129, 0, 63], 37, 29),
    "K and N 2 mod 4": ([70, 0, 1, 129], 98, 138),
    "one-row groups": ([1, 1, 2, 0, 1, 3, 0, 0] * 4, 256, 64),
    "one group holds every row": ([0, 0, 200, 0], 64, 256),
    "K = 0": ([5, 0, 4], 0, 16),
}


@pytest.mark.parametrize("case", list(MMA_EDGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile", MMA_TILES)
def test_each_mma_grouped_tile_matches_the_plain_version(cuda, tile, dtype,
                                                         case):
    """The f32 / f64 route with each tile named to ``grouped_mm_cuda``
    against the plain version: 1e-5 / 1e-12 of the max-abs, bitwise on a
    repeat, one launch of the route a call; K = 0 gives zeros."""
    from repro_torch.kernels import grouped_mm
    sizes, K, N = MMA_EDGES[case]
    x, w, offsets = _float_operands(sizes, K, N, cuda, dtype, seed=3)
    grouped_mm.reset_route_launches()
    got = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    again = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    torch.cuda.synchronize()
    assert grouped_mm.ROUTE_LAUNCHES["mma"] == 2
    want = grouped_mm.plain(x, w, offsets)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    if K == 0:
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert _rel(got.double(), want.double()) <= MMA_TOL[dtype]


@pytest.mark.parametrize("tile", MMA_TILES)
def test_one_grouped_graph_serves_two_routings_on_each_mma_tile(cuda, tile):
    """One capture of the f32 route's tile, two routings written into the
    offsets: each replay gives the plain version's result for the routing
    it found."""
    from repro_torch.kernels import grouped_mm
    x, w, offsets = _float_operands([57, 0, 170, 1, 9], 64, 72, cuda,
                                    torch.float32, seed=6)
    R = x.shape[0]
    routings = [torch.tensor([0, 5, 5, R - 75, R - 74, R], device=cuda),
                torch.tensor([0, 0, R - 1, R, R, R], device=cuda)]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                         # warm-up
        grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=tile)
    g = torch.Generator(device=cuda).manual_seed(9)
    for routing in routings:
        offsets.copy_(routing)
        x.copy_(torch.randn(x.shape, generator=g, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(y, grouped_mm.plain(x, w, offsets)) <= 1e-5


def test_an_fp32_sort_config_serves_on_the_card_as_its_plain_path(cuda):
    """C26: deepseek-v3's smoke config in fp32 with the sort dispatch on the
    card: the prefill's last logits within 1e-4 of the same model's with the
    plain grouped product patched in; the decode graphed (one CUDA graph,
    the f32 route's launches in each replay) gives the eager engine's
    tokens and the plain path's; a replay makes no host sync."""
    from unittest import mock

    from repro_torch.core.program import _eager_chunks
    from repro_torch.kernels import grouped_mm
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = _serve_config("deepseek-v3-671b", torch.float32, moe_impl="sort")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(4))
    prompts = _prompts(cfg.vocab_size, 2, 10, 6)
    tokens = torch.tensor(prompts, device=cuda)
    outs, logits = {}, {}
    for mode in ("eager", "graph", "plain"):
        eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=32),
                            params=model, device=cuda)
        with contextlib.ExitStack() as stack:
            if mode != "graph":
                stack.enter_context(_eager_chunks())
            if mode == "plain":
                stack.enter_context(mock.patch.object(ops, "grouped_mm",
                                                      grouped_mm.plain))
            with torch.inference_mode():
                logits[mode] = eng.prefill(tokens)[0][:, -1].double()
            outs[mode] = _serve(eng, prompts, new=4)
        if mode == "graph":
            assert eng.stats["decode_program"] == "graph"
            assert eng.programs[2].launches == {"grouped_mm": 3 * cfg.n_layers}
            prog = eng.programs[2]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                prog.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    assert _rel(logits["eager"], logits["plain"]) <= 1e-4
    assert torch.equal(logits["eager"], logits["graph"])
    assert outs["graph"] == outs["eager"] == outs["plain"]


def test_mla_decode_on_the_card_matches_the_cpu(cuda):
    """bf16 ``mla_decode`` on the card (latent scores from ``bmm`` with an
    f32 output over the cache as it lies) against the same call on the CPU
    (the cache upcast): only row ``cache_len`` written, outputs alike within
    bf16 rounding; a 0-d ``cache_len`` and an int agree bitwise."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mla
    cfg = smoke_config("deepseek-v3-671b")
    p = mla.init_mla_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    B, T, n = 3, 24, 13
    x = torch.randn(B, 1, cfg.d_model, generator=g).to(cfg.dtype)
    ckv = torch.randn(B, T, cfg.kv_lora_rank, generator=g).to(cfg.dtype)
    kr = torch.randn(B, T, cfg.qk_rope_head_dim, generator=g).to(cfg.dtype)
    pos = torch.full((B,), n)
    outs = {}
    with torch.inference_mode():
        for dev, cl in (("cpu", n), ("cuda", n),
                        ("cuda-0d", torch.tensor(n, device=cuda))):
            d = dev.split("-")[0]
            c1, c2 = ckv.clone().to(d), kr.clone().to(d)
            y, c1, c2 = mla.mla_decode({k: w.to(d) for k, w in p.items()},
                                       x.to(d), pos.to(d), c1, c2, cl, cfg)
            outs[dev] = (y.cpu(), c1.cpu(), c2.cpu())
    assert all(torch.equal(a, b) for a, b in zip(outs["cuda"],
                                                 outs["cuda-0d"]))
    others = [t for t in range(T) if t != n]
    for i, c in ((1, ckv), (2, kr)):
        assert torch.equal(outs["cuda"][i][:, others], c[:, others])
        assert _rel(outs["cuda"][i][:, n], outs["cpu"][i][:, n]) <= 2e-2
    assert _rel(outs["cuda"][0], outs["cpu"][0]) <= 2e-2


# -- programs: each solver chunk a CUDA graph --------------------------------

def graph_and_eager(run):
    """``run()`` through the sessions' graph programs, then through the
    eager chunk; each with the launch counters set to 0 just before and
    read just after.  Returns ((result, launches) graph, (...) eager)."""
    from repro_torch.core.program import _eager_chunks
    out = []
    for eager in (False, True):
        ops.reset_launches()
        if eager:
            with _eager_chunks():
                res = run()
        else:
            res = run()
        torch.cuda.synchronize()
        out.append((res, dict(ops.LAUNCHES)))
    return out


def assert_bitwise(a, b):
    """Two results (or state dicts) equal bit for bit, NaN slots too."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        pairs = [(a[k], b[k]) for k in a]
    else:
        pairs = list(zip(a, b))
    for x, y in pairs:
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.nan_to_num(-1), y.nan_to_num(-1))


@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr",
                                    "ssbicgsafe2", "p-bicgstab", "bicgstab",
                                    "gpbicg", "cgs"])
def test_graph_program_matches_the_eager_chunk(cuda, method):
    """Each method's solve through its captured chunks equals the eager
    chunk's bit for bit (x, iterations, relres, history), with the same
    launches; repeat solves replay the program (``traces`` stays 1).
    ``rr_epoch=20``: -rr crosses replacement steps, each pattern of them
    in a chunk a graph of its own."""
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    cfg = repro_torch.SolverConfig(rr_epoch=20, record_history=True)
    solver = repro_torch.make_solver(method, ell, substrate="cuda",
                                     config=cfg)
    (graph, g_launches), (eager, e_launches) = graph_and_eager(
        lambda: solver.solve(b))
    assert bool(graph.converged)
    assert_bitwise(graph, eager)
    assert g_launches == e_launches
    assert solver.stats["traces"] == solver.stats["programs"] == 1
    graphs = solver.stats["graphs"]
    assert graphs >= 1
    if method == "p-bicgsafe-rr":
        assert solver.stats["rr_steps"] >= 4 and graphs >= 2
    again = solver.solve(2.0 * b)
    torch.cuda.synchronize()
    assert bool(again.converged)
    assert solver.stats["traces"] == 1
    assert_bitwise(solver.solve(b), graph)


def test_graph_solve_many_matches_the_eager_chunk(cuda):
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    g = torch.Generator(device=cuda).manual_seed(5)
    B = torch.stack([b] + [torch.randn(b.shape[0], generator=g, device=cuda,
                                       dtype=b.dtype) for _ in range(3)], 1)
    tol = [1e-8, 1e-8, 1e-6, 1e-6]
    solver = repro_torch.make_solver(
        "p-bicgsafe", ell, substrate="cuda",
        config=repro_torch.SolverConfig(record_history=True, maxiter=400))
    (graph, g_launches), (eager, e_launches) = graph_and_eager(
        lambda: solver.solve_many(B, tol=tol))
    assert bool(graph.converged.all())
    assert_bitwise(graph, eager)
    assert g_launches == e_launches
    solver.solve_many(2.0 * B, tol=tol)
    assert solver.stats["traces"] == 1


def test_graph_open_loop_matches_the_eager_chunk(cuda):
    """``step_chunk`` + ``splice`` + ``step_chunk`` on the graph programs
    equal the eager chunk's, and leave every state they were given or
    returned as it was."""
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    B = torch.stack([b, 0.5 * b, b + 1.0], dim=1)
    refill = torch.tensor([True, False, False], device=cuda)
    st0 = solver.init(B, tol=1e-8)
    snap0 = {k: v.clone() for k, v in st0.items()}

    def run():
        st1 = solver.step_chunk(st0, 16)
        snap1 = {k: v.clone() for k, v in st1.items()}
        st2 = solver.step_chunk(solver.splice(st1, refill, 2.0 * B), 40)
        st3 = solver.step_chunk(st2, 5)
        assert_bitwise(st1, snap1)
        return st3
    (graph, g_launches), (eager, e_launches) = graph_and_eager(run)
    assert_bitwise(st0, snap0)
    assert_bitwise(graph, eager)
    assert g_launches == e_launches
    assert solver.stats["traces"] == 1


def test_graph_guarded_driver_matches_the_eager_chunk(cuda):
    """The guarded driver with a NaN written into column 2 before chunk 1:
    the same restart event, statuses and solution through the graphs as
    through the eager chunk."""
    from repro_torch.resilience import ChunkFaultInjector
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    g = torch.Generator(device=cuda).manual_seed(5)
    B = torch.stack([b] + [torch.randn(b.shape[0], generator=g, device=cuda,
                                       dtype=b.dtype) for _ in range(3)], 1)
    pol = repro_torch.RecoveryPolicy(chunk=16, substrate_fallback=False)
    gs = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                 recovery=pol)
    events = []

    def run():
        gs.events.clear()
        gs.inject = ChunkFaultInjector(nan_at={1: (2,)})
        res = gs.solve_many(B, tol=1e-8)
        events.append(list(gs.events))
        return res
    (graph, g_launches), (eager, e_launches) = graph_and_eager(run)
    assert events[0] == events[1] == [dict(event="restart", chunk=2,
                                           columns=[2])]
    assert (graph.status == repro_torch.SolveStatus.CONVERGED).all()
    assert_bitwise(graph, eager)
    assert g_launches == e_launches


def test_graph_block_jacobi_matches_the_eager_chunk(cuda):
    """block_jacobi's kernels inside the captured chunks (the batched
    one's bulk route included: its launcher queries the device on every
    launch)."""
    op, b, _ = TM.convection_diffusion(32, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                     precond="block_jacobi")
    B = torch.stack([b, 0.5 * b, b + 1.0, b - 1.0], dim=1)
    (graph, g_launches), (eager, e_launches) = graph_and_eager(
        lambda: (solver.solve(b), solver.solve_many(B)))
    for g, e in zip(graph, eager):
        assert bool(g.converged.all())
        assert_bitwise(g, e)
    assert g_launches == e_launches
    assert g_launches["block_jacobi_apply"] > 0
    assert g_launches["block_jacobi_apply_batched"] > 0


def test_capture_refuses_a_host_read(cuda):
    """A matvec that reads the device from the host cannot be captured:
    the solve raises, naming the program, and does not run eagerly in its
    place; the card is usable afterwards."""
    op, b, _ = TM.convection_diffusion(12, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    seen = []

    def matvec(x):
        seen.append(float(x.abs().max().item()))
        return ell.matvec(x)
    solver = repro_torch.make_solver("p-bicgsafe", matvec, substrate="cuda")
    with pytest.raises(RuntimeError, match="capturing program"):
        solver.solve(b)
    assert seen                                 # the warm-up ran eagerly
    assert solver.stats["steps"] == 0           # no chunk ran
    res = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda"
                                  ).solve(b)
    assert bool(res.converged)


# -- the solve service and the session cache's byte budget ---------------------


def serve_on_card(ell, rhs, substrate, *, precond=None, recovery=None,
                  corrupt=False, max_batch=4, chunk=16, tols=(1e-8, 1e-6)):
    """Serve ``rhs`` (numpy columns) through a ``SolveEngine`` on the card;
    returns ``({rid: result}, engine, launches)``."""
    from repro_torch.resilience import corrupt_engine_block
    from repro_torch.service import ServiceConfig, SolveEngine
    eng = SolveEngine(ServiceConfig(max_batch=max_batch, chunk=chunk,
                                    substrate=substrate, maxiter=2000,
                                    recovery=recovery))
    name = eng.register(ell, precond=precond)
    for i, b in enumerate(rhs):
        eng.submit(name, b, tol=tols[i % len(tols)])
    ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
    first = []
    if corrupt:
        first = eng.poll()
        corrupt_engine_block(eng, name, cols=[0])
    out = {r.rid: r for r in first + eng.run()}
    torch.cuda.synchronize()
    return out, eng, dict(ops.LAUNCHES)


def service_rhs(n, count, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(count)]


@pytest.mark.parametrize("precond", [None, "block_jacobi"])
def test_engine_on_cuda_matches_the_torch_substrate(cuda, precond):
    """The engine on "cuda" launches the batched kernels on every step
    (and, registered with block_jacobi, the batched block-Jacobi apply)
    and serves what the same engine on "torch" serves on the card; a
    chunk is one graph replay and one host read."""
    op, _, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    rhs = service_rhs(ell.n, 10)
    got, eng, launches = serve_on_card(ell, rhs, "cuda", precond=precond)
    want, _, plain = serve_on_card(ell, rhs, "torch", precond=precond)
    assert sorted(got) == sorted(want) == list(range(10))
    for rid, r in got.items():
        w = want[rid]
        assert r.status == w.status == repro_torch.SolveStatus.CONVERGED
        assert abs(r.iterations - w.iterations) <= 2
        assert np.max(np.abs(r.x - w.x)) <= 1e-6
    st = eng.stats
    assert st["runs"] == st["host_reads"] == st["chunks"]
    assert st["admissions"] > 0
    steps = st["steps"]
    assert launches["fused_dots_batched"] == steps
    assert launches["fused_axpy_batched"] == steps
    # two per step, one per admission's splice and one at the initial fill
    assert launches["spmv_ell_batched"] == 2 * steps + st["admissions"] + 1
    if precond:
        assert launches["block_jacobi_apply_batched"] >= 2 * steps
    assert not any(plain.values())
    assert eng.registry.entries()[0].session.stats["graphs"] == 2


def test_engine_corruption_scrub_and_retry_on_the_card(cuda):
    """NaN written into the resident block on the card (the state the
    program handed out, written in place): the victim retires NONFINITE,
    is scrubbed and served again (``retries == 1``), and the guarded
    kernels ran."""
    from repro_torch.resilience import RecoveryPolicy
    op, _, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    rhs = service_rhs(ell.n, 4)
    got, eng, launches = serve_on_card(
        ell, rhs, "cuda", recovery=RecoveryPolicy(max_retries=1),
        corrupt=True)
    clean, _, _ = serve_on_card(ell, rhs, "cuda",
                                recovery=RecoveryPolicy(max_retries=1))
    assert got[0].retries == 1
    for rid, r in got.items():
        assert r.status == repro_torch.SolveStatus.CONVERGED
        assert np.isfinite(r.x).all()
        assert abs(r.iterations - clean[rid].iterations) <= 2
    assert launches["fused_dots_health_batched"] == eng.stats["steps"]
    assert launches["fused_dots_batched"] == 0


def test_session_cache_budget_returns_card_memory(cuda, monkeypatch):
    """Sessions bound past the byte budget release their programs: the
    memory reserved falls back under the budget plus one session, and
    ``tol`` overrides run one program."""
    from repro_torch import api
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    op, _, _ = TM.convection_diffusion(32, peclet=1.0)
    ells = [TM.stencil_to_ell(dataclasses.replace(op, c=op.c * (1.0 + i)))
            for i in range(6)]
    B = torch.ones((ells[0].n, 8), dtype=torch.float64, device=cuda)
    first = repro_torch.make_solver("p-bicgsafe", ells[0], substrate="cuda")
    for tol in (1e-4, 1e-6, 1e-8):
        first.solve_many(B, tol=tol, maxiter=32)
    assert first.stats["programs"] == 1
    one = first.nbytes
    assert one > 0
    budget = int(2.5 * one)
    monkeypatch.setattr(api, "_SESSION_CACHE_BYTES", budget)
    for ell in ells[1:]:
        repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda"
                                ).solve_many(B, maxiter=32)
    info = api.session_cache_info()
    assert info["bytes"] <= budget and info["programs"] == 2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()             # the allocator's free blocks
    assert torch.cuda.memory_reserved() - base <= budget + one
    assert not first._programs
    assert bool(first.solve_many(B, maxiter=32).iterations.eq(32).all())


# -- the trace ring and the profiles ------------------------------------------

def same_trace(a, b):
    return a.steps == b.steps and np.array_equal(a.buffer, b.buffer,
                                                 equal_nan=True)


@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr",
                                    "ssbicgsafe2"])
def test_traced_graph_chunk_is_bitwise_the_untraced(cuda, method):
    """A traced solve through its graph programs is the untraced one bit
    for bit, with the same launches; the traced eager chunk gives the same
    bits and the same ring.  ``rr_epoch=20``: -rr crosses replacement
    steps."""
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    solver = repro_torch.make_solver(
        method, ell, substrate="cuda",
        config=repro_torch.SolverConfig(rr_epoch=20))
    (plain, p_launches), _ = graph_and_eager(lambda: solver.solve(b))
    (graph, g_launches), (eager, e_launches) = graph_and_eager(
        lambda: solver.solve(b, trace=True))
    assert bool(graph.converged)
    assert_bitwise(plain, graph)
    assert_bitwise(graph, eager)
    assert p_launches == g_launches == e_launches
    assert same_trace(graph.trace, eager.trace)
    assert graph.trace.steps == int(graph.iterations) + 1


def test_traced_graph_solve_many_is_bitwise_the_untraced(cuda):
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    B = torch.stack([b, 0.5 * b, b + 1.0], dim=1)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    (plain, p_launches), _ = graph_and_eager(lambda: solver.solve_many(B))
    (graph, g_launches), (eager, e_launches) = graph_and_eager(
        lambda: solver.solve_many(B, trace=True))
    assert_bitwise(plain, graph)
    assert_bitwise(graph, eager)
    assert p_launches == g_launches == e_launches
    assert same_trace(graph.trace, eager.trace)


def test_kernel_map_names_the_main_path_kernels(cuda, tmp_path):
    """A profiled ``solve`` on the card: the map learnt from the eager run
    names the three kernels of the main path by their phases, and the
    window's reduce-phase kernels are the fused dots' two kernels per
    launch."""
    from repro_torch.observe import profile as P
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    ops.reset_launches()
    plain = solver.solve(b)
    torch.cuda.synchronize()
    dots = ops.LAUNCHES["fused_dots"]
    res = solver.solve(b, profile=str(tmp_path))
    assert_bitwise(plain, res)
    with open(tmp_path / "kernel_map.json") as fh:
        kmap = __import__("json").load(fh)["kernels"]
    phases = {}
    for name, tag in kmap.items():
        for kernel in ("fused_dots", "spmv_ell", "fused_axpy"):
            if kernel in name:
                phases.setdefault(kernel, set()).add(tag)
    assert phases == {"fused_dots": {"repro.reduce"},
                      "spmv_ell": {"repro.matvec"},
                      "fused_axpy": {"repro.axpy"}}
    rep = solver.last_profile
    assert rep.n_device_events > 0 and rep.device_wall_us > 0
    assert all(rep.phase_us[k] > 0 for k in ("matvec", "reduce", "axpy"))
    events = P.phase_events(rep.timeline_path, kmap)
    assert sum(e["phase"] == "reduce" for e in events) == 2 * dots


# -- the distributed driver at world 1: NCCL, the collective in the graph ----

MESH_REDUCTIONS = {"p-bicgsafe": 1, "p-bicgsafe-rr": 1, "ssbicgsafe2": 1,
                   "p-bicgstab": 2, "bicgstab": 2, "gpbicg": 3, "cgs": 2}


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank NCCL process group (``file://`` store) and its
    ``(1,)`` DeviceMesh; destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("rows",))
    finally:
        dist.destroy_process_group()


FRESH_GROUP_CHILD = """
import sys, tempfile
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
import repro_torch
from repro_torch.core import matrices as TM
dist.init_process_group("nccl", init_method="file://" + tempfile.mktemp(),
                        rank=0, world_size=1)
mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("rows",))
op, b, _ = TM.convection_diffusion(24, peclet=1.0)
sessions = 0
for rep in range(4):
    for method in sys.argv[1:]:
        # a fresh session (the cache emptied, the earlier sessions'
        # programs freed): its programs capture afresh
        repro_torch.clear_session_cache()
        s = repro_torch.make_solver(method, op, substrate="cuda",
                                    config=repro_torch.SolverConfig(
                                        tol=1e-8 * (1 + rep)))
        single = s.solve(b)
        res = s.on_mesh(mesh).solve(b.reshape(24, 24, 24))
        torch.cuda.synchronize()
        assert torch.equal(res.x.reshape(-1), single.x), method
        sessions += 1
dist.destroy_process_group()
print("captured", sessions)
"""


def test_captures_right_after_a_fresh_nccl_group(cuda, tmp_path):
    """ROADMAP C17: in a fresh process with a one-rank NCCL group made,
    28 fresh sessions (every method, four times, the cache emptied before
    each) capture their chunks, single-process and on the mesh, and agree
    bit for bit.  With the garbage collector free to run inside a capture
    (a dropped mesh-bound session is a reference cycle) this failed in
    each of three runs ("operation failed due to a previous error during
    capture")."""
    import os
    import subprocess
    import sys
    script = tmp_path / "child.py"
    script.write_text(FRESH_GROUP_CHILD)
    # the child imports the package this test imported
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, str(script)]
                          + sorted(MESH_REDUCTIONS), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"captured {4 * len(MESH_REDUCTIONS)}" in proc.stdout


@pytest.mark.parametrize("method", sorted(MESH_REDUCTIONS))
def test_mesh_solve_at_world_1_is_bitwise_the_single_process_solve(
        cuda, mesh1, method):
    """One rank: the all-reduce is the identity and both halos are zeros,
    so ``on_mesh(mesh).solve`` is the session's own ``solve`` bit for bit,
    with the same launches, Table 3.1's reductions per step, and each
    chunk one graph with the NCCL collective in it."""
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    solver = repro_torch.make_solver(method, op, substrate="cuda")
    ops.reset_launches()
    single = solver.solve(b)
    torch.cuda.synchronize()
    single_launches = dict(ops.LAUNCHES)
    dsolver = solver.on_mesh(mesh1)
    assert solver.on_mesh(mesh1) is dsolver
    graphs = solver.stats["graphs"]
    steps = solver.stats["steps"]
    dsolver.syncs.calls = 0
    ops.reset_launches()
    res = dsolver.solve(b.reshape(24, 24, 24))
    torch.cuda.synchronize()
    assert torch.equal(res.x.reshape(-1), single.x)
    assert int(res.iterations) == int(single.iterations)
    assert dict(ops.LAUNCHES) == single_launches
    assert solver.stats["graphs"] > graphs
    steps = solver.stats["steps"] - steps
    assert dsolver.syncs.calls == 1 + MESH_REDUCTIONS[method] * steps


def test_mesh_graph_program_matches_the_eager_chunk(cuda, mesh1):
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    dsolver = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda",
                                      config=repro_torch.SolverConfig(
                                          record_history=True)
                                      ).on_mesh(mesh1)
    calls = []

    def run():
        dsolver.syncs.calls = 0
        res = dsolver.solve(b.reshape(24, 24, 24))
        calls.append(dsolver.syncs.calls)
        return res
    (graph, g_launches), (eager, e_launches) = graph_and_eager(run)
    assert bool(graph.converged)
    assert_bitwise(graph, eager)
    assert g_launches == e_launches
    assert calls[0] == calls[1]


@pytest.mark.parametrize("guard", [False, True])
def test_mesh_solve_many_at_world_1_is_bitwise(cuda, mesh1, guard):
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    B = torch.stack([b, 0.5 * b, b + 1.0], dim=1)
    solver = repro_torch.make_solver(
        "p-bicgsafe", op, substrate="cuda",
        config=repro_torch.SolverConfig(guard=guard, maxiter=400))
    single = solver.solve_many(B)
    dsolver = solver.on_mesh(mesh1)
    dsolver.syncs.shapes.clear()
    res = dsolver.solve_many(B.reshape(24, 24, 24, 3))
    torch.cuda.synchronize()
    assert torch.equal(res.x.reshape(B.shape), single.x)
    assert torch.equal(res.iterations, single.iterations)
    assert dsolver.syncs.shapes == {(1, 3), (11 if guard else 9, 3)}


def test_verify_contracts_then_a_solve_on_the_card(cuda):
    """The contract analyzer on a CUDA session traces in fake mode: it
    launches nothing, finds the kernel ops in the step, and the solve
    after it launches the kernels its steps take."""
    op, b, _ = TM.convection_diffusion(24, peclet=1.0)
    ell = TM.stencil_to_ell(op)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    ops.reset_launches()
    reports = solver.verify_contracts(bindings=["single", "batched"])
    assert dict(ops.LAUNCHES) == launches()
    for rep in reports:
        assert rep.ok, [f.to_dict() for f in rep.violations]
        assert rep.finding("kernel_backed").detail.startswith(
            "4 kernel op(s)")
    res = solver.solve(b)
    torch.cuda.synchronize()
    assert bool(res.converged)
    steps = solver.stats["steps"]
    assert dict(ops.LAUNCHES) == method_launches("p-bicgsafe", steps, 0)


@pytest.mark.parametrize("name", ["convdiff-multirhs-pallas",
                                  "helmholtz-multirhs-pallas"])
def test_cuda_scenario_cell_on_the_card(cuda, name):
    """A ``"cuda"`` seed scenario through ``run_cell`` on the card: the
    batched dots and update kernels launch once a step each, and nothing
    else; the cell converges, passes its plugin's oracle and its contract
    row; a second bind is the same session and captures no new graph."""
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.sweep import run_cell
    sc = get_scenario(name)
    session = sc.bind(cuda)
    ops.reset_launches()
    rec = run_cell(sc, device=cuda)
    torch.cuda.synchronize()
    got = dict(ops.LAUNCHES)
    steps = session.stats["steps"]
    assert rec["converged"] and rec["oracle"]["ok"]
    assert rec["contracts"]["ok"], rec["contracts"]["deviations"]
    assert steps >= rec["iterations"] > 0
    assert got == launches(fused_dots_batched=steps,
                           fused_axpy_batched=steps)
    graphs = session.stats["graphs"]
    assert sc.bind(cuda) is session
    assert repro_torch.make_solver(scenario=name, device=cuda) is session
    run_cell(sc, contracts=False, device=cuda)
    assert session.stats["graphs"] == graphs


# -- training and the Newton-Krylov step -----------------------------------------

def _smoke_phi3(**kw):
    from repro_torch.configs import smoke_config
    return smoke_config("phi3-mini-3.8b").replace(
        dtype=torch.float32, param_dtype=torch.float32, **kw)


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Two fused train steps of the f32 smoke phi3 from the same weights
    and batches, on the card and on the CPU: the losses and the weights
    agree to f32 rounding; no kernel of the port runs (training takes the
    plain attention branch)."""
    import copy
    from repro_torch.data import DataConfig, make_dataset
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, pipelined_clip_init
    from repro_torch.train import TrainConfig, make_train_step
    cfg = _smoke_phi3()
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=1,
                                       decay_steps=2))
    batch_fn = make_dataset(DataConfig(batch_size=2, seq_len=32,
                                       vocab_size=cfg.vocab_size), cfg)
    models = {"cpu": init_params(cfg, torch.Generator().manual_seed(0))}
    models["cuda"] = copy.deepcopy(models["cpu"]).to(cuda)
    losses = {}
    ops.reset_launches()
    for dev, model in models.items():
        step = make_train_step(cfg, tcfg)
        opt = adamw_init(dict(model.named_parameters()), tcfg.opt)
        clip = pipelined_clip_init(dev)
        losses[dev] = []
        for s in range(2):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch_fn(s).items()}
            model, opt, clip, m = step(model, opt, clip, batch,
                                       torch.tensor(1e9, device=dev))
            assert float(m["accepted"]) == 1.0
            losses[dev].append(float(m["loss"]))
    assert dict(ops.LAUNCHES) == launches()
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-4)
    for a, b in zip(models["cpu"].parameters(), models["cuda"].parameters()):
        assert float((b.cpu() - a).abs().max() / a.abs().max()) <= 1e-4


# -- training on a mesh (repro_torch.parallel) ----------------------------------

@pytest.fixture
def parallel_mesh(cuda, mesh1):
    """A (1, 1) ("data", "model") mesh on the one-rank NCCL group of
    ``mesh1``, as a LogicalMesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel import LogicalMesh
    return LogicalMesh(init_device_mesh("cuda", (1, 1),
                                        mesh_dim_names=("data", "model")))


def test_parallel_train_on_a_one_rank_mesh_is_the_plain_trainer(
        parallel_mesh, tmp_path):
    """Three steps of the f32 smoke phi3 through ``train(lm=)`` on the
    (1, 1) NCCL mesh and through the plain trainer, same seed and data:
    every parameter a DTensor placed as ``module_param_specs`` gives, the
    losses and grad norms equal, the weights equal bit for bit, no kernel
    of the port launched; the mesh's checkpoint resumes in the plain
    trainer."""
    from torch.distributed.tensor import DTensor
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import module_param_specs
    from repro_torch.train import TrainConfig, train
    lm = parallel_mesh
    cfg = _smoke_phi3()
    dcfg = DataConfig(batch_size=4, seq_len=32, vocab_size=cfg.vocab_size)

    def tcfg(d, steps=3):
        return TrainConfig(steps=steps, ckpt_every=3, ckpt_dir=str(
            tmp_path / d), opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                          decay_steps=12))
    ops.reset_launches()
    mesh = train(cfg, dcfg, tcfg("mesh"), lm=lm)
    plain = train(cfg, dcfg, tcfg("plain"), device="cuda")
    torch.cuda.synchronize()
    assert dict(ops.LAUNCHES) == launches()
    specs = module_param_specs(mesh["params"], lm)
    for k, p in mesh["params"].named_parameters():
        assert isinstance(p, DTensor) and p.device.type == "cuda", k
        assert tuple(p.placements) == lm.placements(specs[k]), k
    for key in ("loss", "grad_norm"):
        assert [h[key] for h in mesh["history"]] == \
            [h[key] for h in plain["history"]], key
    theirs = dict(plain["params"].named_parameters())
    for k, p in mesh["params"].named_parameters():
        assert torch.equal(p.full_tensor(), theirs[k]), k
    more = train(cfg, dcfg, tcfg("mesh", steps=4), device="cuda")
    assert more["start_step"] == 3 and len(more["history"]) == 1


def test_parallel_logical_constraint_on_cuda_dtensors(parallel_mesh):
    """``logical_constraint`` on CUDA DTensors: the placements its names
    give (a name whose axes do not divide its dimension dropped), the
    values and the gradient's placements unchanged; a plain CUDA tensor,
    and any tensor with no mesh set, returned as it is."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.parallel import logical_constraint, use_mesh
    lm = parallel_mesh
    t = torch.randn(4, 6, 8, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    x = distribute_tensor(t, lm.mesh, [Replicate(), Replicate()])
    x.requires_grad_(True)
    with use_mesh(lm):
        y = logical_constraint(x, "batch", None, "heads")
        assert y.placements == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), t)
        g, = torch.autograd.grad((y * 2).sum(), [x])
        assert logical_constraint(t, "batch", None, None) is t
    assert g.placements == x.placements
    assert torch.equal(g.full_tensor(), torch.full_like(t, 2.0))
    assert logical_constraint(x, "batch") is x


@pytest.mark.parametrize("substrate", ["cuda", "torch"])
def test_newton_krylov_step_launches_the_fp32_kernels(cuda, substrate):
    """A Newton-Krylov step on the 1-layer f32 smoke phi3: with
    ``substrate="cuda"`` its inner p-BiCGSafe solve launches the fused dots
    and the fused update once per queued step, in f32, and nothing else;
    with ``"torch"`` no kernel.  The inner solve runs the eager program
    (no graph is captured), and the step lowers the loss."""
    import functools
    from repro_torch.core.pipelined_bicgsafe import pbicgsafe_solve
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.optim import NewtonKrylovConfig, newton_krylov_step
    cfg = _smoke_phi3(n_layers=1)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    stats = {}
    nk = NewtonKrylovConfig(damping=1e-2, inner_maxiter=10, inner_tol=1e-2,
                            lr=0.5, solver=functools.partial(
                                pbicgsafe_solve, substrate=substrate,
                                stats=stats))
    batch = {"tokens": toks}
    ops.reset_launches()
    _, m = newton_krylov_step(lambda p, b: loss_fn(p, cfg, b)[0],
                              lambda p, b: forward(p, cfg, b)[0], model,
                              batch, nk)
    torch.cuda.synchronize()
    steps = stats["steps"]
    assert steps == 10 and stats.get("graphs", 0) == 0
    assert dict(ops.LAUNCHES) == (
        launches(fused_dots=steps, fused_axpy=steps) if substrate == "cuda"
        else launches())
    assert next(model.parameters()).dtype == torch.float32
    assert 0 < int(m["inner_iters"]) <= steps
    assert float(m["new_loss"]) < float(m["loss"])
