"""The port's CUDA kernels on the card (marker ``gpu``; each test skips when
no CUDA device is present).  This file imports no JAX, so it runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core.linear_operator import ELLOperator  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_axpy import IN_ORDER, MASKED_OUT  # noqa: E402

pytestmark = pytest.mark.gpu

#: max |kernel - plain| over the result's scale; fp64: FMA contraction and
#: another summation order; fp32: the tolerances of tests/test_kernels.py
TOL = {torch.float64: 1e-12, torch.float32: 5e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
        {"fused_dots": 1, "fused_axpy": 1, "spmv_ell": 1,
         "fused_dots_batched": 0, "fused_axpy_batched": 0,
         "spmv_ell_batched": 0}


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


@pytest.mark.parametrize("method", ["p-bicgsafe", "p-bicgsafe-rr"])
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
    assert abs(int(res.iterations) - int(plain.iterations)) <= 2
    assert float((res.x - plain.x).abs().max()) <= 1e-6
    steps, rr = solver.stats["steps"], solver.stats["rr_steps"]
    assert dict(ops.LAUNCHES) == {"fused_dots": steps, "fused_axpy": steps,
                                  "spmv_ell": 1 + 2 * steps + 4 * rr,
                                  "fused_dots_batched": 0,
                                  "fused_axpy_batched": 0,
                                  "spmv_ell_batched": 0}


#: batched fp32: the tolerances of tests/test_kernels.py
TOL_BATCHED = {torch.float64: 1e-12, torch.float32: 2e-4}


@pytest.mark.parametrize("m", [1, 3, 8, 17, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_kernels_match_plain_versions(cuda, dtype, m):
    """m = 300 takes the dots kernel's multi-tile path (256 columns a
    tile)."""
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
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == \
        {"fused_dots": 0, "fused_axpy": 0, "spmv_ell": 0,
         "fused_dots_batched": 1, "fused_axpy_batched": 1,
         "spmv_ell_batched": 1}


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
    assert dict(ops.LAUNCHES) == {"fused_dots": 0, "fused_axpy": 0,
                                  "spmv_ell": 0,
                                  "fused_dots_batched": steps,
                                  "fused_axpy_batched": steps,
                                  "spmv_ell_batched": 1 + 2 * steps}
