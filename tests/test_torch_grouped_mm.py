"""The grouped matrix product of the MoE sort dispatch
(``repro_torch.kernels.grouped_mm`` and ``ops.grouped_mm``) held against
``jax.lax.ragged_dot`` on the CPU.

The CUDA kernel has no counterpart in the JAX package (it stands in for
``ragged_dot``, which XLA lowers); here its plain version, the CPU path
and the card's oracle, is held to ``ragged_dot`` over empty groups, one
group holding every row and one group alone, in f32 (1e-5 of the result's
max-abs: another summation order), f64 (1e-12, with JAX's x64 on inside
the test alone) and bf16 (2e-2, tests/test_kernels.py's bf16 bar: both
round the f32 sums to bf16, from other orders); the op's fake kernel, its
derivative and the card's choice of route (from the dtype alone), of
each route's tile (from R and E alone) and of the f32 / f64 route's copies
(from K and N alone) too.  The kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py, on the card.  Inputs come from
numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.kernels import grouped_mm as kgrouped  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from conftest import enable_x64  # noqa: E402

TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "float64": torch.float64,
         "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "float64": jnp.float64,
       "bfloat16": jnp.bfloat16}
#: case -> the group sizes (R = their sum)
SIZES = {
    "empty groups": [5, 0, 17, 0, 0, 1, 9, 0],
    "one group holds every row": [0, 0, 23, 0],
    "one group": [19],
}


def operands(sizes, dtype, K=24, N=16, seed=0):
    """numpy x (R, K), w (E, K, N) rounded to ``dtype``, and the sizes."""
    rng = np.random.default_rng(seed)
    R, E = sum(sizes), len(sizes)
    x = rng.standard_normal((R, K))
    w = rng.standard_normal((E, K, N)) / np.sqrt(K)
    if dtype != "float64":
        x, w = x.astype(np.float32), w.astype(np.float32)
    if dtype == "bfloat16":
        x, w = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in (x, w))
    return x, w, np.asarray(sizes, np.int32)


def offsets_of(sizes) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])).long()


def rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64) if want.dtype == jnp.float64 else \
        np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("case", list(SIZES))
def test_plain_version_matches_ragged_dot(case, dtype):
    x, w, sizes = operands(SIZES[case], dtype)
    with enable_x64(dtype == "float64"):
        want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x, JAX[dtype]),
                                             jnp.asarray(w, JAX[dtype]),
                                             jnp.asarray(sizes)))
        assert want.dtype == JAX[dtype]
    tx, tw = (torch.from_numpy(a).to(TORCH[dtype]) for a in (x, w))
    got = kgrouped.plain(tx, tw, offsets_of(sizes))
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == want.shape
    assert rel(got, want) <= TOL[dtype]
    # the op on the CPU is the plain version
    assert torch.equal(ops.grouped_mm(tx, tw, offsets_of(sizes)), got)


def test_derivative_matches_ragged_dots():
    """The op's backward (dx through the grouped product of each
    ``w[e]^T``, dw per group) against ``jax.grad`` of ``ragged_dot``."""
    x, w, sizes = operands(SIZES["empty groups"], "float32", seed=1)
    ct = np.random.default_rng(2).standard_normal(
        (x.shape[0], w.shape[2])).astype(np.float32)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jax.lax.ragged_dot(
        a, b, jnp.asarray(sizes)) * ct), argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (ops.grouped_mm(tx, tw, offsets_of(sizes)) * torch.from_numpy(ct)
     ).sum().backward()
    assert rel(tx.grad, jdx) <= TOL["float32"]
    assert rel(tw.grad, jdw) <= TOL["float32"]
    assert float(tw.grad[1].abs().max()) == 0.0       # an empty group


def test_fake_kernel_gives_the_shape_without_a_host_read():
    """In fake mode the op's fake kernel runs: ``make_fx`` traces a call on
    fake offsets (whose values no one can read) to one op node."""
    x, w, sizes = operands(SIZES["empty groups"], "bfloat16")
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
            offsets_of(sizes))
    mode = FakeTensorMode()
    fake = [mode.from_tensor(a) for a in args]
    gm = make_fx(ops.grouped_mm, tracing_mode="fake")(*fake)
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets == ["repro_torch.grouped_mm.default"]
    with mode:
        out = ops.grouped_mm(*fake)
    assert tuple(out.shape) == (x.shape[0], w.shape[2])
    assert out.dtype == torch.bfloat16


def test_the_plain_version_checks_the_offsets():
    x, w, sizes = operands([3, 4], "float32")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for bad in ([0, 3, 6], [1, 3, 7], [0, 8, 7]):
        with pytest.raises(ValueError, match="offsets must rise"):
            ops.grouped_mm(tx, tw, torch.tensor(bad))


@pytest.mark.parametrize("change,error,match", [
    (dict(offsets=torch.tensor([0, 3, 7], dtype=torch.int32)), TypeError,
     "int64"),
    (dict(w=torch.zeros(3, 24, 16)), ValueError, "E \\+ 1"),
    (dict(x=torch.zeros(7, 8)), ValueError, "expected x"),
    (dict(w=torch.zeros(2, 24, 16, dtype=torch.float64)), TypeError,
     "share a float dtype"),
    (dict(x=torch.zeros(24, 7).T), ValueError, "contiguous"),
])
def test_the_wrapper_refuses_bad_operands(change, error, match):
    x, w, _ = operands([3, 4], "float32")
    args = dict(x=torch.from_numpy(x), w=torch.from_numpy(w),
                offsets=torch.tensor([0, 3, 7]))
    args.update(change)
    with pytest.raises(error, match=match):
        ops.grouped_mm(**args)


#: (R, E, K, N) -> the wgmma route's tile, the mma route's tile, and
#: whether the mma route copies 16 bytes at a time in f32 and in f64:
#: deepseek-v3's decode step (32 rows of a 4-token step at top-8 over 256
#: experts) and prefill (4 x 1,024 tokens), fewer rows than groups (at and
#: below R = E / 32, once a bf16 crossover, now the same route), the
#: tiles' crossover (64 rows a group, for both routes) on either side, and
#: K or N that break 16-byte rows in f32 alone (2 mod 4) or in both (odd)
ROUTE_CASES = {
    "decode step": ((32, 256, 7168, 2048), "128x256", "64x128",
                    (True, True)),
    "prefill": ((32768, 256, 7168, 2048), "192x192", "144x128",
                (True, True)),
    "prefill wo": ((32768, 256, 2048, 7168), "192x192", "144x128",
                   (True, True)),
    "at the crossover": ((8, 256, 64, 64), "128x256", "64x128",
                         (True, True)),
    "below the crossover": ((7, 256, 64, 64), "128x256", "64x128",
                            (True, True)),
    "at the wide tile": ((64 * 16, 16, 64, 64), "192x192", "144x128",
                         (True, True)),
    "below the wide tile": ((64 * 16 - 1, 16, 64, 64), "128x256", "64x128",
                            (True, True)),
    "K and N 2 mod 4": ((64 * 16, 16, 66, 6), "192x192", "144x128",
                        (False, True)),
    "odd K": ((64 * 16 - 1, 16, 37, 64), "128x256", "64x128",
              (False, False)),
    "odd N": ((64 * 16, 16, 64, 29), "192x192", "144x128", (False, False)),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_chooses_by_shape_and_dtype_alone(case):
    """The card's route of a grouped product from the dtype (bf16 on
    wgmma, f32 and f64 on mma.sync, whatever the shape; float16 refused),
    each route's tile from R and E alone, and the mma route's copies from
    K and N alone."""
    (R, E, K, N), tile, mma_tile, vec = ROUTE_CASES[case]
    assert kgrouped.route(torch.bfloat16) == "wgmma"
    assert kgrouped.wgmma_tile(R, E) == tile
    assert kgrouped.tile_rows("wgmma", R, E) == int(tile[:3])
    assert kgrouped.mma_tile(R, E) == mma_tile
    assert kgrouped.tile_rows("mma", R, E) == int(mma_tile.split("x")[0])
    for dtype, v in zip((torch.float32, torch.float64), vec):
        assert kgrouped.route(dtype) == "mma"
        assert kgrouped.mma_vec(dtype, K, N) is v
    with pytest.raises(TypeError, match="bfloat16, float32 or float64"):
        kgrouped.route(torch.float16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_the_card_path_traces_without_a_host_read(dtype):
    """``make_fx`` in fake mode over ``ops.grouped_mm`` on fake CUDA
    operands: the card's checks (the route, the alignment of the bf16
    route, the tile count) read no value, and the call is one op node;
    f32 and f64 take K and N that break 16-byte rows (21 and 13: element
    copies) and K and N that keep them (24 and 16)."""
    shapes = [(24, 16)] if dtype == "bfloat16" else [(21, 13), (24, 16)]
    for K, N in shapes:
        x, w, sizes = operands(SIZES["empty groups"], "float32", K=K, N=N)
        mode = FakeTensorMode()
        with mode:
            fake = [torch.empty(x.shape, dtype=TORCH[dtype], device="cuda"),
                    torch.empty(w.shape, dtype=TORCH[dtype], device="cuda"),
                    torch.empty(len(sizes) + 1, dtype=torch.int64,
                                device="cuda")]
        gm = make_fx(ops.grouped_mm, tracing_mode="fake")(*fake)
        targets = [str(n.target) for n in gm.graph.nodes
                   if n.op == "call_function"]
        assert targets == ["repro_torch.grouped_mm.default"]
        with mode:
            out = ops.grouped_mm(*fake)
        assert tuple(out.shape) == (x.shape[0], N)
        assert out.dtype == TORCH[dtype] and out.device.type == "cuda"
        if dtype != "bfloat16":
            assert kgrouped.mma_vec(TORCH[dtype], K, N) is (K == 24)


@pytest.mark.parametrize("dtype,K,match", [
    (torch.float16, 24, "bfloat16, float32 or float64"),
    (torch.bfloat16, 12, "multiples of 8"),
])
def test_the_card_path_refuses_what_no_route_takes(dtype, K, match):
    """On (fake) CUDA operands, float16 and a bf16 K that is not a
    multiple of 8 raise before any launch; nothing falls back to the plain
    version."""
    with FakeTensorMode():
        args = (torch.empty(7, K, dtype=dtype, device="cuda"),
                torch.empty(2, K, 16, dtype=dtype, device="cuda"),
                torch.empty(3, dtype=torch.int64, device="cuda"))
        with pytest.raises((TypeError, ValueError), match=match):
            ops.grouped_mm(*args)
