"""The grouped matrix product of the MoE sort dispatch
(``repro_torch.kernels.grouped_mm`` and ``ops.grouped_mm``) held against
``jax.lax.ragged_dot`` on the CPU.

The CUDA kernel has no counterpart in the JAX package (it stands in for
``ragged_dot``, which XLA lowers); here its plain version, the CPU path
and the card's oracle, is held to ``ragged_dot`` over empty groups, one
group holding every row and one group alone, in f32 (1e-5 of the result's
max-abs: another summation order) and bf16 (2e-2, tests/test_kernels.py's
bf16 bar: both round the f32 sums to bf16, from other orders); the op's
fake kernel and its derivative too.  The kernel itself runs in
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

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
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
    x = rng.standard_normal((R, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    if dtype == "bfloat16":
        x, w = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in (x, w))
    return x, w, np.asarray(sizes, np.int32)


def offsets_of(sizes) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])).long()


def rel(got, want) -> float:
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SIZES))
def test_plain_version_matches_ragged_dot(case, dtype):
    x, w, sizes = operands(SIZES[case], dtype)
    want = jax.lax.ragged_dot(jnp.asarray(x, JAX[dtype]),
                              jnp.asarray(w, JAX[dtype]),
                              jnp.asarray(sizes))
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
