"""The port's kernel modules, through their CPU path (the plain versions),
held against the JAX package's oracles (``repro.kernels.ref``) and its
Pallas kernels in interpret mode; plus the wrappers' operand checks and the
build command.  The CUDA kernels themselves run in tests/test_torch_cuda.py
and chip_smoke.py, on the card."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import enable_x64  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_axpy import (fused_axpy_batched_pallas,  # noqa: E402
                                      fused_axpy_pallas)
from repro.kernels.fused_dots import (  # noqa: E402
    fused_dots_batched_pallas, fused_dots_health_batched_pallas,
    fused_dots_health_pallas, fused_dots_pallas)
from repro.kernels.spmv_ell import (spmv_ell_batched_pallas,  # noqa: E402
                                    spmv_ell_pallas)
from repro_torch.core.linear_operator import ELLOperator  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.fused_axpy import (IN_ORDER, MASKED_OUT,  # noqa: E402
                                            OUT_ORDER)
from repro_torch.kernels.fused_dots import (MAX_BLOCKS, num_blocks,  # noqa: E402
                                            tile_width)

SCALARS = (0.3, -0.7, 1.1, 0.2)


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def vectors(n, count, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(dtype) for _ in range(count)]


def assert_close(got, want, scale, dtype, rtol32, atol32=0.0, what=""):
    """fp64: within 1e-12 of ``scale``; fp32: the tolerances of
    tests/test_kernels.py."""
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    if dtype == np.float64:
        err = np.max(np.abs(got - want) / np.asarray(scale))
        assert err <= 1e-12, (what, err)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol32, atol=atol32,
                                   err_msg=what)


@pytest.mark.parametrize("n", [100, 1000, 40_000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_dots_matches_ref_and_pallas(n, dtype):
    vecs = vectors(n, 5, dtype, seed=n)
    with enable_x64(dtype == np.float64):
        jv = [jnp.asarray(v) for v in vecs]
        want_ref = np_(jref.fused_dots(*jv))
        want_pallas = np_(fused_dots_pallas(*jv, interpret=True))
    before = dict(ops.LAUNCHES)
    got = ops.fused_dots(*(torch.from_numpy(v) for v in vecs))
    assert ops.LAUNCHES == before          # the CPU path launches nothing
    assert got.shape == (9,) and got.dtype == getattr(torch, dtype.__name__)
    scale = np_(ref.fused_dots(*(torch.from_numpy(np.abs(v))
                                 for v in vecs))).astype(np.float64)
    for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
        assert_close(got, want, scale, dtype, rtol32=2e-5, what=what)


@pytest.mark.parametrize("n", [100, 8193])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_axpy_matches_ref_and_pallas(n, dtype):
    vecs = dict(zip(IN_ORDER, vectors(n, len(IN_ORDER), dtype, seed=n + 1)))
    with enable_x64(dtype == np.float64):
        jv = {k: jnp.asarray(v) for k, v in vecs.items()}
        want_ref = {k: np_(v) for k, v in jref.fused_axpy(jv, SCALARS).items()}
        want_pallas = {k: np_(v) for k, v in
                       fused_axpy_pallas(jv, SCALARS, interpret=True).items()}
    got = ops.fused_axpy({k: torch.from_numpy(v) for k, v in vecs.items()},
                         SCALARS)
    assert tuple(got) == OUT_ORDER
    for k in OUT_ORDER:
        scale = np.max(np.abs(want_ref[k]))
        for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
            assert_close(got[k], want[k], scale, dtype, rtol32=5e-5,
                         atol32=1e-5, what=f"{what}:{k}")


def _banded(n, dtype, seed):
    rng = np.random.default_rng(seed)
    offs = np.array([-2, -1, 0, 1, 2])
    cols = np.clip(np.arange(n)[:, None] + offs[None, :], 0, n - 1)
    vals = rng.standard_normal((n, len(offs)))
    vals[cols == np.arange(n)[:, None]] += 3.0
    return vals.astype(dtype), cols.astype(np.int32)


@pytest.mark.parametrize("n", [512, 1000, 4099])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_ell_matches_ref_and_pallas(n, dtype):
    vals, cols = _banded(n, dtype, seed=n)
    x = vectors(n, 1, dtype, seed=n + 2)[0]
    with enable_x64(dtype == np.float64):
        jv, jc, jx = jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)
        want_ref = np_(jref.spmv_ell(jv, jc, jx))
        want_pallas = np_(spmv_ell_pallas(jv, jc, jx, interpret=True))
    op = ELLOperator(torch.from_numpy(vals), torch.from_numpy(cols), n)
    got = ops.spmv_ell(op, torch.from_numpy(x))
    scale = np.max(np.abs(want_ref))
    for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
        assert_close(got, want, scale, dtype, rtol32=1e-4, atol32=1e-5,
                     what=what)


def test_spmv_ell_takes_unbanded_matrices(x64):
    """No band limit in the port: a random (unbanded) ELL matrix goes
    through the same wrapper and matches the JAX oracle."""
    rng = np.random.default_rng(0)
    n, k = 3000, 6
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k))
    x = rng.standard_normal(n)
    want = np_(jref.spmv_ell(jnp.asarray(vals), jnp.asarray(cols),
                             jnp.asarray(x)))
    op = ELLOperator(torch.from_numpy(vals), torch.from_numpy(cols), n)
    got = np_(ops.spmv_ell(op, torch.from_numpy(x)))
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


def test_fused_dots_rejects_bad_operands():
    v = torch.ones(10, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.fused_dots(*(v.half(),) * 5)
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.fused_dots(*(v.long(),) * 5)
    with pytest.raises(ValueError, match="unlike"):
        ops.fused_dots(v, v, v, v, torch.ones(11, dtype=torch.float64))
    with pytest.raises(ValueError, match="unlike"):
        ops.fused_dots(v, v, v, v, v.float())
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_dots(v, v, v, v, torch.ones(20, dtype=torch.float64)[::2])
    with pytest.raises(ValueError, match="1-D"):
        ops.fused_dots(*(v.reshape(2, 5, 1),) * 5)
    with pytest.raises(ValueError, match="unlike"):
        ops.fused_dots(v, v, v, v, v.reshape(10, 1))


def test_fused_axpy_rejects_bad_operands():
    vecs = {k: torch.ones(8, dtype=torch.float64) for k in IN_ORDER}
    with pytest.raises(KeyError, match="As"):
        ops.fused_axpy({k: v for k, v in vecs.items() if k != "As"},
                       SCALARS)
    with pytest.raises(ValueError, match="4 scalars"):
        ops.fused_axpy(vecs, SCALARS[:3])
    got = ops.fused_axpy(vecs, torch.tensor(SCALARS, dtype=torch.float64))
    want = ops.fused_axpy(vecs, SCALARS)
    for k in OUT_ORDER:
        assert torch.equal(got[k], want[k])


def test_spmv_ell_rejects_bad_operands():
    vals, cols = _banded(16, np.float64, seed=0)
    op = ELLOperator(torch.from_numpy(vals), torch.from_numpy(cols), 16)
    with pytest.raises(ValueError):
        ops.spmv_ell(op, torch.ones(15, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.spmv_ell(op, torch.ones(16, dtype=torch.float32))
    with pytest.raises(TypeError):
        ops.spmv_ell(op, torch.ones(16, dtype=torch.float16))


def test_fused_dots_grid_is_fixed_by_n():
    assert num_blocks(0) == 1 and num_blocks(1) == 1
    assert num_blocks(256) == 1 and num_blocks(257) == 2
    assert num_blocks(108 ** 3) == MAX_BLOCKS
    # the batched kernel: a block takes 256 // m rows of all m <= 256
    # columns per pass, or a 256-column tile of one row
    assert [tile_width(m) for m in (1, 8, 17, 256, 300)] == \
        [1, 8, 17, 256, 256]
    assert num_blocks(1000, 256 // tile_width(8)) == 32
    assert num_blocks(108 ** 3, 256 // tile_width(8)) == MAX_BLOCKS


def test_build_command_targets_sm90a(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    out = tmp_path / "lib.so"
    srcs = _build.sources()
    objs = [tmp_path / f"{s.stem}.o" for s in srcs]
    for src, obj in zip(srcs, objs):
        cmd = _build.compile_command(src, obj)
        assert cmd[0] == str(fake)
        assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and str(src) in cmd
        assert cmd[cmd.index("-o") + 1] == str(obj)
    assert {s.name for s in srcs} >= {
        "fused_dots.cu", "fused_axpy.cu", "spmv_ell.cu",
        "fused_dots_batched.cu", "fused_axpy_batched.cu",
        "spmv_ell_batched.cu", "flash_attention.cu",
        "flash_attention_mma.cu"}
    cmd = _build.link_command(out, objs)
    assert cmd[0] == str(fake) and "-shared" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert cmd[-len(objs):] == [str(o) for o in objs]
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parent == _build.CSRC.parents[2]
    assert path.name.startswith("librepro_torch_kernels-")


def test_launch_counts_only_successful_launches():
    _build.reset_launches()
    _build.launch("spmv_ell", lambda: 0)
    assert _build.LAUNCHES["spmv_ell"] == 1
    _build.reset_launches()
    assert set(_build.LAUNCHES.values()) == {0}


# -- the batched (multi-RHS) kernels ------------------------------------------

BATCHED_SHAPES = [(n, m) for n in (100, 1000) for m in (1, 3, 8, 17)]


def blocks(n, m, count, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, m)).astype(dtype) for _ in range(count)]


@pytest.mark.parametrize("n,m", BATCHED_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_dots_batched_matches_ref_and_pallas(n, m, dtype):
    vecs = blocks(n, m, 5, dtype, seed=n + m)
    with enable_x64(dtype == np.float64):
        jv = [jnp.asarray(v) for v in vecs]
        want_ref = np_(jref.fused_dots_batched(*jv))
        want_pallas = np_(fused_dots_batched_pallas(*jv, interpret=True))
    before = dict(ops.LAUNCHES)
    got = ops.fused_dots(*(torch.from_numpy(v) for v in vecs))
    assert ops.LAUNCHES == before          # the CPU path launches nothing
    assert got.shape == (9, m) and got.dtype == getattr(torch, dtype.__name__)
    scale = np_(ref.fused_dots(*(torch.from_numpy(np.abs(v))
                                 for v in vecs))).astype(np.float64)
    for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
        assert_close(got, want, scale, dtype, rtol32=2e-4, atol32=1e-5,
                     what=what)


@pytest.mark.parametrize("n,m", BATCHED_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_axpy_batched_matches_ref_and_pallas(n, m, dtype):
    """Per-column coefficients and the in-kernel mask (every third column
    frozen): frozen columns keep their inputs bit for bit."""
    vecs = dict(zip(IN_ORDER, blocks(n, m, len(IN_ORDER), dtype, seed=n)))
    rng = np.random.default_rng(m)
    scal = rng.standard_normal((4, m)).astype(dtype)
    mask = np.arange(m) % 3 != 1
    with enable_x64(dtype == np.float64):
        jv = {k: jnp.asarray(v) for k, v in vecs.items()}
        js = tuple(jnp.asarray(c) for c in scal)
        jm = jnp.asarray(mask)
        want_ref = {k: np_(v) for k, v in
                    jref.fused_axpy(jv, js, mask=jm).items()}
        want_pallas = {k: np_(v) for k, v in fused_axpy_batched_pallas(
            jv, js, jm, interpret=True).items()}
    tv = {k: torch.from_numpy(v) for k, v in vecs.items()}
    got = ops.fused_axpy(tv, torch.from_numpy(scal),
                         torch.from_numpy(mask))
    assert tuple(got) == OUT_ORDER
    for k in OUT_ORDER:
        assert got[k].shape == (n, m)
        scale = np.max(np.abs(want_ref[k]))
        for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
            assert_close(got[k], want[k], scale, dtype, rtol32=5e-5,
                         atol32=1e-5, what=f"{what}:{k}")
        if k in MASKED_OUT:
            assert torch.equal(got[k][:, ~mask], tv[k][:, ~mask]), k


def test_fused_axpy_batched_mask_is_a_select(x64):
    """NaN and Inf coefficients in frozen columns (a zero column's relres
    is 0/0) stay out of the state; ``mask=None`` advances every column,
    as an all-True mask does."""
    n, m = 64, 4
    vecs = {k: torch.from_numpy(v) for k, v in
            zip(IN_ORDER, blocks(n, m, len(IN_ORDER), np.float64, seed=9))}
    scal = torch.tensor([[0.3, np.nan, 0.5, np.inf]] * 4, dtype=torch.float64)
    mask = torch.tensor([True, False, True, False])
    got = ops.fused_axpy(vecs, scal, mask)
    for k in MASKED_OUT:
        assert torch.equal(got[k][:, ~mask], vecs[k][:, ~mask]), k
        assert bool(torch.isfinite(got[k]).all()), k
    live = ops.fused_axpy(vecs, scal[:, [0, 2]].repeat(1, 2),
                          torch.ones(m, dtype=torch.bool))
    free = ops.fused_axpy(vecs, scal[:, [0, 2]].repeat(1, 2))
    for k in OUT_ORDER:
        assert torch.equal(live[k], free[k]), k
    # scalar and (m,) coefficients broadcast over the columns
    one = ops.fused_axpy(vecs, SCALARS)
    per = ops.fused_axpy(vecs, [torch.full((m,), c, dtype=torch.float64)
                                for c in SCALARS])
    for k in OUT_ORDER:
        assert torch.equal(one[k], per[k]), k


@pytest.mark.parametrize("n,m", BATCHED_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_ell_batched_matches_ref_and_pallas(n, m, dtype):
    vals, cols = _banded(n, dtype, seed=n)
    x = blocks(n, m, 1, dtype, seed=n + m)[0]
    with enable_x64(dtype == np.float64):
        jv, jc, jx = jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)
        want_ref = np_(jref.spmv_ell(jv, jc, jx))
        want_pallas = np_(spmv_ell_batched_pallas(jv, jc, jx, interpret=True))
    op = ELLOperator(torch.from_numpy(vals), torch.from_numpy(cols), n)
    got = ops.spmv_ell(op, torch.from_numpy(x))
    assert got.shape == (n, m)
    scale = np.max(np.abs(want_ref))
    for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
        assert_close(got, want, scale, dtype, rtol32=1e-4, atol32=1e-5,
                     what=what)


def test_batched_wrappers_reject_bad_operands():
    v = torch.ones(10, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="unlike"):
        ops.fused_dots(v, v, v, v, torch.ones(10, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_dots(v, v, v, v, torch.ones(3, 10, dtype=torch.float64).T)
    vecs = {k: torch.ones(8, 3, dtype=torch.float64) for k in IN_ORDER}
    with pytest.raises(ValueError, match="4 scalars"):
        ops.fused_axpy(vecs, torch.ones(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"mask must be \(3,\)"):
        ops.fused_axpy(vecs, SCALARS, torch.ones(2, dtype=torch.bool))
    vals, cols = _banded(16, np.float64, seed=0)
    op = ELLOperator(torch.from_numpy(vals), torch.from_numpy(cols), 16)
    with pytest.raises(ValueError):
        ops.spmv_ell(op, torch.ones(15, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.spmv_ell(op, torch.ones(2, 16, dtype=torch.float64).T)


def test_mask_on_vectors_raises():
    vecs = {k: torch.ones(8, dtype=torch.float64) for k in IN_ORDER}
    with pytest.raises(ValueError, match="multi-RHS"):
        ops.fused_axpy(vecs, SCALARS, torch.ones(8, dtype=torch.bool))


# -- the guarded (11-row) health dots ------------------------------------------

@pytest.mark.parametrize("n", [100, 1000, 40_000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_dots_health_matches_ref_and_pallas(n, dtype):
    vecs = vectors(n, 6, dtype, seed=n + 7)
    with enable_x64(dtype == np.float64):
        jv = [jnp.asarray(v) for v in vecs]
        want_ref = np_(jref.fused_dots_health(*jv))
        want_pallas = np_(fused_dots_health_pallas(*jv, interpret=True))
    before = dict(ops.LAUNCHES)
    tv = [torch.from_numpy(v) for v in vecs]
    got = ops.fused_dots_health(*tv)
    assert ops.LAUNCHES == before          # the CPU path launches nothing
    assert got.shape == (11,) and got.dtype == getattr(torch, dtype.__name__)
    # rows 0-8 are the 9-row phase's, bit for bit
    assert torch.equal(got[:9], ops.fused_dots(*tv[:5]))
    scale = np_(ref.fused_dots_health(*(torch.from_numpy(np.abs(v))
                                        for v in vecs))).astype(np.float64)
    for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
        assert_close(got, want, scale, dtype, rtol32=2e-5, what=what)


@pytest.mark.parametrize("n,m", BATCHED_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_dots_health_batched_matches_ref_and_pallas(n, m, dtype):
    vecs = blocks(n, m, 6, dtype, seed=n + m + 7)
    with enable_x64(dtype == np.float64):
        jv = [jnp.asarray(v) for v in vecs]
        want_ref = np_(jref.fused_dots_health_batched(*jv))
        want_pallas = np_(fused_dots_health_batched_pallas(*jv,
                                                           interpret=True))
    tv = [torch.from_numpy(v) for v in vecs]
    got = ops.fused_dots_health(*tv)
    assert got.shape == (11, m) and got.dtype == getattr(torch,
                                                         dtype.__name__)
    assert torch.equal(got[:9], ops.fused_dots(*tv[:5]))
    scale = np_(ref.fused_dots_health(*(torch.from_numpy(np.abs(v))
                                        for v in vecs))).astype(np.float64)
    for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
        assert_close(got, want, scale, dtype, rtol32=2e-4, atol32=1e-5,
                     what=what)


@pytest.mark.parametrize("batched", [False, True])
def test_fused_dots_health_probe_flags_exactly_the_poisoned_columns(batched,
                                                                    x64):
    """A NaN in x and an Inf in s make row 10 non-finite in exactly those
    columns, on both sides; the other columns stay finite."""
    n, m = 300, 5
    vecs = blocks(n, m, 6, np.float64, seed=21)
    s, x = vecs[0], vecs[5]
    s[17, 1] = np.inf
    x[200, 3] = np.nan
    if not batched:
        vecs = [v[:, 3].copy() for v in vecs]     # the NaN column alone
    jv = [jnp.asarray(v) for v in vecs]
    if batched:
        want = [np_(jref.fused_dots_health_batched(*jv)),
                np_(fused_dots_health_batched_pallas(*jv, interpret=True))]
    else:
        want = [np_(jref.fused_dots_health(*jv)),
                np_(fused_dots_health_pallas(*jv, interpret=True))]
    got = np_(ops.fused_dots_health(*(torch.from_numpy(v) for v in vecs)))
    for rows in [got] + want:
        probe = np.atleast_1d(rows[10])
        bad = ~np.isfinite(probe)
        assert bad.tolist() == ([False, True, False, True, False]
                                if batched else [True])


def test_fused_dots_health_rejects_bad_operands():
    v = torch.ones(10, dtype=torch.float64)
    with pytest.raises(ValueError, match="unlike"):
        ops.fused_dots_health(v, v, v, v, v, v.float())
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_dots_health(v, v, v, v, v,
                              torch.ones(20, dtype=torch.float64)[::2])
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.fused_dots_health(*(v.long(),) * 6)
    with pytest.raises(TypeError):
        ops.fused_dots_health(v, v, v, v, v)      # x is not optional
