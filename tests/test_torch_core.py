"""The PyTorch port's foundation held against the JAX package: types,
operators, generators and the BiCGSafe coefficient algebra (fp64, CPU)."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402  caps torch's threads

import jax.numpy as jnp  # noqa: E402

from repro.core import _common as jcommon  # noqa: E402
from repro.core import linear_operator as jlo  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import operator_from_numpy  # noqa: E402
from repro_torch.core import _common as tcommon  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.linear_operator import ELLOperator  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CPU = "cpu"


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def rel_err(got, want):
    got, want = np_(got), np_(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


# -- types --------------------------------------------------------------------

def test_solve_status_codes_match():
    assert {s.name: s.value for s in ttypes.SolveStatus} == \
        {s.name: s.value for s in jtypes.SolveStatus}


def test_solver_config_fields_and_defaults_match():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(ttypes.SolverConfig) == spec(jtypes.SolverConfig)
    assert ttypes.SolveResult._fields == jtypes.SolveResult._fields


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_breakdown_threshold_matches(dtype, x64):
    assert ttypes.SolverConfig().breakdown_threshold(getattr(torch, dtype)) \
        == jtypes.SolverConfig().breakdown_threshold(getattr(jnp, dtype))


def test_status_predicates_and_drift_threshold_match():
    for s in ttypes.SolveStatus:
        j = jtypes.SolveStatus(s.value)
        assert (s.is_failure, s.is_terminal) == (j.is_failure, j.is_terminal)
    for scale in (0.0, 1e-3):
        assert ttypes.SolverConfig(drift_scale=scale).drift_threshold(
            torch.float64) == jtypes.SolverConfig(
                drift_scale=scale).drift_threshold(jnp.float64)


@pytest.mark.parametrize("m", [None, 3])
def test_trace_cap_not_ported(m, x64):
    """Ported now: ``trace_init`` / ``trace_record`` write the JAX
    package's ring (channels, slot ``i % cap``); the port's record also
    takes ``active`` and keeps the slot when it is false."""
    assert ttypes.TRACE_CHANNELS == jtypes.TRACE_CHANNELS
    C = len(ttypes.TRACE_CHANNELS)
    cfg = dict(trace_cap=4)
    jbuf = jtypes.trace_init(jtypes.SolverConfig(**cfg), jnp.float64, m)
    tbuf = ttypes.trace_init(ttypes.SolverConfig(**cfg), torch.float64,
                             "cpu", m)
    assert tbuf.shape == jbuf.shape and tbuf.isnan().all()
    rng = np.random.default_rng(0)
    shape = () if m is None else (m,)
    for i in (0, 1, 5, 6, 9):
        vals = [rng.standard_normal(shape) for _ in range(C)]
        jbuf = jtypes.trace_record(jbuf, jnp.asarray(i, jnp.int32),
                                   [jnp.asarray(v) for v in vals])
        ttypes.trace_record(tbuf, torch.tensor(i, dtype=torch.int32),
                            [torch.from_numpy(np.asarray(v)) for v in vals],
                            torch.tensor(True))
        assert np.array_equal(np_(tbuf), np.asarray(jbuf), equal_nan=True)
    kept = tbuf.clone()
    ttypes.trace_record(tbuf, torch.tensor(2, dtype=torch.int32),
                        [torch.zeros(shape, dtype=torch.float64)] * C,
                        torch.tensor(False))
    assert torch.equal(tbuf.nan_to_num(), kept.nan_to_num())


def test_classify_status_matches(x64):
    for conv, bd, rel in [(True, False, 1e-9), (False, True, 1.0),
                          (False, False, float("nan")),
                          (False, False, 0.5), (True, True, 1e-9)]:
        want = int(jtypes.classify_status(jnp.asarray(conv), jnp.asarray(bd),
                                          jnp.asarray(rel)))
        got = ttypes.classify_status(torch.tensor(conv), torch.tensor(bd),
                                     torch.tensor(rel, dtype=torch.float64))
        assert got.dtype == torch.int32 and int(got) == want


def test_history_update_respects_active():
    cfg = ttypes.SolverConfig(maxiter=4, record_history=True)
    hist = ttypes.history_init(cfg, torch.float64, CPU)
    assert hist.shape == (5,) and bool(torch.isnan(hist).all())
    i = torch.tensor(1, dtype=torch.int32)
    ttypes.history_update(hist, i, torch.tensor(0.5, dtype=torch.float64),
                          cfg, torch.tensor(True))
    ttypes.history_update(hist, i, torch.tensor(0.25, dtype=torch.float64),
                          cfg, torch.tensor(False))
    assert float(hist[1]) == 0.5
    off = ttypes.history_init(ttypes.SolverConfig(), torch.float64, CPU)
    assert off.shape == (0,)
    assert ttypes.history_update(off, i, torch.tensor(0.5), ttypes
                                 .SolverConfig(), torch.tensor(True)) is off


def test_resolve_device_defaults_to_cuda():
    assert ttypes.resolve_device(CPU) == torch.device(CPU)
    if torch.cuda.is_available():
        assert ttypes.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttypes.resolve_device(None)


# -- operators -----------------------------------------------------------------

def _jax_operators():
    """One JAX operator of each class, with the arrays that carry it over."""
    dense, _, _ = JM.nonsym_dense(60, seed=2)
    csr, _, _ = JM.random_nonsym(500, 6, seed=2)
    ell = jlo.ELLOperator.from_csr(csr)
    sten, _, _ = JM.convection_diffusion(6, ny=5, nz=4, peclet=1.5)
    return {
        "dense": (dense, {"a": dense.a}),
        "csr": (csr, {"data": csr.data, "indices": csr.indices,
                      "row_ids": csr.row_ids, "n": csr.n}),
        "ell": (ell, {"values": ell.values, "cols": ell.cols, "n": ell.n}),
        "stencil7": (sten, {"c": sten.c, "nx": sten.nx, "ny": sten.ny,
                            "nz": sten.nz}),
    }


@pytest.mark.parametrize("kind", ["dense", "csr", "ell", "stencil7"])
def test_operator_matvec_and_diagonal_match(kind, x64):
    jop, arrays = _jax_operators()[kind]
    top = operator_from_numpy(kind, {k: np_(v) for k, v in arrays.items()},
                              device=CPU, dtype=torch.float64)
    assert top.shape == tuple(jop.shape) and top.dtype == torch.float64
    x = np.random.default_rng(7).standard_normal(jop.shape[0])
    assert rel_err(top.matvec(torch.from_numpy(x)),
                   jop.matvec(jnp.asarray(x))) <= 1e-14
    assert rel_err(top.diagonal(), jop.diagonal()) <= 1e-14


def test_ell_from_csr_matches(x64):
    jcsr, _, _ = JM.random_nonsym(300, 5, seed=4)
    tcsr, _, _ = TM.random_nonsym(300, 5, seed=4, device=CPU)
    jell, tell = jlo.ELLOperator.from_csr(jcsr), ELLOperator.from_csr(tcsr)
    assert tell.cols.dtype == torch.int32
    np.testing.assert_array_equal(np_(tell.values), np_(jell.values))
    np.testing.assert_array_equal(np_(tell.cols), np_(jell.cols))


def test_ell_operator_validates_cols():
    vals = torch.ones(4, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        ELLOperator(vals, torch.full((4, 2), 4, dtype=torch.int32), 4)
    with pytest.raises(TypeError, match="int32"):
        ELLOperator(vals, torch.zeros(4, 2, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        ELLOperator(vals, torch.zeros(3, 2, dtype=torch.int32), 4)


def test_operator_from_numpy_rejects_unknown_kind_and_missing_arrays():
    with pytest.raises(ValueError):
        operator_from_numpy("coo", {}, device=CPU)
    with pytest.raises(KeyError):
        operator_from_numpy("ell", {"values": np.zeros((2, 1))}, device=CPU)


# -- generators ----------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("random_nonsym", dict(n=400, nnz_per_row=7, seed=3)),
    ("random_nonsym", dict(n=400, nnz_per_row=5, seed=9, fmt="ell")),
    ("hard_nonsym", dict(n=300, seed=3, scale_range=3.0)),
    ("spd_dense", dict(n=50, seed=1)),
    ("nonsym_dense", dict(n=50, seed=2)),
])
def test_generators_bitwise_equal(name, kwargs, x64):
    jop, jb, _ = getattr(JM, name)(**kwargs)
    top, tb, txt = getattr(TM, name)(device=CPU, **kwargs)
    assert type(top).__name__ == type(jop).__name__
    for field in dataclasses.fields(jop):
        j, t = getattr(jop, field.name), getattr(top, field.name)
        if isinstance(t, torch.Tensor):
            assert t.dtype == getattr(torch, str(np_(j).dtype))
            np.testing.assert_array_equal(np_(t), np_(j), err_msg=field.name)
        else:
            assert t == j
    assert rel_err(tb, jb) <= 1e-14
    assert bool((txt == 1).all())


@pytest.mark.parametrize("name,kwargs", [
    ("poisson3d", dict(nx=6, ny=5, nz=4)),
    ("convection_diffusion", dict(nx=6, peclet=2.0)),
    ("anisotropic3d", dict(nx=5, eps=1e-2)),
])
def test_stencil_generators_match(name, kwargs, x64):
    jop, jb, _ = getattr(JM, name)(**kwargs)
    top, tb, _ = getattr(TM, name)(device=CPU, **kwargs)
    np.testing.assert_array_equal(np_(top.c), np_(jop.c))
    assert (top.nx, top.ny, top.nz) == (jop.nx, jop.ny, jop.nz)
    assert rel_err(tb, jb) <= 1e-14


@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 3, 4)])
def test_stencil_to_ell_is_the_same_matrix(shape, x64):
    top, _, _ = TM.convection_diffusion(*shape, peclet=0.5, device=CPU)
    ell = TM.stencil_to_ell(top)
    assert ell.k == 7 and ell.cols.dtype == torch.int32
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(top.n))
    assert rel_err(ell.matvec(x), top.matvec(x)) <= 1e-14
    assert rel_err(ell.diagonal(), top.diagonal()) == 0.0
    # the same arrays as a JAX ELL operator: equal to the JAX stencil, and
    # banded, so the JAX "pallas" substrate sends it to its SpMV kernel
    jsten, _, _ = JM.convection_diffusion(*shape, peclet=0.5)
    jell = jlo.ELLOperator(jnp.asarray(np_(ell.values)),
                           jnp.asarray(np_(ell.cols)), ell.n)
    assert rel_err(jell.matvec(jnp.asarray(np_(x))),
                   jsten.matvec(jnp.asarray(np_(x)))) <= 1e-14
    assert jops.ell_is_banded(jell)


# -- coefficient algebra -------------------------------------------------------

def _coef_inputs(seed):
    rng = np.random.default_rng(seed)
    dots = rng.standard_normal(9)
    dots[0], dots[1] = abs(dots[0]) + 1.0, abs(dots[1]) + 1.0
    alpha_prev, zeta_prev, f_prev = rng.standard_normal(3)
    return dots, alpha_prev, zeta_prev, f_prev


def _both(fn_name, dots, i, alpha_prev, zeta_prev, f_prev, eps=1e-12):
    jout = getattr(jcommon, fn_name)(
        jnp.asarray(dots), jnp.asarray(i, jnp.int32), jnp.asarray(alpha_prev),
        jnp.asarray(zeta_prev), jnp.asarray(f_prev), eps)
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    tout = getattr(tcommon, fn_name)(
        t(dots), torch.tensor(i, dtype=torch.int32), t(alpha_prev),
        t(zeta_prev), t(f_prev), eps)
    return jout, tout


@pytest.mark.parametrize("i", [0, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bicgsafe_coefficients_match(i, seed, x64):
    jout, tout = _both("bicgsafe_coefficients", *_coef_inputs(seed)[:1], i,
                       *_coef_inputs(seed)[1:])
    for name, j, t in zip(("beta", "alpha", "zeta", "eta", "f", "rr"),
                          jout[:6], tout[:6]):
        assert abs(float(t) - float(j)) <= 1e-14 * max(abs(float(j)), 1.0), \
            name
    assert bool(tout[6]) == bool(jout[6]) is False
    code = tcommon.bicgsafe_breakdown_code(
        torch.tensor(_coef_inputs(seed)[0]), i,
        *(torch.tensor(v) for v in _coef_inputs(seed)[1:]), 1e-12)
    assert int(code) == 0


def _breakdown_case(case):
    dots, alpha_prev, zeta_prev, f_prev = _coef_inputs(11)
    i = 3
    if case == "rho":          # beta denominator zeta_{i-1} f_{i-1}
        f_prev = 0.0
    elif case == "alpha":      # alpha denominator g + beta h
        dots[6], dots[7] = 0.0, 0.0
    elif case == "omega":      # zeta/eta denominator a b - c^2
        dots[0], dots[1], dots[2] = 1.0, 4.0, 2.0
    elif case == "alpha_i0":   # i == 0: g is the alpha denominator
        i, dots[6] = 0, 0.0
    elif case == "pivot_i0":   # i == 0: (s, s) is the zeta pivot
        i, dots[0] = 0, 0.0
    return dots, i, alpha_prev, zeta_prev, f_prev


@pytest.mark.parametrize("case,code", [
    ("rho", ttypes.SolveStatus.BREAKDOWN_RHO),
    ("alpha", ttypes.SolveStatus.BREAKDOWN_ALPHA),
    ("omega", ttypes.SolveStatus.BREAKDOWN_OMEGA),
    ("alpha_i0", ttypes.SolveStatus.BREAKDOWN_ALPHA),
    ("pivot_i0", ttypes.SolveStatus.BREAKDOWN_ALPHA),
])
def test_breakdown_branches_match(case, code, x64):
    args = _breakdown_case(case)
    jout, tout = _both("bicgsafe_coefficients", *args)
    assert bool(tout[6]) and bool(jout[6])
    for j, t in zip(jout[:6], tout[:6]):
        assert np.isclose(float(t), float(j), rtol=1e-14, atol=0.0) \
            or (np.isnan(float(t)) and np.isnan(float(j)))
    jcode, tcode = _both("bicgsafe_breakdown_code", *args)
    assert tcode.dtype == torch.int32
    assert int(tcode) == int(jcode) == int(code)


@pytest.mark.parametrize("seed", range(4))
def test_typed_coefficients_give_the_breakdown_code(seed):
    """``bicgsafe_coefficients(..., typed=True)`` derives the code from its
    own denominators' flags; it equals ``bicgsafe_breakdown_code`` on
    columns that hit each branch (and on healthy ones)."""
    rng = np.random.default_rng(seed)
    m = 12
    dots = torch.from_numpy(rng.standard_normal((9, m)))
    alpha, zeta, f = (torch.from_numpy(rng.standard_normal(m))
                      for _ in range(3))
    i = torch.from_numpy(rng.integers(0, 2, m).astype(np.int32))
    dots[0, 0] = 0.0                                  # pivot a
    dots[0, 1], dots[1, 1], dots[2, 1] = 1.0, 4.0, 2.0   # a*b - c^2 = 0
    zeta[2] = 0.0                                     # rho denominator
    dots[6, 3], dots[7, 3] = 0.0, 0.0                 # alpha denominator
    *_, bad, code = tcommon.bicgsafe_coefficients(dots, i, alpha, zeta, f,
                                                  1e-12, typed=True)
    want = tcommon.bicgsafe_breakdown_code(dots, i, alpha, zeta, f, 1e-12)
    assert torch.equal(code, want)
    assert bool(((code != 0) == bad).all())
    plain = tcommon.bicgsafe_coefficients(dots, i, alpha, zeta, f, 1e-12)
    for a, b in zip(plain, tcommon.bicgsafe_coefficients(
            dots, i, alpha, zeta, f, 1e-12, typed=True)):
        assert torch.equal(a, b)


def test_safe_div_and_recurrence_tail_match(x64):
    num = np.array([1.0, 2.0, -3.0])
    den = np.array([0.0, 1e-30, 4.0])
    jv, jb = jcommon.safe_div(jnp.asarray(num), jnp.asarray(den), 1e-20)
    tv, tb = tcommon.safe_div(torch.from_numpy(num), torch.from_numpy(den),
                              1e-20)
    np.testing.assert_array_equal(np_(tv), np_(jv))
    np.testing.assert_array_equal(np_(tb), np_(jb))
    rng = np.random.default_rng(3)
    vecs = [rng.standard_normal(50) for _ in range(5)]
    sc = (0.3, -1.2, 0.7)
    jl = jcommon.pipelined_recurrence_tail(*map(jnp.asarray, vecs), *sc)
    tl = tcommon.pipelined_recurrence_tail(*map(torch.from_numpy, vecs), *sc)
    for j, t in zip(jl, tl):
        assert rel_err(t, j) <= 1e-15


def test_local_dots_and_sync_counter(x64):
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(300), rng.standard_normal(300)
    pairs = [(a, b), (a, a)]
    want = jcommon.local_dots([(jnp.asarray(x), jnp.asarray(y))
                               for x, y in pairs])
    got = tcommon.local_dots([(torch.from_numpy(x), torch.from_numpy(y))
                              for x, y in pairs])
    assert rel_err(got, want) <= 1e-14
    counter = tcommon.SyncCounter(lambda p: p)
    counter(got)
    assert counter.calls == 1


# -- isolation -----------------------------------------------------------------

def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.core.matrices, repro_torch.core.multirhs, "
            "repro_torch.resilience, repro_torch.core.bicgstab, "
            "repro_torch.models, repro_torch.serve, repro_torch.configs, "
            "repro_torch.configs.qwen3_8b, repro_torch.launch.serve, "
            "repro_torch.service, repro_torch.observe, "
            "repro_torch.core.distributed, repro_torch.analysis, "
            "repro_torch.scenarios, repro_torch.scenarios.sweep, "
            "repro_torch.train, repro_torch.optim, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.optim.newton_krylov, "
            "repro_torch.parallel\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(_torch_threads.child_env(),
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    offenders = [f"{path}:{no}" for path in files
                 for no, line in enumerate(open(path), 1)
                 if pattern.match(line)]
    assert not offenders
