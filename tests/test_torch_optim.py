"""The port's optimizers (``repro_torch.optim``) held against the JAX
package's ``repro.optim`` on the CPU.

Inputs come from numpy seeds.  8-bit quantization is held bit for bit
(codes) and to f32 rounding (scales); AdamW over 3 steps in each state
dtype to f32 rounding in the parameters and to the state dtype's own
rounding in the moments; the Newton-Krylov step on the JAX package's
softmax-regression case in f64 (its regression test's set-up) to the same
inner iterations within 2, the same line-search step and parameters within
1e-6; the GGN matvec on a 1-layer smoke phi3 within 1e-5 of JAX's.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clipping as jclip  # noqa: E402
from repro.optim import eightbit as j8  # noqa: E402
from repro.optim import newton_krylov as jnk  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.models import forward as tforward  # noqa: E402
from repro_torch.models import loss_fn as tloss_fn  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import clipping as tclip  # noqa: E402
from repro_torch.optim import eightbit as t8  # noqa: E402
from repro_torch.optim import newton_krylov as tnk  # noqa: E402

from conftest import enable_x64  # noqa: E402

F32_RTOL = 1e-6        # one f32 op chain, another library's rounding


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().cpu().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64)) \
        if str(jnp.asarray(a).dtype) == "bfloat16" else np.asarray(a)


def rel(got, want):
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- 8-bit states ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (256,), (3, 256), (5, 7), (2, 3, 384)])
def test_quantize_and_dequantize_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = np.asarray(rng.standard_normal(shape) * 3.0, dtype=np.float32)
    if x.ndim > 1:                               # an all-zero block too
        bs = 128 if x.shape[-1] % 128 == 0 else x.shape[-1]
        x.reshape(-1, x.shape[-1])[0, :bs] = 0.0
    jq = j8.quantize(jnp.asarray(x))
    tq = t8.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    assert tq.codes.dtype == torch.int8
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               rtol=F32_RTOL, atol=0)
    np.testing.assert_allclose(t8.dequantize(tq).numpy(),
                               np.asarray(j8.dequantize(jq)),
                               rtol=F32_RTOL, atol=1e-7)
    z = t8.zeros_like_q8(torch.from_numpy(x))
    jz = j8.zeros_like_q8(jnp.asarray(x))
    assert tuple(z.codes.shape) == jz.codes.shape
    assert tuple(z.scales.shape) == jz.scales.shape


# -- AdamW -----------------------------------------------------------------------

def test_schedule_matches_jax():
    cfg = dict(lr=3e-3, warmup_steps=5, decay_steps=40, min_lr_ratio=0.1)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 41, 100):
        got = tadamw.schedule(tc, torch.tensor(step, dtype=torch.int32))
        want = jadamw.schedule(jc, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert rel(got, want) <= F32_RTOL, step


def _adamw_tree(rng):
    return {"w": rng.standard_normal((4, 256)).astype(np.float32),
            "b": rng.standard_normal((256,)).astype(np.float32),
            "s": rng.standard_normal((3, 5)).astype(np.float32)}


#: the moments' own rounding: bf16 keeps 8 bits; an 8-bit code is within
#: one step (its block's scale) of the other package's
MOMENT_TOL = {"f32": 1e-5, "bf16": 2 ** -7, "i8": 1.0 / 127}


@pytest.mark.parametrize("state_dtype", ["f32", "bf16", "i8"])
def test_adamw_update_matches_jax_for_three_steps(state_dtype):
    rng = np.random.default_rng(7)
    params = _adamw_tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=10,
               state_dtype=state_dtype)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jadamw.adamw_init(jp, jc), tadamw.adamw_init(tp, tc)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        scale = np.float32(0.5 + 0.25 * step)
        jp, js = jadamw.adamw_update(
            jp, {k: jnp.asarray(g) for k, g in grads.items()}, js, jc,
            grad_scale=jnp.asarray(scale))
        tp, ts = tadamw.adamw_update(
            tp, {k: torch.from_numpy(g) for k, g in grads.items()}, ts, tc,
            grad_scale=torch.tensor(scale))
    assert int(ts["count"]) == int(js["count"]) == 3
    for k in params:
        assert tp[k].dtype == torch.float32
        assert rel(tp[k], jp[k]) <= 1e-5, k
        for key in ("m", "v"):
            got, want = ts[key][k], js[key][k]
            if state_dtype == "i8":
                assert isinstance(got, t8.Q8)
                assert np.abs(got.codes.numpy().astype(int) - np.asarray(
                    want.codes).astype(int)).max() <= 1
                got, want = t8.dequantize(got), j8.dequantize(want)
            else:
                assert got.dtype == (torch.bfloat16 if state_dtype == "bf16"
                                     else torch.float32)
            assert rel(got, want) <= MOMENT_TOL[state_dtype], (key, k)


# -- clipping --------------------------------------------------------------------

def test_pipelined_clip_uses_the_stale_norm():
    rng = np.random.default_rng(3)
    js, ts = jclip.pipelined_clip_init(), tclip.pipelined_clip_init()
    fresh = []
    for step, size in enumerate((4.0, 0.25, 9.0)):
        grads = {"a": (size * rng.standard_normal((8, 16))).astype(
            np.float32), "b": rng.standard_normal(16).astype(np.float32)}
        jscale, js = jclip.pipelined_clip(
            {k: jnp.asarray(v) for k, v in grads.items()}, js, 1.0)
        tscale, ts = tclip.pipelined_clip(
            {k: torch.from_numpy(v) for k, v in grads.items()}, ts, 1.0)
        assert rel(tscale, jscale) <= F32_RTOL
        assert rel(ts.prev_norm, js.prev_norm) <= F32_RTOL
        assert bool(ts.initialized)
        fresh.append(float(ts.prev_norm))
        # the scale of step k is 1 / max(1, norm of step k - 1): stale by
        # one step (the first step has only its own)
        stale = fresh[-2] if step else fresh[-1]
        assert float(tscale) == pytest.approx(min(1.0, 1.0 / stale),
                                              rel=1e-6)
    assert rel(tclip.global_norm([torch.ones(4), torch.ones(5)]),
               jclip.global_norm([jnp.ones(4), jnp.ones(5)])) == 0.0


# -- Newton-Krylov ---------------------------------------------------------------

def _softmax_regression():
    """The JAX package's regression case (tests/test_substrate.py): a tiny
    softmax regression, logits = x @ W, in f64."""
    key = jax.random.PRNGKey(0)
    X = np.asarray(jax.random.normal(key, (64, 8), jnp.float64))
    y = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (64,), 0, 5))
    return X, y


def test_newton_krylov_step_matches_jax_on_softmax_regression():
    with enable_x64(True):
        X, y = _softmax_regression()

        def jlogits(p, b):
            return b["x"] @ p["w"]

        def jloss(p, b):
            lg = jlogits(p, b)
            return -jnp.mean(jax.nn.log_softmax(lg)[
                jnp.arange(lg.shape[0]), b["y"]])

        def tlogits(p, b):
            return b["x"] @ p["w"]

        def tloss(p, b):
            lg = tlogits(p, b)
            return -torch.log_softmax(lg, dim=-1)[
                torch.arange(lg.shape[0]), b["y"]].mean()

        kw = dict(damping=1e-2, inner_maxiter=50, inner_tol=1e-8,
                  trust_radius=10.0)
        jc, tc = jnk.NewtonKrylovConfig(**kw), tnk.NewtonKrylovConfig(**kw)
        jp = {"w": jnp.zeros((8, 5), jnp.float64)}
        tp = {"w": torch.zeros((8, 5), dtype=torch.float64)}
        jb = {"x": jnp.asarray(X), "y": jnp.asarray(y)}
        tb = {"x": torch.from_numpy(X.copy()),
              "y": torch.from_numpy(y.astype(np.int64))}
        losses = [float(tloss(tp, tb))]
        jstep = jax.jit(jnk.newton_krylov_step, static_argnums=(0, 1, 4))
        for _ in range(5):
            jp, jm = jstep(jloss, jlogits, jp, jb, jc)
            tp, tm = tnk.newton_krylov_step(tloss, tlogits, tp, tb, tc)
            assert abs(int(tm["inner_iters"]) - int(jm["inner_iters"])) <= 2
            assert float(tm["step_scale"]) == float(jm["step_scale"])
            assert tp["w"].dtype == torch.float64
            np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                       rtol=0, atol=1e-6)
            assert float(tm["new_loss"]) == pytest.approx(
                float(jm["new_loss"]), rel=1e-10)
            losses.append(float(tloss(tp, tb)))
        assert all(b <= a + 1e-12 for a, b in zip(losses, losses[1:]))
        assert losses[-1] < losses[0] - 0.25


@pytest.fixture(scope="module")
def phi3_one_layer():
    """1-layer smoke phi3 in f32: JAX parameters, the port's model with the
    same weights, and a seeded batch."""
    jc = jsmoke("phi3-mini-3.8b").replace(
        n_layers=1, dtype=jnp.float32, param_dtype=jnp.float32)
    tc = tsmoke("phi3-mini-3.8b").replace(
        n_layers=1, dtype=torch.float32, param_dtype=torch.float32)
    jp = jinit(jc, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    return jc, tc, jp, model, toks


def test_ravel_order_is_the_jax_package_s(phi3_one_layer):
    jc, tc, jp, model, _ = phi3_one_layer
    flat, _ = ravel_pytree(jp)
    rv = tnk.ravel(model)
    np.testing.assert_array_equal(rv.flat.numpy(), np.asarray(flat))
    back = rv.unravel(rv.flat)
    for name, p in model.named_parameters():
        assert torch.equal(back[name], p.detach())


def test_ggn_matvec_matches_jax_on_one_layer_phi3(phi3_one_layer):
    jc, tc, jp, model, toks = phi3_one_layer
    jmv, jflat, _ = jnk.make_ggn_matvec(
        lambda p, b: jforward(p, jc, b)[0], jp, {"tokens": jnp.asarray(toks)},
        1e-2)
    tmv, tflat, _ = tnk.make_ggn_matvec(
        lambda p, b: tforward(p, tc, b)[0], model,
        {"tokens": torch.from_numpy(toks)}, 1e-2)
    v = np.random.default_rng(2).standard_normal(jflat.shape).astype(
        np.float32)
    got = tmv(torch.from_numpy(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == jflat.shape
    assert rel(got, jmv(jnp.asarray(v))) <= 1e-5


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_ggn_matvec_refuses_remat(phi3_one_layer, remat):
    """``torch.func`` does not run through ``torch.utils.checkpoint``'s
    saved-tensor hooks (JAX's ``jax.checkpoint`` is transparent to
    ``jvp``): a Newton-Krylov step on a remat config raises at once, so it
    runs with ``remat="none"``, as the JAX package's own Newton-Krylov test
    does."""
    jc, tc, jp, model, toks = phi3_one_layer
    c = tc.replace(remat=remat)
    with pytest.raises(RuntimeError, match="saved tensor hooks"):
        tnk.make_ggn_matvec(lambda p, b: tforward(p, c, b)[0], model,
                            {"tokens": torch.from_numpy(toks)}, 1e-2)


def test_newton_krylov_step_lowers_the_loss_of_one_layer_phi3(
        phi3_one_layer):
    """The JAX package's model test (one step on the 1-layer smoke phi3,
    f32, the JAX test's settings) through the port: the loss falls and the
    module is updated in place.  Its numbers are not held to the JAX
    package's: both compute attention and RoPE in f32, so the GGN operator
    is linear only to f32 rounding, and p-BiCGSafe's recurrences carry each
    package's rounding apart (on this case the two inner solutions are
    2e-3 apart after 10 iterations, each several per cent from an f64
    solve); the f64 softmax regression above holds the step itself."""
    jc, tc, jp, model, toks = phi3_one_layer
    model = copy.deepcopy(model)
    kw = dict(damping=1e-2, inner_maxiter=10, inner_tol=1e-2, lr=0.5)
    tb = {"tokens": torch.from_numpy(toks)}
    before = tloss_fn(model, tc, tb)[0].item()
    out, tm = tnk.newton_krylov_step(
        lambda p, b: tloss_fn(p, tc, b)[0], lambda p, b: tforward(p, tc, b)[0],
        model, tb, tnk.NewtonKrylovConfig(**kw))
    assert out is model                          # a module: in place
    assert 0 < int(tm["inner_iters"]) <= 10
    assert float(tm["loss"]) == pytest.approx(before, rel=1e-6)
    after = tloss_fn(model, tc, tb)[0].item()
    assert after == pytest.approx(float(tm["new_loss"]), rel=1e-6)
    assert np.isfinite(after) and after < before
