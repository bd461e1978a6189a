"""The port's hybrid family (``repro_torch.models.ssm``, the hybrid
branches of ``models.transformer``, ``serve`` and ``convert``; zamba2)
held against the JAX package on the CPU.

The smoke zamba2 (4 Mamba2 layers, d 64, the shared block every 2nd layer,
a 64-token window) in fp32, with the JAX package's initial weights carried
over by ``lm_params_from_numpy`` and the norms, biases and the f32
``a_log`` / ``dt_bias`` / ``d_skip`` redrawn so that none is trivially 1 or
0.  Bars, relative to the reference's max-abs: 1e-5 for one Mamba2 layer,
its conv and single steps, 5e-5 for whole-model logits, caches and
gradients.  The decode runs past the window: its ring rolls on the device,
and C27 (``max_len`` under the window) is the reference's narrowing, which
the port's engine refuses.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.engine import DecodeProgram  # noqa: E402

ARCH = "zamba2-1.2b"
CPU = "cpu"
TOL_STEP = 1e-5        # one Mamba2 layer, its conv, one step (fp32)
TOL_MODEL = 5e-5       # whole-model logits, caches and gradients (fp32)
TOL_BF16 = 2e-2        # tests/test_torch_lm.py's bf16 bar

#: leaves redrawn around their initial value, and by how much
REDRAWN = {"ln": 0.3, "ln2": 0.3, "final_norm": 0.3, "norm": 0.3,
           "norm_in": 0.3, "a_log": 0.3, "dt_bias": 0.3, "d_skip": 0.3,
           "conv_b": 0.1}


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def rel(got, want) -> float:
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(dtype="f32", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jsmoke(ARCH).replace(dtype=jdt, param_dtype=jdt, **kw),
            smoke_config(ARCH).replace(dtype=tdt, param_dtype=tdt, **kw))


def numpy_params(jc, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        scale = REDRAWN.get(path[-1].key)
        if scale:
            a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(
        leaf, jax.jit(jtr.init_params, static_argnums=0)(
            jc, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def hybrid():
    """fp32 configs, the numpy tree, the JAX parameters and the port's
    model with the same weights."""
    jc, tc = configs()
    tree = numpy_params(jc)
    return jc, tc, tree, jax.tree_util.tree_map(jnp.asarray, tree), \
        lm_params_from_numpy(tc, tree, device=CPU)


@functools.lru_cache(maxsize=None)
def jitted(name: str, jc):
    fn = {"forward": lambda p, t: jtr.forward(p, jc, {"tokens": t})[0],
          "prefill": lambda p, t: jtr.prefill_step(p, jc, {"tokens": t}),
          "decode": lambda p, c, t, n: jtr.decode_step(p, jc, c, t, n),
          "mamba2": lambda p, x: jssm.mamba2_forward(p, x, jc,
                                                     return_state=True)}
    return jax.jit(fn[name])


def tokens(S, B=2, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def layer0(jparams):
    return jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])


def randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# -- configs and parameters ------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
def test_config_equals_the_jax_one(full):
    t = get_config(ARCH) if full else smoke_config(ARCH)
    j = jget(ARCH) if full else jsmoke(ARCH)
    skip = {"dtype", "param_dtype"}
    assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
            if f.name not in skip} == \
        {f.name: getattr(j, f.name) for f in dataclasses.fields(j)
         if f.name not in skip}
    assert t.family == "hybrid" and t.dtype == torch.bfloat16
    assert (t.n_ssm_heads, t.d_inner) == (j.n_ssm_heads, j.d_inner)


def test_init_mamba2_params_names_shapes_and_dtypes():
    """bf16 config: the JAX package's names and shapes, ``a_log``,
    ``dt_bias`` and ``d_skip`` in f32, the rest in bf16; the initial values
    of the constant leaves equal."""
    jc, tc = configs("bf16")
    consts = ("conv_b", "a_log", "dt_bias", "d_skip", "norm", "norm_in")

    def init(key):
        return jssm.init_mamba2_params(key, jc)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    want = jax.jit(lambda k: {n: init(k)[n] for n in consts})(
        jax.random.PRNGKey(0))
    got = tssm.init_mamba2_params(torch.Generator().manual_seed(0), tc)
    assert set(got) == set(shapes)
    for name, w in shapes.items():
        assert tuple(got[name].shape) == w.shape, name
        f32 = name in tssm.F32_LEAVES
        assert (w.dtype == jnp.float32) == f32, name
        assert got[name].dtype == (torch.float32 if f32 else torch.bfloat16)
    for name in consts:
        np.testing.assert_array_equal(np_(got[name]), np_(want[name]))


def test_lm_params_from_numpy_carries_every_leaf_and_round_trips(hybrid):
    jc, tc, tree, _, model = hybrid
    names = [k for k, _ in model.named_parameters()]
    back = ttr.params_tree(dict(model.named_parameters()))
    want = jax.tree_util.tree_leaves_with_path(tree)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat) == {path for path, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(np_(flat[path]), leaf)
    again = ttr.params_from_tree(back, names)
    assert all(torch.equal(again[n], p) for n, p in model.named_parameters())
    assert len(model.layers) == jc.n_layers
    assert {k for k, _ in model.shared_attn.named_parameters()} == {
        "ln", "ln2", "attn.p.wq", "attn.p.wk", "attn.p.wv", "attn.p.wo",
        "mlp.p.wi", "mlp.p.wg", "mlp.p.wo"}
    # bf16: the three f32 leaves stay f32
    _, tb = configs("bf16")
    mb = lm_params_from_numpy(tb, tree, device=CPU)
    for name, p in mb.layers[0].p.items():
        assert p.dtype == (torch.float32 if name in tssm.F32_LEAVES
                           else torch.bfloat16), name


# -- one Mamba2 layer --------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(hybrid, with_state):
    jc, tc, _, jparams, model = hybrid
    rng = np.random.default_rng(3)
    cd = jc.d_inner + 2 * jc.ssm_state
    xbc = randn(rng, (2, 9, cd))
    st = randn(rng, (2, jc.ssm_conv - 1, cd)) if with_state else None
    wout, wst = jssm._causal_conv(layer0(jparams), jnp.asarray(xbc), jc,
                                  None if st is None else jnp.asarray(st))
    gout, gst = tssm._causal_conv(model.layers[0].p, torch.from_numpy(xbc),
                                  tc, None if st is None
                                  else torch.from_numpy(st))
    assert rel(gout, wout) <= TOL_STEP
    assert rel(gst, wst) == 0.0


@pytest.mark.parametrize("S", [40, 512])
def test_mamba2_forward_matches_jax(hybrid, S):
    """S = 40: one chunk of 40 (not a multiple of 256); S = 512: two chunks
    of 256, the carry crossing once; output and final state."""
    jc, tc, _, jparams, model = hybrid
    x = randn(np.random.default_rng(S), (2, S, jc.d_model))
    wout, wst = jitted("mamba2", jc)(layer0(jparams), jnp.asarray(x))
    with torch.no_grad():
        gout, gst = model.layers[0](torch.from_numpy(x), tc,
                                    return_state=True)
    assert rel(gout, wout) <= TOL_STEP
    assert rel(gst["h"], wst["h"]) <= TOL_STEP
    assert rel(gst["conv"], wst["conv"]) <= TOL_STEP
    assert gst["h"].dtype == torch.float32


def test_mamba2_decode_matches_the_jax_step_and_the_forward(hybrid):
    """One step from a random state against the JAX step; then 40 steps
    from zeros, token by token, against the port's forward over the same
    40 inputs (each output, and the final state)."""
    jc, tc, _, jparams, model = hybrid
    rng = np.random.default_rng(5)
    layer = model.layers[0]
    H, P = jc.n_ssm_heads, jc.d_inner // jc.n_ssm_heads
    x1 = randn(rng, (2, 1, jc.d_model))
    st = {"h": randn(rng, (2, H, P, jc.ssm_state), 0.5),
          "conv": randn(rng, (2, jc.ssm_conv - 1,
                              jc.d_inner + 2 * jc.ssm_state))}
    wy, wst = jssm.mamba2_decode(layer0(jparams), jnp.asarray(x1),
                                 {k: jnp.asarray(v) for k, v in st.items()},
                                 jc)
    with torch.no_grad():
        gy, gst = layer.decode(torch.from_numpy(x1),
                               {k: torch.from_numpy(v) for k, v in st.items()},
                               tc)
    assert rel(gy, wy) <= TOL_STEP
    for key in ("h", "conv"):
        assert rel(gst[key], wst[key]) <= TOL_STEP

    x = torch.from_numpy(randn(rng, (2, 40, jc.d_model)))
    with torch.no_grad():
        want, fin = layer(x, tc, return_state=True)
        state = tssm.mamba2_init_state(tc, 2, tc.dtype, device=CPU)
        outs = []
        for t in range(40):
            y, state = layer.decode(x[:, t:t + 1], state, tc)
            outs.append(y)
    assert rel(torch.cat(outs, 1), want) <= TOL_STEP
    assert rel(state["h"], fin["h"]) <= TOL_STEP
    assert rel(state["conv"], fin["conv"]) <= TOL_STEP


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 70, 512])
def test_forward_and_prefill_match_jax(hybrid, S):
    """40: inside the window; 70: past it (the prefill's K/V cut to the
    last 64 rows); 512: two SSD chunks.  Logits of both entry points, the
    cache's keys, shapes and values."""
    jc, tc, _, jparams, model = hybrid
    toks = tokens(S, seed=S)
    wf = jitted("forward", jc)(jparams, jnp.asarray(toks))
    wl, wcache = jitted("prefill", jc)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        gf, aux = ttr.forward(model, tc, {"tokens": torch.from_numpy(toks)})
        gl, gcache = ttr.prefill_step(model, tc,
                                      {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    assert rel(gf, wf) <= TOL_MODEL and rel(gl, wl) <= TOL_MODEL
    W, npts = min(S, jc.sliding_window), 2
    H, P = jc.n_ssm_heads, jc.d_inner // jc.n_ssm_heads
    shapes = {"ssm_h": (4, 2, H, P, jc.ssm_state),
              "ssm_conv": (4, 2, 3, jc.d_inner + 2 * jc.ssm_state),
              "attn_k": (npts, 2, W, jc.n_kv_heads, jc.hd),
              "attn_v": (npts, 2, W, jc.n_kv_heads, jc.hd)}
    assert {k: tuple(v.shape) for k, v in gcache.items()} == shapes
    for key in shapes:
        assert rel(gcache[key], wcache[key]) <= TOL_MODEL, key


@pytest.fixture(scope="module")
def bf16_hybrid():
    """The fp32 weights rounded to bf16 (the f32 leaves kept): the bf16 and
    fp32 configs, the JAX bf16 and fp32 parameters and the port's bf16
    model, all holding the same numbers."""
    jc, tc = configs("bf16")
    jc32, _ = configs()

    def bf16(path, a):
        if path[-1].key in tssm.F32_LEAVES:
            return a
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    tree = jax.tree_util.tree_map_with_path(bf16, numpy_params(jc32))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if path[-1].key in
                                    tssm.F32_LEAVES else jnp.bfloat16), tree)
    return dict(jc=jc, tc=tc, tree=tree, jp=jp, jc32=jc32,
                jp32=jax.tree_util.tree_map(jnp.asarray, tree),
                model=lm_params_from_numpy(tc, tree, device=CPU))


def test_bf16_keeps_the_jax_numbers(bf16_hybrid):
    """bf16 weights and activations, the f32 leaves f32, the weights
    bf16-exact in both packages: one Mamba2 layer at S = 512 within the bf16
    bar of the JAX package's; the whole model's logits (70 tokens) no
    further from the fp32 forward than twice the JAX package's bf16 logits
    are (four layers of bf16 rounding: the JAX package's own bf16 logits
    are 3% of their max-abs off its fp32 ones)."""
    b = bf16_hybrid
    jc, tc, model = b["jc"], b["tc"], b["model"]
    x = jnp.asarray(randn(np.random.default_rng(8), (2, 512, jc.d_model)),
                    jnp.bfloat16)
    want = jitted("mamba2", jc)(layer0(b["jp"]), x)[0]
    with torch.no_grad():
        got = model.layers[0](torch.from_numpy(np_(x).astype(np.float32))
                              .bfloat16(), tc)
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= TOL_BF16
    toks = jnp.asarray(tokens(70, seed=9))
    want = jitted("forward", jc)(b["jp"], toks)
    fp32 = jitted("forward", b["jc32"])(b["jp32"], toks)
    with torch.no_grad():
        got = ttr.forward(model, tc, {"tokens": torch.from_numpy(
            np.array(toks))})[0]
    assert rel(got, fp32) <= 2 * rel(want, fp32)


def splice(model, cfg, pcache, batch, max_len, plen):
    """The cache of a decode program of ``max_len`` with a prefill cache
    spliced in (the engine's splice)."""
    prog = DecodeProgram(model, cfg, batch, max_len, CPU)
    prog.start(pcache, torch.zeros(batch, dtype=torch.int64), plen,
               graphed=False)
    return prog.cache


def jsplice(jc, pcache, batch, max_len):
    target = jtr.init_cache(jc, batch, max_len)
    return {k: jnp.pad(pcache[k], [(0, d - s) for d, s in
                                   zip(target[k].shape, pcache[k].shape)])
            for k in target}


def decode_both(hybrid, S, max_len, steps, as_tensor=True, seed=1):
    """A prefill of S tokens, then ``steps`` decode steps through both
    packages, each fed the JAX step's greedy tokens.  Returns the per-step
    relative errors of the logits, the JAX and the port's logits, the fed
    tokens and both final caches."""
    jc, tc, _, jparams, model = hybrid
    toks = tokens(S, seed=seed)
    wl, wc = jitted("prefill", jc)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        _, gc = ttr.prefill_step(model, tc, {"tokens": torch.from_numpy(toks)})
    cache = splice(model, tc, gc, 2, max_len, S)
    jcache = jsplice(jc, wc, 2, max_len)
    nxt = np.argmax(np_(wl)[:, -1], axis=-1).astype(np.int32)[:, None]
    errs, wlogs, glogs, fed = [], [], [], [nxt]
    for step in range(steps):
        n = S + step
        with torch.no_grad():
            glog, out = ttr.decode_step(
                model, tc, cache, torch.from_numpy(nxt),
                torch.tensor(n) if as_tensor else n)
        assert out is cache
        wlog, jcache = jitted("decode", jc)(jparams, jcache, jnp.asarray(nxt),
                                            jnp.asarray(n, jnp.int32))
        errs.append(rel(glog, wlog))
        wlogs.append(np_(wlog)[:, 0])
        glogs.append(np_(glog)[:, 0])
        nxt = np.argmax(np_(wlog)[:, 0], axis=-1).astype(np.int32)[:, None]
        fed.append(nxt)
    return dict(errs=errs, wlogs=np.stack(wlogs, 1), glogs=np.stack(glogs, 1),
                toks=toks, fed=np.concatenate(fed, 1), cache=cache,
                jcache=jcache)


@pytest.mark.parametrize("S,as_tensor", [(40, True), (40, False),
                                         (70, True)])
def test_decode_steps_past_the_window_match_the_jitted_jax_step(
        hybrid, S, as_tensor):
    """40 steps at ``max_len`` 256 (a 64-row ring): from a 40-token prompt
    the ring fills at cache_len 64 and then rolls each step; after a
    70-token prompt it rolls from the first step.  ``cache_len`` a 0-d
    tensor or an int; logits after every step, the caches at the end."""
    run = decode_both(hybrid, S, 256, 40, as_tensor=as_tensor)
    assert max(run["errs"]) <= TOL_MODEL
    for key in run["cache"]:
        assert rel(run["cache"][key], run["jcache"][key]) <= TOL_MODEL, key
    assert run["cache"]["attn_k"].shape[2] == 64


def test_decode_matches_the_teacher_forced_forward(hybrid):
    """The port alone: 40 decode steps after a 40-token prompt (the ring
    rolls from cache_len 64) against ``forward`` over the prompt and the
    fed tokens, at those positions."""
    jc, tc, _, _, model = hybrid
    run = decode_both(hybrid, 40, 256, 40, seed=4)
    seq = np.concatenate([run["toks"], run["fed"][:, :-1]], 1)
    with torch.no_grad():
        logits = ttr.forward(model, tc, {"tokens": torch.from_numpy(seq)})[0]
    assert rel(run["glogs"], np_(logits)[:, 40:]) <= TOL_MODEL


def jax_steps(jc, jparams, toks, fed, max_len):
    """The JAX package's prefill of ``toks``, then one jitted step for each
    column of ``fed`` but the last: the steps' logits, (B, steps, V)."""
    wl, wc = jitted("prefill", jc)(jparams, jnp.asarray(toks))
    B, S = toks.shape
    jcache = jsplice(jc, wc, B, max_len)
    logs = []
    for step in range(fed.shape[1] - 1):
        wlog, jcache = jitted("decode", jc)(
            jparams, jcache, jnp.asarray(fed[:, step:step + 1]),
            jnp.asarray(S + step, jnp.int32))
        logs.append(np_(wlog)[:, 0])
    return np.stack(logs, 1)


def test_bf16_decode_past_the_window_keeps_the_jax_numbers(bf16_hybrid):
    """bf16: 40 steps after a 40-token prompt at ``max_len`` 256 (the ring
    rolls from cache_len 64), the port's step and the jitted JAX bf16 step
    fed the same tokens; the port's logits no further from the JAX fp32
    step's (fed those tokens too) than twice the JAX bf16 step's are, the
    bar the JAX package's own bf16-vs-fp32 decode distance sets.  The SSM
    state stays f32, the conv state and the rings bf16, in both."""
    b = bf16_hybrid
    run = decode_both((b["jc"], b["tc"], b["tree"], b["jp"], b["model"]),
                      40, 256, 40, seed=4)
    fp32 = jax_steps(b["jc32"], b["jp32"], run["toks"], run["fed"], 256)
    assert rel(run["glogs"], fp32) <= 2 * rel(run["wlogs"], fp32)
    for key, t in run["cache"].items():
        want = "float32" if key == "ssm_h" else "bfloat16"
        assert str(t.dtype) == f"torch.{want}", key
        assert run["jcache"][key].dtype == jnp.dtype(want), key
    assert run["cache"]["attn_k"].shape[2] == 64


def test_c27_a_ring_under_the_window_narrows_attention_and_is_refused(hybrid):
    """ROADMAP C27: ``max_len`` 48 under the 64-token window gives a
    48-row ring.  The port's ``decode_step`` equals the JAX step's; both
    equal the forward while ``cache_len`` < 48 and leave it from 48 on
    (attention narrowed to 48 tokens); the port's engine refuses such a
    batch before its prefill."""
    jc, tc, _, _, model = hybrid
    run = decode_both(hybrid, 40, 48, 16, seed=6)
    assert max(run["errs"]) <= TOL_MODEL
    seq = np.concatenate([run["toks"], run["fed"][:, :-1]], 1)
    with torch.no_grad():
        fwd = np_(ttr.forward(model, tc, {"tokens": torch.from_numpy(seq)})[0])
    fwd = fwd[:, 40:]
    scale = np.abs(fwd).max()
    inside = np.abs(run["wlogs"][:, :8] - fwd[:, :8]).max() / scale
    past = np.abs(run["wlogs"][:, 8:] - fwd[:, 8:]).max(axis=(0, 2)) / scale
    assert inside <= TOL_MODEL
    assert past.min() > 100 * TOL_MODEL            # every step from 48 on
    eng = ServingEngine(tc, ServeConfig(max_batch=2, max_len=48),
                        params=model, device=CPU)
    eng.submit(Request(prompt=list(map(int, run["toks"][0])),
                       max_new_tokens=16))
    with pytest.raises(ValueError, match="C27"):
        eng.run()
    assert eng.stats["prefill_s"] == []


def test_engine_gives_the_jax_engines_tokens_past_the_window(hybrid):
    """Both engines at ``max_len`` 256 (ring 64): a batch of two 40-token
    prompts and one of two 70-token prompts, 40 new tokens each, the same
    greedy tokens; the port's second batch reuses the first's program."""
    jc, tc, _, jparams, model = hybrid
    jeng = JServingEngine(jc, JServeConfig(max_batch=2, max_len=256),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=2, max_len=256),
                         params=model, device=CPU)
    for S, seed in ((40, 11), (70, 12)):
        for row in tokens(S, seed=seed):
            jeng.submit(JRequest(prompt=list(map(int, row)),
                                 max_new_tokens=40))
            teng.submit(Request(prompt=list(map(int, row)),
                                max_new_tokens=40))
    want = [r.output for r in jeng.run()]
    got = [r.output for r in teng.run()]
    assert got == want and all(len(o) == 40 for o in got)
    assert list(teng.programs) == [2]
    assert len(teng.stats["decode_s"]) == 2 * 39


@pytest.mark.parametrize("plen,max_len,new,ok", [
    (40, 64, 40, True),     # max_len = window: decodes without bound
    (70, 64, 40, True),     # a prompt past the window
    (40, 48, 9, True),      # 48 rows needed, 48 held
    (40, 48, 10, False),    # 49 needed (C27)
])
def test_engine_refuses_only_a_ring_that_would_narrow(hybrid, plen, max_len,
                                                      new, ok):
    _, tc, _, _, model = hybrid
    eng = ServingEngine(tc, ServeConfig(max_batch=1, max_len=max_len),
                        params=model, device=CPU)
    eng.submit(Request(prompt=list(map(int, tokens(plen, B=1)[0])),
                       max_new_tokens=new))
    if ok:
        assert len(eng.run()[0].output) == new
    else:
        with pytest.raises(ValueError,
                           match="need 49 cache rows; max_len is 48"):
            eng.run()


# -- training ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads(hybrid):
    jc, _, _, jparams, _ = hybrid
    toks = tokens(40, seed=13)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                           static_argnums=1)(
        jparams, jc, {"tokens": jnp.asarray(toks)})
    return toks, jl, jm, jg


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_jax(hybrid, jax_grads, remat):
    _, tc, tree, _, _ = hybrid
    toks, jl, jm, jg = jax_grads
    tc = tc.replace(remat=remat)
    model = lm_params_from_numpy(tc, tree, device=CPU)
    tl, tm = ttr.loss_fn(model, tc, {"tokens": torch.from_numpy(toks)})
    assert rel(tl, jl) <= TOL_MODEL
    assert set(tm) == set(jm) and float(tm["aux_loss"]) == 0.0
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in model.named_parameters()])
    flat = dict(jax.tree_util.tree_leaves_with_path(
        ttr.params_tree(dict(zip(names, grads)))))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        assert rel(flat[path], leaf) <= TOL_MODEL, path


# -- the launcher ------------------------------------------------------------------

def test_launch_serve_runs_zamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--requests", "3", "--prompt-len", "8",
                       "--max-new", "3", "--device", "cpu"])
    assert [len(r.output) for r in done] == [3, 3, 3]
    assert "3 requests, 9 tokens" in capsys.readouterr().out
