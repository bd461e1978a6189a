"""The port's SSM family (``repro_torch.models.xlstm``, the SSM branches of
``models.transformer``, ``serve`` and ``convert``; xlstm-350m) held against
the JAX package on the CPU.

The smoke xlstm (4 layers, so 2 sLSTM + mLSTM pairs, d 64, 2 heads, vocab
256) in fp32, with the JAX package's initial weights carried over by
``lm_params_from_numpy`` and the norms, the mLSTM's ``b_if`` and the
sLSTM's ``bias`` redrawn so that none is trivially 1 or 0.  Bars, relative
to the reference's max-abs: 1e-5 for one block or one step, 5e-5 for
whole-model logits, caches and gradients, 2e-2 in bf16.  The decode state
has no sequence axis, so the engine serves a batch past ``max_len``, as
the JAX engine does.
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
from repro.models import transformer as jtr  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.engine import DecodeProgram  # noqa: E402

ARCH = "xlstm-350m"
CPU = "cpu"
TOL_STEP = 1e-5        # one block, one step (fp32)
TOL_MODEL = 5e-5       # whole-model logits, caches and gradients (fp32)
TOL_BF16 = 2e-2        # tests/test_torch_lm.py's bf16 bar

#: leaves redrawn around their initial value, and by how much
REDRAWN = {"final_norm": 0.3, "norm": 0.3, "norm_in": 0.3, "b_if": 0.5,
           "bias": 0.3}
#: the cache's entries, in the JAX package's order
ENTRIES = ("s_c", "s_n", "s_h", "s_m", "m_c", "m_n", "m_m")


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
def xlstm():
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
          "mlstm": lambda p, x: jx.mlstm_forward(p, x, jc,
                                                 return_state=True),
          "slstm": lambda p, x: jx.slstm_forward(p, x, jc,
                                                 return_state=True),
          "mlstm_decode": lambda p, x, s: jx.mlstm_decode(p, x, s, jc),
          "slstm_decode": lambda p, x, s: jx.slstm_decode(p, x, s, jc)}
    return jax.jit(fn[name])


def tokens(S, B=2, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def pair_params(jparams, kind, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], jparams["layers"][kind])


def randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


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
    assert t.family == "ssm" and t.dtype == t.param_dtype == torch.bfloat16


def test_init_params_names_shapes_and_dtypes():
    """bf16: the JAX package's tree, leaf by leaf, in shape and dtype (every
    leaf bf16), the pairs stacked; the constant leaves' values equal; the
    full config's 442,283,104 parameters."""
    jc, tc = configs("bf16")
    shapes = jax.eval_shape(lambda k: jtr.init_params(jc, k),
                            jax.random.PRNGKey(0))
    model = ttr.init_params(tc, torch.Generator().manual_seed(0))
    assert len(model.layers) == 2
    got = dict(jax.tree_util.tree_leaves_with_path(
        ttr.params_tree(dict(model.named_parameters()))))
    want = dict(jax.tree_util.tree_leaves_with_path(shapes))
    assert set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert w.dtype == jnp.bfloat16 and got[path].dtype == torch.bfloat16
    consts = jax.jit(lambda k: {
        kind: {n: jtr.init_params(jc, k)["layers"][kind][n] for n in names}
        for kind, names in (("slstm", ("bias", "norm", "norm_in")),
                            ("mlstm", ("b_if", "norm", "norm_in")))})(
        jax.random.PRNGKey(0))
    for kind, leaves in consts.items():
        for name, w in leaves.items():
            t = torch.stack([getattr(p, kind).p[name] for p in model.layers])
            np.testing.assert_array_equal(np_(t), np_(w))
    full = jax.eval_shape(lambda k: jtr.init_params(jget(ARCH), k),
                          jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(full)) == 442_283_104


def test_init_slstm_w_r_is_drawn_at_its_head_fan_in():
    """``w_r`` is drawn at ``fan_in = hd`` (scale hd ** -0.5), ``w_down``
    at ``ff // 2``, as the reference's: the draws' standard deviations."""
    cfg = get_config(ARCH).replace(dtype=torch.float32,
                                   param_dtype=torch.float32)
    p = tx.init_slstm_params(torch.Generator().manual_seed(0), cfg)
    hd = cfg.d_model // cfg.n_heads
    assert abs(float(p["w_r"].std()) * hd ** 0.5 - 1) < 0.01
    ff = p["w_up"].shape[1]
    assert ff == int(1024 * 4 / 3 / 64) * 64 * 2 == 2688
    assert abs(float(p["w_down"].std()) * (ff // 2) ** 0.5 - 1) < 0.01


def test_lm_params_from_numpy_carries_every_leaf_and_round_trips(xlstm):
    jc, tc, tree, _, model = xlstm
    names = [k for k, _ in model.named_parameters()]
    assert "layers.1.slstm.p.w_r" in names and "layers.0.mlstm.p.b_if" in names
    assert ttr.param_path("layers.1.slstm.p.w_x") == (
        ("layers", "slstm", "w_x"), 1)
    back = ttr.params_tree(dict(model.named_parameters()))
    want = jax.tree_util.tree_leaves_with_path(tree)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat) == {path for path, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(np_(flat[path]), leaf)
    again = ttr.params_from_tree(back, names)
    assert all(torch.equal(again[n], p) for n, p in model.named_parameters())
    with pytest.raises(ValueError, match="the tree has 2 layers, the config 3"):
        lm_params_from_numpy(tc.replace(n_layers=6), tree, device=CPU)


# -- one mLSTM and one sLSTM block -------------------------------------------------

@pytest.mark.parametrize("S", [40, 512])
def test_mlstm_forward_and_its_state_match_jax(xlstm, S):
    """S = 40: one chunk of 40 (not a multiple of 256); S = 512: two chunks
    of 256, the stabilised carry crossing once."""
    jc, tc, _, jparams, model = xlstm
    x = randn(np.random.default_rng(S), (2, S, jc.d_model))
    wout, wst = jitted("mlstm", jc)(pair_params(jparams, "mlstm", 1),
                                    jnp.asarray(x))
    with torch.no_grad():
        gout, gst = model.layers[1].mlstm(t_(x), tc, return_state=True)
    assert rel(gout, wout) <= TOL_STEP
    for key in ("c", "n", "m"):
        assert rel(gst[key], wst[key]) <= TOL_STEP, key
        assert gst[key].dtype == torch.float32


def test_slstm_forward_and_its_state_match_jax(xlstm):
    jc, tc, _, jparams, model = xlstm
    x = randn(np.random.default_rng(7), (2, 70, jc.d_model))
    wout, wst = jitted("slstm", jc)(pair_params(jparams, "slstm", 1),
                                    jnp.asarray(x))
    with torch.no_grad():
        gout, gst = model.layers[1].slstm(t_(x), tc, return_state=True)
    assert rel(gout, wout) <= TOL_STEP
    for key in ("c", "n", "h", "m"):
        assert rel(gst[key], wst[key]) <= TOL_STEP, key


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_the_jax_steps_and_the_forward(xlstm, kind):
    """Eight steps from the initial state (stabilisers at -1e30), each fed
    the JAX step's state, against the JAX step (output and state within
    1e-5); then the port's own 40 steps against its forward over the same
    40 inputs (each output and the final state)."""
    jc, tc, _, jparams, model = xlstm
    block = getattr(model.layers[0], kind)
    jp = pair_params(jparams, kind)
    init = {"mlstm": (jx.mlstm_init_state, tx.mlstm_init_state),
            "slstm": (jx.slstm_init_state, tx.slstm_init_state)}[kind]
    rng = np.random.default_rng(11)
    jst = init[0](jc, 2)
    for _ in range(8):
        x1 = randn(rng, (2, 1, jc.d_model))
        wy, wst = jitted(f"{kind}_decode", jc)(jp, jnp.asarray(x1), jst)
        with torch.no_grad():
            gy, gst = block.decode(t_(x1), {k: t_(v) for k, v in jst.items()},
                                   tc)
        assert rel(gy, wy) <= TOL_STEP
        assert set(gst) == set(wst)
        for key in wst:
            assert rel(gst[key], wst[key]) <= TOL_STEP, key
        jst = wst
    x = t_(randn(rng, (2, 40, jc.d_model)))
    with torch.no_grad():
        want, fin = block(x, tc, return_state=True)
        state = init[1](tc, 2, device=CPU)
        outs = []
        for t in range(40):
            y, state = block.decode(x[:, t:t + 1], state, tc)
            outs.append(y)
    assert rel(torch.cat(outs, 1), want) <= TOL_STEP
    for key in fin:
        assert rel(state[key], fin[key]) <= TOL_STEP, key


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 512])
def test_forward_and_prefill_match_jax(xlstm, S):
    """40: one mLSTM chunk; 512: two.  Logits of both entry points, and the
    prefill's seven cache entries: keys, shapes, f32 and values."""
    jc, tc, _, jparams, model = xlstm
    toks = tokens(S, seed=S)
    wf = jitted("forward", jc)(jparams, jnp.asarray(toks))
    wl, wcache = jitted("prefill", jc)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        gf, aux = ttr.forward(model, tc, {"tokens": torch.from_numpy(toks)})
        gl, gcache = ttr.prefill_step(model, tc,
                                      {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    assert rel(gf, wf) <= TOL_MODEL and rel(gl, wl) <= TOL_MODEL
    assert tuple(gcache) == ttr.XLSTM_STATE == ENTRIES
    init = ttr.init_cache(tc, 2, S, device=CPU)
    for key in ENTRIES:
        assert gcache[key].shape == wcache[key].shape == init[key].shape, key
        assert gcache[key].dtype == torch.float32, key
        assert rel(gcache[key], wcache[key]) <= TOL_MODEL, key


def test_init_cache_is_the_jax_one(xlstm):
    """The zero state of both packages, whatever ``max_len`` (the
    stabilisers -1e30), and the state entries the engine splices whole."""
    jc, tc, _, _, _ = xlstm
    want = jtr.init_cache(jc, 3, 17)
    got = ttr.init_cache(tc, 3, 999, device=CPU)
    assert list(got) == list(ENTRIES) and set(want) == set(got)
    for key in got:
        np.testing.assert_array_equal(np_(got[key]), np_(want[key]))
    assert ttr.state_entries(tc) == ENTRIES
    assert ttr.cache_rows(tc, 10 ** 6) == 0


def jsplice(jc, pcache, batch, max_len):
    target = jtr.init_cache(jc, batch, max_len)
    return {k: jnp.pad(pcache[k], [(0, d - s) for d, s in
                                   zip(target[k].shape, pcache[k].shape)])
            for k in target}


def decode_both(run_args, S, steps, as_tensor=True, seed=1, max_len=16):
    """A prefill of S tokens spliced into a decode program of ``max_len``
    (shorter than the prompt: the state holds no rows), then ``steps``
    decode steps through both packages, each fed the JAX step's greedy
    tokens.  Returns the per-step relative errors of the logits, both
    packages' logits, the fed tokens and both final caches."""
    jc, tc, _, jparams, model = run_args
    toks = tokens(S, seed=seed)
    wl, wc = jitted("prefill", jc)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        _, gc = ttr.prefill_step(model, tc, {"tokens": torch.from_numpy(toks)})
    prog = DecodeProgram(model, tc, 2, max_len, CPU)
    prog.start(gc, torch.zeros(2, dtype=torch.int64), S, graphed=False)
    cache = prog.cache
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
                                         (256, True)])
def test_decode_steps_match_the_jitted_jax_step(xlstm, S, as_tensor):
    """20 steps after a prompt of 40 tokens (one mLSTM chunk of 40) or 256
    (one of 256), ``cache_len`` a 0-d tensor or an int: logits after every
    step, every cache entry at the end, written in place."""
    run = decode_both(xlstm, S, 20, as_tensor=as_tensor)
    assert max(run["errs"]) <= TOL_MODEL
    assert set(run["cache"]) == set(run["jcache"])
    for key in run["cache"]:
        assert rel(run["cache"][key], run["jcache"][key]) <= TOL_MODEL, key


def test_decode_matches_the_teacher_forced_forward(xlstm):
    """The port alone: 40 decode steps after a 40-token prompt against
    ``forward`` over the prompt and the fed tokens, at those positions."""
    jc, tc, _, _, model = xlstm
    run = decode_both(xlstm, 40, 40, seed=4)
    seq = np.concatenate([run["toks"], run["fed"][:, :-1]], 1)
    with torch.no_grad():
        logits = ttr.forward(model, tc, {"tokens": torch.from_numpy(seq)})[0]
    assert rel(run["glogs"], np_(logits)[:, 40:]) <= TOL_MODEL


@pytest.fixture(scope="module")
def bf16_xlstm():
    """The fp32 weights rounded to bf16: the bf16 and fp32 configs, the JAX
    bf16 and fp32 parameters and the port's bf16 model, all holding the
    same numbers."""
    jc, tc = configs("bf16")
    jc32, _ = configs()
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)),
        numpy_params(jc32))
    return dict(jc=jc, tc=tc, tree=tree, jc32=jc32,
                jp=jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.bfloat16), tree),
                jp32=jax.tree_util.tree_map(jnp.asarray, tree),
                model=lm_params_from_numpy(tc, tree, device=CPU))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_block_keeps_the_jax_numbers(bf16_xlstm, kind):
    """One bf16 block at S = 512 (two mLSTM chunks) within the bf16 bar of
    the JAX package's, its state f32 in both."""
    b = bf16_xlstm
    jc, tc, model = b["jc"], b["tc"], b["model"]
    x = jnp.asarray(randn(np.random.default_rng(8), (2, 512, jc.d_model)),
                    jnp.bfloat16)
    want, wst = jitted(kind, jc)(pair_params(b["jp"], kind), x)
    with torch.no_grad():
        got, gst = getattr(model.layers[0], kind)(
            t_(np_(x)).bfloat16(), tc, return_state=True)
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= TOL_BF16
    for key in wst:
        assert gst[key].dtype == torch.float32
        assert wst[key].dtype == jnp.float32
        assert rel(gst[key], wst[key]) <= TOL_BF16, key


def test_bf16_logits_keep_the_jax_numbers(bf16_xlstm):
    """bf16 weights and activations: the whole model's logits (40 tokens,
    one mLSTM chunk) no further from the fp32 forward than
    twice the JAX package's bf16 logits are (four blocks of bf16 rounding
    through the exponential gates: the JAX package's own bf16 logits are
    12-18% of their max-abs off its fp32 ones, so the blocks alone are held
    to the 2e-2 bar); then 8 decode steps, fed the same tokens, no further
    from the JAX fp32 steps than twice the JAX bf16 steps are."""
    b = bf16_xlstm
    jc, tc, model = b["jc"], b["tc"], b["model"]
    toks = jnp.asarray(tokens(40, seed=9))
    want = jitted("forward", jc)(b["jp"], toks)
    fp32 = jitted("forward", b["jc32"])(b["jp32"], toks)
    with torch.no_grad():
        got = ttr.forward(model, tc, {"tokens": torch.from_numpy(
            np.array(toks))})[0]
    assert got.dtype == torch.bfloat16
    assert rel(got, fp32) <= 2 * rel(want, fp32)
    run = decode_both((jc, tc, b["tree"], b["jp"], model), 40, 8, seed=4)
    wl, wc = jitted("prefill", b["jc32"])(b["jp32"], jnp.asarray(run["toks"]))
    jcache = jsplice(b["jc32"], wc, 2, 16)
    logs = []
    for step in range(8):
        wlog, jcache = jitted("decode", b["jc32"])(
            b["jp32"], jcache, jnp.asarray(run["fed"][:, step:step + 1]),
            jnp.asarray(40 + step, jnp.int32))
        logs.append(np_(wlog)[:, 0])
    ref = np.stack(logs, 1)
    assert rel(run["glogs"], ref) <= 2 * rel(run["wlogs"], ref)
    for key, t in run["cache"].items():
        assert t.dtype == torch.float32 and run["jcache"][key].dtype == \
            jnp.float32, key


# -- the engine --------------------------------------------------------------------

def test_engine_gives_the_jax_engines_tokens_past_max_len(xlstm):
    """Both engines at ``max_len`` 24: a batch of two 12-token prompts, 8
    new tokens each (inside), then one of two 30-token prompts, 20 new
    tokens each: 49 positions, twice ``max_len``, which a state with no
    rows serves exactly and the port's engine does not refuse.  The same
    greedy tokens; the second batch reuses the first's program."""
    jc, tc, _, jparams, model = xlstm
    jeng = JServingEngine(jc, JServeConfig(max_batch=2, max_len=24),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=2, max_len=24),
                         params=model, device=CPU)
    for S, new, seed in ((12, 8, 11), (30, 20, 12)):
        for row in tokens(S, seed=seed):
            jeng.submit(JRequest(prompt=list(map(int, row)),
                                 max_new_tokens=new))
            teng.submit(Request(prompt=list(map(int, row)),
                                max_new_tokens=new))
    want = [r.output for r in jeng.run()]
    got = [r.output for r in teng.run()]
    assert got == want
    assert [len(o) for o in got] == [8, 8, 20, 20]
    assert list(teng.programs) == [2]
    assert len(teng.stats["decode_s"]) == 7 + 19
    assert teng.stats["decode_program"].startswith("eager: ")


def test_the_capture_warm_up_puts_the_state_back(xlstm, monkeypatch):
    """The decode program's warm-up (the step before a capture) advances
    every state entry; the program puts them back, so the first replay
    decodes from the prefill's state.  Here the capture is a stand-in that
    runs the warm-up, then the step: the state after the warm-up equals
    the spliced one bitwise, and the first step's logits and tokens equal
    an unwarmed program's."""
    from repro_torch.core import program as _program
    jc, tc, _, _, model = xlstm
    toks = torch.from_numpy(tokens(20, seed=5))
    with torch.no_grad():
        logits, pcache = ttr.prefill_step(model, tc, {"tokens": toks})
    first = logits[:, -1].argmax(-1)
    progs = [DecodeProgram(model, tc, 2, 8, CPU) for _ in range(2)]
    for prog in progs:
        prog.start(pcache, first, 20, graphed=False)
    spliced = {k: t.clone() for k, t in progs[0].cache.items()}
    seen = {}

    def capture(label, device, pool, warm_up, body):
        warm_up()
        seen.update({k: torch.equal(t, spliced[k])
                     for k, t in progs[0].cache.items()})
        body()
        return None, {}, 0, 0

    monkeypatch.setattr(_program, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with torch.no_grad():
        progs[0].capture()
        progs[1].step()
    assert seen == dict.fromkeys(ENTRIES, True)
    assert not torch.equal(progs[0].cache["m_c"], spliced["m_c"])
    assert torch.equal(progs[0].logits, progs[1].logits)
    assert torch.equal(progs[0].tokens, progs[1].tokens)
    for key in ENTRIES:
        assert torch.equal(progs[0].cache[key], progs[1].cache[key]), key


# -- training ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads(xlstm):
    jc, _, _, jparams, _ = xlstm
    toks = tokens(40, seed=13)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                           static_argnums=1)(
        jparams, jc, {"tokens": jnp.asarray(toks)})
    return toks, jl, jm, jg


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_jax(xlstm, jax_grads, remat):
    _, tc, tree, _, _ = xlstm
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

def test_launch_serve_runs_xlstm_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--requests", "3", "--prompt-len", "8",
                       "--max-new", "3", "--device", "cpu"])
    assert [len(r.output) for r in done] == [3, 3, 3]
    assert "3 requests, 9 tokens" in capsys.readouterr().out
