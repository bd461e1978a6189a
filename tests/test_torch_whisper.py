"""The port's audio family (whisper: ``layer_norm``, ``gelu_ffn``,
``sinusoidal_positions``, cross-attention, the audio branches of
``models.transformer``, ``serve`` and ``convert``) held against the JAX
package on the CPU.

The smoke whisper (2 encoder and 2 decoder layers, d 64, 4 heads, vocab
256, the 32,768-row learned position table) in fp32, with the JAX
package's initial weights carried over by ``lm_params_from_numpy`` and the
LayerNorms, the final norm and the MLP biases redrawn so that none is
trivially 1 or 0.  Bars, relative to the reference's max-abs: 1e-6 for the
norms, the MLP and the sinusoids, 1e-5 for attention and for whole-model
logits and caches.  Whisper's decode rotates q and the new k with RoPE and
its prefill does not (ROADMAP C29), so a decode step is held to the JAX
step, not to ``forward``; 1,500 frames are refused by both packages (C30).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.engine import DecodeProgram  # noqa: E402

ARCH = "whisper-tiny"
CPU = "cpu"
TOL_OP = 1e-6          # layer_norm, gelu_ffn, the sinusoids (fp32)
TOL_MODEL = 1e-5       # attention, whole-model logits and caches (fp32)
PARAMS = 49_046_016    # whisper-tiny's count in the JAX package

#: leaves redrawn around their initial value, and by how much
REDRAWN = {"ln1_s": 0.3, "ln1_b": 0.3, "lnx_s": 0.3, "lnx_b": 0.3,
           "ln2_s": 0.3, "ln2_b": 0.3, "enc_final_s": 0.3,
           "enc_final_b": 0.3, "final_norm": 0.3, "bi": 0.1, "bo": 0.1}
#: the cache's entries
ENTRIES = ("k", "v", "cross_k", "cross_v")


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def rel(got, want) -> float:
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def configs(**kw):
    return (jsmoke(ARCH).replace(dtype=jnp.float32, param_dtype=jnp.float32,
                                 **kw),
            smoke_config(ARCH).replace(dtype=torch.float32,
                                       param_dtype=torch.float32, **kw))


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
def whisper():
    """fp32 configs, the numpy tree, the JAX parameters and the port's
    model with the same weights."""
    jc, tc = configs()
    tree = numpy_params(jc)
    return jc, tc, tree, jax.tree_util.tree_map(jnp.asarray, tree), \
        lm_params_from_numpy(tc, tree, device=CPU)


@functools.lru_cache(maxsize=None)
def jitted(name: str, jc):
    fn = {"forward": lambda p, b: jtr.forward(p, jc, b)[0],
          "loss": lambda p, b: jtr.loss_fn(p, jc, b),
          "prefill": lambda p, b: jtr.prefill_step(p, jc, b),
          "decode": lambda p, c, t, n: jtr.decode_step(p, jc, c, t, n)}
    return jax.jit(fn[name])


def batch(S, T, B=2, seed=0, vocab=256, d=64):
    """Tokens (B, S) and frames (B, T, d) from a numpy seed, as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, vocab, (B, S)).astype(np.int32),
            "frames": rng.standard_normal((B, T, d)).astype(np.float32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


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
    assert t.family == "audio" and t.is_encoder_decoder
    assert t.dtype == t.param_dtype == torch.bfloat16


def test_init_params_names_shapes_and_dtypes():
    """bf16: the JAX package's tree, leaf by leaf, in shape and dtype (the
    two stacks, the 32,768-row position table), the constant leaves'
    values (the LayerNorms' ones and zeros, the MLP biases); the full
    config's 49,046,016 parameters in both packages."""
    jc = jsmoke(ARCH)
    tc = smoke_config(ARCH)
    shapes = jax.eval_shape(lambda k: jtr.init_params(jc, k),
                            jax.random.PRNGKey(0))
    model = ttr.init_params(tc, torch.Generator().manual_seed(0))
    assert (len(model.enc_layers), len(model.dec_layers)) == (2, 2)
    assert model.enc_layers[0].xattn is None
    got = dict(jax.tree_util.tree_leaves_with_path(
        ttr.params_tree(dict(model.named_parameters()))))
    want = dict(jax.tree_util.tree_leaves_with_path(shapes))
    assert set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert w.dtype == jnp.bfloat16 and got[path].dtype == torch.bfloat16
        key = path[-1].key
        if key.endswith("_s") or key == "final_norm":
            assert bool((got[path] == 1).all()), path
        elif key.endswith("_b") or key in ("bi", "bo"):
            assert bool((got[path] == 0).all()), path
    assert tuple(model.dec_pos_embed.shape) == (ttr.DEC_POSITIONS, 64)
    full = jax.eval_shape(lambda k: jtr.init_params(jget(ARCH), k),
                          jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(full)) == PARAMS
    big = ttr.init_params(get_config(ARCH), torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in big.parameters()) == PARAMS


def test_lm_params_from_numpy_carries_every_leaf_and_round_trips(whisper):
    """Every leaf of the JAX tree, the two stacks by ``param_path``, back
    through ``params_tree`` bit for bit; a stack of the wrong depth is
    refused by its name."""
    jc, tc, tree, _, model = whisper
    names = [k for k, _ in model.named_parameters()]
    assert "dec_layers.1.xattn.p.wk" in names and "enc_layers.0.ln1_b" in names
    assert ttr.param_path("dec_layers.1.xattn.p.wk") == (
        ("dec_layers", "xattn", "wk"), 1)
    assert ttr.param_path("enc_layers.0.mlp.p.bi") == (
        ("enc_layers", "mlp", "bi"), 0)
    assert ttr.param_path("dec_pos_embed") == (("dec_pos_embed",), -1)
    back = ttr.params_tree(dict(model.named_parameters()))
    want = jax.tree_util.tree_leaves_with_path(tree)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat) == {path for path, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(np_(flat[path]), leaf)
    # sorted by param_path, the names run through the JAX leaves in order
    order = []
    for name in sorted(names, key=ttr.param_path):
        if ttr.param_path(name)[0] not in order:
            order.append(ttr.param_path(name)[0])
    assert order == [tuple(k.key for k in path) for path, _ in want]
    again = ttr.params_from_tree(back, names)
    assert all(torch.equal(again[n], p) for n, p in model.named_parameters())
    with pytest.raises(ValueError,
                       match="the tree has 2 dec_layers, the config 3"):
        lm_params_from_numpy(tc.replace(n_layers=3), tree, device=CPU)


def test_train_state_from_numpy_takes_the_audio_tree(whisper):
    """A JAX training state of the audio tree (moments drawn per leaf):
    each moment lands on the parameter of its own path."""
    _, tc, tree, _, _ = whisper
    rng = np.random.default_rng(3)

    def moments():
        return jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)

    m, v = moments(), moments()
    state = train_state_from_numpy(
        tc, {"params": tree, "opt": {"m": m, "v": v, "count": np.int32(4)},
             "clip": (np.float32(1.5), np.bool_(True))}, device=CPU)
    model = state["params"]
    for key, jt in (("m", m), ("v", v)):
        got = ttr.params_tree(state["opt"][key])
        for path, leaf in jax.tree_util.tree_leaves_with_path(jt):
            node = got
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(np_(node), leaf)
    assert set(state["opt"]["m"]) == {k for k, _ in model.named_parameters()}
    assert int(state["opt"]["count"]) == 4


# -- the pieces --------------------------------------------------------------------

@pytest.mark.parametrize("piece", ["layer_norm", "gelu_ffn", "sinusoids"])
def test_norm_mlp_and_sinusoids_match_jax(whisper, piece):
    jc, tc, _, jparams, model = whisper
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 9, 64)) * 3 + 1).astype(np.float32)
    if piece == "layer_norm":
        s, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
        want = jcommon.layer_norm(jnp.asarray(s), jnp.asarray(b),
                                  jnp.asarray(x))
        got = tcommon.layer_norm(t_(s), t_(b), t_(x))
    elif piece == "gelu_ffn":
        lp = jax.tree_util.tree_map(lambda a: a[1],
                                    jparams["dec_layers"]["mlp"])
        want = jmoe.gelu_ffn(lp, jnp.asarray(x))
        with torch.no_grad():
            got = model.dec_layers[1].mlp(t_(x))
        # the erf GELU is another function: the tanh form is the JAX one
        with torch.no_grad():
            erf = torch.nn.functional.gelu(
                t_(x) @ model.dec_layers[1].mlp.p["wi"]
                + model.dec_layers[1].mlp.p["bi"]) \
                @ model.dec_layers[1].mlp.p["wo"] + model.dec_layers[1].mlp.p["bo"]
        assert rel(erf, want) > 10 * TOL_OP
    else:
        want = jcommon.sinusoidal_positions(1500, 384)
        got = tcommon.sinusoidal_positions(1500, 384)
        assert got.dtype == np.float32
        on = tcommon.sinusoidal_on(1500, 384, torch.float32,
                                   torch.device(CPU))
        np.testing.assert_array_equal(on.numpy(), got)
    assert rel(got, want) <= TOL_OP


@pytest.mark.parametrize("kind", ["cross", "encoder"])
def test_cross_and_encoder_attention_match_jax(whisper, kind):
    """Cross-attention (12 queries on 20 encoder rows, ``x_kv``, no RoPE)
    and the encoder's bidirectional self-attention, each with
    ``return_kv``: the output and the un-repeated ``(k, v)``."""
    jc, tc, _, jparams, model = whisper
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12 if kind == "cross" else 20, 64)).astype(
        np.float32)
    enc = rng.standard_normal((2, 20, 64)).astype(np.float32)
    stack, name = ("dec_layers", "xattn") if kind == "cross" else \
        ("enc_layers", "attn")
    lp = jax.tree_util.tree_map(lambda a: a[1], jparams[stack][name])
    kw = dict(causal=False, return_kv=True)
    jkv = dict(x_kv=jnp.asarray(enc)) if kind == "cross" else {}
    tkv = dict(x_kv=t_(enc)) if kind == "cross" else {}
    want, (wk, wv) = jattn.multihead_attention(lp, jnp.asarray(x), None, jc,
                                               **kw, **jkv)
    with torch.no_grad():
        got, (gk, gv) = tattn.multihead_attention(
            getattr(getattr(model, stack)[1], name).p, t_(x), None, tc, **kw,
            **tkv)
    assert gk.shape == (2, 20, 4, 16)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert rel(g, w) <= TOL_MODEL


# -- the model ---------------------------------------------------------------------

def test_forward_and_loss_match_jax(whisper):
    """Logits over 12 tokens against 20 frames, and the loss and its
    metrics."""
    jc, tc, _, jparams, model = whisper
    b = batch(12, 20, seed=1)
    want = jitted("forward", jc)(jparams, jbatch(b))
    wl, wm = jitted("loss", jc)(jparams, jbatch(b))
    with torch.no_grad():
        got, aux = ttr.forward(model, tc, tbatch(b))
        gl, gm = ttr.loss_fn(model, tc, tbatch(b))
    assert float(aux) == 0.0
    assert rel(got, want) <= TOL_MODEL
    assert rel(gl, wl) <= TOL_MODEL
    assert set(gm) == set(wm) and float(gm["aux_loss"]) == 0.0


def test_prefill_and_its_four_cache_entries_match_jax(whisper):
    jc, tc, _, jparams, model = whisper
    b = batch(12, 20, seed=2)
    wl, wc = jitted("prefill", jc)(jparams, jbatch(b))
    with torch.no_grad():
        gl, gc = ttr.prefill_step(model, tc, tbatch(b))
    assert rel(gl, wl) <= TOL_MODEL
    assert tuple(gc) == ENTRIES and set(wc) == set(ENTRIES)
    for key in ENTRIES:
        assert rel(gc[key], wc[key]) <= TOL_MODEL, key
    assert tuple(gc["cross_k"].shape) == (2, 2, 20, 4, 16)


def test_init_cache_is_the_jax_one(whisper):
    """Zeros of the JAX shapes: the cross K/V of ``enc_len`` rows, 1,500
    by default; the audio cache has no state entries."""
    jc, tc, _, _, _ = whisper
    for enc_len in (0, 7):
        want = jtr.init_cache(jc, 3, 17, enc_len=enc_len)
        got = ttr.init_cache(tc, 3, 17, enc_len=enc_len, device=CPU)
        assert tuple(got) == ENTRIES and set(want) == set(got)
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, key
            assert not bool(got[key].any())
    assert got["cross_k"].shape[2] == 7
    assert ttr.state_entries(tc) == () and ttr.cache_rows(tc, 40) == 40


def jsplice(jc, pcache, B, max_len, T):
    target = jtr.init_cache(jc, B, max_len, enc_len=T)
    return {k: jnp.pad(pcache[k], [(0, d - s) for d, s in
                                   zip(target[k].shape, pcache[k].shape)])
            for k in target}


@pytest.mark.parametrize("variant", ["int", "tensor", "padded-cross"])
def test_decode_steps_from_the_jax_cache_match_the_jax_steps(whisper,
                                                             variant):
    """Four teacher-forced steps from the JAX prefill's cache (spliced to
    ``max_len`` 24), each fed the JAX step's greedy token: the logits and
    the self K/V after every step within 1e-5, the cross K/V untouched.
    ``cache_len`` an int or a 0-d tensor; with ``padded-cross`` the cross
    K/V sit in 24-row buffers whose rows past the 20 of the encoder hold
    noise, masked by a 0-d ``enc_len``: the same numbers."""
    jc, tc, _, jparams, model = whisper
    S, T, max_len = 12, 20, 24
    b = batch(S, T, seed=3)
    wl, wc = jitted("prefill", jc)(jparams, jbatch(b))
    jcache = jsplice(jc, wc, 2, max_len, T)
    cache = {k: t_(np_(v)) for k, v in jcache.items()}
    enc_len = None
    if variant == "padded-cross":
        rng = np.random.default_rng(9)
        for key in ttr.CROSS:
            pad = t_(rng.standard_normal((2, 2, max_len - T, 4, 16)))
            cache[key] = torch.cat([cache[key], pad], dim=2)
        enc_len = torch.tensor(T)
    cross = {k: cache[k].clone() for k in ttr.CROSS}
    nxt = np.argmax(np_(wl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for step in range(4):
        n = S + step
        with torch.no_grad():
            glog, out = ttr.decode_step(
                model, tc, cache, torch.from_numpy(nxt),
                n if variant == "int" else torch.tensor(n), enc_len=enc_len)
        wlog, jcache = jitted("decode", jc)(jparams, jcache, jnp.asarray(nxt),
                                            jnp.asarray(n, jnp.int32))
        assert out is cache
        assert rel(glog, wlog) <= TOL_MODEL
        for key in ("k", "v"):
            assert rel(cache[key], jcache[key]) <= TOL_MODEL, key
        nxt = np.argmax(np_(wlog)[:, 0], axis=-1).astype(np.int32)[:, None]
    for key in ttr.CROSS:
        assert torch.equal(cache[key], cross[key])


def test_decode_differs_from_forward_as_the_jax_decode_does(whisper):
    """ROADMAP C29: the decode rotates q and the new k with RoPE, the
    prefill and ``forward`` rotate nothing.  Eight teacher-forced steps of
    the port (through its decode program) against its own ``forward`` over
    the prompt and the fed tokens: off by about a tenth of the logits'
    max-abs, as the JAX decode is off the JAX forward; the port's steps
    within 1e-5 of the JAX steps."""
    jc, tc, _, jparams, model = whisper
    S, T, n = 12, 20, 8
    b = batch(S, T, seed=4)
    wl, wc = jitted("prefill", jc)(jparams, jbatch(b))
    with torch.no_grad():
        gl, gc = ttr.prefill_step(model, tc, tbatch(b))
    prog = DecodeProgram(model, tc, 2, S + n, CPU)
    prog.start(gc, gl[:, -1].argmax(-1), S, graphed=False)
    jcache = jsplice(jc, wc, 2, S + n, T)
    nxt = np.argmax(np_(wl)[:, -1], axis=-1).astype(np.int32)[:, None]
    fed, glogs, wlogs = [], [], []
    for step in range(n):
        fed.append(nxt)
        prog.tokens.copy_(torch.from_numpy(nxt))
        with torch.no_grad():
            prog.step()
        wlog, jcache = jitted("decode", jc)(jparams, jcache, jnp.asarray(nxt),
                                            jnp.asarray(S + step, jnp.int32))
        glogs.append(np_(prog.logits)[:, 0])
        wlogs.append(np_(wlog)[:, 0])
        nxt = np.argmax(wlogs[-1], axis=-1).astype(np.int32)[:, None]
    assert int(prog.cache_len) == S + n and int(prog.enc_len) == T
    glogs, wlogs = np.stack(glogs, 1), np.stack(wlogs, 1)
    seq = dict(b, tokens=np.concatenate([b["tokens"]] + fed, 1))
    wf = np_(jitted("forward", jc)(jparams, jbatch(seq)))[:, S:]
    with torch.no_grad():
        gf = np_(ttr.forward(model, tc, tbatch(seq))[0])[:, S:]
    assert rel(glogs, wlogs) <= TOL_MODEL
    jgap, ggap = rel(wlogs, wf), rel(glogs, gf)
    assert jgap > 1e-2                      # the reference's own gap
    assert abs(ggap - jgap) <= 1e-4


def test_the_flash_branch_is_the_plain_function(whisper, monkeypatch):
    """S = 256 tokens with ``use_flash_kernel=True``: the decoder's causal
    self-attention takes the kernel's entry (its plain version here), one
    call a decoder layer, the encoder (bidirectional) and the
    cross-attention none; the logits within 1e-5 of the JAX forward with
    ``use_flash_kernel=False``, the same function."""
    jc, tc, tree, jparams, _ = whisper
    tcf = tc.replace(use_flash_kernel=True)
    model = lm_params_from_numpy(tcf, tree, device=CPU)
    calls = []
    real = kops.flash_attention

    def counted(qg, k, v, **kw):
        calls.append(tuple(qg.shape))
        return real(qg, k, v, **kw)

    monkeypatch.setattr(kops, "flash_attention", counted)
    b = batch(256, 20, B=1, seed=5)
    want = jitted("forward", jc)(jparams, jbatch(b))
    with torch.no_grad():
        got = ttr.forward(model, tcf, tbatch(b))[0]
    assert calls == [(1, 256, 4, 1, 16)] * tc.n_layers
    assert rel(got, want) <= TOL_MODEL


def test_c30_both_packages_refuse_1500_frames(whisper):
    """The encoder's plain attention runs 1,024-row query blocks past
    1,024 frames: the JAX package asserts, the port raises."""
    jc, tc, _, jparams, model = whisper
    b = batch(4, 1500, B=1, seed=6)
    with pytest.raises(AssertionError, match="not divisible by q_block"):
        jax.eval_shape(lambda p, x: jtr.prefill_step(p, jc, x), jparams,
                       jbatch(b))
    with pytest.raises(ValueError, match="not divisible by q_block"), \
            torch.no_grad():
        ttr.prefill_step(model, tc, tbatch(b))


# -- the engine --------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [(10, 6), (6, 10)])
def test_engine_gives_the_jax_engines_tokens_over_two_prompt_lengths(
        whisper, lengths):
    """One engine serves two batches of two prompts, of two lengths in
    turn: the same greedy tokens as the JAX engine (which sizes its cross
    K/V to each batch's prompt).  The port's one program holds
    ``max_len`` cross rows; after the longer prompt, rows past the
    shorter one are zeros that must not weigh in the cross softmax."""
    jc, tc, _, jparams, model = whisper
    jeng = JServingEngine(jc, JServeConfig(max_batch=2, max_len=24),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=2, max_len=24),
                         params=model, device=CPU)
    for S, seed in zip(lengths, (11, 12)):
        for row in batch(S, 1, seed=seed)["tokens"]:
            jeng.submit(JRequest(prompt=list(map(int, row)),
                                 max_new_tokens=6))
            teng.submit(Request(prompt=list(map(int, row)),
                                max_new_tokens=6))
    want = [r.output for r in jeng.run()]
    got = [r.output for r in teng.run()]
    assert got == want
    assert [len(o) for o in got] == [6] * 4
    assert list(teng.programs) == [2]
    prog = teng.programs[2]
    assert int(prog.enc_len) == lengths[1]
    assert tuple(prog.cache["cross_k"].shape) == (2, 2, 24, 4, 16)
    assert not bool(prog.cache["cross_k"][:, :, lengths[1]:].any())


def test_the_capture_warm_up_leaves_the_cross_entries(whisper, monkeypatch):
    """The decode program's warm-up (the step before a capture) writes
    the self K/V row that the first replay writes again and no cross row:
    every cross entry equals the spliced one bitwise after it, and the
    first step's logits and tokens equal an unwarmed program's."""
    from repro_torch.core import program as _program
    jc, tc, _, _, model = whisper
    b = batch(9, 9, seed=7)
    with torch.no_grad():
        logits, pcache = ttr.prefill_step(model, tc, tbatch(dict(
            b, frames=np.zeros((2, 9, 64), np.float32))))
    first = logits[:, -1].argmax(-1)
    progs = [DecodeProgram(model, tc, 2, 16, CPU) for _ in range(2)]
    for prog in progs:
        prog.start(pcache, first, 9, graphed=False)
    spliced = {k: progs[0].cache[k].clone() for k in ttr.CROSS}
    seen = {}

    def capture(label, device, pool, warm_up, body):
        warm_up()
        seen.update({k: torch.equal(progs[0].cache[k], spliced[k])
                     for k in ttr.CROSS})
        body()
        return None, {}, 0, 0

    monkeypatch.setattr(_program, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with torch.no_grad():
        progs[0].capture()
        progs[1].step()
    assert seen == dict.fromkeys(ttr.CROSS, True)
    assert torch.equal(progs[0].logits, progs[1].logits)
    assert torch.equal(progs[0].tokens, progs[1].tokens)
    for key in ENTRIES:
        assert torch.equal(progs[0].cache[key], progs[1].cache[key]), key


def test_engine_refuses_a_max_len_past_the_position_table(whisper):
    """A ``max_len`` past the 32,768 learned positions is refused before
    the prefill (the JAX gather would read the last row again, C30); at
    32,768 a batch is served."""
    _, tc, _, _, model = whisper
    eng = ServingEngine(tc, ServeConfig(max_batch=1,
                                        max_len=ttr.DEC_POSITIONS + 1),
                        params=model, device=CPU)
    eng.submit(Request(prompt=[3, 4, 5], max_new_tokens=2))
    with pytest.raises(ValueError, match="32768 rows of the decoder's"):
        eng.run()
    with torch.no_grad():
        pos = ttr._learned_position(model, torch.tensor(ttr.DEC_POSITIONS
                                                        + 5))
    assert torch.equal(pos[0], model.dec_pos_embed[-1])


def test_launch_serve_runs_whisper_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--requests", "3", "--prompt-len", "8",
                       "--max-new", "3", "--device", "cpu"])
    assert [len(r.output) for r in done] == [3, 3, 3]
    assert "3 requests, 9 tokens" in capsys.readouterr().out
