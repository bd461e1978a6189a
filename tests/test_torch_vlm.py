"""The port's VLM family (qwen2-vl: ``apply_mrope``, M-RoPE in the
attention's projections, the patch splice and the (t, h, w) positions of
``models.transformer``, the engine's text positions, ``convert`` and the
launchers) held against the JAX package on the CPU.

The smoke qwen2-vl (2 layers, d 64, 4 heads on 2 KV heads of 16, sections
(2, 3, 3), QKV biases, vocab 256) in fp32, with the JAX package's initial
weights carried over by ``lm_params_from_numpy`` and the norms and the
QKV biases redrawn so that none is trivially 1 or 0.  The JAX engine
serves text positions, t = h = w, where M-RoPE equals RoPE, so the
rotation itself is held through ``forward`` and ``prefill_step`` with
patch embeddings and distinct (t, h, w) streams.  Bars, relative to the
reference's max-abs: 1e-6 for ``apply_mrope``, 1e-5 for whole-model
logits, caches and the loss.  One JAX model, one port model and the
jitted JAX functions are shared by every case (module scope).
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
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import LATER, get_config, smoke_config  # noqa: E402
from repro_torch.data import DataConfig, make_dataset  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim import pipelined_clip_init  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402

ARCH = "qwen2-vl-72b"
CPU = "cpu"
TOL_OP = 1e-6          # apply_mrope (fp32)
TOL_MODEL = 1e-5       # whole-model logits, caches and the loss (fp32)

#: leaves redrawn around their initial value, and by how much
REDRAWN = {"ln1": 0.3, "ln2": 0.3, "final_norm": 0.3, "bq": 0.3,
           "bk": 0.3, "bv": 0.3}


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


@pytest.fixture(scope="module")
def vlm():
    """fp32 configs, the numpy tree, the JAX parameters and the port's
    model with the same weights."""
    jc = jsmoke(ARCH).replace(dtype=jnp.float32, param_dtype=jnp.float32)
    tc = smoke_config(ARCH).replace(dtype=torch.float32,
                                    param_dtype=torch.float32)
    rng = np.random.default_rng(0)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        scale = REDRAWN.get(path[-1].key)
        if scale:
            a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(
        leaf, jax.jit(jtr.init_params, static_argnums=0)(
            jc, jax.random.PRNGKey(0)))
    return jc, tc, tree, jax.tree_util.tree_map(jnp.asarray, tree), \
        lm_params_from_numpy(tc, tree, device=CPU)


@functools.lru_cache(maxsize=None)
def jitted(name: str, jc):
    fn = {"forward": lambda p, b: jtr.forward(p, jc, b)[0],
          "loss": lambda p, b: jtr.loss_fn(p, jc, b)[0],
          "prefill": lambda p, b: jtr.prefill_step(p, jc, b),
          "decode": lambda p, c, t, n: jtr.decode_step(p, jc, c, t, n)}
    return jax.jit(fn[name])


def image_positions(B, S, grid=(2, 3), start=1):
    """Qwen2-VL's (t, h, w) ids of a prompt with one image: text before it
    on all three streams, the image's patches at rows ``start`` on with t
    fixed and (h, w) over a ``grid``, text after it from the largest id
    plus one.  int32 (B, S, 3)."""
    gh, gw = grid
    pos = np.zeros((S, 3), np.int64)
    pos[:start] = np.arange(start)[:, None]
    r = np.arange(gh * gw)
    pos[start:start + gh * gw] = np.stack(
        [np.full_like(r, start), start + r // gw, start + r % gw], 1)
    nxt = pos[:start + gh * gw].max() + 1
    rest = S - start - gh * gw
    pos[start + gh * gw:] = (nxt + np.arange(rest))[:, None]
    return np.ascontiguousarray(np.broadcast_to(pos, (B, S, 3)),
                                dtype=np.int32)


def batch(S=12, B=2, P=6, seed=0, distinct=True):
    """Tokens (B, S), ``P`` seeded patch rows (B, P, 64) and the (t, h, w)
    positions of a 2 x 3 patch grid (``distinct``) or t = h = w, as
    numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, 256, (B, S)).astype(np.int32)}
    if P:
        b["patch_embeds"] = rng.standard_normal((B, P, 64)).astype(np.float32)
    b["positions"] = image_positions(B, S) if distinct else \
        np.ascontiguousarray(np.broadcast_to(
            np.arange(S)[None, :, None], (B, S, 3)), dtype=np.int32)
    return b


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
    assert t.family == "vlm" and t.qkv_bias and not LATER
    assert t.dtype == t.param_dtype == torch.bfloat16
    assert sum(t.mrope_sections) == t.hd // 2


def test_init_params_cache_and_tree_are_the_jax_ones(vlm):
    """bf16: the JAX package's tree, leaf by leaf, in shape and dtype (the
    QKV biases zero), and the JAX cache's shapes."""
    jc, tc = jsmoke(ARCH), smoke_config(ARCH)
    shapes = jax.eval_shape(lambda k: jtr.init_params(jc, k),
                            jax.random.PRNGKey(0))
    model = ttr.init_params(tc, torch.Generator().manual_seed(0))
    got = dict(jax.tree_util.tree_leaves_with_path(
        ttr.params_tree(dict(model.named_parameters()))))
    want = dict(jax.tree_util.tree_leaves_with_path(shapes))
    assert set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert got[path].dtype == torch.bfloat16
        if path[-1].key in ("bq", "bk", "bv"):
            assert not bool(got[path].any()), path
    cache = ttr.init_cache(tc, 3, 17, device=CPU)
    jcache = jtr.init_cache(jc, 3, 17)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    assert ttr.state_entries(tc) == () and ttr.cache_rows(tc, 40) == 40


def test_lm_params_from_numpy_carries_every_leaf_and_round_trips(vlm):
    """Every leaf of the JAX tree, the biases included, back through
    ``params_tree`` bit for bit."""
    _, tc, tree, _, model = vlm
    names = [k for k, _ in model.named_parameters()]
    assert "layers.1.attn.p.bk" in names
    flat = dict(jax.tree_util.tree_leaves_with_path(
        ttr.params_tree(dict(model.named_parameters()))))
    want = jax.tree_util.tree_leaves_with_path(tree)
    assert set(flat) == {path for path, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(np_(flat[path]), leaf)
    again = ttr.params_from_tree(ttr.params_tree(
        dict(model.named_parameters())), names)
    assert all(torch.equal(again[n], p) for n, p in model.named_parameters())


# -- M-RoPE ------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
def test_apply_mrope_matches_jax_and_equals_rope_on_one_stream(hd, sections):
    """Random (B, S, 3) positions: within 1e-6 of the JAX function.  With
    t = h = w the port's M-RoPE is its RoPE bit for bit, in f32 and bf16;
    sections that do not sum to hd / 2 are refused."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9, 3)).astype(np.int32)
    want = jax.jit(jcommon.apply_mrope, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = tcommon.apply_mrope(t_(x), torch.from_numpy(pos), 1e6, sections)
    assert rel(got, want) <= TOL_OP
    one = torch.from_numpy(pos[..., 0])
    for dtype in (torch.float32, torch.bfloat16):
        xt = t_(x).to(dtype)
        assert torch.equal(
            tcommon.apply_mrope(xt, one[..., None].expand(2, 9, 3), 1e6,
                                sections),
            tcommon.apply_rope(xt, one, 1e6))
    # and the rotation reads each stream: distinct streams move it
    assert rel(got, tcommon.apply_rope(t_(x), one, 1e6)) > 1e-2
    with pytest.raises(ValueError, match="sum to"):
        tcommon.apply_mrope(t_(x), torch.from_numpy(pos), 1e6, (1, 1, 1))


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_forward_and_prefill_match_jax_with_patches_and_image_positions(
        vlm, entry):
    """Six patch rows spliced in at row 1, the (t, h, w) ids of a 2 x 3
    grid: the logits (and the prefill's K/V) within 1e-5 of the JAX
    package's; the same batch on text positions moves the logits by more
    than the bar a hundredfold, so the rotation is what is held."""
    jc, tc, _, jparams, model = vlm
    b = batch(seed=1)
    text = dict(b, positions=batch(seed=1, distinct=False)["positions"])
    with torch.no_grad():
        if entry == "forward":
            want = jitted("forward", jc)(jparams, jbatch(b))
            got, aux = ttr.forward(model, tc, tbatch(b))
            other = ttr.forward(model, tc, tbatch(text))[0]
            assert float(aux) == 0.0
        else:
            want, wc = jitted("prefill", jc)(jparams, jbatch(b))
            got, gc = ttr.prefill_step(model, tc, tbatch(b))
            other = ttr.prefill_step(model, tc, tbatch(text))[0]
            assert set(gc) == set(wc) == {"k", "v"}
            for key in gc:
                assert rel(gc[key], wc[key]) <= TOL_MODEL, key
    assert rel(got, want) <= TOL_MODEL
    assert rel(other, want) > 100 * TOL_MODEL


def test_default_positions_are_arange_on_three_streams(vlm):
    """No ``positions`` in the batch: ``arange(S)`` on every stream, as the
    JAX package defaults (held to the JAX forward given them); so text
    positions given explicitly change nothing, bit for bit."""
    jc, tc, _, jparams, model = vlm
    b = batch(seed=2, distinct=False)
    bare = {k: v for k, v in b.items() if k != "positions"}
    want = jitted("forward", jc)(jparams, jbatch(b))
    with torch.no_grad():
        got = ttr.forward(model, tc, tbatch(bare))[0]
        same = ttr.forward(model, tc, tbatch(b))[0]
    assert rel(got, want) <= TOL_MODEL
    assert torch.equal(got, same)


@pytest.mark.parametrize("P", [0, 3, 11, 12])
def test_the_patch_splice_clamps_as_dynamic_update_slice(vlm, P):
    """``patch_embeds`` of P rows into 12: the rows the port writes are
    ``jax.lax.dynamic_update_slice``'s at start (0, 1, 0) bit for bit,
    the start clamped to S - P (12 rows land at row 0); the forward's
    logits within 1e-5 of the JAX package's."""
    jc, tc, _, jparams, model = vlm
    S = 12
    b = batch(S=S, P=P, seed=3)
    if not P:
        b["patch_embeds"] = np.zeros((2, 0, 64), np.float32)
    x = np.random.default_rng(4).standard_normal((2, S, 64)).astype(
        np.float32)
    want = jax.lax.dynamic_update_slice(
        jnp.asarray(x), jnp.asarray(b["patch_embeds"]), (0, 1, 0))
    got = ttr._splice_patches(tc, t_(x), tbatch(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if P == S:
        np.testing.assert_array_equal(got.numpy(), b["patch_embeds"])
    wl = jitted("forward", jc)(jparams, jbatch(b))
    with torch.no_grad():
        gl = ttr.forward(model, tc, tbatch(b))[0]
    assert rel(gl, wl) <= TOL_MODEL


def test_more_patch_rows_than_tokens_are_refused_by_both(vlm):
    jc, tc, _, jparams, model = vlm
    b = batch(S=8, P=9, seed=5)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda p, x: jtr.forward(p, jc, x), jparams,
                       jbatch(b))
    with pytest.raises(ValueError, match="9 patch_embeds rows do not fit"), \
            torch.no_grad():
        ttr.prefill_step(model, tc, tbatch(b))
    with pytest.raises(ValueError, match=r"must be \(B, S, 3\)"), \
            torch.no_grad():
        ttr.forward(model, tc, tbatch(dict(batch(S=8, P=2),
                                           positions=np.zeros((2, 8),
                                                              np.int32))))


@pytest.mark.parametrize("variant", ["int", "tensor"])
def test_teacher_forced_decode_from_the_jax_cache_matches_the_jax_steps(
        vlm, variant):
    """Four steps from the JAX prefill's cache (patches and image
    positions), spliced to ``max_len`` 20, each fed the JAX step's greedy
    token: the logits and the K/V after every step within 1e-5.  Both
    packages take position ``cache_len`` on all three streams (ROADMAP
    C32); ``cache_len`` an int or a 0-d tensor."""
    jc, tc, _, jparams, model = vlm
    S, max_len = 12, 20
    b = batch(S=S, seed=6)
    wl, wc = jitted("prefill", jc)(jparams, jbatch(b))
    target = jtr.init_cache(jc, 2, max_len)
    jcache = {k: jnp.pad(wc[k], [(0, d - s) for d, s in
                                 zip(target[k].shape, wc[k].shape)])
              for k in target}
    cache = {k: t_(np_(v)) for k, v in jcache.items()}
    nxt = np.argmax(np_(wl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for step in range(4):
        n = S + step
        with torch.no_grad():
            glog, out = ttr.decode_step(
                model, tc, cache, torch.from_numpy(nxt),
                n if variant == "int" else torch.tensor(n))
        wlog, jcache = jitted("decode", jc)(jparams, jcache, jnp.asarray(nxt),
                                            jnp.asarray(n, jnp.int32))
        assert out is cache
        assert rel(glog, wlog) <= TOL_MODEL
        for key in ("k", "v"):
            assert rel(cache[key], jcache[key]) <= TOL_MODEL, key
        nxt = np.argmax(np_(wlog)[:, 0], axis=-1).astype(np.int32)[:, None]


def test_the_flash_branch_is_the_plain_function(vlm, monkeypatch):
    """S = 256 tokens with ``use_flash_kernel=True``, patches and image
    positions: the causal self-attention takes the kernel's entry (its
    plain version here) with G = 2, one call a layer; the logits within
    1e-5 of the JAX forward's plain branch, the same function."""
    jc, tc, tree, jparams, _ = vlm
    tcf = tc.replace(use_flash_kernel=True)
    model = lm_params_from_numpy(tcf, tree, device=CPU)
    calls = []
    real = kops.flash_attention

    def counted(qg, k, v, **kw):
        calls.append(tuple(qg.shape))
        return real(qg, k, v, **kw)

    monkeypatch.setattr(kops, "flash_attention", counted)
    b = batch(S=256, B=1, P=16, seed=7)
    want = jitted("forward", jc)(jparams, jbatch(b))
    with torch.no_grad():
        got = ttr.forward(model, tcf, tbatch(b))[0]
    assert calls == [(1, 256, 2, 2, 16)] * tc.n_layers
    assert rel(got, want) <= TOL_MODEL


# -- the engine, training and the launchers ----------------------------------------

def test_engine_gives_the_jax_engines_tokens(vlm):
    """Four prompts of 10 tokens, two batches of two, 6 new tokens each:
    the same greedy tokens as the JAX engine, which prefills on text
    positions t = h = w = arange."""
    jc, tc, _, jparams, model = vlm
    jeng = JServingEngine(jc, JServeConfig(max_batch=2, max_len=20),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=2, max_len=20),
                         params=model, device=CPU)
    for seed in (8, 9):
        for row in batch(S=10, P=0, seed=seed, distinct=False)["tokens"]:
            jeng.submit(JRequest(prompt=list(map(int, row)),
                                 max_new_tokens=6))
            teng.submit(Request(prompt=list(map(int, row)),
                                max_new_tokens=6))
    want = [r.output for r in jeng.run()]
    got = [r.output for r in teng.run()]
    assert got == want and [len(o) for o in got] == [6] * 4
    assert list(teng.programs) == [2]


def test_a_train_step_s_loss_is_the_jax_loss_on_a_pipeline_batch(vlm):
    """The data pipeline's VLM batch (64 patch rows at most, text
    positions) is the JAX pipeline's bit for bit; one ``make_train_step``
    step's loss on it is JAX's ``loss_fn`` at the same weights within
    1e-5, and the step is accepted."""
    jc, tc, tree, jparams, _ = vlm
    dcfg = dict(batch_size=2, seq_len=24, vocab_size=tc.vocab_size, seed=3)
    got_b = make_dataset(DataConfig(**dcfg), tc)(0)
    want_b = jmake_dataset(JDataConfig(**dcfg), jc)(0)
    assert set(got_b) == set(want_b) == {"tokens", "patch_embeds",
                                         "positions"}
    for k in want_b:
        np.testing.assert_array_equal(got_b[k], want_b[k])
    model = lm_params_from_numpy(tc, tree, device=CPU)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    step = make_train_step(tc, tcfg)
    opt = adamw_init(dict(model.named_parameters()), tcfg.opt)
    _, _, _, m = step(model, opt, pipelined_clip_init(), tbatch(got_b),
                      torch.tensor(1e9))
    want = jitted("loss", jc)(jparams, jbatch(want_b))
    assert float(m["accepted"]) == 1.0
    assert rel(m["loss"], want) <= TOL_MODEL


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_the_launchers_take_the_vlm(launcher, capsys, tmp_path):
    if launcher == "serve":
        from repro_torch.launch import serve
        done = serve.main(["--arch", ARCH, "--requests", "3", "--prompt-len",
                           "8", "--max-new", "3", "--device", "cpu"])
        assert [len(r.output) for r in done] == [3, 3, 3]
        assert "3 requests, 9 tokens" in capsys.readouterr().out
    else:
        from repro_torch.launch import train
        out = train.main(["--arch", ARCH, "--steps", "2", "--batch-size",
                          "2", "--seq-len", "16", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])
        assert np.isfinite(out["final_loss"])
        assert f"arch={ARCH} steps=2" in capsys.readouterr().out
