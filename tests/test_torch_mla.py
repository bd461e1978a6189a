"""The port's MLA and deepseek-v3 (``repro_torch.models.mla``, the MLA
blocks, the latent cache and the MTP loss of ``models.transformer``,
deepseek's config, ``convert``, the serving engine and the launcher) held
against the JAX package on the CPU.

Inputs and weights come from numpy seeds (JAX's initial weights carried
over with ``lm_params_from_numpy``, the norms redrawn around 1 and the
router's bias around 0).  Everything is fp32 on deepseek-v3's smoke config
unless a case says otherwise.  Tolerances, over the result's max-abs: one
module 1e-5 in fp32 (``ATOL_MODULE``; another summation order) and 2e-2
in bf16 (``BF16_TOL``, tests/test_kernels.py's bf16 bar: the two packages
round to bf16 at other points); two layers and the head 1e-4
(``ATOL_MODEL``); the loss and every gradient 1e-5 of the largest
(``GRAD_RTOL``).  The sort dispatch's grouped product runs its plain
version here (the kernel runs in tests/test_torch_cuda.py and
chip_smoke.py, on the card); the JAX package runs ``jax.lax.ragged_dot``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim import pipelined_clip_init  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402

ARCH = "deepseek-v3-671b"
CPU = "cpu"
ATOL_MODULE = 1e-5     # one module, fp32
ATOL_MODEL = 1e-4      # two layers and the head, fp32
GRAD_RTOL = 1e-5       # the loss and every gradient, of the largest
BF16_TOL = 2e-2        # tests/test_kernels.py's bf16 bar
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MODULE_TOL = {"float32": ATOL_MODULE, "bfloat16": BF16_TOL}
#: leaves redrawn around their initial value, and by how much
REDRAWN = {"ln1": 0.3, "ln2": 0.3, "final_norm": 0.3, "q_norm": 0.3,
           "kv_norm": 0.3, "ln_h": 0.3, "ln_e": 0.3, "router_bias": 0.05}


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=0.0, atol=atol)


def rel(got, want) -> float:
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(dtype="float32", **kw):
    """The JAX and the port's deepseek smoke config in ``dtype``."""
    jc = jsmoke(ARCH).replace(dtype=JAX[dtype], param_dtype=JAX[dtype], **kw)
    tc = tsmoke(ARCH).replace(dtype=TORCH[dtype], param_dtype=TORCH[dtype],
                              **kw)
    return jc, tc


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def redrawn(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        scale = REDRAWN.get(path[-1].key)
        if scale:
            a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def models(jc, tc, seed=0):
    """JAX parameters and the port's Transformer with the same weights."""
    tree = redrawn(jtr.init_params(jc, jax.random.PRNGKey(seed)), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        lm_params_from_numpy(tc, tree, device=CPU)


def mla_params(jc, seed=0):
    """One MLA layer's parameters, numpy f32 (in the config's dtype's
    values), norms redrawn."""
    p = redrawn(jmla.init_mla_params(jax.random.PRNGKey(seed), jc), seed)
    return {k: np_(jnp.asarray(v, jc.dtype)) for k, v in p.items()}


def both(p, dtype):
    return ({k: jnp.asarray(v, JAX[dtype]) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()).to(TORCH[dtype])
             for k, v in p.items()})


def randn(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, JAX[dtype]), torch.from_numpy(
        np_(jnp.asarray(a, JAX[dtype]))).to(TORCH[dtype])


def positions(B, S):
    p = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return jnp.asarray(p), torch.from_numpy(p.copy())


# -- the config and the module ------------------------------------------------

def test_config_equals_the_jax_one():
    dtypes = {"dtype", "param_dtype"}
    for t, j in ((get_config(ARCH), jget(ARCH)), (tsmoke(ARCH), jsmoke(ARCH))):
        assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
                if f.name not in dtypes} == \
            {f.name: getattr(j, f.name) for f in dataclasses.fields(j)
             if f.name not in dtypes}
        assert t.dtype == t.param_dtype == torch.bfloat16
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.use_mla, cfg.moe_impl, cfg.use_mtp) == \
        ("moe", True, "sort", True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_params_has_the_jax_names_and_shapes(dtype):
    jc, tc = configs(dtype)
    want = jmla.init_mla_params(jax.random.PRNGKey(0), jc)
    got = tmla.init_mla_params(torch.Generator().manual_seed(0), tc)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == TORCH[dtype], k
    assert bool((got["q_norm"] == 1).all() and (got["kv_norm"] == 1).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_matches_jax(dtype):
    jc, tc = configs(dtype)
    jp, tp = both(mla_params(jc, seed=1), dtype)
    jx, tx = randn(np.random.default_rng(2), (2, 10, jc.d_model), dtype)
    jpos, tpos = positions(2, 10)
    want = jmla._compress(jp, jx, jc, jpos)
    got = tmla._compress(tp, tx, tc, tpos)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert tuple(got[3].shape) == (2, 10, tc.qk_rope_head_dim)
    for g, w in zip(got, want):
        assert g.dtype == TORCH[dtype]
        assert rel(g, w) <= MODULE_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,q_block", [(12, 1024), (16, 8)])
def test_mla_attention_matches_jax(dtype, S, q_block):
    """The prefill, in one block of rows and in blocks of 8 (the JAX
    package's ``lax.scan``), and the latent rows it returns for the
    cache."""
    jc, tc = configs(dtype)
    jp, tp = both(mla_params(jc, seed=3), dtype)
    jx, tx = randn(np.random.default_rng(4), (2, S, jc.d_model), dtype)
    jpos, tpos = positions(2, S)
    want, (wc, wr) = jmla.mla_attention(jp, jx, jpos, jc, q_block=q_block,
                                        return_cache=True)
    got, (gc, gr) = tmla.mla_attention(tp, tx, tpos, tc, q_block=q_block,
                                       return_cache=True)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == want.shape
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        assert rel(g, w) <= MODULE_TOL[dtype]
    assert torch.equal(tmla.mla_attention(tp, tx, tpos, tc, q_block=q_block),
                       got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_mla_decode_matches_jax_and_writes_the_cache_in_place(dtype,
                                                              as_tensor):
    """The absorbed decode against random latent caches: ``y`` and both
    caches as the JAX package's, the new rows written into the caches it
    was given at ``cache_len`` (an int, or a 0-d tensor) and nowhere
    else."""
    jc, tc = configs(dtype)
    jp, tp = both(mla_params(jc, seed=5), dtype)
    B, T, n = 3, 20, 13
    rng = np.random.default_rng(6)
    jx, tx = randn(rng, (B, 1, jc.d_model), dtype)
    jckv, tckv = randn(rng, (B, T, jc.kv_lora_rank), dtype)
    jkr, tkr = randn(rng, (B, T, jc.qk_rope_head_dim), dtype)
    before = (tckv.clone(), tkr.clone())
    y, c1, c2 = jmla.mla_decode(jp, jx, jnp.full((B,), n), jckv, jkr,
                                jnp.asarray(n, jnp.int32), jc)
    cache_len = torch.tensor(n) if as_tensor else n
    gy, g1, g2 = tmla.mla_decode(tp, tx, torch.full((B,), n), tckv, tkr,
                                 cache_len, tc)
    assert g1 is tckv and g2 is tkr
    assert tuple(gy.shape) == y.shape and gy.dtype == TORCH[dtype]
    assert rel(gy, y) <= MODULE_TOL[dtype]
    for g, w, old in ((g1, c1, before[0]), (g2, c2, before[1])):
        assert rel(g, w) <= MODULE_TOL[dtype]
        others = [t for t in range(T) if t != n]
        assert torch.equal(g[:, others], old[:, others])
        assert not torch.equal(g[:, n], old[:, n])


def test_absorbed_decode_equals_the_rebuilt_prefill_row():
    """In fp32 the absorbed decode of position S - 1, against the latent
    rows of positions 0 .. S - 2, gives the prefill's row S - 1: the same
    sums in another order (chip_smoke.py holds the full width to 1e-4)."""
    jc, tc = configs("float32")
    _, tp = both(mla_params(jc, seed=7), "float32")
    B, S = 2, 11
    _, tx = randn(np.random.default_rng(8), (B, S, tc.d_model), "float32")
    _, tpos = positions(B, S)
    out, (ckv, kr) = tmla.mla_attention(tp, tx, tpos, tc, return_cache=True)
    c1, c2 = ckv.clone(), kr.clone()
    c1[:, S - 1:] = 0
    c2[:, S - 1:] = 0
    y, c1, c2 = tmla.mla_decode(tp, tx[:, S - 1:], tpos[:, S - 1], c1, c2,
                                S - 1, tc)
    assert rel(y[:, 0], out[:, S - 1]) <= ATOL_MODULE
    assert rel(c1, ckv) <= ATOL_MODULE and rel(c2, kr) <= ATOL_MODULE


# -- the model ----------------------------------------------------------------

def test_lm_params_from_numpy_carries_every_leaf():
    """Every leaf of the JAX tree, the MTP block's included, lands in the
    port's model bit for bit and comes back through ``params_tree``; in
    bf16 the router's leaves stay f32."""
    jc, tc = configs()
    tree = numpy_tree(jtr.init_params(jc, jax.random.PRNGKey(0)))
    assert "mtp" in tree
    model = lm_params_from_numpy(tc, tree, device=CPU)
    assert model.mtp is not None
    back = dict(jax.tree_util.tree_leaves_with_path(ttr.params_tree(
        {k: p.detach() for k, p in model.named_parameters()})))
    want = jax.tree_util.tree_leaves_with_path(tree)
    assert set(back) == {path for path, _ in want}
    for path, leaf in want:
        assert np.array_equal(np_(back[path]), leaf), \
            jax.tree_util.keystr(path)
    bf = lm_params_from_numpy(tsmoke(ARCH), tree, device=CPU)
    assert bf.mtp.block.moe.p["router"].dtype == torch.float32
    assert bf.mtp.block.attn.p["wuk"].dtype == torch.bfloat16
    assert bf.layers[0].moe.p["router_bias"].dtype == torch.float32


def test_init_params_and_cache_run_deepseek():
    """The port draws the JAX tree's shapes (MTP included) and gives the
    latent cache."""
    _, tc = configs()
    model = ttr.init_params(tc, torch.Generator().manual_seed(0))
    jtree = jax.eval_shape(lambda: jtr.init_params(
        configs()[0], jax.random.PRNGKey(0)))
    got = dict(jax.tree_util.tree_leaves_with_path(ttr.params_tree(
        {k: p.detach() for k, p in model.named_parameters()})))
    want = jax.tree_util.tree_leaves_with_path(jtree)
    assert {p: tuple(t.shape) for p, t in got.items()} == \
        {p: leaf.shape for p, leaf in want}
    cache = ttr.init_cache(tc, 3, 17, device=CPU)
    jcache = jtr.init_cache(configs()[0], 3, 17)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    assert set(cache) == {"ckv", "krope"}


def test_forward_prefill_and_decode_match_jax():
    jc, tc = configs()
    jparams, model = models(jc, tc, seed=1)
    B, S = 2, 12
    toks = np.random.default_rng(5).integers(
        1, jc.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    got, aux = ttr.forward(model, tc, tb)
    want, waux = jtr.forward(jparams, jc, jb)
    close(got, want, atol=ATOL_MODEL)
    close(aux, waux, atol=ATOL_MODULE)

    with torch.inference_mode():
        glog, gcache = ttr.prefill_step(model, tc, tb)
    wlog, wcache = jtr.prefill_step(jparams, jc, jb)
    close(glog, wlog, atol=ATOL_MODEL)
    assert set(gcache) == set(wcache) == {"ckv", "krope"}
    for key in wcache:
        close(gcache[key], wcache[key], atol=ATOL_MODEL)

    T = S + 4
    cache = ttr.init_cache(tc, B, T, device=CPU)
    for key in cache:
        cache[key][:, :, :S] = gcache[key]
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, T - S), (0, 0)))
              for k, v in wcache.items()}
    jdecode = jax.jit(lambda p, c, t, n: jtr.decode_step(p, jc, c, t, n))
    nxt = np.argmax(np_(wlog)[:, -1], axis=-1).astype(np.int32)[:, None]
    cache_len = torch.tensor(S)
    for step in range(3):
        with torch.inference_mode():
            glog, out = ttr.decode_step(model, tc, cache,
                                        torch.from_numpy(nxt), cache_len)
        wlog, jcache = jdecode(jparams, jcache, jnp.asarray(nxt),
                               jnp.asarray(S + step, jnp.int32))
        assert out is cache
        close(glog, wlog, atol=ATOL_MODEL)
        for key in cache:
            close(cache[key], jcache[key], atol=ATOL_MODEL)
        nxt = np.argmax(np_(wlog)[:, 0], axis=-1).astype(np.int32)[:, None]
        cache_len = cache_len + 1


def test_decode_steps_are_teacher_forced_forward_logits():
    """Prefill 6 tokens, then decode the next 6 of the same sequence: each
    step's logits are ``forward``'s at that position (the absorbed decode
    against the rebuilt prefill; the sort dispatch is batch-invariant, so
    a one-token step routes as the prefill did), within ``ATOL_MODEL``."""
    jc, tc = configs()
    _, model = models(jc, tc, seed=2)
    B, S, P = 2, 12, 6
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, tc.vocab_size, (B, S)))
    with torch.inference_mode():
        full, _ = ttr.forward(model, tc, {"tokens": toks})
        _, pcache = ttr.prefill_step(model, tc, {"tokens": toks[:, :P]})
        cache = ttr.init_cache(tc, B, S, device=CPU)
        for key in cache:
            cache[key][:, :, :P] = pcache[key]
        for t in range(P, S):
            logits, _ = ttr.decode_step(model, tc, cache, toks[:, t:t + 1],
                                        torch.tensor(t))
            close(logits[:, 0], full[:, t], atol=ATOL_MODEL)


def test_engine_gives_the_jax_engines_tokens():
    jc, tc = configs()
    jparams, model = models(jc, tc, seed=3)
    rng = np.random.default_rng(10)
    prompts = [list(map(int, rng.integers(1, jc.vocab_size, 10)))
               for _ in range(3)]
    jeng = JServingEngine(jc, JServeConfig(max_batch=3, max_len=24),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=3, max_len=24),
                         params=model, device=CPU)
    for p in prompts:
        jeng.submit(JRequest(prompt=p, max_new_tokens=5))
        teng.submit(Request(prompt=p, max_new_tokens=5))
    assert [r.output for r in teng.run()] == [r.output for r in jeng.run()]
    assert set(teng.programs[3].cache) == {"ckv", "krope"}
    assert len(teng.stats["decode_s"]) == 4


def test_launch_serve_runs_deepseek_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--requests", "2", "--prompt-len",
                       "8", "--max-new", "3", "--device", "cpu"])
    assert [len(r.output) for r in done] == [3, 3]
    assert "2 requests, 6 tokens" in capsys.readouterr().out


# -- training -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss, metrics and gradients of the f32 smoke
    deepseek (MTP on) on a seeded batch."""
    jc, _ = configs()
    jp = redrawn(jtr.init_params(jc, jax.random.PRNGKey(0)), 0)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jp), jc,
        {"tokens": jnp.asarray(toks)})
    return jp, toks, jl, jm, jg


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_with_mtp_and_every_gradient_match_jax(jax_grads, remat):
    jp, toks, jl, jm, jg = jax_grads
    _, tc = configs(remat=remat)
    model = lm_params_from_numpy(tc, jp, device=CPU)
    tl, tm = ttr.loss_fn(model, tc, {"tokens": torch.from_numpy(toks)})
    assert set(tm) == set(jm) == {"ce_loss", "aux_loss", "mtp_loss", "loss"}
    assert rel(tl, jl) <= GRAD_RTOL
    for key in jm:
        assert rel(tm[key], jm[key]) <= GRAD_RTOL, key
    assert float(tm["mtp_loss"].detach()) > 0.0
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(tl, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    flat = dict(jax.tree_util.tree_leaves_with_path(
        ttr.params_tree(dict(zip(params, grads)))))
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        assert rel(flat[path], want) <= GRAD_RTOL, jax.tree_util.keystr(path)
    assert float(np.abs(np_(jg["mtp"]["proj"])).max()) > 0.0


def test_one_train_step_is_finite_and_accepted():
    _, tc = configs()
    model = ttr.init_params(tc, torch.Generator().manual_seed(0))
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=1))
    step = make_train_step(tc, tcfg)
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    batch = {"tokens": torch.randint(0, tc.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(1))}
    _, _, _, m = step(model, adamw_init(params, tcfg.opt),
                      pipelined_clip_init(), batch, torch.tensor(1e9))
    assert float(m["accepted"]) == 1.0
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    assert "mtp_loss" in m
    moved = [k for k, p in params.items() if not torch.equal(p, before[k])]
    assert "mtp.proj" in moved and "layers.1.moe.p.wo" in moved


# -- C25: MLA outside the MoE family -----------------------------------------

def test_dense_mla_cannot_decode_in_jax_and_the_port_refuses_it():
    """ROADMAP C25: the JAX package gives a dense config with MLA a ``{k,
    v}`` cache, and its decode step reads ``cache["ckv"]``; the port
    refuses the config at its entry points."""
    jc = jsmoke("qwen3-8b").replace(use_mla=True, q_lora_rank=32,
                                    kv_lora_rank=16, qk_nope_head_dim=8,
                                    qk_rope_head_dim=8, v_head_dim=8)
    params = jtr.init_params(jc, jax.random.PRNGKey(0))
    cache = jtr.init_cache(jc, 1, 8)
    assert set(cache) == {"k", "v"}
    with pytest.raises(KeyError, match="ckv"):
        jtr.decode_step(params, jc, cache, jnp.ones((1, 1), jnp.int32),
                        jnp.asarray(0, jnp.int32))
    tc = tsmoke("qwen3-8b").replace(use_mla=True)
    for call in (lambda: ttr.init_params(tc, torch.Generator()),
                 lambda: ttr.init_cache(tc, 1, 8, device=CPU)):
        with pytest.raises(NotImplementedError, match="C25"):
            call()
