"""The port's MoE family (``repro_torch.models.moe`` and the ``moe`` blocks of
``models.transformer``, llama4-scout's config, ``convert``) held against the
JAX package on the CPU.

Inputs and weights come from numpy seeds (JAX's initial weights carried
over with ``lm_params_from_numpy``, the norms redrawn around 1 and the
router's bias around 0, so that selection and weighting differ).
Everything is fp32 on llama4-scout's smoke config unless a case says
otherwise.  Tolerances: one module 1e-5 (``ATOL_MODULE``), two layers and
the head 1e-4 (``ATOL_MODEL``), the loss and every gradient 1e-5 of the
largest (``GRAD_RTOL``), bf16 2e-2 (tests/test_kernels.py's bf16 bar).
Both packages' ``moe_ffn`` are plain array code, so JAX runs directly
(its sort dispatch through ``jax.lax.ragged_dot``).
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import newton_krylov as jnk  # noqa: E402
from repro.optim import pipelined_clip_init as jclip_init  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import restore_pytree as jrestore  # noqa: E402
from repro.train import train as jtrain  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, make_dataset  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim import newton_krylov as tnk  # noqa: E402
from repro_torch.optim import pipelined_clip_init  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.train import TrainConfig, load_state_tree  # noqa: E402
from repro_torch.train import make_train_step, state_tree, train  # noqa: E402
from repro_torch.train.checkpoint import restore_pytree  # noqa: E402

ARCH = "llama4-scout-17b-a16e"
CPU = "cpu"
ATOL_MODULE = 1e-5     # one module, fp32
ATOL_MODEL = 1e-4      # two layers and the head, fp32
GRAD_RTOL = 1e-5       # the loss and every gradient, of the largest
LOSS_RTOL = 1e-5       # AdamW steps after a restore, fp32
BF16_TOL = 2e-2        # tests/test_kernels.py's bf16 bar


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=atol)


def rel(got, want) -> float:
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(**kw):
    """The JAX and the port's llama4 smoke config, in fp32."""
    jc = jsmoke(ARCH).replace(dtype=jnp.float32, param_dtype=jnp.float32,
                              **kw)
    tc = tsmoke(ARCH).replace(dtype=torch.float32, param_dtype=torch.float32,
                              **kw)
    return jc, tc


#: leaves redrawn around their initial value, and by how much
REDRAWN = {"ln1": 0.3, "ln2": 0.3, "final_norm": 0.3, "router_bias": 0.05}


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def models(jc, tc, seed=0):
    """JAX parameters and the port's Transformer with the same weights."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        scale = REDRAWN.get(path[-1].key)
        if scale:
            a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(
        leaf, jtr.init_params(jc, jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        lm_params_from_numpy(tc, tree, device=CPU)


def moe_params(jc, seed=0):
    """One MoE layer's JAX parameters (numpy, f32) with a redrawn bias."""
    p = numpy_tree(jmoe.init_moe_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    p["router_bias"] = (0.05 * rng.standard_normal(
        p["router_bias"].shape)).astype(np.float32)
    return p


def both(p, dtype=torch.float32):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()).to(
                torch.float32 if k.startswith("router") else dtype)
             for k, v in p.items()})


def randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# -- routing and dispatch -----------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_jax(top_k):
    jc, tc = configs(moe_top_k=top_k)
    jp, tp = both(moe_params(jc))
    x = randn(np.random.default_rng(1), (128, jc.d_model))
    gp, ge, ga = tmoe._route(tp, torch.from_numpy(x), tc)
    wp, we, wa = jmoe._route(jp, jnp.asarray(x), jc)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    close(gp, wp, atol=ATOL_MODULE)
    close(ga, wa, atol=ATOL_MODULE)
    # the bias moves the selection: some token's first choice is not the
    # expert of its largest score
    scores = torch.softmax(torch.from_numpy(x) @ tp["router"], dim=-1)
    assert (ge[:, 0] != scores.argmax(-1)).any()


def test_route_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` takes the lower index among equal scores: a router
    with two equal columns picks the first of them, in both packages."""
    jc, tc = configs(moe_top_k=2)
    p = moe_params(jc)
    p["router"][:, 3] = p["router"][:, 1]
    p["router_bias"][:] = 0.0
    jp, tp = both(p)
    x = randn(np.random.default_rng(2), (64, jc.d_model))
    _, ge, _ = tmoe._route(tp, torch.from_numpy(x), tc)
    _, we, _ = jmoe._route(jp, jnp.asarray(x), jc)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    tied = (ge == 1).any(-1) | (ge == 3).any(-1)
    assert tied.any()
    # where the tied pair is the top two, expert 1 comes first
    pair = (ge[:, 0] == 1) & (ge[:, 1] == 3)
    assert pair.any() and not ((ge[:, 0] == 3) & (ge[:, 1] == 1)).any()


def test_route_rounds_the_router_to_the_activations_dtype():
    """bf16 activations: the f32 router is rounded to bf16 and the product
    summed in f32, as the JAX package's einsum does; the same product with
    the router left in f32 misses the JAX scores by far more."""
    jc, tc = configs()
    jc, tc = jc.replace(dtype=jnp.bfloat16), tc.replace(dtype=torch.bfloat16)
    p = moe_params(jc)
    jp, tp = both(p)
    x = jnp.asarray(randn(np.random.default_rng(3), (256, jc.d_model)),
                    jnp.bfloat16)
    tx = torch.from_numpy(np_(x)).to(torch.bfloat16)
    gp, ge, _ = tmoe._route(tp, tx, tc)
    wp, we, _ = jmoe._route(jp, x, jc)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    assert rel(gp, wp) <= 1e-6
    unrounded = torch.softmax(tx.float() @ tp["router"], dim=-1)
    want = jax.nn.softmax(jnp.einsum(
        "nd,de->ne", x, jp["router"].astype(jnp.bfloat16),
        preferred_element_type=jnp.float32), axis=-1)
    got = torch.softmax(tx.float() @ tp["router"].bfloat16().float(), dim=-1)
    assert rel(got, want) <= 1e-6
    assert rel(unrounded, want) > 1e-4


@pytest.mark.parametrize("cf", [0.5, 1.25, 16])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("impl", ["gather", "sort"])
def test_moe_ffn_matches_jax(impl, top_k, groups, cf):
    jc, tc = configs(moe_top_k=top_k, moe_groups=groups,
                     moe_capacity_factor=cf)
    jp, tp = both(moe_params(jc, seed=top_k))
    x = randn(np.random.default_rng(4), (2, 64, jc.d_model))
    y, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tc, impl=impl)
    wy, waux = jmoe.moe_ffn(jp, jnp.asarray(x), jc, impl=impl)
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32
    close(y, wy, atol=ATOL_MODULE)
    close(aux, waux, atol=ATOL_MODULE)
    # the capacity regime this case covers
    _, experts, _ = tmoe._route(tp, torch.from_numpy(x).reshape(-1, 64), tc)
    _, keep = tmoe.slots(experts, tc)
    if cf == 0.5:
        assert not keep.all()           # tokens really drop in gather
    if cf == 16:
        assert keep.all()


def test_capacity_is_the_jax_arithmetic():
    cfg = get_config(ARCH)
    assert tmoe.capacity(4096, cfg) == (256, 16, 4)    # a 4 x 1,024 prefill
    assert tmoe.capacity(4, cfg) == (4, 1, 1)          # a decode step of 4
    assert tmoe.capacity(4096, cfg.replace(
        moe_capacity_factor=cfg.moe_experts)) == (256, 16, 16)
    assert tmoe.capacity(96, cfg.replace(moe_groups=5)) == (2, 48, 4)


@pytest.mark.parametrize("impl", ["gather", "sort"])
def test_moe_ffn_in_bf16_matches_jax(impl):
    jc, tc = configs(moe_top_k=2)
    jc = jc.replace(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tc = tc.replace(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    p = moe_params(jc)
    for k in p:                  # the experts' weights as bf16 values
        if not k.startswith("router"):
            p[k] = np_(jnp.asarray(p[k], jnp.bfloat16))
    jp, tp = both(p, torch.bfloat16)
    jp = {k: v if k.startswith("router") else v.astype(jnp.bfloat16)
          for k, v in jp.items()}
    assert tp["router"].dtype == torch.float32
    x = jnp.asarray(randn(np.random.default_rng(5), (2, 32, jc.d_model)),
                    jnp.bfloat16)
    y, _ = tmoe.moe_ffn(tp, torch.from_numpy(np_(x)).bfloat16(), tc,
                        impl=impl)
    wy, _ = jmoe.moe_ffn(jp, x, jc, impl=impl)
    assert y.dtype == torch.bfloat16
    assert rel(y, wy) <= BF16_TOL


def test_unknown_impl_raises():
    """The JAX package takes gather for any string but "sort"; the port
    refuses (ROADMAP C)."""
    jc, tc = configs()
    _, tp = both(moe_params(jc))
    with pytest.raises(ValueError, match="gather | sort"):
        tmoe.moe_ffn(tp, torch.zeros(1, 4, 64), tc, impl="ragged")


def test_sort_dispatch_is_batch_invariant():
    """The port of tests/test_arch_smoke.py::test_moe_dispatch_batch_
    invariance: an input stream biased along the router's first singular
    direction oversubscribes one expert past gather's capacity; the
    dropless sort dispatch gives each token the output it gets alone, the
    gather dispatch does not."""
    cfg = tsmoke(ARCH).replace(moe_top_k=2, moe_experts=8)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(3), cfg)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 32, cfg.d_model, generator=g)
    u = torch.from_numpy(np.linalg.svd(p["router"].double().numpy(),
                                       full_matrices=False)[0][:, 0])
    x = (x + 2.0 * u.float()[None, None, :]).to(cfg.dtype)
    _, experts, _ = tmoe._route(p, x.reshape(-1, cfg.d_model), cfg)
    loads = torch.bincount(experts.reshape(-1), minlength=cfg.moe_experts)
    G, n, C = tmoe.capacity(64, cfg)
    assert G == 1 and int(loads.max()) > C, (loads, C)

    y_batch, _ = tmoe.moe_ffn(p, x, cfg, impl="sort")
    y_tok = torch.cat([tmoe.moe_ffn(p, x[:, i:i + 1], cfg, impl="sort")[0]
                       for i in range(32)], dim=1)
    close(y_batch, y_tok, atol=2e-2, rtol=2e-2)
    yg_batch, _ = tmoe.moe_ffn(p, x, cfg, impl="gather")
    yg_tok = torch.cat([tmoe.moe_ffn(p, x[:, i:i + 1], cfg,
                                     impl="gather")[0] for i in range(32)],
                       dim=1)
    assert float((yg_batch.float() - yg_tok.float()).abs().max()) > 1e-3


def test_gather_reads_nothing_back_to_the_host(monkeypatch):
    """The gather path's shapes come from the config and the token count:
    a call makes no host read (``.tolist()`` / ``.item()``).  Nor does the
    sort path's own code: its only reads are the plain grouped product's,
    the CPU path of the kernel, one of the offsets per expert product
    (three); on the card the kernel reads them on the device."""
    jc, tc = configs(moe_groups=4)
    _, tp = both(moe_params(jc))
    reads = []
    for name in ("tolist", "item"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            reads.append((_name, sys._getframe(1).f_code.co_name))
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    x = torch.from_numpy(randn(np.random.default_rng(6), (4, 1, 64)))
    tmoe.moe_ffn(tp, x, tc, impl="gather")
    assert reads == []
    tmoe.moe_ffn(tp, x, tc, impl="sort")
    assert reads == [("tolist", "plain")] * 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("experts", [16, 256])
def test_sort_dispatch_at_deepseeks_top_k_matches_jax(experts, dtype):
    """The dropless dispatch at deepseek-v3's top-8, over 16 and 256
    experts (most of them empty at 256), against the JAX package's
    ``ragged_dot`` dispatch: fp32 within ``ATOL_MODULE``, bf16 within
    ``BF16_TOL`` of the max-abs."""
    jc, tc = configs(moe_top_k=8, moe_experts=experts)
    p = moe_params(jc, seed=experts)
    tdt = torch.float32
    if dtype == "bfloat16":
        jc = jc.replace(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        tc = tc.replace(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        tdt = torch.bfloat16
        for k in p:              # the experts' weights as bf16 values
            if not k.startswith("router"):
                p[k] = np_(jnp.asarray(p[k], jnp.bfloat16))
    jp, tp = both(p, tdt)
    if dtype == "bfloat16":
        jp = {k: v if k.startswith("router") else v.astype(jnp.bfloat16)
              for k, v in jp.items()}
    x = jnp.asarray(randn(np.random.default_rng(7), (2, 24, jc.d_model)),
                    jc.dtype)
    y, aux = tmoe.moe_ffn(tp, torch.from_numpy(np_(x)).to(tdt), tc,
                          impl="sort")
    wy, waux = jmoe.moe_ffn(jp, x, jc, impl="sort")
    assert y.dtype == tdt
    if dtype == "float32":
        close(y, wy, atol=ATOL_MODULE)
        close(aux, waux, atol=ATOL_MODULE)
    else:
        assert rel(y, wy) <= BF16_TOL


def test_sort_dispatch_is_batch_invariant_at_top_8():
    """The batch invariance above at deepseek-v3's top-8 of 32 experts:
    the dropless dispatch gives each token its output alone."""
    cfg = tsmoke(ARCH).replace(moe_top_k=8, moe_experts=32)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(5), cfg)
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(6)).to(cfg.dtype)
    y_batch, _ = tmoe.moe_ffn(p, x, cfg, impl="sort")
    y_tok = torch.cat([tmoe.moe_ffn(p, x[:, i:i + 1], cfg, impl="sort")[0]
                       for i in range(16)], dim=1)
    close(y_batch, y_tok, atol=2e-2, rtol=2e-2)


# -- the model ----------------------------------------------------------------

def test_init_params_and_cache_run_the_moe_family():
    cfg = tsmoke(ARCH)
    model = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    block = model.layers[0]
    assert not hasattr(block, "mlp") and isinstance(block.moe, tmoe.MoEFFN)
    p = block.moe.p
    assert p["router"].dtype == p["router_bias"].dtype == torch.float32
    assert p["wi"].dtype == torch.bfloat16
    E, d, ff = cfg.moe_experts, cfg.d_model, cfg.d_ff
    assert tuple(p["wi"].shape) == tuple(p["wg"].shape) == (E, d, ff)
    assert tuple(p["wo"].shape) == (E, ff, d)
    assert tuple(p["shared_wi"].shape) == (d, ff * cfg.moe_shared_experts)
    assert not p["router_bias"].detach().any()
    # the experts' weights are scaled by their own fan-in, not by E
    assert 0.5 < float(p["wi"].float().std()) * d ** 0.5 < 2.0
    assert 0.5 < float(p["wo"].float().std()) * ff ** 0.5 < 2.0
    names = dict(model.named_parameters())
    assert ttr.param_path("layers.1.moe.p.wi") == (("layers", "moe", "wi"),
                                                   1)
    assert "layers.1.moe.p.router_bias" in names
    cache = ttr.init_cache(cfg, 2, 8, device=CPU)
    assert set(cache) == {"k", "v"}
    assert tuple(cache["k"].shape) == (2, 2, 8, cfg.n_kv_heads, cfg.hd)


def test_lm_params_from_numpy_keeps_the_router_in_f32():
    """bf16 parameters: the router and its bias stay f32, as the JAX
    package keeps them; every leaf carries over bit for bit."""
    jc = jsmoke(ARCH)
    tc = tsmoke(ARCH)
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    assert jp["layers"]["moe"]["router"].dtype == jnp.float32
    tree = numpy_tree(jp)
    model = lm_params_from_numpy(tc, tree, device=CPU)
    for i, block in enumerate(model.layers):
        for name, t in block.moe.p.items():
            want = tree["layers"]["moe"][name][i]
            assert t.dtype == (torch.float32 if name.startswith("router")
                               else torch.bfloat16), name
            np.testing.assert_array_equal(np_(t), want, err_msg=name)
    f64 = lm_params_from_numpy(tc, tree, device=CPU, dtype=torch.float64)
    assert f64.layers[0].moe.p["router"].dtype == torch.float64


@pytest.mark.parametrize("impl", ["gather", "sort"])
@pytest.mark.parametrize("S,flash", [(24, False), (256, True)])
def test_forward_prefill_and_decode_match_jax(S, flash, impl):
    jc, tc = configs(use_flash_kernel=flash, moe_impl=impl)
    jparams, model = models(jc, tc, seed=1)
    rng = np.random.default_rng(5)
    B = 2
    toks = rng.integers(1, jc.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}

    got, aux = ttr.forward(model, tc, tb)
    want, waux = jtr.forward(jparams, jc, jb)
    close(got, want, atol=ATOL_MODEL)
    close(aux, waux, atol=ATOL_MODULE)
    assert float(aux.detach()) > 0.0

    glog, gcache = ttr.prefill_step(model, tc, tb)
    wlog, wcache = jtr.prefill_step(jparams, jc, jb)
    close(glog, wlog, atol=ATOL_MODEL)
    assert set(gcache) == set(wcache) == {"k", "v"}
    for key in ("k", "v"):
        close(gcache[key], wcache[key], atol=ATOL_MODEL)

    T = S + 4
    cache = ttr.init_cache(tc, B, T, device=CPU)
    for key in ("k", "v"):
        cache[key][:, :, :S] = gcache[key]
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, T - S), (0, 0), (0, 0)))
              for k, v in wcache.items()}
    nxt = np.argmax(np_(wlog)[:, -1], axis=-1).astype(np.int32)[:, None]
    for step in range(3):
        glog, cache = ttr.decode_step(model, tc, cache,
                                      torch.from_numpy(nxt), S + step)
        wlog, jcache = jtr.decode_step(jparams, jc, jcache,
                                       jnp.asarray(nxt),
                                       jnp.asarray(S + step, jnp.int32))
        close(glog, wlog, atol=ATOL_MODEL)
        for key in ("k", "v"):
            close(cache[key], jcache[key], atol=ATOL_MODEL)
        nxt = np.argmax(np_(wlog)[:, 0], axis=-1).astype(np.int32)[:, None]


def test_engine_gives_the_jax_engines_tokens():
    """fp32, the flash path, 256-token prompts, 4 new tokens: the same
    greedy tokens from both engines.  (The gather dispatch is
    batch-competitive, so a prefill may drop a token that a one-token
    decode keeps: serving is not held to teacher forcing, ROADMAP C23.)"""
    jc, tc = configs(use_flash_kernel=True)
    jparams, model = models(jc, tc, seed=2)
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(1, jc.vocab_size, 256)))
               for _ in range(3)]
    jeng = JServingEngine(jc, JServeConfig(max_batch=3, max_len=264),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=3, max_len=264),
                         params=model, device=CPU)
    for p in prompts:
        jeng.submit(JRequest(prompt=p, max_new_tokens=4))
        teng.submit(Request(prompt=p, max_new_tokens=4))
    want = [r.output for r in jeng.run()]
    got = [r.output for r in teng.run()]
    assert got == want
    assert len(teng.stats["decode_s"]) == 3


def test_launch_serve_runs_llama4_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--requests", "3", "--prompt-len",
                       "8", "--max-new", "3", "--device", "cpu"])
    assert [len(r.output) for r in done] == [3, 3, 3]
    assert "3 requests, 9 tokens" in capsys.readouterr().out


def test_llama4_config_equals_the_jax_one():
    import dataclasses
    for t, j in ((get_config(ARCH), jget(ARCH)), (tsmoke(ARCH), jsmoke(ARCH))):
        fields = [f.name for f in dataclasses.fields(t)
                  if f.name not in ("dtype", "param_dtype")]
        assert {f: getattr(t, f) for f in fields} == \
            {f: getattr(j, f) for f in fields}
    assert get_config(ARCH).family == "moe"


# -- training -----------------------------------------------------------------

@pytest.fixture(scope="module", params=["gather", "sort"])
def jax_grads(request):
    """The JAX package's loss and gradients of the f32 smoke llama4 on a
    seeded batch, per dispatch."""
    jc, _ = configs(moe_impl=request.param)
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jp, jc, {"tokens": jnp.asarray(toks)})
    return request.param, numpy_tree(jp), toks, jl, jm, jg


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_every_gradient_match_jax(jax_grads, remat):
    impl, jp, toks, jl, jm, jg = jax_grads
    _, tc = configs(remat=remat, moe_impl=impl)
    model = lm_params_from_numpy(tc, jp, device=CPU)
    tl, tm = ttr.loss_fn(model, tc, {"tokens": torch.from_numpy(toks)})
    assert rel(tl, jl) <= GRAD_RTOL
    assert set(tm) == set(jm)
    for key in ("ce_loss", "aux_loss", "loss"):
        assert rel(tm[key], jm[key]) <= GRAD_RTOL, key
    assert float(tm["aux_loss"].detach()) > 0.0
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(tl, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    flat = dict(jax.tree_util.tree_leaves_with_path(
        ttr.params_tree(dict(zip(params, grads)))))
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        assert rel(flat[path], want) <= GRAD_RTOL, jax.tree_util.keystr(path)
    # the bias moves the selection only: no gradient in either package
    assert float(np.abs(np_(jg["layers"]["moe"]["router_bias"])).max()) == 0


DATA = dict(batch_size=2, seq_len=16, seed=3)
OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=5)


def test_moe_checkpoint_crosses_both_ways(tmp_path):
    """The JAX package trains the smoke llama4 2 steps and checkpoints; the
    port resumes from that checkpoint (the MoE leaves, the router's bias
    with its zero gradient included) and its step 2 loss is the JAX run's;
    the JAX package restores the port's checkpoint bit for bit."""
    jc, tc = configs()
    jdir = tmp_path / "jax"
    jout = jtrain(jc, JDataConfig(vocab_size=jc.vocab_size, **DATA),
                  JTrainConfig(steps=3, ckpt_every=2, ckpt_dir=str(jdir),
                               opt=JAdamWConfig(**OPT)))
    mine = tmp_path / "port"
    mine.mkdir()
    for suffix in (".npz", ".json"):
        (mine / f"step_00000002{suffix}").write_bytes(
            (jdir / f"step_00000002{suffix}").read_bytes())
    out = train(tc, DataConfig(vocab_size=tc.vocab_size, **DATA),
                TrainConfig(steps=3, ckpt_every=1, ckpt_dir=str(mine),
                            opt=AdamWConfig(**OPT)), device=CPU)
    assert out["start_step"] == 2
    assert [h["step"] for h in out["history"]] == [2]
    np.testing.assert_allclose([out["history"][0]["loss"]],
                               [jout["history"][2]["loss"]], rtol=LOSS_RTOL)

    jparams = jtr.init_params(jc, jax.random.PRNGKey(0))
    tpl = {"params": jparams, "opt": jadamw_init(jparams,
                                                 JAdamWConfig(**OPT)),
           "clip": jclip_init()}
    restored, at = jrestore(tpl, mine)
    assert at == 3
    model = out["params"]
    ptpl = state_tree(model, adamw_init(dict(model.named_parameters()),
                                        AdamWConfig(**OPT)),
                      pipelined_clip_init())
    tree, _ = restore_pytree(ptpl, mine)
    port_state = state_tree(model, *load_state_tree(model, tree))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(np.asarray, restored)),
            jax.tree_util.tree_leaves_with_path(port_state)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=str(path))
    # the JAX step-2 state carried over in memory steps as the port's
    # restore of the same checkpoint did, bit for bit
    jstate, _ = jrestore(tpl, jdir, step=2)
    state = train_state_from_numpy(
        tc, jax.tree_util.tree_map(np.asarray, jstate), device=CPU)
    assert state["opt"]["m"]["layers.0.moe.p.router"].dtype == torch.float32
    step = make_train_step(tc, TrainConfig(opt=AdamWConfig(**OPT)))
    batch = {k: torch.from_numpy(v) for k, v in make_dataset(DataConfig(
        vocab_size=tc.vocab_size, **DATA))(2).items()}
    _, _, _, m = step(state["params"], state["opt"], state["clip"], batch,
                      torch.tensor(1e9))
    assert float(m["loss"]) == out["history"][0]["loss"]


@pytest.fixture(scope="module")
def llama4_one_layer():
    jc, tc = configs(n_layers=1)
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tc, numpy_tree(jp), device=CPU)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    return jc, tc, jp, model, toks


def test_ggn_matvec_matches_jax_on_one_layer_llama4(llama4_one_layer):
    jc, tc, jp, model, toks = llama4_one_layer
    jmv, jflat, _ = jnk.make_ggn_matvec(
        lambda p, b: jforward(p, jc, b)[0], jp, {"tokens": jnp.asarray(toks)},
        1e-2)
    tmv, tflat, _ = tnk.make_ggn_matvec(
        lambda p, b: ttr.forward(p, tc, b)[0], model,
        {"tokens": torch.from_numpy(toks)}, 1e-2)
    v = np.random.default_rng(2).standard_normal(jflat.shape).astype(
        np.float32)
    assert rel(tmv(torch.from_numpy(v)), jmv(jnp.asarray(v))) <= 1e-5


def test_newton_krylov_step_lowers_the_loss_of_one_layer_llama4(
        llama4_one_layer):
    import copy
    jc, tc, jp, model, toks = llama4_one_layer
    model = copy.deepcopy(model)
    tb = {"tokens": torch.from_numpy(toks)}
    before = ttr.loss_fn(model, tc, tb)[0].item()
    _, tm = tnk.newton_krylov_step(
        lambda p, b: ttr.loss_fn(p, tc, b)[0],
        lambda p, b: ttr.forward(p, tc, b)[0], model, tb,
        tnk.NewtonKrylovConfig(damping=1e-2, inner_maxiter=10,
                               inner_tol=1e-2, lr=0.5))
    after = ttr.loss_fn(model, tc, tb)[0].item()
    assert 0 < int(tm["inner_iters"]) <= 10
    assert np.isfinite(after) and after < before
