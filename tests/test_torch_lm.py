"""The port's LM serving path (``repro_torch.models``, ``.serve``,
``.configs``, ``.launch.serve`` and the plain flash attention) held against
the JAX package on the CPU.

Weights and inputs come from numpy seeds (JAX's initial weights carried
over with ``lm_params_from_numpy``, with the norms and biases redrawn so
that none is trivially 1 or 0).  Everything is fp32 unless a case says
otherwise; the flash path runs the Pallas kernel in interpret mode on the
JAX side and the plain version on the port's.  The CUDA kernel itself runs
in tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_IDS, LATER, get_config  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402

CPU = "cpu"
ATOL_MODULE = 1e-5     # one module, fp32
ATOL_MODEL = 1e-4      # two layers and the head, fp32


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=atol)


def configs(arch, **kw):
    """The JAX and the port's smoke config of ``arch``, in fp32."""
    jc = jsmoke(arch).replace(dtype=jnp.float32, param_dtype=jnp.float32,
                              **kw)
    tc = tsmoke(arch).replace(dtype=torch.float32, param_dtype=torch.float32,
                              **kw)
    return jc, tc


#: leaves redrawn around their initial value (norm scales start at 1,
#: biases at 0)
REDRAWN = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "bq", "bk", "bv")


def models(jc, tc, seed=0):
    """JAX parameters and the port's Transformer with the same weights."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name in REDRAWN:
            a = a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(
        leaf, jtr.init_params(jc, jax.random.PRNGKey(seed)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, lm_params_from_numpy(tc, tree, device=CPU)


def layer0(jparams, key):
    return jax.tree_util.tree_map(lambda a: a[0], jparams["layers"][key])


def randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# -- the plain flash attention --------------------------------------------------

FLASH_SHAPES = [
    (1, 4, 4, 256, 64),     # MHA                   (tests/test_kernels.py)
    (2, 8, 2, 512, 64),     # GQA G = 4
    (1, 2, 1, 1024, 128),   # MQA, longer S
    (2, 6, 2, 256, 16),     # G = 3, the smoke configs' head_dim
]


def flash_inputs(shape, dtype, seed):
    B, H, K, S, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v = (randn(rng, (B, h, S, hd)) for h in (H, K, K))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tq, tk, tv = (torch.tensor(np_(a)).to(tdt) for a in (jq, jk, jv))
    return (jq, jk, jv), (tq, tk, tv), 1.0 / np.sqrt(hd)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_plain_flash_matches_jax_ref_and_pallas(shape, dtype, causal):
    (jq, jk, jv), (tq, tk, tv), scale = flash_inputs(shape, dtype, seed=3)
    got = ref.flash_attention(tq, tk, tv, scale=scale, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    want = jref.flash_attention(jq, jk, jv, scale=scale, causal=causal)
    close(got, want, atol=tol, rtol=tol)
    pallas = flash_attention_pallas(jq, jk, jv, scale=scale, causal=causal,
                                    block_q=128, block_k=128, interpret=True)
    close(got, pallas, atol=tol, rtol=tol)


def test_plain_flash_takes_ragged_sequences():
    """S = 300 is no multiple of a tile: the port's kernel takes it (the
    Pallas kernel asserts divisibility), and its plain version agrees with
    the JAX oracle there."""
    (jq, jk, jv), (tq, tk, tv), scale = flash_inputs((1, 4, 2, 300, 16),
                                                     jnp.float32, seed=5)
    for causal in (True, False):
        close(ref.flash_attention(tq, tk, tv, scale=scale, causal=causal),
              jref.flash_attention(jq, jk, jv, scale=scale, causal=causal),
              atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_ops_flash_in_model_layout_matches_jax_repeated_kv(G):
    """The port passes un-repeated (B, S, K, hd) K/V with qg (B, S, K, G,
    hd); the JAX stack passes K/V repeated to H heads with G = 1.  Same
    function."""
    B, S, K, hd = 2, 256, 2, 16
    H = K * G
    rng = np.random.default_rng(7)
    q, k, v = randn(rng, (B, S, H, hd)), randn(rng, (B, S, K, hd)), \
        randn(rng, (B, S, K, hd))
    scale = 1.0 / np.sqrt(hd)
    want = jops.flash_attention(
        jnp.asarray(q).reshape(B, S, H, 1, hd),
        jnp.repeat(jnp.asarray(k), G, axis=2),
        jnp.repeat(jnp.asarray(v), G, axis=2), scale=scale, causal=True)
    got = ops.flash_attention(torch.from_numpy(q).reshape(B, S, K, G, hd),
                              torch.from_numpy(k), torch.from_numpy(v),
                              scale=scale, causal=True)
    assert tuple(got.shape) == (B, S, H * hd)
    close(got, want, atol=2e-5, rtol=2e-5)


def test_ops_flash_checks_its_operands():
    qg = torch.zeros(1, 8, 2, 2, 16)
    kv = torch.zeros(1, 8, 2, 16)
    launches = dict(ops.LAUNCHES)
    ops.flash_attention(qg, kv, kv, scale=0.25)
    assert ops.LAUNCHES == launches           # the CPU path launches nothing
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(qg.double(), kv.double(), kv.double(), scale=1.0)
    with pytest.raises(ValueError, match="bfloat16 on cpu"):
        ops.flash_attention(qg, kv.bfloat16(), kv, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(qg.transpose(1, 2), kv, kv, scale=1.0)
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention(qg, kv[:, :4].contiguous(), kv[:, :4].contiguous(),
                            scale=1.0)
    with pytest.raises(TypeError, match="tensor"):
        ops.flash_attention(qg, np.zeros((1, 8, 2, 16)), kv, scale=1.0)


# -- the modules ------------------------------------------------------------------

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = randn(rng, (2, 7, 3, 16))
    scale = randn(rng, (16,)) + 1.0
    close(tcommon.rms_norm(torch.from_numpy(scale), torch.from_numpy(x), 1e-6),
          jcommon.rms_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6),
          atol=ATOL_MODULE)
    pos = np.stack([np.arange(7), 1000 + np.arange(7)]).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 theta),
              jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
              atol=ATOL_MODULE)
    np.testing.assert_array_equal(tcommon.rope_freqs(16, 1e6),
                                  jcommon.rope_freqs(16, 1e6))


@pytest.fixture(scope="module")
def qwen3():
    jc, tc = configs("qwen3-8b")
    jparams, model = models(jc, tc)
    return jc, tc, jparams, model


def test_lm_params_from_numpy_carries_every_weight(qwen3):
    jc, tc, jparams, model = qwen3
    assert isinstance(model, ttr.Transformer) and len(model.layers) == 2
    close(model.embed, jparams["embed"], atol=0)
    close(model.lm_head, jparams["lm_head"], atol=0)
    for i, block in enumerate(model.layers):
        for key, mod in (("attn", block.attn), ("mlp", block.mlp)):
            want = jparams["layers"][key]
            assert set(mod.p) == set(want)
            for name in want:
                close(mod.p[name], want[name][i], atol=0)
        close(block.ln1, jparams["layers"]["ln1"][i], atol=0)
    # trainable: the training path takes gradients of these
    assert all(p.requires_grad for p in model.parameters())
    # bf16 weights arrive bit-equal through their fp32 values
    w = jnp.asarray(np.random.default_rng(1).standard_normal((4, 4)),
                    jnp.bfloat16)
    tree = {"embed": np.asarray(w.astype(jnp.float32)),
            "final_norm": np.ones(4, np.float32),
            "lm_head": np.asarray(w.astype(jnp.float32)),
            "layers": jax.tree_util.tree_map(
                lambda a: np.asarray(a.astype(jnp.float32)),
                jtr.init_params(jc.replace(n_layers=1, d_model=4, n_heads=1,
                                           n_kv_heads=1, head_dim=4, d_ff=8,
                                           vocab_size=4,
                                           param_dtype=jnp.bfloat16),
                                jax.random.PRNGKey(0))["layers"])}
    tiny = lm_params_from_numpy(
        tc.replace(n_layers=1, d_model=4, n_heads=1, n_kv_heads=1,
                   head_dim=4, d_ff=8, vocab_size=4,
                   param_dtype=torch.bfloat16), tree, device=CPU)
    assert tiny.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(np_(tiny.embed),
                                  np.asarray(w.astype(jnp.float32)))


def test_dense_ffn_matches_jax(qwen3):
    jc, tc, jparams, model = qwen3
    x = randn(np.random.default_rng(2), (2, 9, jc.d_model))
    close(tmoe.dense_ffn(model.layers[0].mlp.p, torch.from_numpy(x)),
          jmoe.dense_ffn(layer0(jparams, "mlp"), jnp.asarray(x)),
          atol=ATOL_MODULE)


@pytest.mark.parametrize("branch,S,flash,q_block", [
    ("flash", 256, True, 1024),
    ("one block", 40, False, 1024),
    ("chunked", 256, False, 64),
])
def test_multihead_attention_matches_jax(qwen3, branch, S, flash, q_block):
    jc, tc, jparams, model = qwen3
    jc, tc = jc.replace(use_flash_kernel=flash), tc.replace(
        use_flash_kernel=flash)
    x = randn(np.random.default_rng(3), (2, S, jc.d_model))
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    launches = dict(ops.LAUNCHES)
    got, (gk, gv) = tattn.multihead_attention(
        model.layers[0].attn.p, torch.from_numpy(x), torch.from_numpy(pos),
        tc, q_block=q_block, return_kv=True)
    want, (wk, wv) = jattn.multihead_attention(
        layer0(jparams, "attn"), jnp.asarray(x), jnp.asarray(pos), jc,
        q_block=q_block, return_kv=True)
    assert ops.LAUNCHES == launches
    assert tuple(gk.shape) == (2, S, jc.n_kv_heads, jc.hd)
    close(got, want, atol=ATOL_MODULE)
    close(gk, wk, atol=ATOL_MODULE)
    close(gv, wv, atol=ATOL_MODULE)


def test_decode_attention_matches_jax_and_writes_the_cache_in_place(qwen3):
    jc, tc, jparams, model = qwen3
    rng = np.random.default_rng(4)
    B, T, cache_len = 2, 12, 5
    x = randn(rng, (B, 1, jc.d_model))
    kc = randn(rng, (B, T, jc.n_kv_heads, jc.hd))
    vc = randn(rng, (B, T, jc.n_kv_heads, jc.hd))
    pos = np.full((B,), cache_len, np.int32)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, gk, gv = tattn.decode_attention(
        model.layers[0].attn.p, torch.from_numpy(x), torch.from_numpy(pos),
        tk, tv, cache_len, tc)
    want, wk, wv = jattn.decode_attention(
        layer0(jparams, "attn"), jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cache_len, jnp.int32),
        jc)
    assert gk is tk and gv is tv
    close(got, want, atol=ATOL_MODULE)
    close(gk, wk, atol=ATOL_MODULE)
    close(gv, wv, atol=ATOL_MODULE)
    np.testing.assert_array_equal(np_(gk)[:, cache_len + 1:],
                                  kc[:, cache_len + 1:])


# -- the model -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2.5-32b"])
@pytest.mark.parametrize("S,flash", [(24, False), (256, True)])
def test_forward_prefill_and_decode_match_jax(arch, S, flash):
    jc, tc = configs(arch, use_flash_kernel=flash)
    jparams, model = models(jc, tc, seed=1)
    rng = np.random.default_rng(5)
    B = 2
    toks = rng.integers(1, jc.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}

    got, aux = ttr.forward(model, tc, tb)
    want, _ = jtr.forward(jparams, jc, jb)
    close(got, want, atol=ATOL_MODEL)
    assert float(aux) == 0.0
    close(model(tb["tokens"]), want, atol=ATOL_MODEL)

    glog, gcache = ttr.prefill_step(model, tc, tb)
    wlog, wcache = jtr.prefill_step(jparams, jc, jb)
    close(glog, wlog, atol=ATOL_MODEL)
    for key in ("k", "v"):
        assert tuple(gcache[key].shape) == tuple(wcache[key].shape)
        close(gcache[key], wcache[key], atol=ATOL_MODEL)

    T = S + 4
    cache = ttr.init_cache(tc, B, T, device=CPU)
    for key in ("k", "v"):
        cache[key][:, :, :S] = gcache[key]
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, T - S), (0, 0), (0, 0)))
              for k, v in wcache.items()}
    nxt = np.argmax(np_(wlog)[:, -1], axis=-1).astype(np.int32)[:, None]
    for step in range(2):
        glog, cache = ttr.decode_step(model, tc, cache,
                                      torch.from_numpy(nxt), S + step)
        wlog, jcache = jtr.decode_step(jparams, jc, jcache,
                                       jnp.asarray(nxt),
                                       jnp.asarray(S + step, jnp.int32))
        close(glog, wlog, atol=ATOL_MODEL)
        for key in ("k", "v"):
            close(cache[key], jcache[key], atol=ATOL_MODEL)
        nxt = np.argmax(np_(wlog)[:, 0], axis=-1).astype(np.int32)[:, None]


# -- the engine ------------------------------------------------------------------

def test_engine_gives_the_jax_engines_tokens():
    """fp32, the flash path, 256-token prompts, 4 new tokens: the same
    greedy tokens from both engines."""
    jc, tc = configs("qwen3-8b", use_flash_kernel=True)
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
    assert len(teng.stats["prefill_s"]) == 1
    assert len(teng.stats["decode_s"]) == 3


def test_engine_refuses_to_decode_past_max_len():
    """An 8-token prompt and 8 new tokens need 15 cache rows.  At max_len
    10 the JAX engine clamps its cache write and goes on; this engine
    raises before the prefill.  At max_len 15 both give the same tokens."""
    jc, tc = configs("qwen3-8b")
    jparams, model = models(jc, tc, seed=3)
    prompt = list(map(int, np.random.default_rng(7).integers(
        1, jc.vocab_size, 8)))
    short = ServingEngine(tc, ServeConfig(max_batch=1, max_len=10),
                          params=model, device=CPU)
    short.submit(Request(prompt=prompt, max_new_tokens=8))
    with pytest.raises(ValueError, match="8 tokens and 8 new tokens need "
                                         "15 cache rows; max_len is 10"):
        short.run()
    assert short.stats["prefill_s"] == []
    jeng = JServingEngine(jc, JServeConfig(max_batch=1, max_len=15),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=1, max_len=15),
                         params=model, device=CPU)
    jeng.submit(JRequest(prompt=prompt, max_new_tokens=8))
    teng.submit(Request(prompt=prompt, max_new_tokens=8))
    want = jeng.run()[0].output
    got = teng.run()[0].output
    assert len(want) == 8 and got == want


def test_serving_engine_batches_and_decodes():
    cfg = tsmoke("qwen3-8b")
    eng = ServingEngine(cfg, ServeConfig(max_batch=3, max_len=64),
                        device=CPU)
    rng = np.random.default_rng(0)
    for i in range(5):
        plen = 8 if i < 3 else 12
        eng.submit(Request(prompt=list(rng.integers(1, 200, plen)),
                           max_new_tokens=6))
    done = eng.run()
    assert len(done) == 5
    assert len(eng.stats["prefill_s"]) == 2       # one bucket per length
    for r in done:
        assert len(r.output) == 6
        assert all(0 <= t < cfg.vocab_size for t in r.output)


def test_serving_matches_teacher_forcing():
    """Engine greedy decode == argmax of teacher-forced forward."""
    cfg = tsmoke("phi3-mini-3.8b")
    eng = ServingEngine(cfg, ServeConfig(max_batch=1, max_len=64),
                        device=CPU)
    prompt = list(range(1, 11))
    eng.submit(Request(prompt=prompt, max_new_tokens=4))
    out = eng.run()[0].output

    toks = list(prompt)
    for i in range(4):
        logits, _ = ttr.forward(eng.params, cfg,
                                {"tokens": torch.tensor([toks])})
        nxt = int(logits[0, -1].argmax())
        assert nxt == out[i], (i, nxt, out)
        toks.append(nxt)


def test_engine_stops_at_eos():
    cfg = tsmoke("qwen3-8b")
    eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=32),
                        device=CPU)
    eng.submit(Request(prompt=[3, 4, 5], max_new_tokens=8))
    first = eng.run()[0].output
    eos = ServingEngine(cfg, ServeConfig(max_batch=2, max_len=32,
                                         eos_id=first[2]), device=CPU)
    eos.submit(Request(prompt=[3, 4, 5], max_new_tokens=8))
    out = eos.run()[0].output
    stop = first.index(first[2], 1)      # the first eos after the prefill's
    assert out == first[:stop]


def test_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tsmoke("qwen3-8b"), ServeConfig())
    model = ttr.init_params(tsmoke("qwen3-8b"), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tsmoke("qwen3-8b"), ServeConfig(), params=model)


def test_launch_serve_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "qwen2.5-32b", "--requests", "3",
                       "--prompt-len", "8", "--max-new", "3",
                       "--device", "cpu"])
    assert [len(r.output) for r in done] == [3, 3, 3]
    assert "3 requests, 9 tokens" in capsys.readouterr().out


# -- configs and the families of later slices ---------------------------------------

def test_dense_configs_equal_the_jax_ones():
    from repro.configs import get_config as jget
    dtypes = {"dtype", "param_dtype"}
    for arch in ("qwen3-8b", "phi3-mini-3.8b", "qwen2.5-32b",
                 "qwen1.5-110b", "llama4-scout-17b-a16e"):
        for full in (True, False):
            t = get_config(arch) if full else tsmoke(arch)
            j = jget(arch) if full else jsmoke(arch)
            assert {f.name: getattr(t, f.name)
                    for f in dataclasses.fields(t) if f.name not in dtypes} \
                == {f.name: getattr(j, f.name)
                    for f in dataclasses.fields(j) if f.name not in dtypes}
            assert t.dtype == t.param_dtype == torch.bfloat16
            assert not t.use_flash_kernel


@pytest.mark.parametrize("arch", ["qwen2-vl-72b"])
def test_later_families_name_their_slice(arch):
    """The VLM was the last architecture of a later slice: ``LATER`` is
    empty, and its configs, full and smoke, come out of the registry; the
    smoke one builds its model and its ``{"k", "v"}`` cache."""
    assert arch in ARCH_IDS and not LATER
    assert get_config(arch).family == tsmoke(arch).family == "vlm"
    cfg = tsmoke(arch)
    model = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    assert len(model.layers) == cfg.n_layers
    assert "bq" in model.layers[0].attn.p
    cache = ttr.init_cache(cfg, 1, 8, device=CPU)
    assert {k: tuple(v.shape) for k, v in cache.items()} == dict.fromkeys(
        ("k", "v"), (cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.hd))


@pytest.mark.parametrize("change,word", [
    (dict(family="vlm"), "VLM"),
    (dict(use_mla=True), "C25"),       # MLA outside the MoE family
    (dict(mrope_sections=(2, 3, 3)), "VLM"),
])
def test_model_entry_points_refuse_later_families(change, word):
    """MLA outside the MoE family is refused (C25).  The VLM family and
    M-RoPE, refused until the VLM slice, now build their params and their
    cache (the dense family's)."""
    cfg = tsmoke("qwen3-8b").replace(**change)
    if word == "C25":
        with pytest.raises(NotImplementedError, match=word):
            ttr.init_params(cfg, torch.Generator())
        with pytest.raises(NotImplementedError, match=word):
            ttr.init_cache(cfg, 1, 8, device=CPU)
        return
    model = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    assert len(model.layers) == cfg.n_layers
    cache = ttr.init_cache(cfg, 1, 8, device=CPU)
    assert {k: tuple(v.shape) for k, v in cache.items()} == dict.fromkeys(
        ("k", "v"), (cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.hd))
