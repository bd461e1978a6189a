"""The serving engine's decode program (``repro_torch.serve.engine``'s
:class:`DecodeProgram`, ``decode_step`` with ``cache_len`` on the device)
held against the JAX package on the CPU.

The JAX engine compiles its decode step once, ``cache_len`` traced; the
port's step takes ``cache_len`` as a 0-d integer tensor and never reads it
on the host, so on the card it captures as one CUDA graph (that capture
runs in tests/test_torch_cuda.py and chip_smoke.py).  Here: several
consecutive steps against the JAX ``decode_step`` under ``jax.jit`` with a
traced ``jnp.int32`` ``cache_len`` (dense, MoE gather, MoE sort, a sliding
window, deepseek's MLA with its latent cache, the hybrid zamba2 with a
window of 8, so that its rings roll at every step, the SSM xlstm,
whose cache is its pairs' state, and the audio whisper, whose decoder
reads its learned positions at ``cache_len`` and the encoder's K/V under a
device ``enc_len``, and the VLM qwen2-vl, whose M-RoPE takes ``cache_len``
on all three streams), the step traced by
``make_fx`` in fake mode (no host read left, the MoE sort dispatch's
grouped product included), the in-place splice across batches, and the
engine's choice of graph or eager.  Weights and inputs come from numpy
seeds; everything is fp32; two layers and the head within 1e-4
(``ATOL_MODEL``, tests/test_torch_lm.py's bar).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.core.program import _eager_chunks  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.engine import decode_program_mode  # noqa: E402

CPU = "cpu"
ATOL_MODEL = 1e-4      # two layers and the head, fp32

#: case -> (arch, config changes)
CASES = {
    "dense": ("qwen3-8b", {}),
    "moe-gather": ("llama4-scout-17b-a16e", {"moe_impl": "gather"}),
    "moe-sort": ("llama4-scout-17b-a16e", {"moe_impl": "sort"}),
    "sliding-window": ("qwen3-8b", {"sliding_window": 5}),
    "mla": ("deepseek-v3-671b", {}),
    "hybrid": ("zamba2-1.2b", {"sliding_window": 8}),
    "xlstm": ("xlstm-350m", {}),
    "whisper": ("whisper-tiny", {}),
    "vlm": ("qwen2-vl-72b", {}),
}
#: leaves redrawn around their initial value, and by how much
REDRAWN = {"ln1": 0.3, "ln2": 0.3, "final_norm": 0.3, "q_norm": 0.3,
           "k_norm": 0.3, "kv_norm": 0.3, "router_bias": 0.05,
           "ln": 0.3, "norm": 0.3, "norm_in": 0.3, "a_log": 0.3,
           "dt_bias": 0.3, "d_skip": 0.3, "b_if": 0.5, "bias": 0.3,
           "ln1_s": 0.3, "ln1_b": 0.3, "lnx_s": 0.3, "lnx_b": 0.3,
           "ln2_s": 0.3, "ln2_b": 0.3, "enc_final_s": 0.3,
           "enc_final_b": 0.3, "bi": 0.1, "bo": 0.1, "bq": 0.3, "bk": 0.3,
           "bv": 0.3}
#: whisper's encoder frames in these tests (its cross K/V rows)
FRAMES = 7


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=0.0, atol=atol)


def case(name, seed=0):
    """The JAX and the port's fp32 smoke configs of ``name`` and both
    packages' parameters with the same weights."""
    arch, kw = CASES[name]
    jc = jsmoke(arch).replace(dtype=jnp.float32, param_dtype=jnp.float32,
                              **kw)
    tc = tsmoke(arch).replace(dtype=torch.float32, param_dtype=torch.float32,
                              **kw)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        scale = REDRAWN.get(path[-1].key)
        if scale:
            a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(
        leaf, jtr.init_params(jc, jax.random.PRNGKey(seed)))
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, tree), \
        lm_params_from_numpy(tc, tree, device=CPU)


def prompts(vocab, n, length, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, length))) for _ in range(n)]


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_with_a_device_cache_len_match_the_jitted_jax_step(name):
    """Five consecutive decode steps after a 12-token prefill, each fed the
    JAX step's greedy tokens: the port's ``cache_len`` a 0-d int32 tensor,
    the JAX one a traced ``jnp.int32`` under ``jax.jit``; logits and every
    cache entry within ``ATOL_MODEL`` after every step (the hybrid's: its
    SSM state and its 8-row rings, full from the first step; the xlstm's:
    its seven state entries; the whisper's: its self K/V and the encoder's
    K/V over ``FRAMES`` seeded frames, which no step writes)."""
    jc, tc, jparams, model = case(name, seed=1)
    B, S, steps = 2, 12, 5
    T = S + steps + 1
    toks = np.asarray(prompts(jc.vocab_size, B, S, 3), np.int32)
    frames, enc = {}, {}
    if tc.family == "audio":
        frames["frames"] = np.random.default_rng(4).standard_normal(
            (B, FRAMES, jc.d_model)).astype(np.float32)
        enc["enc_len"] = FRAMES
    wlog, wcache = jtr.prefill_step(
        jparams, jc, {"tokens": jnp.asarray(toks),
                      **{k: jnp.asarray(v) for k, v in frames.items()}})
    with torch.inference_mode():
        _, gcache = ttr.prefill_step(
            model, tc, {"tokens": torch.from_numpy(toks),
                        **{k: torch.from_numpy(v) for k, v in frames.items()}})
        cache = ttr.init_cache(tc, B, T, device=CPU, **enc)
        for key, dst in cache.items():
            src = gcache[key]
            if key in ttr.state_entries(tc):
                dst.copy_(src)
            else:
                dst[:, :, :src.shape[2]] = src
    target = jtr.init_cache(jc, B, T, **enc)
    jcache = {k: jnp.pad(v, [(0, d - s) for d, s in
                             zip(target[k].shape, v.shape)])
              for k, v in wcache.items()}
    jdecode = jax.jit(lambda p, c, t, n: jtr.decode_step(p, jc, c, t, n))
    nxt = np.argmax(np_(wlog)[:, -1], axis=-1).astype(np.int32)[:, None]
    cache_len = torch.tensor(S, dtype=torch.int32)
    for step in range(steps):
        with torch.inference_mode():
            glog, out = ttr.decode_step(model, tc, cache,
                                        torch.from_numpy(nxt), cache_len)
        wlog, jcache = jdecode(jparams, jcache, jnp.asarray(nxt),
                               jnp.asarray(S + step, jnp.int32))
        assert out is cache
        assert int(cache_len) == S + step   # the step does not advance it
        close(glog, wlog, ATOL_MODEL)
        assert set(cache) == set(jcache)
        for key in cache:
            close(cache[key], jcache[key], ATOL_MODEL)
        nxt = np.argmax(np_(wlog)[:, 0], axis=-1).astype(np.int32)[:, None]
        cache_len = cache_len + 1


def fake_trace(model, cfg, B=2, T=16, cache_len=9):
    """``decode_step`` with a tensor ``cache_len`` (and, for whisper, a
    tensor ``enc_len`` under the cross K/V's T rows) traced by ``make_fx``
    in fake mode (nothing runs; the weights are constants), after one real
    step on the same shapes: the graph module."""
    cache = ttr.init_cache(cfg, B, T, enc_len=T, device=CPU)
    keys = list(cache)
    tokens = torch.ones((B, 1), dtype=torch.int64)
    n = torch.tensor(cache_len)
    kw = {"enc_len": torch.tensor(FRAMES)} if "cross_k" in cache else {}

    def step(*args):
        caches, (tokens, n), rest = (args[:len(keys)],
                                     args[len(keys):len(keys) + 2],
                                     args[len(keys) + 2:])
        return ttr.decode_step(model, cfg, dict(zip(keys, caches)), tokens,
                               n, **dict(zip(kw, rest)))[0]

    inputs = (*cache.values(), tokens, n, *kw.values())
    with torch.no_grad():
        step(*inputs)                                # the real step
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        args = [mode.from_tensor(t) for t in inputs]
        return make_fx(step, tracing_mode="fake")(*args)


@pytest.mark.parametrize("name", ["dense", "moe-gather", "sliding-window",
                                  "mla", "hybrid", "xlstm", "whisper",
                                  "vlm"])
def test_decode_step_traces_in_fake_mode_without_a_host_read(name):
    """No data-dependent host read is left in the step: ``make_fx`` in fake
    mode traces it whole, the cache (K/V, MLA's latent rows, or the
    hybrid's rings, rolled at ``cache_len`` 9 past their 8 rows) written by
    ``index_copy_`` (the xlstm, which has no attention, writes its state
    by ``copy_``: seven a pair; whisper writes its self K/V alone, its
    learned position read by ``index_select`` at ``cache_len``) and no
    node reads a value to the host."""
    _, tc, _, model = case(name)
    gm = fake_trace(model, tc)
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    attention_layers = {"hybrid": -(-tc.n_layers // tc.hybrid_shared_period),
                        "ssm": 0}.get(tc.family, tc.n_layers)
    if tc.family == "ssm":
        assert targets.count("aten.copy_.default") == 7 * tc.n_layers // 2
    if tc.family == "audio":
        assert targets.count("aten.index_select.default") == 1
    assert targets.count("aten.index_copy_.default") == 2 * attention_layers
    assert not [t for t in targets if t in ("aten._local_scalar_dense.default",
                                            "aten.item.default")]


def test_the_sort_dispatch_fails_the_fake_trace_at_its_host_read():
    """The same trace of a sort config no longer stops at a host read in
    ``_moe_sort``: its group offsets stay on the device, each expert
    product is one grouped-product op (its fake kernel in fake mode; three
    a layer), and no node reads a value to the host.  So the engine graphs
    a sort config's decode."""
    _, tc, _, model = case("moe-sort")
    gm = fake_trace(model, tc)
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.grouped_mm.default") == 3 * tc.n_layers
    assert targets.count("aten.index_copy_.default") == 2 * tc.n_layers
    assert not [t for t in targets if t in ("aten._local_scalar_dense.default",
                                            "aten.item.default")]


def test_the_engine_serves_two_batches_in_turn_as_fresh_engines_do():
    """One engine, two batches of the same size in turn (a 14-token, then a
    6-token prompt length), against a fresh engine for each: the same
    tokens.  The second batch reuses the first's program and cache, whose
    rows past what the batch wrote read zero: the in-place splice left no
    stale rows."""
    _, tc, _, model = case("dense", seed=2)
    scfg = ServeConfig(max_batch=2, max_len=24)
    batches = [prompts(tc.vocab_size, 2, 14, 4),
               prompts(tc.vocab_size, 2, 6, 5)]
    new = 5
    eng = ServingEngine(tc, scfg, params=model, device=CPU)
    got = []
    for batch in batches:
        for p in batch:
            eng.submit(Request(prompt=p, max_new_tokens=new))
        eng.done.clear()
        got.append([r.output for r in eng.run()])
    want = []
    for batch in batches:
        fresh = ServingEngine(tc, scfg, params=model, device=CPU)
        for p in batch:
            fresh.submit(Request(prompt=p, max_new_tokens=new))
        want.append([r.output for r in fresh.run()])
    assert got == want
    assert list(eng.programs) == [2] and eng.stats["decode_graphs"] == 0
    prog = eng.programs[2]
    written = 6 + new - 1                 # the prompt and new - 1 decode rows
    for key in ("k", "v"):
        assert bool((prog.cache[key][:, :, written:] == 0).all())
        assert bool((prog.cache[key][:, :, :written] != 0).any())
    assert int(prog.cache_len) == written


def test_decode_program_mode_names_why_a_step_runs_eagerly():
    """``"graph"`` for a dense, MoE gather, MoE sort, MLA, hybrid, xlstm,
    whisper or VLM config on the card; ``"eager: ..."`` on the CPU and
    under ``_eager_chunks``."""
    cuda = torch.device("cuda")
    dense, gather, sort, mla, hybrid, xlstm, whisper, vlm = (
        tsmoke(a).replace(**kw) for a, kw in (
            CASES["dense"], CASES["moe-gather"], CASES["moe-sort"],
            CASES["mla"], CASES["hybrid"], CASES["xlstm"],
            CASES["whisper"], CASES["vlm"]))
    for cfg in (dense, gather, sort, mla, hybrid, xlstm, whisper, vlm):
        assert decode_program_mode(cfg, cuda) == "graph"
        assert decode_program_mode(cfg, CPU).startswith("eager: ")
    with _eager_chunks():
        assert decode_program_mode(dense, cuda).startswith("eager: ")
    assert decode_program_mode(dense, cuda) == "graph"


def test_a_sort_engine_reports_eager_and_gives_the_jax_engines_tokens():
    """The MoE sort config on the engine: the greedy tokens are the JAX
    engine's; ``decode_program`` says eager on the CPU only (on the card
    the step is graphed, as every config's)."""
    jc, tc, jparams, model = case("moe-sort", seed=3)
    jeng = JServingEngine(jc, JServeConfig(max_batch=2, max_len=20),
                          params=jparams)
    teng = ServingEngine(tc, ServeConfig(max_batch=2, max_len=20),
                         params=model, device=CPU)
    for p in prompts(jc.vocab_size, 2, 10, 6):
        jeng.submit(JRequest(prompt=p, max_new_tokens=5))
        teng.submit(Request(prompt=p, max_new_tokens=5))
    assert [r.output for r in teng.run()] == [r.output for r in jeng.run()]
    assert teng.stats["decode_program"] == decode_program_mode(tc, CPU)
    assert decode_program_mode(tc, torch.device("cuda")) == "graph"
    assert teng.stats["decode_graphs"] == 0
    assert teng.stats["capture_s"] == 0.0
    assert len(teng.stats["decode_s"]) == 4
