"""The port's dry-run tooling (``repro_torch.configs``' grid,
``repro_torch.launch.flops``, ``launch.mesh``, ``launch.multihost``) held
against the JAX package on the CPU, in this process (the fake process
groups run in a child: ``tests/test_torch_dryrun.py``).

* ``skip_reason`` word for word and ``input_specs`` leaf by leaf (shape and
  dtype; ``meta`` tensors against ``ShapeDtypeStruct``s) on all 40 cells.
* ``count_fn`` on the JAX package's four counter tests
  (``tests/test_analysis.py``): one product's FLOPs and ``dot_bytes``
  exactly, ten products run in a loop, a checkpointed product and its
  backward, a remat train step's ratio to 8 N D.
* The smoke phi3 and qwen3, forward and train step, against JAX's
  ``count_fn``: FLOPs within 1%, ``dot_bytes`` equal (the products are
  the same; the elementwise ops differ in granularity between aten and
  jaxpr, which the FLOPs' 1% holds).
* ROADMAP C34: the flash op and the grouped product counted by their
  formulas, alone and in a model (the smoke qwen3 with flash on, the
  smoke deepseek-v3's sort dispatch); JAX's counter lower
  (``pallas_call`` once, ``ragged_dot`` 0).
* ``solver_mesh_shape`` against JAX's ``make_solver_mesh`` for 1..512
  devices; ``multihost`` on two gloo processes.
"""
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402  caps torch's threads

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import skip_reason as jskip  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.flops import count_fn as jcount  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable,  # noqa: E402
                                 get_config, input_specs, skip_reason,
                                 smoke_config)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.flops import count_fn  # noqa: E402
from repro_torch.launch.mesh import solver_mesh_shape  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.train.train_loop import loss_and_grads  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
TORCH_DTYPE = {jnp.dtype(jnp.int32): torch.int32,
               jnp.dtype(jnp.float32): torch.float32,
               jnp.dtype(jnp.bfloat16): torch.bfloat16}
FLOP_RTOL = 1e-2
DENSE = ("phi3-mini-3.8b", "qwen3-8b")


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_reason_is_the_jax_string(arch, shape):
    assert skip_reason(arch, shape) == jskip(arch, shape)
    assert applicable(arch, shape) == (jskip(arch, shape) is None)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax_leaf_by_leaf(arch, shape):
    ours = dict(leaves(input_specs(get_config(arch), shape)))
    theirs = dict(leaves(jinput_specs(jget_config(arch), shape, arch)))
    assert sorted(ours) == sorted(theirs)
    for key, t in ours.items():
        want = theirs[key]
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(want.shape), key
        assert t.dtype == TORCH_DTYPE[jnp.dtype(want.dtype)], key


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_count_single_matmul():
    c = count_fn(lambda a, b: a @ b, meta(32, 64), meta(64, 128))
    assert c["flops"] == 2 * 32 * 64 * 128
    assert c["dot_bytes"] == 4 * (32 * 64 + 64 * 128 + 32 * 128)
    assert c["bytes"] == c["dot_bytes"]


def test_count_bmm_with_an_f32_output_as_bmm():
    """``bmm.dtype`` (bf16 products summed into f32: the MLA decode's
    scores on the card) is counted by ``bmm``'s formula on its operands."""
    a, b = meta(8, 16, 32, dtype=torch.bfloat16), meta(8, 32, 64,
                                                       dtype=torch.bfloat16)
    c = count_fn(lambda x, y: torch.bmm(x, y, out_dtype=torch.float32), a, b)
    assert c["flops"] == 2 * 8 * 16 * 32 * 64
    assert c["dot_bytes"] == 2 * (8 * 16 * 32 + 8 * 32 * 64) + 4 * 8 * 16 * 64


def test_count_runs_a_python_loop():
    """The JAX scan's test: ten chained products (here a loop, counted as
    it runs)."""
    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x
    c = count_fn(f, meta(16, 16), meta(10, 16, 16))
    assert c["flops"] == 10 * 2 * 16 * 16 * 16


def test_count_backward_and_checkpoint_recompute():
    def f(a):
        y = torch.utils.checkpoint.checkpoint(lambda t: t @ t, a,
                                              use_reentrant=False)
        return torch.autograd.grad(y.sum(), [a])
    with FakeTensorMode():
        a = torch.randn(8, 8, requires_grad=True)
        c = count_fn(f, a)
    # forward, the recompute, two backward products
    assert c["flops"] >= 3 * 2 * 8 ** 3


def test_count_model_flops_close_to_8nd():
    cfg = smoke_config("phi3-mini-3.8b").replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, remat="full")
    with FakeTensorMode():
        model = init_params(cfg, torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros((4, 128), dtype=torch.int32)}
        c = count_fn(lambda: loss_and_grads(model, cfg, batch))
        n_params = sum(p.numel() for p in model.parameters())
    ratio = c["flops"] / (8 * n_params * 4 * 128)
    assert 0.5 < ratio < 3.0, ratio


def f32(cfg, torch_side: bool):
    if torch_side:
        return cfg.replace(dtype=torch.float32, param_dtype=torch.float32)
    return cfg.replace(dtype=jnp.float32, param_dtype=jnp.float32)


@pytest.mark.parametrize("step", ["forward", "train"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_counts_match_jax(arch, step):
    B, S = 2, 32
    jc, tc = f32(jsmoke(arch), False), f32(smoke_config(arch), True)
    jp = jax.eval_shape(lambda: jinit(jc, jax.random.PRNGKey(0)))
    jb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if step == "forward":
        want = jcount(lambda p, b: jforward(p, jc, b), jp, jb)
    else:
        want = jcount(lambda p, b: jax.value_and_grad(
            lambda q: jloss(q, jc, b)[0])(p), jp, jb)
    with FakeTensorMode():
        model = init_params(tc, torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
        fn = (lambda: forward(model, tc, batch)) if step == "forward" \
            else (lambda: loss_and_grads(model, tc, batch))
        got = count_fn(fn)
    assert abs(got["flops"] / want["flops"] - 1) <= FLOP_RTOL
    assert got["dot_bytes"] == want["dot_bytes"]


def test_flash_counts_its_formula_and_jax_counts_one_grid_cell():
    """C34: the port's flash op counts 4 B H hd S^2 (non-causal); JAX's
    counter walks the ``pallas_call`` body once, 1 / (H nq nk) of it."""
    B, H, K, S, hd, blk = 1, 4, 2, 512, 64, 128
    q = jax.ShapeDtypeStruct((B, H, S, hd), jnp.float32)
    kv = jax.ShapeDtypeStruct((B, K, S, hd), jnp.float32)
    theirs = jcount(lambda a, b, c: flash_attention_pallas(
        a, b, c, scale=0.125, causal=False, block_q=blk, block_k=blk,
        interpret=True), q, kv, kv)["flops"]
    with FakeTensorMode():
        qg = torch.empty(B, S, K, H // K, hd)
        k, v = torch.empty(B, S, K, hd), torch.empty(B, S, K, hd)
        ours, causal = (count_fn(lambda: ops.flash_attention(
            qg, k, v, scale=0.125, causal=c)) for c in (False, True))
    assert ours["flops"] == 4 * B * H * hd * S * S == 268_435_456
    assert theirs == 4_292_608 < ours["flops"]
    assert causal["flops"] == 4 * B * H * hd * S * (S + 1) // 2


def test_grouped_product_counts_its_formula_and_ragged_dot_counts_zero():
    """C34: the sort dispatch's grouped product and its weight gradient
    count 2 R K N each; JAX's counter gives ``ragged_dot`` 0."""
    R, E, Kd, N = 64, 4, 32, 16
    theirs = jcount(lambda x, w, g: jax.lax.ragged_dot(x, w, g),
                    jax.ShapeDtypeStruct((R, Kd), jnp.float32),
                    jax.ShapeDtypeStruct((E, Kd, N), jnp.float32),
                    jax.ShapeDtypeStruct((E,), jnp.int32))
    assert theirs["flops"] == 0.0
    with FakeTensorMode():
        x = torch.randn(R, Kd, requires_grad=True)
        w = torch.randn(E, Kd, N, requires_grad=True)
        off = torch.zeros(E + 1, dtype=torch.int64)
        fwd = count_fn(ops.grouped_mm, x, w, off)
        both = count_fn(lambda: torch.autograd.grad(
            ops.grouped_mm(x, w, off).sum(), [x, w]))
    assert fwd["flops"] == 2 * R * Kd * N == 65_536
    # forward, dx (a grouped product of w^T) and dw
    assert both["flops"] == 3 * 2 * R * Kd * N


def port_forward_count(cfg, B, S, without=None):
    """The port's forward count of ``cfg`` on (B, S) tokens; ``without``
    an op packet whose FLOP formula is taken as 0 (its products
    apart)."""
    from torch.utils import flop_counter
    saved = flop_counter.flop_registry.get(without)
    if without is not None:
        flop_counter.flop_registry[without] = lambda *a, **k: 0
    try:
        with FakeTensorMode():
            model = init_params(cfg, torch.Generator().manual_seed(0))
            batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
            return count_fn(lambda: forward(model, cfg, batch))["flops"]
    finally:
        if without is not None:
            flop_counter.flop_registry[without] = saved


def jax_forward_count(cfg, B, S):
    params = jax.eval_shape(lambda: jinit(cfg, jax.random.PRNGKey(0)))
    return jcount(lambda p, b: jforward(p, cfg, b), params,
                  {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})[
        "flops"]


def test_sort_dispatch_model_counts_its_grouped_products_and_jax_none():
    """C34 in a model: the smoke deepseek-v3 (sort dispatch) forward.  With
    the grouped products' formula taken out the port's count is JAX's
    within 1%; with it, higher by their 2 R K N each, which JAX's
    ``ragged_dot`` count lacks."""
    B, S = 2, 32
    tc = f32(smoke_config("deepseek-v3-671b"), True)
    assert tc.moe_impl == "sort"
    want = jax_forward_count(f32(jsmoke("deepseek-v3-671b"), False), B, S)
    ours = port_forward_count(tc, B, S)
    bare = port_forward_count(tc, B, S,
                              without=torch.ops.repro_torch.grouped_mm)
    assert abs(bare / want - 1) <= FLOP_RTOL
    # three grouped products a MoE layer (wi, wg, wo), every token's top-k
    # rows: 2 R K N each
    rows = B * S * tc.moe_top_k
    grouped = tc.n_layers * rows * 2 * (2 * tc.d_model * tc.d_ff
                                        + tc.d_ff * tc.d_model)
    assert ours - bare == grouped
    assert want < ours


def test_flash_model_counts_its_formula_and_jax_one_grid_cell():
    """C34 in a model: the smoke qwen3 with ``use_flash_kernel`` on (S =
    256, the kernel's threshold): the port's count holds each layer's flash
    call at its formula; JAX's, walking each ``pallas_call`` body once, is
    lower."""
    B, S = 1, 256
    tc = f32(smoke_config("qwen3-8b"), True).replace(use_flash_kernel=True)
    jc = f32(jsmoke("qwen3-8b"), False).replace(use_flash_kernel=True)
    ours = port_forward_count(tc, B, S)
    bare = port_forward_count(tc, B, S,
                              without=torch.ops.repro_torch.flash_attention)
    per_layer = 4 * B * tc.n_heads * tc.hd * (S * (S + 1) // 2)
    assert ours - bare == tc.n_layers * per_layer
    assert jax_forward_count(jc, B, S) < ours


def test_solver_mesh_shape_is_jax_fold(monkeypatch):
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: shape)
    for n in range(1, 513):
        assert solver_mesh_shape(n) == tuple(jmesh.make_solver_mesh(n)), n
        assert solver_mesh_shape(n, ("rows",)) == tuple(
            jmesh.make_solver_mesh(n, axes=("rows",))), n


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_two_gloo_processes_with_no_command():
    env = dict(_torch_threads.child_env(threads=1),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.multihost",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(i), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    for out in outs:
        assert "distributed ok: 2 global / 1 local" in out, out
