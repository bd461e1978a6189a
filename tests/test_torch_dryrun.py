"""The dry run over fake process groups (``repro_torch.launch.dryrun``,
``dryrun_solver``, ``launch.train --production-mesh``), run in one child
process (``tests/_torch_dryrun_child.py``: the fake group is process-wide
state) and held here against the JAX package.

* The private fake backend the dry run relies on: 256 ranks, an
  all-reduce that returns with the tensor untouched, a (16, 16) mesh and
  a DTensor product on it.
* Each architecture's per-rank bytes of its ``train_4k`` arguments at full
  width (depth 2) on (16, 16) and (2, 16, 16): the port's placed
  parameters, AdamW moments (8-bit for the JAX package's four) and batch
  against the shards JAX's ``tree_param_specs`` give over an
  ``AbstractMesh`` (the JAX dry run's moment and batch specs); likewise
  its ``prefill_32k`` arguments (parameters and batch) and its
  ``decode_32k`` ones (parameters, the cache placed by
  ``cache_logical_axes`` with the JAX dry run's ``_div_spec`` fallback,
  the tokens on "batch" and the 0-d ``cache_len``).
* The solver's one iteration on 8 fake ranks: exactly one all-reduce (the
  paper's invariant), the interior slab's halo (two matvecs, a plane each
  way each), the state's bytes a whole number of local vectors.
* ``launch.train --production-mesh --arch qwen3-8b`` (depth 1) prints
  ``"status": "ok"`` and writes its record.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402  caps torch's threads

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.models import cache_logical_axes as jcache_axes  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim import AdamWConfig, adamw_init  # noqa: E402
from repro.optim.eightbit import Q8  # noqa: E402
from repro.parallel import LogicalMesh as JLogicalMesh  # noqa: E402
from repro.parallel.param_rules import tree_param_specs  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch.dryrun import I8_STATE_ARCHS  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_dryrun_child.py")
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
SPAWN_TIMEOUT = 600
DEPTH = 2                      # the child's
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun")
    env = dict(_torch_threads.child_env(threads=1),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = work / "out.json"
    proc = subprocess.run([sys.executable, CHILD, str(out), str(work)],
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-6000:]
    return json.loads(out.read_text())


def test_the_fake_backend_behaves_as_the_dry_run_needs(child):
    pg = child["fake_pg"]
    assert pg["world"] == 256 and pg["backend"] == "fake"
    assert pg["all_reduce_untouched"]
    assert pg["mesh"] == [16, 16] and pg["names"] == ["data", "model"]
    # a (32, 8) x (8, 32) product sharded 16 x 16: rows split 16 ways
    assert pg["product_global"] == [32, 32] and pg["product_local"] == [2, 32]


def shard_bytes(leaf, spec, sizes) -> int:
    n = int(np.prod(leaf.shape))
    for entry in tuple(spec):
        for axis in (entry,) if isinstance(entry, str) else entry or ():
            n //= sizes[axis]
    return n * leaf.dtype.itemsize


def jax_rank_bytes(arch, mesh) -> int:
    """One rank's bytes of the JAX dry run's train_4k arguments: params by
    ``tree_param_specs``, moments like their parameters (8-bit: the codes
    so, the scales by the leading dims), the count whole, the batch's
    leaves (tokens; whisper's frames; the VLM's patch embeddings and
    positions) sharded on "batch"."""
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    lm = JLogicalMesh(AbstractMesh(shape, names))
    cfg = jget_config(arch).replace(n_layers=DEPTH)
    params = jax.eval_shape(lambda: jinit(cfg, jax.random.PRNGKey(0)))
    specs = tree_param_specs(params, lm)
    i8 = arch in I8_STATE_ARCHS
    opt = jax.eval_shape(lambda p: adamw_init(p, AdamWConfig(
        state_dtype="i8" if i8 else "f32")), params)
    leaves = jax.tree_util.tree_leaves(params)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    total = sum(shard_bytes(a, s, sizes) for a, s in zip(leaves, spec_leaves))
    for key in ("m", "v"):
        moments = jax.tree_util.tree_leaves(
            opt[key], is_leaf=lambda x: isinstance(x, Q8))
        for m, s in zip(moments, spec_leaves):
            if isinstance(m, Q8):
                lead = tuple(s)[:-1] if len(s) else ()
                total += shard_bytes(m.codes, s, sizes)
                total += shard_bytes(m.scales, P(*lead, None), sizes)
            else:
                total += shard_bytes(m, s, sizes)
    total += opt["count"].dtype.itemsize
    rows = 1
    for axis in ("pod", "data"):
        rows *= sizes.get(axis, 1)
    for leaf in jinput_specs(cfg, "train_4k", arch)["batch"].values():
        total += shard_bytes(leaf, P(tuple(a for a in ("pod", "data")
                                           if a in sizes)), sizes) \
            if leaf.shape[0] % rows == 0 else shard_bytes(leaf, P(), sizes)
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_rank_argument_bytes_are_the_jax_specs_bytes(child, arch, mesh):
    assert child["argument_bytes"][f"{mesh}/{arch}"] == \
        jax_rank_bytes(arch, mesh)


def jdiv_spec(lm, shape, *logical):
    """The JAX dry run's own ``_div_spec``.  Its module sets ``XLA_FLAGS``
    (512 host devices) when imported, so the variable is put back: the
    other JAX tests of this process keep their one device."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _div_spec
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _div_spec(lm, shape, *logical)


def jax_serve_bytes(arch, mesh, shape) -> int:
    """One rank's bytes of the JAX dry run's ``prefill_32k`` or
    ``decode_32k`` arguments: the parameters by ``tree_param_specs``; the
    batch's leaves on "batch", or the cache by ``cache_logical_axes``, the
    tokens on "batch" and ``cache_len`` whole, each by ``_div_spec``."""
    shp, names = MESHES[mesh]
    sizes = dict(zip(names, shp))
    lm = JLogicalMesh(AbstractMesh(shp, names))
    cfg = jget_config(arch).replace(n_layers=DEPTH)
    params = jax.eval_shape(lambda: jinit(cfg, jax.random.PRNGKey(0)))
    specs = tree_param_specs(params, lm)
    total = sum(shard_bytes(a, s, sizes) for a, s in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, P))))
    inputs = jinput_specs(cfg, shape, arch)
    if shape == "prefill_32k":
        for leaf in inputs["batch"].values():
            total += shard_bytes(leaf, jdiv_spec(
                lm, leaf.shape, "batch", *(None,) * (len(leaf.shape) - 1)),
                sizes)
        return total
    axes = jcache_axes(cfg)
    for key, leaf in inputs["cache"].items():
        total += shard_bytes(leaf, jdiv_spec(lm, leaf.shape, *axes[key]),
                             sizes)
    tokens = inputs["tokens"]
    total += shard_bytes(tokens, jdiv_spec(lm, tokens.shape, "batch", None),
                         sizes)
    return total + inputs["cache_len"].dtype.itemsize


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_rank_serving_argument_bytes_are_the_jax_specs_bytes(
        child, arch, mesh, shape):
    assert child["argument_bytes"][f"{mesh}/{arch}/{shape}"] == \
        jax_serve_bytes(arch, mesh, shape)


def test_solver_iteration_has_one_all_reduce(child):
    s = child["solver"]
    counts = s["collectives"]["counts"]
    assert counts["all-reduce"] == 1
    # an interior slab: two matvecs, one plane to and from each side each
    assert counts["send"] == counts["recv"] == 4
    nxl, ny, nz = s["local_shape"]
    assert (nxl, ny, nz) == (16 // 8, 8, 8)
    vector = nxl * ny * nz * 8                          # fp64
    plane = ny * nz * 8
    assert s["collectives"]["result_bytes"]["send"] == 4 * plane
    assert s["collectives"]["result_bytes"]["all-reduce"] == 9 * 8
    # the state and the constants: whole local vectors, and a few scalars
    vectors = s["argument_size_in_bytes"] // vector
    assert 10 <= vectors <= 15
    assert s["argument_size_in_bytes"] - vectors * vector < vector
    assert s["peak_memory_in_bytes"] >= s["argument_size_in_bytes"]


def test_production_mesh_train_runs_the_dry_run(child):
    t = child["train_cli"]
    assert t["written"]
    printed = t["stdout"][t["stdout"].index("{"):]
    assert json.loads(printed)["status"] == "ok"
    rec = t["record"]
    assert rec["mesh"] == "pod16x16" and rec["trace_s"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["analytic_global_flops"] > rec["per_rank_flops"] > 0
    assert rec["collectives"]["counts"]["all-gather"] > 0
