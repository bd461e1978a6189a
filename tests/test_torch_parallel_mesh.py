"""Training on a device mesh (``repro_torch.parallel``,
``train.make_train_step(lm=)``, ``train.train(lm=)``) on the CPU: one
spawn of ``tests/_torch_parallel_child.py`` on 8 gloo processes (a
``file://`` store, as ``tests/test_torch_distributed.py`` spawns its
worlds), held here against the JAX package and the port on one device.

The model is the JAX elastic test's (``tests/test_elastic.py``): the smoke
phi3 in f32, batches of 4 x 32 tokens, AdamW lr 1e-3, warm-up 2 steps,
decay over 12.

* The first step's loss and every gradient of the JAX weights on (2, 4)
  ("data", "model") (remat "none", "full" and "dots"), (8,) ("data",)
  and (2, 2, 2) ("pod", "data", "model"), and of the smoke llama4 (MoE, gather dispatch) on (2, 4),
  within 1e-5 relative of the JAX single-device ``loss_fn`` grads
  (``tests/test_torch_train.py``'s ``GRAD_RTOL``).
* Each rank's shard shapes are the JAX specs' shard shapes; its bytes of
  parameters and moments are the sum of its shards (no hidden replicated
  copy); every moment is placed as its parameter.
* 6 steps on (2, 4), one on each other mesh, 2 on (2, 4) with 8-bit
  moments: the losses within 1e-4 relative of the port's single-device
  run; the (2, 4) checkpoint of step
  6 resumed on one device to step 12 against 12 uninterrupted steps.
* A failure injected on the mesh: ``run_with_restarts`` resumes from the
  mesh's checkpoint and repeats the uninterrupted run's losses bit for bit.
* Every other smoke config on (2, 4), deepseek-v3's MoE sort dispatch
  included (its weight gradient an op with a whole-operand rule, ROADMAP
  C33): the loss and every gradient within 1e-5 relative of the port's
  single-device ones (the recurrent hybrid and SSM families' gradients
  within their files' whole-model bar, 5e-5).
* The mesh mechanisms repaired for the dry run's grid (ROADMAP C35), each
  a case of the child's ``REPAIRS`` on (2, 4) within 1e-5 relative of the
  same call on one device: a train step with 6 heads on the 4-way model
  axis (its one-device loss and gradients also within 1e-5 of the JAX
  package's); decode steps on a sequence-sharded cache (its logits each
  step and the cache after them) for phi3, deepseek-v3's absorbed MLA, the
  xlstm and zamba2 at B = 1; whisper's train step, its rows a fold of a
  batch on "data" and a sequence on "model".
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402  caps torch's threads
import _torch_parallel_child as pchild  # noqa: E402  the repaired cases

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.parallel import LogicalMesh as JLogicalMesh  # noqa: E402
from repro.parallel.param_rules import \
    tree_param_specs as jtree_specs  # noqa: E402
from repro_torch.configs import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.data import DataConfig, make_dataset  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import param_path  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import TrainConfig, train  # noqa: E402
from repro_torch.train.train_loop import loss_and_grads  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_parallel_child.py")
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
SPAWN_TIMEOUT = 400
WORLD = 8
GRAD_RTOL = 1e-5       # a two-layer f32 forward and backward (test_torch_train)
LOSS_RTOL = 1e-4       # f32 AdamW steps later, the sums in another order
#: the recurrent families' whole-model gradients: their own files' bar
#: (TOL_MODEL of tests/test_torch_hybrid.py and tests/test_torch_xlstm.py)
RECURRENT_RTOL = {"hybrid": 5e-5, "ssm": 5e-5}
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "8": ((8,), ("data",)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
JAX_ARCHS = {"phi3": "phi3-mini-3.8b", "llama4": "llama4-scout-17b-a16e"}
REPAIR_RTOL = 1e-5
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=12)


def f32(arch):
    return smoke_config(arch).replace(dtype=torch.float32,
                                      param_dtype=torch.float32)


def jf32(arch):
    return jsmoke(arch).replace(dtype=jnp.float32, param_dtype=jnp.float32)


def dcfg(cfg):
    return DataConfig(batch_size=4, seq_len=32, vocab_size=cfg.vocab_size)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def flat_tree(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_tree(v, prefix + (k,))
    else:
        yield prefix, tree


def leaf_at(tree, name):
    """The JAX tree's leaf of the port's parameter ``name`` (a stacked
    leaf's layer)."""
    path, layer = param_path(name)
    node = tree
    for key in path:
        node = node[key]
    return node[layer] if layer >= 0 else node


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX weights, loss and gradients of the f32 smoke phi3 and
    llama4 on the batch of step 0."""
    tokens = make_dataset(dcfg(f32("phi3-mini-3.8b")))(0)["tokens"]
    out = {"tokens": tokens}
    for short, arch in JAX_ARCHS.items():
        jc = jf32(arch)
        jp = jinit(jc, jax.random.PRNGKey(0))
        (loss, _), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True),
                                   static_argnums=1)(
            jp, jc, {"tokens": jnp.asarray(tokens)})
        out[short] = (jax.tree_util.tree_map(np.asarray, jp), float(loss),
                      jax.tree_util.tree_map(np.asarray, grads))
    # the 6-head case's JAX weights, loss and gradients on its batch
    arch, over, _, B, S = pchild.REPAIRS["heads_train"]
    jc = jf32(arch).replace(**over)
    jp = jinit(jc, jax.random.PRNGKey(0))
    batch = pchild.repair_batch(pchild.repair_config("heads_train"), B, S)
    (loss, _), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True),
                               static_argnums=1)(
        jp, jc, {"tokens": jnp.asarray(batch["tokens"].numpy())})
    out["heads"] = (jax.tree_util.tree_map(np.asarray, jp), float(loss),
                    jax.tree_util.tree_map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def world(jax_refs, tmp_path_factory):
    """Run the child on 8 gloo processes; return rank 0's output."""
    work = tmp_path_factory.mktemp("parallel8")
    inputs = {"tokens": jax_refs["tokens"]}
    for short in list(JAX_ARCHS) + ["heads"]:
        for path, arr in flat_tree(jax_refs[short][0]):
            inputs["/".join((short,) + path)] = arr
    np.savez(work / "inputs.npz", **inputs)
    env = dict(_torch_threads.child_env(threads=1), PYTHONPATH=SRC
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # each rank's output to a file: no rank waits on a pipe nobody reads
    logs = [work / f"rank{rank}.log" for rank in range(WORLD)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, str(rank), str(WORLD),
                 str(work / "store"), str(work / "inputs.npz"),
                 str(work / "out")],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"--- rank {r} exit {c}\n{log.read_text()[-3000:]}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    with open(work / "out" / "scalars.json") as f:
        scalars = json.load(f)
    return dict(arrays=dict(np.load(work / "out" / "arrays.npz")),
                scalars=scalars, out=work / "out")


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The port's single-device run of the same 12 steps."""
    cfg = f32("phi3-mini-3.8b")
    tcfg = TrainConfig(steps=12, ckpt_every=100, opt=OPT,
                       ckpt_dir=str(tmp_path_factory.mktemp("one") / "ck"))
    return [h["loss"] for h in train(cfg, dcfg(cfg), tcfg,
                                     device="cpu")["history"]]


def grads_of(world, name):
    prefix = f"grad/{name}/"
    return {k[len(prefix):]: v for k, v in world["arrays"].items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", ["phi3/2x4", "phi3/8", "phi3/2x2x2",
                                  "phi3_full/2x4", "phi3_dots/2x4",
                                  "llama4/2x4"])
def test_first_step_loss_and_gradients_match_jax(world, jax_refs, name):
    short = name.split("/")[0].split("_")[0]
    _, jloss, jgrads = jax_refs[short]
    assert rel(world["scalars"][f"loss/{name}"], jloss) <= GRAD_RTOL
    grads = grads_of(world, name)
    names = [k for k, _ in f32_model(JAX_ARCHS[short]).named_parameters()]
    assert sorted(grads) == sorted(names)
    worst = max(rel(g, leaf_at(jgrads, k)) for k, g in grads.items())
    assert worst <= GRAD_RTOL, worst


def f32_model(arch):
    return init_params(f32(arch), torch.Generator().manual_seed(0))


def shard_shape(shape, spec, sizes):
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes[axis]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_rank_holds_the_jax_specs_shards_and_nothing_more(world, mesh):
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    jc = jf32("phi3-mini-3.8b")
    jshapes = jax.eval_shape(lambda: jinit(jc, jax.random.PRNGKey(0)))
    jspecs = jtree_specs(jshapes, JLogicalMesh(AbstractMesh(shape, names)))
    model = f32_model("phi3-mini-3.8b")
    want, nbytes, sharded = {}, 0, 0
    for k, p in model.named_parameters():
        spec = tuple(leaf_at_spec(jspecs, k))
        want[k] = shard_shape(p.shape, spec, sizes)
        nbytes += int(np.prod(want[k])) * p.element_size()
        sharded += any(e is not None for e in spec)
    assert sharded
    ranks = world["scalars"][f"ranks/{mesh}"]
    assert len(ranks) == WORLD
    for r, got in enumerate(ranks):
        assert got["shapes"] == want, r
        assert got["param_bytes"] == nbytes, r
        assert got["moment_bytes"] == 2 * nbytes, r      # f32 m and v
        assert got["moments_placed"], r


def leaf_at_spec(jspecs, name):
    path, layer = param_path(name)
    node = jspecs
    for key in path:
        node = node[key]
    return tuple(node)[1:] if layer >= 0 else tuple(node)


def test_training_on_the_meshes_matches_one_device(world, one_device):
    s = world["scalars"]
    assert s["train_dtensors/2x4"]
    losses = s["train/2x4"]
    assert len(losses) == 6
    assert rel(losses[0], one_device[0]) <= GRAD_RTOL
    assert rel(losses, one_device[:6]) <= LOSS_RTOL
    for mesh in ("8", "2x2x2"):
        assert rel(s[f"train/{mesh}"], one_device[:1]) <= GRAD_RTOL, mesh
    assert len(set(s["train/2x4"])) == 6           # the loss moves


def test_eight_bit_moments_on_the_mesh_match_one_device(world, tmp_path):
    cfg = f32("phi3-mini-3.8b")
    tcfg = TrainConfig(steps=2, ckpt_every=100, ckpt_dir=str(tmp_path),
                       opt=dataclasses.replace(OPT, state_dtype="i8"))
    want = [h["loss"] for h in train(cfg, dcfg(cfg), tcfg,
                                     device="cpu")["history"]]
    assert rel(world["scalars"]["train_i8/2x4"], want) <= LOSS_RTOL


def test_mesh_checkpoint_resumes_on_one_device(world, one_device, tmp_path):
    ckpt = tmp_path / "ck"
    shutil.copytree(world["out"] / "ckpt_2x4", ckpt)
    cfg = f32("phi3-mini-3.8b")
    tcfg = TrainConfig(steps=12, ckpt_every=6, opt=OPT, ckpt_dir=str(ckpt))
    out = train(cfg, dcfg(cfg), tcfg, device="cpu")
    assert out["start_step"] == 6
    assert rel([h["loss"] for h in out["history"]], one_device[6:]) \
        <= LOSS_RTOL


def test_restart_on_the_mesh_repeats_the_uninterrupted_losses(world):
    r = world["scalars"]["restart/2x4"]
    assert r["restarts"] == 1 and r["start_step"] == 2
    first = world["scalars"]["train/2x4"][:4]
    # steps 0, 1, 2, then (after the failure at 3) 2 again and 3
    assert r["losses"] == first[:3] + first[2:4]


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in
                                  JAX_ARCHS.values()])
def test_every_family_on_the_mesh_matches_one_device(world, arch):
    cfg = f32(arch)
    batch = {k: torch.as_tensor(v)
             for k, v in make_dataset(dcfg(cfg), cfg)(0).items()}
    model = f32_model(arch)
    s = world["scalars"]
    loss, _, grads = loss_and_grads(model, cfg, batch)
    assert rel(s[f"loss/{arch}/2x4"], loss.item()) <= GRAD_RTOL
    got = grads_of(world, f"{arch}/2x4")
    assert sorted(got) == sorted(grads)
    worst = max(rel(got[k], g.numpy()) for k, g in grads.items())
    assert worst <= RECURRENT_RTOL.get(cfg.family, GRAD_RTOL), worst


def heads_inputs(jax_refs):
    return {"/".join(("heads",) + path): arr
            for path, arr in flat_tree(jax_refs["heads"][0])}


@pytest.mark.parametrize("case", list(pchild.REPAIRS))
def test_repaired_mesh_case_matches_one_device(world, jax_refs, case):
    err = world["scalars"].get(f"repair_error/{case}")
    assert err is None, err
    prefix = f"repair/{case}/"
    got = {k[len(prefix):]: v for k, v in world["arrays"].items()
           if k.startswith(prefix)}
    flat = heads_inputs(jax_refs) if case == "heads_train" else None
    want = pchild.repair_run(case, None, flat)
    assert sorted(got) == sorted(want)
    worst = max((rel(got[k], v), k) for k, v in want.items())
    assert worst[0] <= REPAIR_RTOL, worst
    if case == "heads_train":
        # the one-device step against the JAX package's
        _, jloss, jgrads = jax_refs["heads"]
        assert rel(want["loss"], jloss) <= GRAD_RTOL
        worst = max(rel(g, leaf_at(jgrads, k[len("grad/"):]))
                    for k, g in want.items() if k.startswith("grad/"))
        assert worst <= GRAD_RTOL, worst
