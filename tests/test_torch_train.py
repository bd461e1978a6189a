"""The port's training path (``repro_torch.data``, ``models.loss_fn``,
``train/``, ``launch/train.py``, ``convert.train_state_from_numpy``) held
against the JAX package on the CPU.

Inputs come from numpy seeds; the models are the smoke phi3 in f32 with
the JAX package's initial weights carried over (``lm_params_from_numpy``).
Batches are held bit for bit; the loss and every gradient within 1e-5 of
the largest (relative); a resumed run's losses within 1e-5 relative of the
other package's over 3 steps (three f32 AdamW steps apart only by
rounding); checkpoints in both directions bit for bit where nothing was
computed.
"""
import io
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import pipelined_clip_init as jclip_init  # noqa: E402
from repro.optim.eightbit import dequantize as jdequantize  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import restore_pytree as jrestore  # noqa: E402
from repro.train import train as jtrain  # noqa: E402
from repro_torch import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, make_dataset  # noqa: E402
from repro_torch.data import synthetic_token_stream  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.transformer import params_tree  # noqa: E402
from repro_torch.optim import AdamWConfig, dequantize  # noqa: E402
from repro_torch.optim import pipelined_clip_init  # noqa: E402
from repro_torch.train import (FailureInjector, TrainConfig,  # noqa: E402
                               make_train_step, run_with_restarts, state_tree,
                               train)
from repro_torch.train.checkpoint import restore_pytree  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
GRAD_RTOL = 1e-5       # a two-layer f32 forward and backward, two libraries
LOSS_RTOL = 1e-5       # three f32 AdamW steps later


def configs(**kw):
    """The JAX and the port's smoke phi3 in f32."""
    jc = jsmoke("phi3-mini-3.8b").replace(dtype=jnp.float32,
                                          param_dtype=jnp.float32, **kw)
    tc = tsmoke("phi3-mini-3.8b").replace(dtype=torch.float32,
                                          param_dtype=torch.float32, **kw)
    return jc, tc


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tree_rel(port_tree, jax_tree) -> float:
    """The largest leaf-wise ``rel`` between a tree of tensors in the JAX
    layout and a JAX (or numpy) tree."""
    leaves = jax.tree_util.tree_leaves_with_path(jax_tree)
    flat = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    return max(rel(flat[path], leaf) for path, leaf in leaves)


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["synthetic", "file"])
@pytest.mark.parametrize("shard", [0, 1])
def test_batches_are_the_jax_package_s_bit_for_bit(tmp_path, source, shard):
    path = tmp_path / "corpus.txt"
    path.write_text("the port reads the same bytes as the reference; " * 40)
    kw = dict(batch_size=3, seq_len=24, vocab_size=97, seed=5,
              source=source, path=str(path), shard_index=shard,
              shard_count=2)
    mine = make_dataset(DataConfig(**kw))
    theirs = jmake_dataset(JDataConfig(**kw))
    for step in (0, 1, 7):
        got, want = mine(step), theirs(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    if source == "synthetic":
        # each shard draws its own stream
        other = synthetic_token_stream(DataConfig(**dict(kw, shard_index=1
                                                          - shard)), 0)
        assert not np.array_equal(mine(0)["tokens"], other)


# -- loss and gradients ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss and gradients of the f32 smoke phi3 on a
    seeded batch (``remat`` moves no value: one reference for every
    case)."""
    jc, _ = configs()
    jp = jinit(jc, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True),
                           static_argnums=1)(
        jp, jc, {"tokens": jnp.asarray(toks)})
    return numpy_tree(jp), toks, jl, jm, jg


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_every_gradient_match_jax(jax_grads, remat):
    jp, toks, jl, jm, jg = jax_grads
    _, tc = configs(remat=remat)
    model = lm_params_from_numpy(tc, jp, device=CPU)
    tl, tm = loss_fn(model, tc, {"tokens": torch.from_numpy(toks)})
    assert rel(tl, jl) <= GRAD_RTOL
    assert set(tm) == set(jm) and float(tm["aux_loss"]) == 0.0
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in model.named_parameters()])
    assert tree_rel(params_tree(dict(zip(names, grads))), jg) <= GRAD_RTOL


def test_loss_takes_labels_and_a_mask():
    jc, tc = configs()
    jp = jinit(jc, jax.random.PRNGKey(1))
    model = lm_params_from_numpy(tc, numpy_tree(jp), device=CPU)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) < 0.7).astype(np.float32)
    want, _ = jloss_fn(jp, jc, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels),
                                "loss_mask": jnp.asarray(mask)})
    got, _ = loss_fn(model, tc, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels),
                                 "loss_mask": torch.from_numpy(mask)})
    assert rel(got, want) <= GRAD_RTOL


def test_flash_config_refuses_to_train():
    """Neither package's flash kernel has a derivative: the trainer refuses
    a flash config, and a backward through the flash branch raises instead
    of training quietly through another branch."""
    _, tc = configs(use_flash_kernel=True)
    with pytest.raises(NotImplementedError, match="no derivative"):
        make_train_step(tc, TrainConfig())
    from repro_torch.models import init_params
    model = init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.randint(0, tc.vocab_size, (1, 256),
                         generator=torch.Generator().manual_seed(0))
    loss, _ = loss_fn(model, tc, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="no derivative"):
        loss.backward()
    with torch.inference_mode():                 # serving: no derivative
        assert torch.isfinite(loss_fn(model, tc, {"tokens": toks})[0])
    with pytest.raises(NotImplementedError, match="parallel/ slice"):
        make_train_step(configs()[1], TrainConfig(), lm=object())


def test_bad_step_gate_leaves_the_state_untouched():
    _, tc = configs()
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    model = init_params(tc, torch.Generator().manual_seed(0))
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=1))
    step = make_train_step(tc, tcfg)
    opt = adamw_init(dict(model.named_parameters()), tcfg.opt)
    clip = pipelined_clip_init()
    batch = {"tokens": torch.from_numpy(synthetic_token_stream(DataConfig(
        batch_size=2, seq_len=16, vocab_size=tc.vocab_size), 0))}
    # one accepted step first, so every part of the state is non-trivial
    model, opt, clip, m = step(model, opt, clip, batch, torch.tensor(1e9))
    assert float(m["accepted"]) == 1.0 and int(opt["count"]) == 1
    before = state_tree(model, opt, clip)
    with torch.no_grad():
        model.final_norm[0] = float("inf")       # a non-finite step
    before["params"]["final_norm"][0] = float("inf")
    for spike in (1e9, 0.0):                     # then a spiking one
        model, opt, clip, m = step(model, opt, clip, batch,
                                   torch.tensor(spike))
        assert float(m["accepted"]) == 0.0
        after = state_tree(model, opt, clip)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(after),
                jax.tree_util.tree_leaves_with_path(before)):
            assert torch.equal(a, b), path
        with torch.no_grad():
            model.final_norm[0] = 1.0
        before["params"]["final_norm"][0] = 1.0


# -- checkpoints across the packages ---------------------------------------------

DATA = dict(batch_size=2, seq_len=16, seed=3)


def _opt(state_dtype="f32"):
    return dict(lr=3e-3, warmup_steps=1, decay_steps=5,
                state_dtype=state_dtype)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's 5 steps of the f32 smoke phi3, checkpointed every
    2 steps (2, 4 and 5 kept)."""
    jc, _ = configs()
    d = tmp_path_factory.mktemp("jax_ckpt")
    out = jtrain(jc, JDataConfig(vocab_size=jc.vocab_size, **DATA),
                 JTrainConfig(steps=5, ckpt_every=2, ckpt_dir=str(d),
                              opt=JAdamWConfig(**_opt())))
    return d, out


def test_port_resumes_a_jax_checkpoint(tmp_path, jax_run):
    """Both packages step on from the JAX package's step-2 checkpoint: the
    port through its own restore, and through ``train_state_from_numpy`` of
    the JAX restore; the losses of steps 2-4 agree.  Then the JAX package
    restores the port's step-5 checkpoint, bit for bit the port's state."""
    jdir, jout = jax_run
    jc, tc = configs()
    mine = tmp_path / "port"
    mine.mkdir()
    for suffix in (".npz", ".json"):
        shutil.copy(jdir / f"step_00000002{suffix}", mine)
    out = train(tc, DataConfig(vocab_size=tc.vocab_size, **DATA),
                TrainConfig(steps=5, ckpt_every=2, ckpt_dir=str(mine),
                            opt=AdamWConfig(**_opt())), device=CPU)
    assert out["start_step"] == 2
    want = [h["loss"] for h in jout["history"][2:]]
    got = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [2, 3, 4]
    assert all(h["accepted"] for h in out["history"])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    # the same from the JAX restore carried over in memory
    jparams = jinit(jc, jax.random.PRNGKey(0))
    jopt = jadamw_init(jparams, JAdamWConfig(**_opt()))
    tpl = {"params": jparams, "opt": jopt, "clip": jclip_init()}
    jstate, _ = jrestore(tpl, jdir, step=2)
    state = train_state_from_numpy(tc, numpy_tree(jstate), device=CPU)
    model, opt, clip = state["params"], state["opt"], state["clip"]
    step = make_train_step(tc, TrainConfig(opt=AdamWConfig(**_opt())))
    batch_fn = make_dataset(DataConfig(vocab_size=tc.vocab_size, **DATA))
    losses = []
    for s in (2, 3, 4):
        batch = {k: torch.from_numpy(v) for k, v in batch_fn(s).items()}
        model, opt, clip, m = step(model, opt, clip, batch,
                                   torch.tensor(1e9))
        losses.append(float(m["loss"]))
    assert losses == got                         # the same state, bitwise

    # the JAX package restores the port's last checkpoint
    restored, at = jrestore(tpl, mine)
    assert at == 5
    port_state = state_tree(out["params"], *_opt_clip(out, mine, tc))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(numpy_tree(restored)),
            jax.tree_util.tree_leaves_with_path(port_state)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=str(path))
    assert tree_rel(port_state["params"], jout["params"]) <= 1e-5


def _opt_clip(out, directory, tc):
    """The port's optimizer and clip state as its step-5 checkpoint holds
    them (``train`` returns only the parameters)."""
    from repro_torch.optim import adamw_init
    model = out["params"]
    tpl = state_tree(model, adamw_init(dict(model.named_parameters()),
                                       AdamWConfig(**_opt())),
                     pipelined_clip_init())
    tree, _ = restore_pytree(tpl, directory)
    from repro_torch.train import load_state_tree
    return load_state_tree(model, tree)


def test_eight_bit_state_crosses_both_ways(tmp_path):
    """An AdamW state with 8-bit moments: the JAX package's, carried over
    with ``train_state_from_numpy``, equals it; written by the port, the
    JAX package restores it with its own ``Q8`` leaves."""
    jc, tc = configs()
    jp = jinit(jc, jax.random.PRNGKey(2))
    jcfg = JAdamWConfig(**_opt("i8"))
    jopt = jadamw_init(jp, jcfg)
    grads = jax.tree_util.tree_map(lambda p: jnp.sin(p * 7.0) + 0.1, jp)
    jp, jopt = jax.jit(jadamw_update, static_argnums=3)(jp, grads, jopt,
                                                         jcfg)
    jstate = {"params": jp, "opt": jopt, "clip": jclip_init()}
    state = train_state_from_numpy(tc, numpy_tree(jstate), state_dtype="i8",
                                   device=CPU)
    tree = state_tree(state["params"], state["opt"], state["clip"])
    for key in ("m", "v"):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(numpy_tree(jopt[key])),
                jax.tree_util.tree_leaves_with_path(tree["opt"][key])):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=str(path))
    m0 = state["opt"]["m"]["layers.0.attn.p.wq"]
    assert m0.codes.dtype == torch.int8
    np.testing.assert_array_equal(
        dequantize(m0).numpy(),
        np.asarray(jdequantize(jopt["m"]["layers"]["attn"]["wq"]))[0])
    from repro_torch.train import save_pytree
    save_pytree(tree, tmp_path, 7)
    restored, at = jrestore(jstate, tmp_path)
    assert at == 7
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(numpy_tree(restored)),
            jax.tree_util.tree_leaves_with_path(numpy_tree(jstate))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# -- the loop --------------------------------------------------------------------

def test_restart_after_an_injected_failure_matches_the_uninterrupted_run(
        tmp_path):
    _, tc = configs()
    dcfg = DataConfig(vocab_size=tc.vocab_size, **DATA)

    def tcfg(d):
        return TrainConfig(steps=8, ckpt_every=4, ckpt_dir=str(tmp_path / d),
                           opt=AdamWConfig(**_opt()))

    ref = train(tc, dcfg, tcfg("ref"), device=CPU)
    inj = FailureInjector(fail_at=[6])
    out = run_with_restarts(
        lambda: train(tc, dcfg, tcfg("ft"), injector=inj, device=CPU),
        max_restarts=2)
    assert out["restarts"] == 1
    assert out["start_step"] == 4               # resumed from the step-4 ckpt
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"][4:]]
    for a, b in zip(ref["params"].parameters(), out["params"].parameters()):
        assert torch.equal(a, b)


def test_restart_sees_a_checkpoint_still_being_written(tmp_path,
                                                       monkeypatch):
    """A step that raises while the last checkpoint is still being written
    on its thread: the loop joins the write before the failure leaves it,
    so the restart in the same process resumes from that checkpoint
    (ROADMAP C21; on the card a 7.8 GB write took 8.7 s and the restart
    began from step 0)."""
    import time
    from repro_torch.train import checkpoint
    slow = checkpoint.save_pytree

    def save_slowly(tree, directory, step):
        time.sleep(0.5)
        return slow(tree, directory, step)
    monkeypatch.setattr(checkpoint, "save_pytree", save_slowly)
    _, tc = configs()
    inj = FailureInjector(fail_at=[3])
    out = run_with_restarts(lambda: train(
        tc, DataConfig(vocab_size=tc.vocab_size, **DATA),
        TrainConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                    opt=AdamWConfig(**_opt())), injector=inj, device=CPU),
        max_restarts=1)
    assert out["restarts"] == 1 and out["start_step"] == 2


def test_train_lowers_the_loss(tmp_path):
    """The JAX package's loss test: 30 steps of the bf16 smoke phi3."""
    cfg = tsmoke("phi3-mini-3.8b")
    out = train(cfg, DataConfig(batch_size=4, seq_len=64,
                                vocab_size=cfg.vocab_size),
                TrainConfig(steps=30, ckpt_every=10,
                            ckpt_dir=str(tmp_path), resume=False,
                            opt=AdamWConfig(lr=3e-3, warmup_steps=2,
                                            decay_steps=30)), device=CPU)
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first - 0.2, (first, last)
    assert out["rejected_steps"] == 0
    assert out["checkpoint"]["saves"] == 3


@pytest.mark.parametrize("arch", [None, "phi3-mini-3.8b"])
def test_launcher_trains_three_smoke_steps(tmp_path, arch):
    """The default arch, xlstm-350m as in the JAX launcher, and phi3 named
    explicitly."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    flags = [] if arch is None else ["--arch", arch]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch-size", "2", "--seq-len", "16",
         "--ckpt-dir", str(tmp_path / "ckpt")] + flags,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"arch={arch or 'xlstm-350m'} steps=3" in proc.stdout
    assert (tmp_path / "ckpt" / "step_00000003.npz").exists()
    with pytest.raises(SystemExit), redirect_stdout(io.StringIO()):
        launch_train.main(["--production-mesh"])
