"""One rank of the port's mesh-training checks: gloo processes on the CPU.

    python tests/_torch_parallel_child.py RANK WORLD STORE INPUTS OUTDIR

Spawned by ``tests/test_torch_parallel_mesh.py``, WORLD (8) processes at
once, each with its own RANK; they meet through the ``file://`` store
STORE.  INPUTS is an ``.npz`` of the JAX package's initial weights of the
f32 smoke phi3 and llama4 (keys ``phi3/layers/attn/wq``, ...) and the
batch ``tokens``.  Every rank runs every case (the steps are SPMD); rank 0
writes what the test reads to OUTDIR (``arrays.npz``: gathered gradients;
``scalars.json``: losses, shard shapes, bytes per rank).  It imports
``repro_torch`` only, never ``jax``.

* phi3 on (2, 4) ("data", "model"), (8,) ("data",) and (2, 2, 2) ("pod",
  "data", "model"): the loss and every gradient of the JAX weights (on
  (2, 4) also with remat "full" and "dots"); each rank's shard shapes and
  bytes of parameters and moments;
* phi3 trained 6 steps on (2, 4), checkpointed at step 6, and one step on
  each other mesh; 2 steps on (2, 4) with 8-bit moments; 4 steps on (2, 4) under ``run_with_restarts`` with a
  failure injected at step 3 (checkpoints every 2 steps);
* llama4 (MoE, gather dispatch) on (2, 4): the loss and every gradient of
  the JAX weights;
* every other smoke config on (2, 4), deepseek-v3's sort dispatch
  included: the loss and gradients of the port's seed-0 weights;
* the repaired mesh mechanisms on (2, 4) (``REPAIRS``, each run by
  :func:`repair_run`, which the test also calls on one device): a train
  step with 6 heads on the 4-way model axis (the JAX weights under
  ``heads/``); decode steps on a cache sharded by its sequence, after a
  one-device prefill, for phi3 (batch and heads merged into the scores'
  product), deepseek-v3's absorbed MLA, the xlstm (two pairs) and zamba2
  at B = 1 (a batch the "data" axis cannot split); whisper's train step
  (batch and sequence folded into its products' rows).  A case that fails
  records its error and the others run on.
"""
import dataclasses
import json
import os
import sys
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import lm_params_from_numpy
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.data import DataConfig, make_dataset
from repro_torch.launch.dryrun import div_spec
from repro_torch.models import (cache_logical_axes, decode_step, init_cache,
                                init_params, prefill_step)
from repro_torch.models.transformer import state_entries
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import LogicalMesh
from repro_torch.parallel.sharding import mesh_context
from repro_torch.train import (FailureInjector, TrainConfig,
                               run_with_restarts, train)
from repro_torch.train.train_loop import (loss_and_grads, place_model,
                                          place_opt_state)

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "8": ((8,), ("data",)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=12)


def f32(arch):
    return smoke_config(arch).replace(dtype=torch.float32,
                                      param_dtype=torch.float32)


def tree_of(flat, prefix):
    """The nested JAX tree of the ``prefix/``-keyed arrays."""
    tree = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def storage_bytes(t):
    return t.to_local().untyped_storage().nbytes()


class Run:
    def __init__(self, rank, outdir):
        self.rank, self.outdir = rank, outdir
        self.arrays, self.scalars = {}, {}

    def gathered(self, value):
        """Every rank's ``value``, in rank order."""
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, value)
        return out

    def grads(self, name, cfg, model, batch, lm):
        """The loss and every gradient (gathered whole) of ``model`` placed
        on ``lm``."""
        loss, _, grads = loss_and_grads(model, cfg, batch, lm)
        self.scalars[f"loss/{name}"] = float(loss)
        for k, g in grads.items():
            full = g.full_tensor()
            if self.rank == 0:
                self.arrays[f"grad/{name}/{k}"] = full.numpy()
        return grads


def mesh_cases(run, flat, tokens, outdir):
    cfg = f32("phi3-mini-3.8b")
    tree = tree_of(flat, "phi3")
    for mname, (shape, names) in MESHES.items():
        lm = LogicalMesh(init_device_mesh("cpu", shape, mesh_dim_names=names))
        model = lm_params_from_numpy(cfg, tree, device="cpu")
        specs = place_model(model, lm)
        params = dict(model.named_parameters())
        run.grads(f"phi3/{mname}", cfg, model, {"tokens": tokens}, lm)
        opt = place_opt_state(adamw_init(params, OPT), specs, lm)
        mine = {
            "shapes": {k: list(p.to_local().shape) for k, p in params.items()},
            "placements": {k: [str(x) for x in p.placements]
                           for k, p in params.items()},
            "param_bytes": sum(storage_bytes(p) for p in params.values()),
            "moment_bytes": sum(storage_bytes(s) for part in ("m", "v")
                                for s in opt[part].values()),
            "moments_placed": all(
                opt[part][k].placements == p.placements
                for part in ("m", "v") for k, p in params.items()),
        }
        run.scalars[f"ranks/{mname}"] = run.gathered(mine)
        if mname == "2x4":
            # the blocks rematerialised in the backward, on the mesh
            for remat in ("full", "dots"):
                rcfg = cfg.replace(remat=remat)
                model = lm_params_from_numpy(rcfg, tree, device="cpu")
                place_model(model, lm)
                run.grads(f"phi3_{remat}/{mname}", rcfg, model,
                          {"tokens": tokens}, lm)


def training_cases(run, flat, tokens, outdir):
    cfg = f32("phi3-mini-3.8b")
    dcfg = DataConfig(batch_size=4, seq_len=32, vocab_size=cfg.vocab_size)
    for mname, (shape, names) in MESHES.items():
        lm = LogicalMesh(init_device_mesh("cpu", shape, mesh_dim_names=names))
        steps = 6 if mname == "2x4" else 1
        tcfg = TrainConfig(steps=steps, ckpt_every=6, opt=OPT,
                           ckpt_dir=os.path.join(outdir, f"ckpt_{mname}"))
        out = train(cfg, dcfg, tcfg, lm=lm)
        run.scalars[f"train/{mname}"] = [h["loss"] for h in out["history"]]
        run.scalars[f"train_norms/{mname}"] = [h["grad_norm"]
                                               for h in out["history"]]
        if mname == "2x4":
            run.scalars["train_dtensors/2x4"] = all(
                type(p).__name__ == "DTensor" for p in out["params"].
                parameters())
    # two steps with 8-bit moments on (2, 4): codes placed as their
    # parameters, scales as their leading dimensions
    lm = LogicalMesh(init_device_mesh("cpu", MESHES["2x4"][0],
                                      mesh_dim_names=MESHES["2x4"][1]))
    i8 = TrainConfig(steps=2, ckpt_every=100, opt=dataclasses.replace(
        OPT, state_dtype="i8"), ckpt_dir=os.path.join(outdir, "ckpt_i8"))
    out = train(cfg, dcfg, i8, lm=lm)
    run.scalars["train_i8/2x4"] = [h["loss"] for h in out["history"]]
    # a failure at step 3 after the checkpoint of step 2: the supervisor
    # restarts the run, which resumes on the same mesh
    shape, names = MESHES["2x4"]
    lm = LogicalMesh(init_device_mesh("cpu", shape, mesh_dim_names=names))
    tcfg = TrainConfig(steps=4, ckpt_every=2, opt=OPT,
                       ckpt_dir=os.path.join(outdir, "ckpt_restart"))
    injector = FailureInjector([3])
    history = []
    out = run_with_restarts(lambda: train(
        cfg, dcfg, tcfg, lm=lm, injector=injector,
        callback=lambda step, rec: history.append(rec["loss"])))
    run.scalars["restart/2x4"] = {"restarts": out["restarts"],
                                  "start_step": out["start_step"],
                                  "losses": history}


def family_cases(run, flat, tokens, outdir):
    shape, names = MESHES["2x4"]
    lm = LogicalMesh(init_device_mesh("cpu", shape, mesh_dim_names=names))
    cfg = f32("llama4-scout-17b-a16e")
    assert cfg.moe_impl == "gather"
    model = lm_params_from_numpy(cfg, tree_of(flat, "llama4"), device="cpu")
    place_model(model, lm)
    run.grads("llama4/2x4", cfg, model, {"tokens": tokens}, lm)
    for arch in ARCH_IDS:
        if arch in ("phi3-mini-3.8b", "llama4-scout-17b-a16e"):
            continue
        cfg = f32(arch)
        batch = {k: torch.as_tensor(v) for k, v in make_dataset(
            DataConfig(batch_size=4, seq_len=32, vocab_size=cfg.vocab_size),
            cfg)(0).items()}
        model = init_params(cfg, torch.Generator().manual_seed(0))
        place_model(model, lm)
        run.grads(f"{arch}/2x4", cfg, model, batch, lm)


#: the repaired mechanisms' cases: (arch, config changes, kind, B, S)
REPAIRS = {
    "heads_train": ("qwen2.5-32b", dict(n_heads=6, n_kv_heads=2,
                                        head_dim=16), "train", 4, 32),
    "merge_decode": ("phi3-mini-3.8b", {}, "decode", 4, 16),
    "mla_decode": ("deepseek-v3-671b", {}, "decode", 4, 16),
    "xlstm_decode": ("xlstm-350m", {}, "decode", 4, 16),
    "batch1_decode": ("zamba2-1.2b", {}, "decode", 1, 16),
    "merge_train": ("whisper-tiny", {}, "train", 4, 256),
}
REPAIR_STEPS = 3          # decode steps, into a cache of S + 4 rows
REPAIR_SEED = 7


def repair_config(case):
    arch, over, _, _, _ = REPAIRS[case]
    return f32(arch).replace(**over)


def repair_batch(cfg, B, S):
    rng = np.random.default_rng(REPAIR_SEED)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
    return batch


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed(t, lm, *names):
    return distribute_tensor(t, lm.mesh,
                             lm.placements(div_spec(lm, t.shape, *names)))


def repair_run(case, lm=None, flat=None):
    """The outputs of ``case`` on ``lm`` (``None``: one device) as numpy
    arrays: a train case's loss and every gradient; a decode case's logits
    of each step and its cache after them.  The weights are the seed-0
    ones, or the JAX tree in ``flat`` under the case's short name."""
    _, _, kind, B, S = REPAIRS[case]
    cfg = repair_config(case)
    if flat is not None:
        model = lm_params_from_numpy(cfg, tree_of(flat, case.split("_")[0]),
                                     device="cpu")
    else:
        model = init_params(cfg, torch.Generator().manual_seed(0))
    batch = repair_batch(cfg, B, S)
    if kind == "train":
        if lm is not None:
            place_model(model, lm)
        loss, _, grads = loss_and_grads(model, cfg, batch, lm)
        out = {"loss": np.asarray(float(loss.detach()))}
        out.update({"grad/" + k: _whole(g).numpy() for k, g in grads.items()})
        return out
    # decode: a one-device prefill spliced into a cache of S + 4 rows (a
    # multiple of the model axis, so that "seq" shards it), then the steps
    with torch.no_grad():
        logits, pcache = prefill_step(model, cfg, batch)
    cache = init_cache(cfg, B, S + 4, device="cpu")
    for key, dst in cache.items():
        src = pcache[key]
        if key in state_entries(cfg):
            dst.copy_(src)
        else:
            dst[:, :, :src.shape[2]].copy_(src)
    cur = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    if lm is not None:
        place_model(model, lm)
        axes = cache_logical_axes(cfg)
        cache = {k: _placed(v, lm, *axes[k]) for k, v in cache.items()}
    out = {}
    for i in range(REPAIR_STEPS):
        tok = cur if lm is None else _placed(cur, lm, "batch", None)
        with torch.no_grad(), mesh_context(lm):
            lg, cache = decode_step(model, cfg, cache, tok, torch.tensor(
                S + i, dtype=torch.int32))
        lg = _whole(lg)
        out[f"logits{i}"] = lg.numpy()
        cur = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
    out.update({"cache/" + k: _whole(v).numpy() for k, v in cache.items()})
    return out


def repair_cases(run, flat, tokens, outdir):
    shape, names = MESHES["2x4"]
    lm = LogicalMesh(init_device_mesh("cpu", shape, mesh_dim_names=names))
    for case in REPAIRS:
        try:
            got = repair_run(case, lm, flat if case == "heads_train"
                             else None)
        except Exception:                # noqa: BLE001 - the next case runs
            run.scalars[f"repair_error/{case}"] = traceback.format_exc()
            continue
        if run.rank == 0:
            run.arrays.update({f"repair/{case}/{k}": v
                               for k, v in got.items()})


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, outdir = sys.argv[3:6]
    torch.set_num_threads(1)            # one thread a rank
    torch.set_num_interop_threads(1)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        data = dict(np.load(inputs))
        tokens = torch.from_numpy(data.pop("tokens"))
        run = Run(rank, outdir)
        for case in (mesh_cases, training_cases, family_cases,
                     repair_cases):
            t0 = time.perf_counter()
            case(run, data, tokens, outdir)
            if rank == 0:
                print(f"{case.__name__}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
        if rank == 0:
            os.makedirs(outdir, exist_ok=True)
            np.savez(os.path.join(outdir, "arrays.npz"), **run.arrays)
            with open(os.path.join(outdir, "scalars.json"), "w") as f:
                json.dump(run.scalars, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)        # the other ranks' collectives fail, not hang
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
