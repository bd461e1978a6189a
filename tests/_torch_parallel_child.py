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
  included: the loss and gradients of the port's seed-0 weights.
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

from repro_torch import lm_params_from_numpy
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.data import DataConfig, make_dataset
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import LogicalMesh
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
        for case in (mesh_cases, training_cases, family_cases):
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
