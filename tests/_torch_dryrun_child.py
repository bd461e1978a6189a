"""The dry run's fake process groups, in a process of their own.

    python tests/_torch_dryrun_child.py OUT.json WORKDIR

Spawned by ``tests/test_torch_dryrun.py``: the fake group is process-wide
state, so no test process joins one.  It imports ``repro_torch`` only,
never ``jax``, and writes what the test holds to OUT.json:

* ``fake_pg``: on a 256-rank fake group (the private
  ``torch.testing._internal.distributed.fake_pg`` the dry run relies on),
  an all-reduce returns at once with the tensor as it was, a (16, 16)
  mesh builds, and a DTensor product runs on it;
* ``argument_bytes``: one rank's bytes of each architecture's ``train_4k``,
  ``prefill_32k`` and ``decode_32k`` cells at full width, depth ``DEPTH``,
  on (16, 16) and (2, 16, 16) (keys ``mesh/arch`` for train_4k,
  ``mesh/arch/shape`` for the others);
* ``solver``: ``dryrun_solver``'s one iteration on 8 fake ranks (rank 1)
  over a ``SOLVER_GRID`` grid;
* ``train_cli``: ``launch.train --production-mesh --arch qwen3-8b`` at depth
  1 (its output and record, written under WORKDIR).
"""
import contextlib
import io
import json
import os
import sys
import traceback
import warnings

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun, dryrun_solver, mesh
from repro_torch.launch import train as train_cli
from repro_torch.parallel import LogicalMesh

DEPTH = 2
ARG_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SOLVER_GRID = (16, 8, 8)
SOLVER_RANKS = 8


def fake_pg_case() -> dict:
    mesh.init_fake_group(256)
    try:
        t = torch.arange(4.0)
        work = dist.all_reduce(t, async_op=True)
        work.wait()
        dm = mesh.make_production_mesh()
        from torch.distributed.tensor import Shard, distribute_tensor
        x = distribute_tensor(torch.ones(32, 8), dm, [Shard(0), Shard(1)])
        y = (x @ x.T.redistribute(dm, [Shard(1), Shard(0)]))
        return {"world": dist.get_world_size(), "backend": dist.get_backend(),
                "all_reduce_untouched": t.tolist() == [0.0, 1.0, 2.0, 3.0],
                "mesh": list(dm.shape), "names": list(dm.mesh_dim_names),
                "product_local": list(y.to_local().shape),
                "product_global": list(y.shape)}
    finally:
        dist.destroy_process_group()


def argument_bytes_case() -> dict:
    out = {}
    for multi_pod in (False, True):
        with mesh.fake_group(multi_pod):
            lm = LogicalMesh(mesh.make_production_mesh(multi_pod=multi_pod))
            for arch in ARCH_IDS:
                for shape in ARG_SHAPES:
                    with FakeTensorMode(allow_non_fake_inputs=True):
                        cell = dryrun.build_cell(arch, shape, multi_pod,
                                                 {"n_layers": DEPTH}, lm=lm)
                        key = f"{mesh.mesh_name(multi_pod)}/{arch}"
                        if shape != "train_4k":
                            key += f"/{shape}"
                        out[key] = dryrun.local_bytes(cell.arguments)
    return out


def solver_case() -> dict:
    mesh.init_fake_group(SOLVER_RANKS, rank=dryrun_solver.RANK)
    try:
        nx, ny, nz = SOLVER_GRID
        step, state, consts, fn = dryrun_solver.build_step(
            "p-bicgsafe", None, nx, ny, nz)
        with FakeTensorMode(allow_non_fake_inputs=True):
            per = dryrun_solver.count_steps(step, state, consts)
        per.pop("state")
        per["local_shape"] = list(fn.layout.local_shape)
        return per
    finally:
        dist.destroy_process_group()


def train_cli_case(workdir: str) -> dict:
    real = dryrun.get_config
    dryrun.get_config = lambda arch: real(arch).replace(n_layers=1)
    cwd = os.getcwd()
    os.chdir(workdir)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rec = train_cli.main(["--arch", "qwen3-8b", "--production-mesh"])
    finally:
        os.chdir(cwd)
        dryrun.get_config = real
    path = os.path.join(workdir, dryrun.OUT, "pod16x16",
                        "qwen3-8b__train_4k.json")
    return {"stdout": buf.getvalue(), "record": rec,
            "written": os.path.exists(path)}


def main():
    out_path, workdir = sys.argv[1:3]
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    out = {}
    try:
        out["fake_pg"] = fake_pg_case()
        out["argument_bytes"] = argument_bytes_case()
        out["solver"] = solver_case()
        out["train_cli"] = train_cli_case(workdir)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        with open(out_path, "w") as f:
            json.dump(out, f, default=str)


if __name__ == "__main__":
    main()
