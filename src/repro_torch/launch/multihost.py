"""Multi-host bring-up (PyTorch port of ``repro.launch.multihost``).

Each host runs this same program; ``torch.distributed`` wires the
processes together over ``tcp://`` (NCCL on the cards, gloo with
``--device cpu``), after which ``launch.mesh.make_production_mesh()`` and
every step function of the port run unchanged across the ranks.

    python -m repro_torch.launch.multihost --coordinator $HOST0:1234 \\
        --num-processes $N --process-id $I -- \\
        python -m repro_torch.launch.train --arch qwen3-8b --full-config

With no command it initializes the group itself and prints
``distributed ok: <world> global / <local> local``.  With one it runs the
command with ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
set, which :func:`initialize_from_env` (``env://``, what torchrun sets)
reads.  The fault-tolerance contract is the JAX package's: a lost rank
fails the step's collective on every other; the supervisor relaunches all
of them, maybe on another topology (checkpoints are topology-free).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=10)


def _backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def _local_count(device: str) -> int:
    if device == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def initialize_from_args(coordinator: str, num_processes: int,
                         process_id: int, device: str = "cuda"):
    """Join the group at ``tcp://coordinator``; returns ``(world size,
    local devices)``."""
    if device == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(_backend(device), init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return dist.get_world_size(), _local_count(device)


def initialize_from_env(device: str = "cuda"):
    """torchrun style: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` from the environment (``env://``)."""
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(_backend(device), init_method="env://",
                            timeout=TIMEOUT)
    return dist.get_world_size(), _local_count(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="nccl on the cards (default) or gloo on the CPU")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to run after distributed init")
    args = ap.parse_args(argv)

    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        n, nl = initialize_from_args(args.coordinator, args.num_processes,
                                     args.process_id, args.device)
        try:
            dist.barrier()
            print(f"distributed ok: {n} global / {nl} local", flush=True)
        finally:
            dist.destroy_process_group()
        return
    host, port = args.coordinator.rsplit(":", 1)
    env = dict(os.environ, MASTER_ADDR=host, MASTER_PORT=port,
               WORLD_SIZE=str(args.num_processes),
               RANK=str(args.process_id))
    raise SystemExit(subprocess.call(cmd, env=env))


if __name__ == "__main__":
    main(sys.argv[1:])
