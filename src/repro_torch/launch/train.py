"""Training launcher: trains a reduced config end to end on one device
(PyTorch port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
      --steps 200 --batch-size 8 --seq-len 128

``--device cpu`` runs it on the CPU (the default is the card).  The flags
and defaults are the JAX launcher's (``--arch`` xlstm-350m), but
``--production-mesh`` refuses: the JAX package's HLO dry-run has no
counterpart in the port yet (ROADMAP A11.11).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--production-mesh", action="store_true",
                    help="lower against the production mesh (the JAX "
                         "package's dry-run; not in the port yet)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        ap.error("--production-mesh: the HLO dry-run waits for the launch/ "
                 "slice of the PyTorch port (ROADMAP A11.11)")

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(batch_size=args.batch_size, seq_len=args.seq_len,
                      vocab_size=cfg.vocab_size)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 20),
                        decay_steps=args.steps))
    out = train(cfg, dcfg, tcfg, device=args.device)
    first = out["history"][0]["loss"] if out["history"] else float("nan")
    print(f"arch={cfg.name} steps={args.steps} "
          f"loss {first:.4f} -> {out['final_loss']:.4f} "
          f"rejected={out['rejected_steps']} "
          f"stragglers={out['straggler_stats']}")
    return out


if __name__ == "__main__":
    main()
