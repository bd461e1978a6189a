"""Serving launcher: batched greedy decoding on a reduced config, on the
card (PyTorch port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --requests 6

``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import smoke_config
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg = smoke_config(args.arch)
    eng = ServingEngine(cfg, ServeConfig(
        max_batch=args.max_batch,
        max_len=args.prompt_len + args.max_new + 8), device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        eng.submit(Request(
            prompt=list(rng.integers(1, cfg.vocab_size,
                                     args.prompt_len).astype(int)),
            max_new_tokens=args.max_new))
    done = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    for r in done[:4]:
        print(f"req {r.rid}: {len(r.output)} tokens -> {r.output[:8]}...")
    print(f"{len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {eng.device}")
    return done


if __name__ == "__main__":
    main()
