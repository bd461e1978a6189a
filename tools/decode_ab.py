"""Time deepseek-v3's decode step of one checkout on the card, eager and
graphed: chip_smoke.py's phase 4c model (full width, depth ``MLA_LAYERS``,
seeded bf16 weights, the sort dispatch) served on phase 4's prompts
(``SERVE_REQUESTS`` x ``SERVE_PROMPT`` tokens, ``SERVE_NEW`` new ones)
``--rounds`` times through chip_smoke.py's ``serve_eager_and_graphed``
(the same bars: graphed = eager tokens, no new capture), and the host's
time to check and enqueue one ``ops.grouped_mm`` call at a decode step's
shape (layer 0's ``wi``, no sync); prints one ``DECODE <label> {...}``
line of ms and µs.

    python3 tools/decode_ab.py ROOT LABEL [--rounds 3]

ROOT is a checkout (this one, or another unpacked under ``build/``); run
two checkouts in turns on the card (a b b a) to compare them in one call.
"""
import argparse
import json
import os
import statistics
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("label")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.serve import ServeConfig, ServingEngine
    _build.library()
    cfg = get_config(cs.MLA_ARCH).replace(n_layers=cs.MLA_LAYERS,
                                          use_mtp=False)
    eng = ServingEngine(cfg, ServeConfig(
        max_batch=cs.SERVE_REQUESTS,
        max_len=cs.SERVE_PROMPT + 2 * cs.SERVE_NEW))
    prompts = cs.serve_prompts(torch, cfg.vocab_size)
    cs.warm_engine(torch, eng, prompts)
    out = {"eager_ms": [], "graph_ms": [], "eager_range_ms": [],
           "prefill_ms": []}
    for _ in range(args.rounds):
        runs = cs.serve_eager_and_graphed(torch, ops, eng, prompts,
                                          args.label)
        out["eager_ms"].append(runs["eager"]["decode_step_ms"])
        out["eager_range_ms"].append(runs["eager"]["decode_step_ms_range"])
        out["graph_ms"].append(runs["graph"]["decode_step_ms"])
        out["prefill_ms"].append(runs["graph"]["prefill_ms"])

    # one grouped call's host time at a decode step's shape: 32 rows, 8 of
    # the 256 experts hit, 4 rows each
    w = eng.params.layers[0].moe.p["wi"]
    R = cs.SERVE_REQUESTS * cfg.moe_top_k
    x = torch.randn(R, w.shape[1], device=w.device, dtype=w.dtype)
    offsets = torch.full((w.shape[0] + 1,), R, dtype=torch.int64,
                         device=w.device)
    offsets[:9] = torch.arange(0, R + 1, 4, device=w.device)
    with torch.inference_mode():
        for _ in range(5):
            ops.grouped_mm(x, w, offsets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            ops.grouped_mm(x, w, offsets)
        out["grouped_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    out["eager_median_ms"] = statistics.median(out["eager_ms"])
    out["graph_median_ms"] = statistics.median(out["graph_ms"])
    out["card"] = cs.card()
    print("DECODE", args.label, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
