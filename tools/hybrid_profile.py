"""Where a zamba2-1.2b decode step and prefill spend the card's time:
chip_smoke.py's phase 4e model (full width and depth, seeded bf16) at
B = 4 behind its engine, a prefill of PROMPT tokens (4e's 5,120 by
default) spliced into the decode program (its rings full, so every step
rolls them).

    python3 tools/hybrid_profile.py [--prompt N] [--reps R]

Prints, with the card's name and power limit: the graphed step's time
(CUDA events over R replays) and its kernels by name from a profiler trace
(device ms a step and launches a step, the largest first); each part of
the step captured as a CUDA graph of its own and timed the same way (the
14 ring rolls, one Mamba2 layer's decode and its state write-back, one
application of the shared block, the head), their sum against the step;
and one prefill's kernels by name.  Run on the card from the root of a
checkout (about a minute); it launches no kernel of the port."""
import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def graph_ms(fn, reps: int) -> float:
    """``fn`` captured as one CUDA graph (after an eager warm-up), then the
    median over 5 trials of ``reps`` replays each, CUDA events around
    them, in ms a replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cs.device_ms(torch, graph.replay, reps=reps)


def kernels_by_name(fn, calls: int, trace: str):
    """``fn`` run ``calls`` times under the profiler: {kernel name: (device
    ms a call, launches a call)}, the largest first."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "build", "profile"), exist_ok=True)
    path = os.path.join(ROOT, "build", "profile", f"{trace}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    ms, n = collections.Counter(), collections.Counter()
    for e in events:
        ms[e["name"][:90]] += e["dur"] / 1e3 / calls
        n[e["name"][:90]] += 1 / calls
    return [(name, t, n[name]) for name, t in ms.most_common()]


def print_kernels(label: str, rows, top: int = 15) -> None:
    total = sum(t for _, t, _ in rows)
    launches = sum(c for _, _, c in rows)
    cs.log(f"{label}: {total:.3f} ms of kernels and {launches:.0f} launches "
           f"a call, by name (the largest {top}) [{cs.card()}]")
    for name, t, c in rows[:top]:
        cs.log(f"  {t:9.4f} ms  {c:6.0f}x  {t / total:6.3f}  {name}")


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=cs.HYBRID_PROMPT)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hybrid_profile: no CUDA device is available")
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import _lm_head, _roll_full
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config(cs.HYBRID_ARCH)
    B = cs.SERVE_REQUESTS
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    prompts = [torch.randint(1, cfg.vocab_size, (args.prompt,),
                             generator=gen).tolist() for _ in range(B)]
    eng = ServingEngine(cfg, ServeConfig(max_batch=B,
                                         max_len=cs.HYBRID_MAX_LEN),
                        params=model, device="cuda")
    cs.warm_engine(torch, eng, prompts)
    tokens = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits, pcache = eng.prefill(tokens)
        prog = eng._splice(pcache, logits[:, -1].argmax(dim=-1),
                           args.prompt)
        del logits, pcache
        step_ms = cs.device_ms(torch, prog.step, reps=args.reps)
        cs.log(f"graphed step at cache_len >= {args.prompt}: "
               f"{step_ms:.4f} ms (CUDA events, {args.reps} replays) "
               f"[{cs.card()}]")
        print_kernels("graphed step", kernels_by_name(prog.step, 8,
                                                      "hybrid_step"))

        cache, W = prog.cache, prog.cache["attn_k"].shape[2]
        full = torch.ones((), dtype=torch.bool, device="cuda")
        wpos = torch.full((), W - 1, dtype=torch.int64, device="cuda")
        pos = torch.full((B,), args.prompt, dtype=torch.int64, device="cuda")
        x = torch.randn(B, 1, cfg.d_model, device="cuda", dtype=cfg.dtype,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(11))
        npts = cache["attn_k"].shape[0]

        def rolls():
            for key in ("attn_k", "attn_v"):
                for j in range(npts):
                    _roll_full(cache[key][j], full)

        layer = model.layers[1]

        def mamba():
            _, st = layer.decode(x, {"h": cache["ssm_h"][1],
                                     "conv": cache["ssm_conv"][1]}, cfg)
            cache["ssm_h"][1].copy_(st["h"])
            cache["ssm_conv"][1].copy_(st["conv"])

        def shared():
            model.shared_attn.decode(x, pos, cache["attn_k"][0],
                                     cache["attn_v"][0], wpos, cfg)

        def head():
            _lm_head(model, cfg, x)

        parts = {"rolls (all 14 rings)": (rolls, 1),
                 "Mamba2 layer decode": (mamba, cfg.n_layers),
                 "shared block decode": (shared, npts),
                 "head": (head, 1)}
        total = 0.0
        for label, (fn, times) in parts.items():
            ms = graph_ms(fn, args.reps)
            total += ms * times
            cs.log(f"  {label}: {ms:.4f} ms x {times} = {ms * times:.4f} "
                   f"ms, {ms * times / step_ms:.3f} of the step")
        cs.log(f"  the parts sum to {total:.4f} ms of the step's "
               f"{step_ms:.4f} [{cs.card()}]")
        del prog
        eng.programs.clear()
        torch.cuda.empty_cache()
        print_kernels("prefill", kernels_by_name(
            lambda: eng.prefill(tokens), 1, "hybrid_prefill"), top=20)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
