"""The ``python -m repro_torch.observe`` CLI: artifacts and ASCII reports
(PyTorch port of ``repro.observe.report``; the same artifact schemas).

Subcommands (artifact defaults live under the git-ignored ``build/``
tree; every solve runs on the card unless ``--device cpu``):

* ``smoke [--out DIR] [--full] [--device D]`` — run one traced session
  solve and one traced engine burst on a small Poisson problem (fp64) and
  write the artifact set under ``DIR`` (default ``build/observe``):
  ``spans.trace.json`` (Chrome trace events, Perfetto loads it),
  ``metrics.prom`` (Prometheus text exposition), ``metrics.json``
  (snapshot) and ``convergence.json`` (the traced solve's ring).
* ``profile [--out DIR] [--full] [--device D]`` — device timelines
  (:mod:`repro_torch.observe.profile`): one session solve per substrate
  (``"torch"`` and, on the card, ``"cuda"``) and one engine drain, each
  under its own subdirectory of ``DIR`` (default ``build/profile``)
  with the raw timeline, the kernel map and ``profile.json``.
* ``report [--dir DIR]`` — render whatever artifacts live under ``DIR``:
  host span timeline, metrics digest, convergence summary, and any
  ``profile.json`` phase breakdowns (searched one level deep).
* ``trajectory`` — the JAX package's benchmark-trajectory gate reads its
  benchmark registry, which the port has not yet (ROADMAP A10): it says
  so and exits 2.

The solves go through the ordinary front door (``repro_torch.make_solver``
and :class:`repro_torch.service.SolveEngine`), so the artifacts are what
instrumented production code emits.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY
from .spans import RECORDER
from .trace import ConvergenceTrace

SCHEMA_SPANS = "repro.observe/chrome-trace/v1"
SCHEMA_METRICS = "repro.observe/metrics-snapshot/v1"


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


# ---------------------------------------------------------------------------
# smoke
# ---------------------------------------------------------------------------

def run_smoke(out_dir: str, quick: bool = True,
              device=None) -> Dict[str, str]:
    """Traced session solve + traced engine burst; writes the artifact
    set.  Returns ``{artifact name: path}``."""
    import numpy as np

    import repro_torch
    from repro_torch.core import SolverConfig
    from repro_torch.core import matrices as M
    from repro_torch.service import ServiceConfig, SolveEngine

    os.makedirs(out_dir, exist_ok=True)
    nx = 6 if quick else 10
    n_req = 6 if quick else 24

    # -- leg 1: one traced session solve ---------------------------------
    op, b, _ = M.poisson3d(nx, device=device)
    solver = repro_torch.make_solver(
        "p-bicgsafe", op, config=SolverConfig(tol=1e-8, maxiter=800),
        device=device)
    res = solver.solve(b, trace=True)
    trace = res.trace

    # -- leg 2: an engine burst (traced resident block) ------------------
    eng = SolveEngine(ServiceConfig(max_batch=4, chunk=16, tol=1e-8,
                                    maxiter=800, trace_cap=64,
                                    device=device))
    eng.register(op, name="poisson")
    rng = np.random.default_rng(0)
    for _ in range(n_req):
        eng.submit("poisson", rng.standard_normal(op.shape[0]))
    results = eng.run()

    conv_path = os.path.join(out_dir, "convergence.json")
    payload = trace.to_json()
    payload["generated_at"] = _utcnow()
    payload["summary"] = trace.summary()
    with open(conv_path, "w") as fh:
        json.dump(payload, fh)

    spans_path = os.path.join(out_dir, "spans.trace.json")
    doc = RECORDER.chrome_trace()
    doc["metadata"] = {"schema": SCHEMA_SPANS, "generated_at": _utcnow()}
    with open(spans_path, "w") as fh:
        json.dump(doc, fh)

    prom_path = os.path.join(out_dir, "metrics.prom")
    with open(prom_path, "w") as fh:
        fh.write(REGISTRY.prometheus())

    mjson_path = os.path.join(out_dir, "metrics.json")
    with open(mjson_path, "w") as fh:
        json.dump({"schema": SCHEMA_METRICS, "generated_at": _utcnow(),
                   "metrics": REGISTRY.snapshot()}, fh)

    n_conv = sum(r.converged for r in results)
    print(f"smoke: traced solve converged={bool(res.converged)} in "
          f"{int(res.iterations)} iterations on {solver.device}; engine "
          f"retired {len(results)} requests ({n_conv} converged)")
    print(f"artifacts under {out_dir}/: convergence.json, "
          "spans.trace.json, metrics.prom, metrics.json")
    return {"convergence": conv_path, "spans": spans_path,
            "prometheus": prom_path, "metrics": mjson_path}


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------

def run_profile(out_dir: str, quick: bool = True,
                device=None) -> Dict[str, str]:
    """Device-timeline captures: one session solve per substrate (``"cuda"``
    only on the card) plus one engine drain, each written under
    ``out_dir/<leg>/``.  Returns ``{leg name: profile.json path}``."""
    import numpy as np

    import repro_torch
    from repro_torch.core import SolverConfig
    from repro_torch.core import matrices as M
    from repro_torch.core.types import resolve_device
    from repro_torch.service import ServiceConfig, SolveEngine

    os.makedirs(out_dir, exist_ok=True)
    nx = 6 if quick else 10
    n_req = 6 if quick else 24
    out: Dict[str, str] = {}
    dev = resolve_device(device)
    subs = ("torch", "cuda") if dev.type == "cuda" else ("torch",)

    op, b, _ = M.poisson3d(nx, device=dev)
    for sub in subs:
        leg = f"session_{sub}"
        leg_dir = os.path.join(out_dir, leg)
        solver = repro_torch.make_solver(
            "p-bicgsafe", op, substrate=sub,
            config=SolverConfig(tol=1e-8, maxiter=800), device=dev)
        res = solver.solve(b, profile=leg_dir)
        print(f"\n== profile: {leg} (converged={bool(res.converged)}) ==")
        print(solver.last_profile.render())
        out[leg] = os.path.join(leg_dir, "profile.json")

    eng_dir = os.path.join(out_dir, "engine")
    eng = SolveEngine(ServiceConfig(max_batch=4, chunk=16, tol=1e-8,
                                    maxiter=800, substrate=subs[-1],
                                    profile_dir=eng_dir, device=dev))
    eng.register(op, name="poisson")
    rng = np.random.default_rng(0)
    for _ in range(n_req):
        eng.submit("poisson", rng.standard_normal(op.shape[0]))
    results = eng.run()
    print(f"\n== profile: engine ({len(results)} requests, "
          f"{sum(r.converged for r in results)} converged) ==")
    print(eng.last_profile.render())
    out["engine"] = os.path.join(eng_dir, "profile.json")

    print(f"\nprofiles under {out_dir}/: " + ", ".join(sorted(out)))
    return out


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _render_timeline(doc: Dict[str, Any], width: int = 60) -> List[str]:
    events = sorted(doc.get("traceEvents", []), key=lambda e: e["ts"])
    if not events:
        return ["  (no spans recorded)"]
    t0 = events[0]["ts"]
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in events)
    span_us = max(t1 - t0, 1.0)
    lines = []
    name_w = min(max(len(e["name"]) for e in events), 28)
    for e in events[:200]:
        start = e["ts"] - t0
        dur = e.get("dur", 0.0)
        lo = int(width * start / span_us)
        hi = max(lo + 1, int(width * (start + dur) / span_us))
        bar = " " * lo + "█" * min(hi - lo, width - lo)
        lines.append(f"  {e['name'][:name_w]:<{name_w}} "
                     f"|{bar:<{width}}| {dur / 1e3:8.2f} ms")
    if len(events) > 200:
        lines.append(f"  ... {len(events) - 200} more spans")
    lines.append(f"  total window: {span_us / 1e3:.2f} ms, "
                 f"{len(events)} spans")
    return lines


def _render_metrics(snap: Dict[str, Any]) -> List[str]:
    lines = []
    for name, meta in sorted(snap.items()):
        values = meta.get("values", [])
        if not values:
            continue
        for v in values:
            labels = v.get("labels", {})
            lab = ",".join(f"{k}={val}" for k, val in labels.items())
            lab = f"{{{lab}}}" if lab else ""
            if meta["kind"] == "histogram":
                n, s = v["count"], v["sum"]
                mean = s / n if n else 0.0
                lines.append(f"  {name}{lab}: count={n} sum={s:.4g} "
                             f"mean={mean:.4g}")
            else:
                lines.append(f"  {name}{lab}: {v['value']:g}")
    return lines or ["  (no metrics recorded)"]


def _render_convergence(data: Dict[str, Any]) -> List[str]:
    trace = ConvergenceTrace.from_json(data)
    views = ([trace.column(j) for j in range(trace.m)]
             if trace.batched else [trace])
    lines = []
    for j, view in enumerate(views):
        s = view.summary()
        tag = f"  column {j}: " if trace.batched else "  "
        lines.append(f"{tag}{s['status']} after {s['iterations']} "
                     f"iterations, final relres {s['final_relres']:.3e} "
                     f"({s['recorded']} recorded)")
        rows = view.per_iteration()
        if rows.size:
            ch = {n: i for i, n in enumerate(view.channels)}
            tail = rows[-5:]
            for row in tail:
                lines.append(
                    f"    it {int(row[ch['iteration']]):>5}  "
                    f"relres {row[ch['relres']]:.3e}  "
                    f"rho_den {row[ch['rho_denom']]:+.2e}  "
                    f"omega_den {row[ch['omega_denom']]:+.2e}  "
                    f"drift {row[ch['drift']]:.2e}")
    return lines


def run_report(dir_: str) -> int:
    """Render the artifact set under ``dir_``; returns exit status."""
    found = False
    spans_path = os.path.join(dir_, "spans.trace.json")
    if os.path.exists(spans_path):
        found = True
        with open(spans_path) as fh:
            doc = json.load(fh)
        print("== span timeline ==")
        print("\n".join(_render_timeline(doc)))
    mjson_path = os.path.join(dir_, "metrics.json")
    if os.path.exists(mjson_path):
        found = True
        with open(mjson_path) as fh:
            snap = json.load(fh).get("metrics", {})
        print("\n== metrics ==")
        print("\n".join(_render_metrics(snap)))
    conv_path = os.path.join(dir_, "convergence.json")
    if os.path.exists(conv_path):
        found = True
        with open(conv_path) as fh:
            data = json.load(fh)
        print("\n== convergence ==")
        print("\n".join(_render_convergence(data)))
    # device-profile breakdowns (dir itself + one level of leg subdirs)
    from .profile import ProfileReport
    candidates = [os.path.join(dir_, "profile.json")] + sorted(
        os.path.join(dir_, d, "profile.json")
        for d in (os.listdir(dir_) if os.path.isdir(dir_) else [])
        if os.path.isdir(os.path.join(dir_, d)))
    for p in candidates:
        if not os.path.exists(p):
            continue
        found = True
        rep = ProfileReport.load(p)
        print(f"\n== device profile: {rep.label or p} ==")
        print(rep.render())
    if not found:
        print(f"no observe artifacts under {dir_!r}; run "
              "`python -m repro_torch.observe smoke` first")
        return 1
    return 0


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.observe",
        description="observability artifacts and reports for the port's "
                    "solver stack")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_smoke = sub.add_parser(
        "smoke", help="run a traced solve + engine burst and write the "
                      "artifact set")
    p_smoke.add_argument("--out", default="build/observe")
    p_prof = sub.add_parser(
        "profile", help="capture device timelines (session solve per "
                        "substrate + engine drain) and compute the "
                        "per-phase / overlap breakdown")
    p_prof.add_argument("--out", default="build/profile")
    for p in (p_smoke, p_prof):
        p.add_argument("--full", action="store_true",
                       help="larger problem / more requests")
        p.add_argument("--device", default=None,
                       help="torch device (default: the card)")
    p_report = sub.add_parser(
        "report", help="render the artifact set as timeline + metrics + "
                       "convergence summary + device profiles")
    p_report.add_argument("--dir", default="build/observe")
    sub.add_parser("trajectory", help="not ported yet (ROADMAP A10)")
    args = parser.parse_args(argv)
    if args.cmd == "smoke":
        run_smoke(args.out, quick=not args.full, device=args.device)
        return 0
    if args.cmd == "profile":
        run_profile(args.out, quick=not args.full, device=args.device)
        return 0
    if args.cmd == "trajectory":
        print("trajectory: the benchmark trajectory reads the benchmark "
              "registry, which repro_torch has not yet (ROADMAP A10)",
              file=sys.stderr)
        return 2
    return run_report(args.dir)
