"""Device profiles of the port's solves: ``torch.profiler`` timelines ->
the per-phase breakdown (PyTorch port of ``repro.observe.profile``).

A capture (:class:`capture`) wraps execution in ``torch.profiler.profile``
(the card's kernels through CUPTI where there is one) and exports the
Chrome trace-event timeline; the timeline is parsed with the stdlib, its
device ops are attributed to solver phases, and the headline number is
computed as in the JAX package:

    overlap efficiency = |reduce ∩ matvec| / |reduce|

the fraction of reduction device wall time hidden under the in-flight
matvec (interval unions, so concurrent ops are not counted twice), and the
*exposed* reduction time per iteration beside it.

Phase attribution:

1. **Tags.**  The solver bodies wrap their phases in
   ``record_function("repro.matvec" | "repro.reduce" | "repro.axpy")``
   ranges, and a program each step in ``"repro.step"``
   (:func:`repro_torch.core._common.phase`), entered only while a capture
   is open.  An op launched inside a tag carries it: every op of an eager
   run, matched to its launch through the profiler's correlation ids.
2. **The kernel map.**  A CUDA graph replay carries no ranges.  So a
   capture first runs the call once through the eager chunk
   (:meth:`Capture.learn`) and maps each kernel name launched inside a
   step to its tag: the port's counterpart of the JAX package's HLO
   metadata map.  A name launched under two tags, or also untagged (the
   generic elementwise kernels of the scalar algebra, the selects and the
   Stencil7 matvec's shifted copies), is left out, and its ops count as
   ``unmapped_ops``.
3. **Name rules** for what neither reaches: ``fused_dots`` /
   ``dots_batched`` and NCCL's ``AllReduce`` -> reduce; ``spmv``,
   ``block_jacobi``, ``stencil`` and NCCL's ``SendRecv`` -> matvec;
   ``fused_axpy`` -> axpy; anything else -> other.

A run on the CPU has no device timeline: its "device ops" are the
top-level CPU operators, which the tags reach directly.  The port runs
each solver step on one stream, and at world 1 NCCL runs no kernel, so the
overlap efficiency reads about 0 (or ``None`` where no reduction time is
seen) on one card, as the JAX package reads about 0 on a serial device.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

SCHEMA_PROFILE = "repro.observe/profile/v1"
SCHEMA_KERNEL_MAP = "repro.observe/kernel-map/v1"

PHASES = ("matvec", "reduce", "axpy", "precond", "other")

# scope tag -> phase; checked against the scope first
_SCOPE_TAGS = (("repro.reduce", "reduce"), ("repro.matvec", "matvec"),
               ("repro.axpy", "axpy"), ("repro.precond", "precond"))
_STEP = "repro.step"

# op-name pattern -> phase (lower case); order matters
_NAME_RULES: Tuple[Tuple[str, str], ...] = (
    ("allreduce", "reduce"), ("all_reduce", "reduce"),
    ("all-reduce", "reduce"), ("reduce-scatter", "reduce"),
    ("psum", "reduce"), ("fused_dots", "reduce"),
    ("dots_batched", "reduce"), ("bicgsafe_dots", "reduce"),
    ("sendrecv", "matvec"), ("collective-permute", "matvec"),
    ("ppermute", "matvec"), ("halo", "matvec"), ("spmv", "matvec"),
    ("stencil", "matvec"), ("block_jacobi", "matvec"),
    ("fused_axpy", "axpy"), ("axpy_phase", "axpy"),
    ("precond", "precond"),
)

#: the categories of the card's ops in a kineto timeline
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host calls that launch them, matched by correlation id
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


# ---------------------------------------------------------------------------
# timeline loading
# ---------------------------------------------------------------------------

def load_timeline(src: Any) -> Dict[str, Any]:
    """Load a Chrome trace-event document from a path (.json / .json.gz)
    or pass a dict through unchanged."""
    if isinstance(src, dict):
        return src
    opener = gzip.open if str(src).endswith(".gz") else open
    with opener(src, "rt") as fh:
        return json.load(fh)


def host_spans(doc: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Aggregate host ranges named ``api.*`` / ``engine.*`` / ``repro.*``
    (the span recorder's and the phase tags) by name -> {count,
    total_us}."""
    out: Dict[str, Dict[str, float]] = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") in _DEVICE_CATS:
            continue
        name = e.get("name", "")
        if not re.match(r"^(api|engine|repro)\.", name):
            continue
        rec = out.setdefault(name, {"count": 0, "total_us": 0.0})
        rec["count"] += 1
        rec["total_us"] += float(e.get("dur", 0.0))
    return out


def _ranges_by_thread(events) -> Dict[Tuple[Any, Any], List[tuple]]:
    """The ``repro.*`` host ranges of each thread, sorted by start."""
    out: Dict[Tuple[Any, Any], List[tuple]] = {}
    for e in events:
        if e.get("cat") == "user_annotation" \
                and str(e.get("name", "")).startswith("repro."):
            ts = float(e["ts"])
            out.setdefault((e.get("pid"), e.get("tid")), []).append(
                (ts, ts + float(e.get("dur", 0.0)), e["name"]))
    for ranges in out.values():
        ranges.sort(key=lambda r: (r[0], -r[1]))
    return out


def _scopes(points, ranges: List[tuple]) -> Dict[int, Tuple[str, bool]]:
    """For host points ``(ts, index)`` of one thread, sorted: index -> the
    innermost phase tag enclosing it (``""``: none) and whether a step
    encloses it.  A sweep with a stack (the ranges of one thread nest)."""
    out: Dict[int, Tuple[str, bool]] = {}
    stack: List[tuple] = []
    j = 0
    for ts, idx in points:
        while j < len(ranges) and ranges[j][0] <= ts:
            while stack and stack[-1][1] <= ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] <= ts:
            stack.pop()
        tag = next((r[2] for r in reversed(stack) if r[2] != _STEP), "")
        out[idx] = (tag, any(r[2] == _STEP for r in stack))
    return out


def device_events(doc: Dict[str, Any]) -> List[dict]:
    """The timeline's device ops as ``{name, ts, dur, scope, in_step}``:
    the card's kernels, copies and memsets where it was traced (each
    scoped by the ranges around its launch, through the correlation id),
    else the top-level CPU operators (a run on the CPU)."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    gpu = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if gpu:
        launches = {}
        for e in events:
            if e.get("cat") in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        ops = gpu
        hosts = [launches.get((e.get("args") or {}).get("correlation"))
                 for e in gpu]
    else:
        ops = _top_level([e for e in events if e.get("cat") == "cpu_op"])
        hosts = ops
    ranges = _ranges_by_thread(events)
    points: Dict[Tuple[Any, Any], List[tuple]] = {}
    for idx, h in enumerate(hosts):
        if h is not None:
            points.setdefault((h.get("pid"), h.get("tid")), []).append(
                (float(h["ts"]), idx))
    scope = [("", False)] * len(ops)
    for key, pts in points.items():
        pts.sort()
        scope_of = _scopes(pts, ranges.get(key, []))
        for idx, got in scope_of.items():
            scope[idx] = got
    return [dict(name=str(e.get("name", "")), ts=float(e.get("ts", 0.0)),
                 dur=float(e.get("dur", 0.0)), scope=scope[i][0],
                 in_step=scope[i][1]) for i, e in enumerate(ops)]


def _top_level(ops: List[dict]) -> List[dict]:
    """The operators no other operator of their thread encloses."""
    out = []
    by_thread: Dict[Tuple[Any, Any], List[dict]] = {}
    for e in ops:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        end = float("-inf")
        for e in evs:
            if float(e["ts"]) >= end:
                out.append(e)
                end = float(e["ts"]) + float(e.get("dur", 0.0))
    return out


def kernel_phase_map(src: Any) -> Dict[str, str]:
    """Kernel name -> phase tag, from the timeline of an eager run with
    the tags on: the names launched inside a step, each under one tag
    only (a name seen under two tags, or untagged in a step, is left
    out)."""
    seen: Dict[str, set] = {}
    for e in device_events(load_timeline(src)):
        if e["in_step"]:
            seen.setdefault(e["name"], set()).add(e["scope"])
    return {name: next(iter(tags)) for name, tags in seen.items()
            if len(tags) == 1 and "" not in tags}


def classify_op(name: str, scope: str = "") -> str:
    """Phase of one device op: its scope tag first, then name rules."""
    for tag, phase in _SCOPE_TAGS:
        if tag in scope:
            return phase
    hay = name.lower()
    for pat, phase in _NAME_RULES:
        if pat in hay:
            return phase
    return "other"


def phase_events(src: Any, kernel_map: Optional[Dict[str, str]] = None
                 ) -> List[dict]:
    """Each device op of the timeline with its ``phase`` and whether a
    tag or the kernel map scoped it (``mapped``)."""
    kernel_map = kernel_map or {}
    out = []
    for e in device_events(load_timeline(src)):
        scope = e["scope"] or kernel_map.get(e["name"], "")
        out.append(dict(e, phase=classify_op(e["name"], scope),
                        mapped=bool(scope)))
    return out


# ---------------------------------------------------------------------------
# interval math
# ---------------------------------------------------------------------------

def merge_intervals(iv: Sequence[Tuple[float, float]]) \
        -> List[Tuple[float, float]]:
    """Union of half-open intervals, sorted and coalesced."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(i for i in iv if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect_intervals(a: Sequence[Tuple[float, float]],
                        b: Sequence[Tuple[float, float]]) \
        -> List[Tuple[float, float]]:
    """Intersection of two merged interval lists (two-pointer sweep)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def total(iv: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in iv)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProfileReport:
    """Per-phase device-time breakdown and the headline overlap numbers;
    the JAX package's fields and schema, so either package loads the
    other's ``profile.json``.

    Times are microseconds of device op wall time (interval union per
    phase).  ``overlap_efficiency`` is None when no reduce-phase device
    time was observed.  ``phase_ops`` counts the distinct op names of each
    phase; ``unmapped_ops`` the ops neither a tag nor the kernel map
    scoped (classified by name rules)."""
    phase_us: Dict[str, float]
    phase_ops: Dict[str, int]
    device_wall_us: float
    reduce_us: float
    matvec_us: float
    hidden_us: float
    exposed_us: float
    overlap_efficiency: Optional[float]
    iterations: Optional[int]
    exposed_per_iter_us: Optional[float]
    n_device_events: int
    unmapped_ops: int
    host_spans: Dict[str, Dict[str, float]]
    label: str = ""
    timeline_path: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["schema"] = SCHEMA_PROFILE
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ProfileReport":
        d = {k: v for k, v in d.items() if k != "schema"}
        return cls(**d)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "ProfileReport":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    def render(self, width: int = 46) -> str:
        lines = [f"== phase breakdown"
                 f"{f' ({self.label})' if self.label else ''} =="]
        denom = max(self.device_wall_us, 1e-9)
        for ph in PHASES:
            us = self.phase_us.get(ph, 0.0)
            if not us and ph not in ("matvec", "reduce"):
                continue
            frac = us / denom
            bar = "█" * int(round(width * min(frac, 1.0)))
            lines.append(f"  {ph:<8} {us / 1e3:9.3f} ms "
                         f"|{bar:<{width}}| {100 * frac:5.1f}%  "
                         f"({self.phase_ops.get(ph, 0)} ops)")
        lines.append(f"  device wall {self.device_wall_us / 1e3:.3f} ms, "
                     f"{self.n_device_events} device events"
                     + (f", {self.unmapped_ops} unmapped"
                        if self.unmapped_ops else ""))
        if self.overlap_efficiency is None:
            lines.append("  overlap: no reduce-phase device time observed")
        else:
            lines.append(
                f"  reduce {self.reduce_us / 1e3:.3f} ms: "
                f"{self.hidden_us / 1e3:.3f} ms hidden under matvec, "
                f"{self.exposed_us / 1e3:.3f} ms exposed "
                f"-> overlap efficiency {self.overlap_efficiency:.3f}")
            if self.exposed_per_iter_us is not None:
                lines.append(
                    f"  exposed communication per iteration: "
                    f"{self.exposed_per_iter_us:.2f} us"
                    + (f" ({self.iterations} iterations)"
                       if self.iterations else ""))
        return "\n".join(lines)


def analyze_timeline(src: Any,
                     kernel_map: Optional[Dict[str, str]] = None,
                     iterations: Optional[int] = None,
                     label: str = "") -> ProfileReport:
    """Parse one trace-event timeline into a :class:`ProfileReport`.

    ``src`` is a path (.json / .json.gz) or a loaded trace dict;
    ``kernel_map`` is :func:`kernel_phase_map`'s.  ``iterations`` (solver
    iterations inside the window) enables the per-iteration exposed time;
    when omitted it is the count of the most-run reduce op.
    """
    doc = load_timeline(src)
    events = phase_events(doc, kernel_map)
    phase_iv: Dict[str, List[Tuple[float, float]]] = {p: [] for p in PHASES}
    phase_ops: Dict[str, set] = {p: set() for p in PHASES}
    reduce_counts: Dict[str, int] = {}
    for e in events:
        phase_iv[e["phase"]].append((e["ts"], e["ts"] + e["dur"]))
        phase_ops[e["phase"]].add(e["name"])
        if e["phase"] == "reduce":
            reduce_counts[e["name"]] = reduce_counts.get(e["name"], 0) + 1

    merged = {p: merge_intervals(iv) for p, iv in phase_iv.items()}
    phase_us = {p: total(iv) for p, iv in merged.items()}
    all_iv = merge_intervals([i for iv in phase_iv.values() for i in iv])

    R, V = merged["reduce"], merged["matvec"]
    reduce_us = total(R)
    hidden_us = total(intersect_intervals(R, V))
    exposed_us = reduce_us - hidden_us
    eff = (hidden_us / reduce_us) if reduce_us > 0 else None

    if iterations is None:
        iterations = max(reduce_counts.values()) if reduce_counts else None
    exposed_per_iter = (exposed_us / iterations
                        if eff is not None and iterations else None)

    return ProfileReport(
        phase_us=phase_us,
        phase_ops={p: len(s) for p, s in phase_ops.items()},
        device_wall_us=total(all_iv),
        reduce_us=reduce_us,
        matvec_us=phase_us["matvec"],
        hidden_us=hidden_us,
        exposed_us=exposed_us,
        overlap_efficiency=eff,
        iterations=int(iterations) if iterations is not None else None,
        exposed_per_iter_us=exposed_per_iter,
        n_device_events=len(events),
        unmapped_ops=sum(not e["mapped"] for e in events),
        host_spans=host_spans(doc),
        label=label,
        timeline_path=src if isinstance(src, str) else None,
    )


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

def _profile_window(torch, path: str):
    """A ``torch.profiler.profile`` (the card's activity too where there is
    one) that exports its timeline to ``path`` when it closes."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=lambda p: p.export_chrome_trace(path))


class _Tags:
    """The phase tags on (:func:`repro_torch.core._common.phase`) for the
    length of a ``with``."""

    def __enter__(self):
        from ..core import _common
        self._prev, _common._TAGS[0] = _common._TAGS[0], True

    def __exit__(self, *exc):
        from ..core import _common
        _common._TAGS[0] = self._prev


def _synchronize(torch) -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Capture:
    """One profiling window: its directory (``trace.json``, the window's
    timeline; ``kernel_map.json`` once saved), and the kernel map."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.timeline_path: Optional[str] = None
        self.kernel_map: Dict[str, str] = {}

    def learn(self, fn: Callable[[], Any]) -> Dict[str, str]:
        """Run ``fn`` once through the eager chunk (every program's steps
        eagerly, on the card too) with the tags on, in a profiler window
        of its own, and add the kernel names it launched inside steps to
        :attr:`kernel_map`.  That run's timeline is parsed, then deleted:
        the map is what it is kept for."""
        import torch

        from ..core.program import _eager_chunks
        path = os.path.join(self.out_dir, "warmup.trace.json")
        _synchronize(torch)
        try:
            with _Tags(), _eager_chunks(), _profile_window(torch, path):
                fn()
                _synchronize(torch)
            self.kernel_map.update(kernel_phase_map(path))
        finally:
            if os.path.exists(path):
                os.remove(path)
        return self.kernel_map

    def analyze(self, iterations: Optional[int] = None,
                label: str = "") -> ProfileReport:
        if self.timeline_path is None or \
                not os.path.exists(self.timeline_path):
            raise FileNotFoundError(
                f"no timeline under {self.out_dir!r}; did the capture "
                "context exit cleanly?")
        return analyze_timeline(self.timeline_path, self.kernel_map,
                                iterations=iterations, label=label)

    def save_kernel_map(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.out_dir, "kernel_map.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"schema": SCHEMA_KERNEL_MAP,
                       "kernels": self.kernel_map}, fh, indent=1,
                      sort_keys=True)
        return path


_ACTIVE: List[Capture] = []


def active_capture() -> Optional[Capture]:
    """The open capture, if any (``torch.profiler`` windows do not
    nest)."""
    return _ACTIVE[-1] if _ACTIVE else None


class capture:
    """``with capture(out_dir, learn=fn) as cap: ...`` runs the body inside
    a ``torch.profiler`` window with the phase tags on and exports its
    timeline to ``out_dir/trace.json``; ``learn`` (the body's call, run
    once first, outside the window) builds the kernel map
    (:meth:`Capture.learn`).

    Warm the programs (their captures) before entering, or the captures'
    warm-ups dominate the timeline.  Raises when a capture is open
    already.
    """

    def __init__(self, out_dir: str, learn: Optional[Callable] = None):
        self.cap = Capture(out_dir)
        self._learn = learn
        self._window = None

    def __enter__(self) -> Capture:
        import torch
        if _ACTIVE:
            raise RuntimeError("a profile capture is open already "
                               "(torch.profiler windows do not nest)")
        os.makedirs(self.cap.out_dir, exist_ok=True)
        if self._learn is not None:
            self.cap.learn(self._learn)
        path = os.path.join(self.cap.out_dir, "trace.json")
        self._tags = _Tags()
        self._window = _profile_window(torch, path)
        _ACTIVE.append(self.cap)
        self._tags.__enter__()
        try:
            _synchronize(torch)
            self._window.__enter__()
        except BaseException:
            self._tags.__exit__(None, None, None)
            _ACTIVE.remove(self.cap)
            raise
        self.cap.timeline_path = path
        return self.cap

    def __exit__(self, *exc) -> None:
        import torch
        try:
            _synchronize(torch)
            self._window.__exit__(*exc)
        finally:
            self._tags.__exit__(*exc)
            _ACTIVE.remove(self.cap)


__all__ = ["SCHEMA_PROFILE", "PHASES", "ProfileReport", "Capture",
           "capture", "active_capture", "analyze_timeline", "classify_op",
           "device_events", "host_spans", "intersect_intervals",
           "kernel_phase_map", "load_timeline", "merge_intervals",
           "phase_events", "total"]
